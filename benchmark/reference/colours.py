"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/colours.py, which this package never imports.

Apple II nominal colours of the 4-bit NTSC sliding-window model, HGR
phase convention: the keys of the palettes' RGB tables (only the enum is
kept here).
"""

import enum


class NominalColours(enum.Enum):
    pass


class HGRColours(NominalColours):
    """4-bit dot window -> nominal colour, HGR phase convention (dots in
    memory bit order, MSB -> LSB)."""
    BLACK = 0b0000
    MAGENTA = 0b0001
    BROWN = 0b1000
    ORANGE = 0b1001
    DARK_GREEN = 0b0100
    GREY1 = 0b0101
    GREEN = 0b1100
    YELLOW = 0b1101
    DARK_BLUE = 0b0010
    VIOLET = 0b0011
    GREY2 = 0b1010
    PINK = 0b1011
    MED_BLUE = 0b0110
    LIGHT_BLUE = 0b0111
    AQUA = 0b1110
    WHITE = 0b1111
