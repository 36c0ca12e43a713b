"""Apple II nominal colours via the 4-bit NTSC sliding-window model (the
port's copy of what it uses of iivision_tpu/colours.py).

The colour of each display dot is a sliding 4-bit window of the dot stream,
rotated by the NTSC clock phase at that dot.
"""

import enum

import numpy as np


class HGRColours(enum.Enum):
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


def dots_to_pixels_vec(dots: np.ndarray, num_bits: int,
                       init_phase: int) -> np.ndarray:
    """Sliding-window colour extraction on a numpy array of dot streams
    (bit i = dot i): shape dots.shape + (num_bits,), each entry the 4-bit
    window at dot i rotated left by the phase (init_phase + i) mod 4."""
    d = dots[..., None]
    shifts = np.arange(num_bits, dtype=dots.dtype)
    win = (d >> shifts) & 0b1111
    phases = (init_phase + np.arange(num_bits)) % 4
    return ((win << phases) | (win >> (4 - phases))) & 0b1111
