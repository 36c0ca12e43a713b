"""Apple II nominal colours via the 4-bit NTSC sliding-window model (the
port's copy of iivision_tpu/colours.py).

The colour of each display dot is a sliding 4-bit window of the dot stream,
rotated by the NTSC clock phase at that dot.  Behavioural parity with
reference transcoder/colours.py:18-148 (colour enums, rol/ror,
dots_to_nominal_colour_pixels); `dots_to_pixels_vec` maps arrays of dot
streams to pixel values in one shot (the LUT build's input).
"""

import enum
from typing import Tuple, Type

import numpy as np


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


class DHGRColours(NominalColours):
    """4-bit dot window -> nominal colour, DHGR phase convention (a 4-bit
    rotation of HGR's: the colour reference is one tick apart)."""
    BLACK = 0b0000
    MAGENTA = 0b1000
    BROWN = 0b0100
    ORANGE = 0b1100
    DARK_GREEN = 0b0010
    GREY1 = 0b1010
    GREEN = 0b0110
    YELLOW = 0b1110
    DARK_BLUE = 0b0001
    VIOLET = 0b1001
    GREY2 = 0b0101
    PINK = 0b1101
    MED_BLUE = 0b0011
    LIGHT_BLUE = 0b1011
    AQUA = 0b0111
    WHITE = 0b1111


def ror(int4: int, howmany: int) -> int:
    """Rotate-right a 4-bit value `howmany` times."""
    r = howmany % 4
    return ((int4 >> r) | (int4 << (4 - r))) & 0b1111


def rol(int4: int, howmany: int) -> int:
    """Rotate-left a 4-bit value `howmany` times."""
    r = howmany % 4
    return ((int4 << r) | (int4 >> (4 - r))) & 0b1111


def dots_to_nominal_colour_pixels(
        num_bits: int, dots: int, colours: Type[NominalColours],
        init_phase: int = 1) -> Tuple[NominalColours, ...]:
    """Scalar reference: the sequence of nominal colours of a dot stream.

    Pixel i is the 4-bit window dots[i:i+4], rotated left by the NTSC phase
    (init_phase + i) mod 4; the first windows straddle the trailing bits
    of the previous packed column."""
    res = []
    shifted = dots
    phase = init_phase
    for _ in range(num_bits):
        res.append(colours(rol(shifted & 0b1111, phase)))
        shifted >>= 1
        phase = (phase + 1) % 4
    return tuple(res)


def dots_to_nominal_colour_pixel_values(
        num_bits: int, dots: int, colours: Type[NominalColours],
        init_phase: int = 1) -> Tuple[int, ...]:
    """`dots_to_nominal_colour_pixels` as the colours' 4-bit values."""
    return tuple(
        p.value for p in
        dots_to_nominal_colour_pixels(num_bits, dots, colours, init_phase))


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
