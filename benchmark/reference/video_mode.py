"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/video_mode.py, which this package never imports.

Video encoding modes (the port's copy of iivision_tpu/video_mode.py).

The values are part of the stream header ABI: Header byte 7 carries
VideoMode.value.  This enum is the port's own; a member of the JAX
package's enum is not equal to it, so entry points check with
`require_mode` instead of silently taking the HGR branch of a comparison.
"""

import enum


class VideoMode(enum.Enum):
    HGR = 0  # Hi-Res: 280x192, main memory only
    DHGR = 1  # Double Hi-Res: 560 dots, interleaved AUX/MAIN memory


def require_mode(mode) -> "VideoMode":
    """`mode` if it is this package's VideoMode; TypeError otherwise (a
    member of another package's enum compares unequal to every member
    here)."""
    if not isinstance(mode, VideoMode):
        raise TypeError("the reference takes its own VideoMode "
                        "(benchmark.reference.video_mode.VideoMode), got %r "
                        "of %s" % (mode, type(mode).__module__))
    return mode
