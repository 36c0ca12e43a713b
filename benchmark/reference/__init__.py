"""The benchmark's plain reference of the transcode, in plain torch and
numpy: ingest (the device path's float64 resize and float32 Lab dither,
and the host path's PIL fixed-point resize and fused-LUT dither), audio
levels, the opcode plan, the encoder (chunk starts, bodies, sub-ops and
threefry nonces, one torch op at a time), op flattening and the 2 KB
stream framing.

It imports neither `jax` nor `iivision_tpu` nor anything of
`iivision_tpu_torch`: the port's plain forms it needs are frozen copies
here, so that a later change to the port cannot move the yardstick.  It
reads the shipped store-cost tables and the player's symbol file by path
(`DATA_DIR`), as raw input files.  `control=True` on an entry point runs
it one precision step lower where the configuration states a precision
(see `check.py`): the control that the comparison has to fail.
"""

import os

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "iivision_tpu", "data")
