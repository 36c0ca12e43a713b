"""ctypes binding for the native C++ player VM (the port's copy of
iivision_tpu/sim/player_vm.py; source `sim/csrc/player_vm.cpp`).

Given an `.a2m` byte stream and the player's opcode address table, it
reconstructs the final screen memory and the audio duty-cycle sequence, and
validates the W5100 2 KB framing contract.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np

from iivision_tpu_torch.sim._build import build_so
from iivision_tpu_torch.stream.opcodes import (OpcodeAddresses,
                                               default_addresses)

ERROR_NAMES = {
    0: "OK",
    -1: "ERR_HEADER",
    -2: "ERR_UNKNOWN_OPCODE",
    -3: "ERR_TRUNCATED",
    -4: "ERR_ACK_POSITION",
    -5: "ERR_ACK_BYTE",
    -6: "ERR_MISSING_ACK",
    -7: "ERR_PADDING",
    -8: "ERR_NOT_TERMINATED",
    -9: "ERR_STREAM_LENGTH",
    -10: "ERR_DUTY_OVERFLOW",
}


@dataclass
class DecodeResult:
    ok: bool
    error: str
    error_pos: int
    n_ops: int
    n_acks: int
    cycles: int
    video_mode: int
    main: np.ndarray  # (32, 256) uint8 final main screen memory
    aux: np.ndarray  # (32, 256) uint8 final aux screen memory
    duty: np.ndarray  # (n_ops,) int32 speaker duty cycles

    @property
    def playback_seconds(self) -> float:
        """Wall-clock playback duration at the nominal 1.0227 MHz clock."""
        return self.cycles / (1024 * 1024)


class PlayerVM:
    """Native .a2m decoder bound to a specific player binary's address
    map."""

    def __init__(self, addrs: Optional[OpcodeAddresses] = None):
        addrs = addrs or default_addresses()
        self._lib = ctypes.CDLL(build_so("player_vm"))
        self._lib.a2m_decode.restype = ctypes.c_int64
        self._lib.a2m_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        self.kind = np.zeros(65536, dtype=np.int32)
        self.tick = np.zeros(65536, dtype=np.int32)
        self.page = np.zeros(65536, dtype=np.int32)
        for (t, p), a in addrs.tick.items():
            self.kind[a] = 1
            self.tick[a] = t
            self.page[a] = p
        self.kind[addrs.ack] = 2
        self.kind[addrs.terminate] = 3
        self.kind[addrs.nop] = 4

    def decode(self, stream: bytes,
               duty_cap: Optional[int] = None) -> DecodeResult:
        n = len(stream)
        duty_cap = duty_cap or max(n // 7 + 16, 1024)
        main = np.zeros(8192, dtype=np.uint8)
        aux = np.zeros(8192, dtype=np.uint8)
        duty = np.zeros(duty_cap, dtype=np.int32)
        counts = np.zeros(6, dtype=np.int64)

        def ptr(a, ty):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        rc = self._lib.a2m_decode(
            stream, n,
            ptr(self.kind, ctypes.c_int32), ptr(self.tick, ctypes.c_int32),
            ptr(self.page, ctypes.c_int32),
            ptr(main, ctypes.c_uint8), ptr(aux, ctypes.c_uint8),
            ptr(duty, ctypes.c_int32), duty_cap,
            ptr(counts, ctypes.c_int64))
        n_ops = int(counts[0])
        return DecodeResult(
            ok=(rc == 0),
            error=ERROR_NAMES.get(int(rc), "ERR_%d" % rc),
            error_pos=int(counts[3]),
            n_ops=n_ops,
            n_acks=int(counts[1]),
            cycles=int(counts[2]),
            video_mode=int(counts[4]),
            main=main.reshape(32, 256),
            aux=aux.reshape(32, 256),
            duty=duty[:n_ops].copy(),
        )
