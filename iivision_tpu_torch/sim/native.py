"""ctypes bindings for the host-side C++ helpers (the port's copy of
iivision_tpu/sim/native.py): error-diffusion dithers, the fused-LUT
quantizer and screen packing, the PIL-exact resize passes and the stream
emitter.  Sources are `sim/csrc/*.cpp`, built by `sim/_build.py`."""

import ctypes
import functools

import numpy as np

from iivision_tpu_torch.sim._build import build_so

KERNELS = {"floyd": 0, "buckels": 0, "atkinson": 1, "jarvis": 2}

_u8 = ctypes.POINTER(ctypes.c_uint8)
_i32 = ctypes.POINTER(ctypes.c_int32)
_f32 = ctypes.POINTER(ctypes.c_float)


def _u8p(a):
    return a.ctypes.data_as(_u8)


def _i32p(a):
    return a.ctypes.data_as(_i32)


def _allowed_p(allowed):
    if allowed is None:
        return None, None
    allowed = np.ascontiguousarray(allowed, dtype=np.uint8)
    return allowed, _u8p(allowed)


@functools.lru_cache(None)
def _dither_lib():
    lib = ctypes.CDLL(build_so("dither"))
    lib.dither_ed.restype = None
    lib.dither_ed.argtypes = [_f32, ctypes.c_int, ctypes.c_int, _f32,
                              ctypes.c_int, _u8, ctypes.c_int, _i32]
    lib.dither_bmp2dhr.restype = None
    lib.dither_bmp2dhr.argtypes = [_u8, ctypes.c_int, ctypes.c_int, _u8,
                                   ctypes.c_int, _u8, ctypes.c_int, _i32]
    return lib


def dither_bmp2dhr(rgb: np.ndarray, palette_rgb: np.ndarray, d: int,
                   allowed: np.ndarray = None) -> np.ndarray:
    """bmp2dhr-mechanics error diffusion (raster scan, saturating integer
    diffusion, Euclidean RGB matching).  rgb: (h, w, 3) uint8;
    palette_rgb: (n, 3) uint8; d: 1..9.  Returns (h, w) int32 codes."""
    h, w = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    pal = np.ascontiguousarray(palette_rgb, dtype=np.uint8)
    out = np.zeros((h, w), dtype=np.int32)
    allowed, allowed_p = _allowed_p(allowed)
    _dither_lib().dither_bmp2dhr(_u8p(rgb), h, w, _u8p(pal), len(pal),
                                 allowed_p, int(d), _i32p(out))
    return out


def dither(rgb: np.ndarray, palette_rgb: np.ndarray,
           kernel: str = "buckels", allowed: np.ndarray = None) -> np.ndarray:
    """Serpentine error-diffusion quantization.  rgb: (h, w, 3) float32
    0..255; palette_rgb: (n, 3).  Returns (h, w) int32 codes."""
    h, w = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb, dtype=np.float32)
    pal = np.ascontiguousarray(palette_rgb, dtype=np.float32)
    out = np.zeros((h, w), dtype=np.int32)
    allowed, allowed_p = _allowed_p(allowed)
    _dither_lib().dither_ed(rgb.ctypes.data_as(_f32), h, w,
                            pal.ctypes.data_as(_f32), len(pal), allowed_p,
                            KERNELS.get(kernel, 0), _i32p(out))
    return out


@functools.lru_cache(None)
def _ingest_lib():
    lib = ctypes.CDLL(build_so("ingest_fast"))
    lib.quantize_fused.restype = None
    lib.quantize_fused.argtypes = [_u8, ctypes.c_int64, _u8, ctypes.c_int,
                                   _u8]
    lib.dhgr_pack.restype = None
    lib.dhgr_pack.argtypes = [_u8, ctypes.c_int64, _u8, _u8]
    lib.hgr_fit.restype = None
    lib.hgr_fit.argtypes = [_u8, ctypes.c_int64, _u8]
    lib.emit_stream.restype = ctypes.c_int64
    lib.emit_stream.argtypes = [
        _i32, _i32, ctypes.c_int64, _i32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _u8, ctypes.c_int64]
    return lib


def _frames(a: np.ndarray, tail) -> tuple:
    lead = a.shape[:-len(tail)]
    F = int(np.prod(lead, dtype=np.int64)) if lead else 1
    return lead, F, np.ascontiguousarray(a, np.uint8).reshape((F,) + tail)


def quantize_fused(rgb: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """(..., 192, 140, 3) uint8 RGB -> (..., 192, 140) uint8 codes via the
    fused (bayer_cell, r, g, b binned) LUT; the channel bin resolution is
    inferred from the LUT size."""
    lead, F, flat = _frames(rgb, (192, 140, 3))
    bits = (int(lut.size // 64).bit_length() - 1) // 3
    if lut.size != 64 << (3 * bits):
        raise ValueError("fused LUT of %d entries" % lut.size)
    lut = np.ascontiguousarray(lut, np.uint8)
    out = np.empty((F, 192, 140), np.uint8)
    _ingest_lib().quantize_fused(_u8p(flat), F, _u8p(lut), bits, _u8p(out))
    return out.reshape(lead + (192, 140))


def dhgr_pack(codes: np.ndarray):
    """(..., 192, 140) uint8 codes -> (main, aux) (..., 32, 256) uint8."""
    lead, F, flat = _frames(codes, (192, 140))
    main = np.empty((F, 32, 256), np.uint8)
    aux = np.empty((F, 32, 256), np.uint8)
    _ingest_lib().dhgr_pack(_u8p(flat), F, _u8p(main), _u8p(aux))
    return main.reshape(lead + (32, 256)), aux.reshape(lead + (32, 256))


def hgr_fit(codes: np.ndarray) -> np.ndarray:
    """(..., 192, 140) uint8 HGR codes -> (..., 32, 256) uint8 main."""
    lead, F, flat = _frames(codes, (192, 140))
    main = np.empty((F, 32, 256), np.uint8)
    _ingest_lib().hgr_fit(_u8p(flat), F, _u8p(main))
    return main.reshape(lead + (32, 256))


@functools.lru_cache(None)
def _resize_lib():
    # native ISA nearly halves the integer convolution time
    lib = ctypes.CDLL(build_so("resize_fast", native_isa=True))
    lib.resample_h_u8.restype = None
    lib.resample_h_u8.argtypes = [
        _u8, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _i32, _i32,
        ctypes.c_int32, _u8]
    lib.resample_v_u8.restype = None
    lib.resample_v_u8.argtypes = [
        _u8, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32, _i32, ctypes.c_int32, _i32, _u8]
    return lib


def resample_h(flat: np.ndarray, w_out: int, bounds: np.ndarray,
               kk: np.ndarray) -> np.ndarray:
    """(N, h, w_in, 3) uint8 -> (N, h, w_out, 3), PIL-exact horizontal
    pass."""
    n, h, w_in, _ = flat.shape
    flat = np.ascontiguousarray(flat, np.uint8)
    out = np.empty((n, h, w_out, 3), np.uint8)
    _resize_lib().resample_h_u8(_u8p(flat), n * h, w_in, w_out,
                                _i32p(bounds), _i32p(kk), kk.shape[1],
                                _u8p(out))
    return out


def resample_v(flat: np.ndarray, h_out: int, bounds: np.ndarray,
               kk: np.ndarray) -> np.ndarray:
    """(N, h_in, w, 3) uint8 -> (N, h_out, w, 3), PIL-exact vertical
    pass."""
    n, h_in, w, _ = flat.shape
    flat = np.ascontiguousarray(flat, np.uint8)
    out = np.empty((n, h_out, w, 3), np.uint8)
    scratch = np.empty(w * 3, np.int32)
    _resize_lib().resample_v_u8(_u8p(flat), n, h_in, h_out, w,
                                _i32p(bounds), _i32p(kk), kk.shape[1],
                                _i32p(scratch), _u8p(out))
    return out


def emit_stream(flat_ops: np.ndarray, levels: np.ndarray, lut: np.ndarray,
                ack_addr: int, term_addr: int, mode_byte: int, dhgr: bool,
                ops_first_frame: int, ops_per_frame: int) -> bytes:
    """C++ assembly of the `.a2m` byte stream (see stream/emit_fast.py)."""
    n = len(flat_ops)
    flat_ops = np.ascontiguousarray(flat_ops, np.int32)
    levels = np.ascontiguousarray(levels[:n], np.int32)
    lut = np.ascontiguousarray(lut, np.int32)
    n_acks = 0 if n == 0 else (
        (1 if n >= ops_first_frame else 0)
        + max(0, (n - ops_first_frame)) // ops_per_frame)
    size = 7 + n * 7 + n_acks * 4 + 2
    size += (2048 - size % 2048) % 2048
    out = np.empty(size + 2048, np.uint8)
    written = _ingest_lib().emit_stream(
        _i32p(flat_ops), _i32p(levels), n, _i32p(lut), ack_addr, term_addr,
        mode_byte, 1 if dhgr else 0, ops_first_frame, ops_per_frame,
        _u8p(out), len(out))
    if written <= 0:
        raise RuntimeError("emit_stream: output buffer undersized")
    return out[:written].tobytes()
