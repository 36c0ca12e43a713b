"""The sub-op microbenchmark's math, plain torch and kernel C (counterpart
of tools/bench_subop_pallas.py `_sub_op_math`, `_sub_op_math_int` and
`make_pallas`).

The microbenchmark isolates the latency floor of the encoder's sequential
sub-op chain: T dependent sub-op selections on (R, 256) float32 state
(R = B*K page rows), each with a hash nonce for the primary offset's
tie-break and the stand-in cost row `by * 0.5 + 1` in place of the
store-cost gather.  It has no table, no `nvalid` and no records: the state
arrays are the whole result.

- `sub_op_math` / `sub_op_math_int`: one sub-op, float32 and int32, the
  JAX expressions written as torch ops.  The gated updates
  `up * (1 - umask) + resid * real` and the others are selects here: for
  state that stays >= 0 (as `fresh()` makes it) they give the same bits.
- `run_plain` / `run_plain_i16`: T sub-ops as an eager loop (the tool's
  `xla` and `xla_i16` variants, which are XLA, not Pallas).
- `run_kernel`: T sub-ops in one launch of kernel C (csrc/subop_bench.cu
  `iiv_subop_bench`, the counterpart of the Pallas `make_pallas.kernel`:
  a warp per row on the body kernel's warp argmax, csrc/warp_argmax.cuh).
  A CPU tensor runs `run_plain`; a CUDA tensor launches the kernel or
  raises.  `run_kernel.launches` counts the launches.
"""

import ctypes

import torch

from iivision_tpu_torch import _build

# the nonce hash: ((jj * NONCE_MUL + offset * NONCE_STEP) & 0xffff), wrapped
# in int32 in JAX; the low 16 bits are the same in any wider integer
NONCE_MUL = 507279793
NONCE_STEP = 40503
# a Python float in JAX, so rounded to float32 once
NONCE_SCALE = 255.0 / 65535.0


def nonce_bits(jj: int, device) -> torch.Tensor:
    """(256,) int32 hash nonce of sub-op jj, per page offset."""
    iota = torch.arange(256, dtype=torch.int64, device=device)
    return ((jj * NONCE_MUL + iota * NONCE_STEP) & 0xFFFF).to(torch.int32)


def sub_op_math(up, dw, by, tb, jj: int):
    """One float32 sub-op on (R, 256) rows; returns the new (up, dw, by)."""
    dev = up.device
    iota = torch.arange(256, device=dev)
    scale = torch.tensor(NONCE_SCALE, dtype=torch.float32, device=dev)
    nonce = nonce_bits(jj, dev).to(torch.float32) * scale
    off0 = torch.argmax(up * 256.0 + nonce, dim=1)  # first maximal index
    oh0 = iota[None, :] == off0[:, None]
    content = tb.gather(1, off0[:, None])

    sc_row = by * 0.5 + 1.0
    score = dw - sc_row
    sl = torch.where((up > 0.0) & (score > 0.0) & ~oh0, score, -1.0)
    acc = torch.zeros_like(oh0)
    for _ in range(3):  # best three, ties to the lowest offset
        o = torch.argmax(sl, dim=1)
        oh = iota[None, :] == o[:, None]
        acc |= oh & (sl.gather(1, o[:, None]) > 0.0)
        sl = torch.where(oh, -1.0, sl)

    real = up.amax(dim=1, keepdim=True) > 0.0
    prim = oh0 & real
    comp = acc & real
    # the primary clears up and dw, a companion takes its residual cost,
    # both store the content byte
    up = torch.where(prim, 0.0, torch.where(comp, sc_row, up))
    dw = torch.where(prim, 0.0, dw)
    by = torch.where(prim | comp, content, by)
    return up, dw, by


def sub_op_math_int(up, dw, by, tb, jj: int):
    """The int32 twin of `sub_op_math` (the tool's `_sub_op_math_int`):
    the same dependent chain on int32 rows, values well below 2^31."""
    dev = up.device
    iota = torch.arange(256, device=dev)
    off0 = torch.argmax(up * 65536 + nonce_bits(jj, dev), dim=1)
    oh0 = iota[None, :] == off0[:, None]
    content = tb.gather(1, off0[:, None])

    sc_row = torch.div(by, 2, rounding_mode="floor") + 1
    score = dw - sc_row
    sl = torch.where((up > 0) & (score > 0) & ~oh0, score, -1)
    acc = torch.zeros_like(oh0)
    for _ in range(3):
        o = torch.argmax(sl, dim=1)
        oh = iota[None, :] == o[:, None]
        acc |= oh & (sl.gather(1, o[:, None]) > 0)
        sl = torch.where(oh, -1, sl)

    real = up.amax(dim=1, keepdim=True) > 0
    prim = oh0 & real
    comp = acc & real
    up = torch.where(prim, 0, torch.where(comp, sc_row, up))
    dw = torch.where(prim, 0, dw)
    by = torch.where(prim | comp, content, by)
    return up, dw, by


def run_plain(up, dw, by, tb, T: int):
    """T float32 sub-ops as an eager loop; returns the final (up, dw, by)."""
    for jj in range(T):
        up, dw, by = sub_op_math(up, dw, by, tb, jj)
    return up, dw, by


def run_plain_i16(up, dw, by, tb, T: int):
    """The int16-carry variant: state scaled by 40 and truncated to int16,
    carried in int16 between sub-ops and computed in int32 (the tool's
    `xla_i16`).  Returns the final int16 (up, dw, by)."""
    tb32 = (tb * 40.0).to(torch.int16).to(torch.int32)
    u, d, b = ((a * 40.0).to(torch.int16) for a in (up, dw, by))
    for jj in range(T):
        u, d, b = (x.to(torch.int16) for x in sub_op_math_int(
            u.to(torch.int32), d.to(torch.int32), b.to(torch.int32), tb32,
            jj))
    return u, d, b


def run_kernel(up, dw, by, tb, T: int):
    """T float32 sub-ops; on a CUDA tensor one launch of kernel C.

    up, dw, by, tb: (R, 256) float32, contiguous, on one device.  Returns
    new (up, dw, by) tensors; the inputs are not changed."""
    if up.device.type == "cpu":
        return run_plain(up, dw, by, tb, T)
    if up.device.type != "cuda":
        raise ValueError("no kernel for device %s" % up.device)
    R = up.shape[0]
    for t in (up, dw, by, tb):
        if t.device != up.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != (R, 256):
            raise ValueError(
                "kernel C argument: want float32 (%d, 256) contiguous on %s,"
                " got %s %s on %s" % (R, up.device, t.dtype, tuple(t.shape),
                                      t.device))
    if T < 0:
        raise ValueError("T=%d sub-ops" % T)
    outs = [torch.empty_like(up) for _ in range(3)]
    _build.launch(
        "iiv_subop_bench", *(ctypes.c_void_p(t.data_ptr())
                             for t in (up, dw, by, tb)),
        R, int(T), *(ctypes.c_void_p(o.data_ptr()) for o in outs),
        ctypes.c_void_p(_build.stream_ptr(up.device)))
    run_kernel.launches += 1
    return tuple(outs)


run_kernel.launches = 0
