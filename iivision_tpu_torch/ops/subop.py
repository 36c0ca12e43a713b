"""The encoder's sequential sub-op chain (counterpart of
iivision_tpu/encoder.py `sub_op`), plain torch and kernel B.

After a scan step's page top-k, each of the k selected pages runs j
sequential op selections on its extracted rows; each sees the earlier
sub-ops' updates.  Layouts:

- rows: (k, 4, 256) float32, the pages' [up, dw, by, tb] rows: update
  priority, live diff weight, modelled screen byte, target byte;
- sc_rows: (k, 256) int32, per offset the row of the int16 store-cost
  table (lane * R + target lane value) on the bank's even/odd lanes;
- table: (n_lanes * R, C) int16 store costs;
- nonce: (j, k, 256) float32 offset tie-break nonces, or None for the
  deterministic encoder (zeros);
- pages: (k,) int64 page indices; nvalid: real ops in this step;
  pad_content: the padding op's content byte;
- out: (j, k, 6) uint8 records [page + 32, content, o0, o1, o2, o3],
  sub-op-major.

`sub_op_chain` updates `rows` in place and writes `out`.  A CPU tensor
runs `sub_op_chain_plain`; a CUDA tensor launches kernel B
(csrc/subop.cu) or raises.  `sub_op_chain.launches` counts the launches.
"""

import ctypes

import torch

from iivision_tpu_torch import _build


def sub_op_chain_plain(rows, sc_rows, table, nonce, pages, nvalid: int,
                       pad_content: int, out) -> None:
    """Plain torch form of the chain, vectorised over the k pages; the
    same float32 expressions as the JAX scan, evaluated one op at a time
    (so no product is fused into its sum)."""
    k = rows.shape[0]
    j = out.shape[0]
    C = table.shape[1]
    dev = rows.device
    iota = torch.arange(256, device=dev)
    slot = torch.arange(k, device=dev)
    up, dw, by, tb = (rows[:, i].clone() for i in range(4))
    for jj in range(j):
        has_work = up.amax(dim=1) > 0.0
        real = has_work & (jj * k + slot < nvalid)
        off_score = up * 256.0
        if nonce is not None:
            off_score = off_score + nonce[jj] * 255.0
        off0 = torch.argmax(off_score, dim=1)  # first maximal index
        content = tb.gather(1, off0[:, None])[:, 0].to(torch.int64)
        sc = table.view(-1)[sc_rows.to(torch.int64) * C
                            + (content & (C - 1))[:, None]].to(torch.float32)
        score = dw - sc
        not_prim = iota[None, :] != off0[:, None]
        sl = torch.where((up > 0.0) & (score > 0.0) & not_prim, score, -1.0)
        offs = []
        comp = torch.zeros_like(up, dtype=torch.bool)
        for _ in range(3):  # best three, ties to the lowest offset
            o = torch.argmax(sl, dim=1)
            hit = sl.gather(1, o[:, None])[:, 0] > 0.0
            offs.append(torch.where(hit, o, off0))
            oh = iota[None, :] == o[:, None]
            comp |= oh & hit[:, None]
            sl = torch.where(oh, -1.0, sl)
        prim = ~not_prim & real[:, None]
        comp &= real[:, None]
        cf = content.to(torch.float32)[:, None]
        up = torch.where(prim, 0.0, torch.where(comp, sc, up))
        dw = torch.where(prim, 0.0, dw)
        by = torch.where(prim | comp, cf, by)
        rec = torch.stack(
            [torch.where(real, pages, 0) + 32,
             torch.where(real, content, pad_content),
             *(torch.where(real, x, 0) for x in [off0] + offs)], dim=1)
        out[jj] = rec.to(torch.uint8)
    rows[:, 0] = up
    rows[:, 1] = dw
    rows[:, 2] = by


def sub_op_chain(rows, sc_rows, table, nonce, pages, nvalid: int,
                 pad_content: int, out) -> None:
    """Run the j sub-ops of one step on the k selected pages (see the
    module docstring for layouts).  j is out.shape[0]."""
    if rows.device.type == "cpu":
        sub_op_chain_plain(rows, sc_rows, table, nonce, pages, nvalid,
                           pad_content, out)
        return
    if rows.device.type != "cuda":
        raise ValueError("no kernel for device %s" % rows.device)
    k = rows.shape[0]
    j = out.shape[0]
    C = table.shape[1]
    want = [(rows, torch.float32, (k, 4, 256)),
            (sc_rows, torch.int32, (k, 256)),
            (table, torch.int16, None),
            (pages, torch.int64, (k,)),
            (out, torch.uint8, (j, k, 6))]
    if nonce is not None:
        want.append((nonce, torch.float32, (j, k, 256)))
    for t, dtype, shape in want:
        if t.device != rows.device or t.dtype != dtype \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(
                "kernel B argument: want %s %s contiguous on %s, got %s %s"
                % (dtype, shape, rows.device, t.dtype, tuple(t.shape)))
    _build.launch(
        "iiv_subop_chain", ctypes.c_void_p(rows.data_ptr()),
        ctypes.c_void_p(sc_rows.data_ptr()),
        ctypes.c_void_p(table.data_ptr()), C,
        ctypes.c_void_p(nonce.data_ptr() if nonce is not None else None),
        ctypes.c_void_p(pages.data_ptr()), k, j, int(nvalid),
        int(pad_content), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(_build.stream_ptr(rows.device)))
    sub_op_chain.launches += 1


sub_op_chain.launches = 0
