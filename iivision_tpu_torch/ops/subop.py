"""The encoder's sequential sub-op chain (counterpart of
iivision_tpu/encoder.py `sub_op`, under `vmap` for a batch), in plain
torch: what `body.encode_body_plain` runs on each step's selected pages,
and what the body kernel (csrc/body.cu `run_slot`) is held to.

After a scan step's page top-k, each of the k selected pages of each of B
movies runs j sequential op selections on its extracted rows; each sees
the earlier sub-ops' updates.  The movies share one plan.  Layouts:

- rows: (B, k, 4, 256) float32, the pages' [up, dw, by, tb] rows: update
  priority, live diff weight, modelled screen byte, target byte;
- sc_rows: (B, k, 256) int32, per offset the row of the int16 store-cost
  table (lane * R + target lane value) on the bank's even/odd lanes;
- table: (n_lanes * R, C) int16 store costs, shared by the movies;
- nonce: (B, j, k, 256) float32 offset tie-break nonces, or None for the
  deterministic encoder (zeros);
- pages: (B, k) int64 page indices; nvalid: real ops in this step (shared);
  pad_content: (B,) int32, each movie's padding-op content byte;
- out: (B, j, k, 6) uint8 records [page + 32, content, o0, o1, o2, o3],
  sub-op-major within a movie.

The default rule stores the target byte at the primary offset; the joint
rule (`--joint_content`, encoder.py:583-610 and :663-676) scores every
content code of the page and keeps the primary's residual.  The solo
encoder is the B = 1 call.  `sub_op_chain_plain` updates `rows` in place
and writes `out`.
"""

import torch


def joint_content_plain(up, dw, base, flat, C: int, off0, not_prim):
    """(B, k) int64 joint content of each page: argmax over c of the gain
    at the primary offset plus the three best positive companion gains
    (every term an integer below 2^18, so the sums are exact in float32)."""
    cost = flat[base[..., None] + torch.arange(C, device=up.device)]
    score_all = dw[..., None] - cost.to(torch.float32)  # (B, k, 256, C)
    idx = off0[..., None, None].expand(-1, -1, 1, C)
    prim = score_all.gather(2, idx)[:, :, 0]
    elig = ((up > 0.0) & not_prim)[..., None]
    slj = torch.where(elig & (score_all > 0.0), score_all, 0.0)
    comp = slj.topk(3, dim=2).values.sum(dim=2)
    return torch.argmax(prim + comp, dim=-1)  # first maximal index


def sub_op_chain_plain(rows, sc_rows, table, nonce, pages, nvalid: int,
                       pad_content, out, joint: bool = False) -> None:
    """Plain torch form of the chain, vectorised over the B x k pages; the
    same float32 expressions as the JAX scan, evaluated one op at a time
    (so no product is fused into its sum)."""
    k = rows.shape[1]
    j = out.shape[1]
    C = table.shape[1]
    dev = rows.device
    iota = torch.arange(256, device=dev)
    slot = torch.arange(k, device=dev)
    flat = table.view(-1)
    base = sc_rows.to(torch.int64) * C
    up, dw, by, tb = (rows[:, :, i].clone() for i in range(4))
    for jj in range(j):
        has_work = up.amax(dim=-1) > 0.0
        real = has_work & (jj * k + slot < nvalid)
        off_score = up * 256.0
        if nonce is not None:
            off_score = off_score + nonce[:, jj] * 255.0
        off0 = torch.argmax(off_score, dim=-1)  # first maximal index
        not_prim = iota != off0[..., None]
        if joint:
            content = joint_content_plain(up, dw, base, flat, C, off0,
                                          not_prim)
        else:
            content = tb.gather(-1, off0[..., None])[..., 0].to(torch.int64)
        sc = flat[base + (content & (C - 1))[..., None]].to(torch.float32)
        score = dw - sc
        sl = torch.where((up > 0.0) & (score > 0.0) & not_prim, score, -1.0)
        offs = []
        comp = torch.zeros_like(up, dtype=torch.bool)
        for _ in range(3):  # best three, ties to the lowest offset
            o = torch.argmax(sl, dim=-1)
            hit = sl.gather(-1, o[..., None])[..., 0] > 0.0
            offs.append(torch.where(hit, o, off0))
            oh = iota == o[..., None]
            comp |= oh & hit[..., None]
            sl = torch.where(oh, -1.0, sl)
        prim = ~not_prim & real[..., None]
        comp &= real[..., None]
        cf = content.to(torch.float32)[..., None]
        # the joint rule keeps the primary's residual: up = dw = cost
        prim_val = sc if joint else 0.0
        up = torch.where(prim, prim_val, torch.where(comp, sc, up))
        dw = torch.where(prim, prim_val, dw)
        by = torch.where(prim | comp, cf, by)
        rec = torch.stack(
            [torch.where(real, pages, 0) + 32,
             torch.where(real, content, pad_content.to(torch.int64)[:, None]),
             *(torch.where(real, x, 0) for x in [off0] + offs)], dim=-1)
        out[:, jj] = rec.to(torch.uint8)
    rows[:, :, 0] = up
    rows[:, :, 1] = dw
    rows[:, :, 2] = by
