"""The body kernel's thread-block-cluster design (csrc/body.cu), on the CPU:

- the chooser `body.cluster_size`: a legal cluster size that holds B
  movies in one wave of the card's active clusters;
- `body.encode_body` refuses an illegal cluster size before any launch;
- an executable spec of the kernel's indexing: a torch emulation that
  splits a movie's 32 pages over c CTAs (CTA q owns pages q * P .. q * P +
  P - 1, P = 32 / c, warp w page q * P + w), lets every warp write its
  page score into every CTA's copy, ranks each page from its own CTA's
  copy, and runs each selected page as slot r = rank, the slot giving the
  nonce counter (r * 256 + t), the nvalid gate (jj * k + r < nvalid) and
  the record index.  It is held bit-equal to `encode_body_plain` for
  every cluster size on bodies of one-second plans (padded and partial
  steps), B = 2.
"""

import numpy as np
import pytest
import torch

from iivision_tpu_torch import _build, encoder
from iivision_tpu_torch.ops import body, chunk_start, distance, subop
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode

DHGR = VideoMode.DHGR


@pytest.mark.parametrize("counts", [
    {1: 132, 2: 66, 4: 32, 8: 16, 16: 7},
    {1: 132, 2: 66, 4: 33, 8: 15, 16: 0},
    {1: 16, 2: 8, 4: 4, 8: 2, 16: 1},
    {1: 0, 2: 0, 4: 0, 8: 0, 16: 0}])
def test_cluster_size_fits_the_batch_in_one_wave(counts):
    """Every choice is one of the kernel's sizes (a power of two that
    divides 32, at most 16), and where some size holds all B movies at
    once, the choice does too."""
    for B in list(range(1, 40)) + [64, 65, 66, 67, 132, 133, 500]:
        for k, j in ((1, 1), (8, 1), (16, 4), (32, 10)):
            for joint in (False, True):
                c = body.cluster_size(B, k, j, joint, counts)
                assert c in (1, 2, 4, 8, 16) and 32 % c == 0
                if any(n >= B for n in counts.values()):
                    assert counts[c] >= B, (B, k, j, joint, c)


def test_cluster_size_spreads_a_solo_movie():
    """A movie alone at the solo headline's setting takes the largest
    cluster the card holds; a batch of 32 one that fits 32 clusters."""
    counts = {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}
    assert body.cluster_size(1, 32, 10, False, counts) == 16
    assert body.cluster_size(1, 32, 10, True, counts) == 16
    assert body.cluster_size(32, 16, 4, False, counts) == 4


@pytest.mark.parametrize("cluster", [3, 0, 32, -4, 1.5])
def test_encode_body_refuses_other_cluster_sizes(cluster, monkeypatch):
    """A size the kernel has no instantiation for raises ValueError before
    anything runs: neither the plain body nor a launch is reached."""
    def never(*args, **kw):
        raise AssertionError("ran before the cluster size was checked")

    monkeypatch.setattr(body, "encode_body_plain", never)
    monkeypatch.setattr(_build, "launch", never)
    st = torch.zeros((1, 2, 32, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="clusters"):
        body.encode_body(st, st, st, None, None, 0, 0, None, None, None, 0,
                         1, torch.zeros((1, 1, 1, 1, 6), dtype=torch.uint8),
                         DHGR, cluster=cluster)


def run_slot(cta, w, page, r, s, b, nv, okeys, k, flat, C, joint, pad, ops):
    """Slot r's sub-ops on warp w's page of one CTA (`cta`: the CTA's
    shared state, float32 rows of its pages).  okeys[jj]: sub-op jj's
    offset key, or None (deterministic)."""
    iota = torch.arange(256)
    up, dw, by = cta["up"][w], cta["dw"][w], cta["by"][w]
    tb, row = cta["tb"][w], cta["row"][w]
    for jj in range(ops.shape[2]):
        real = bool(up.max() > 0.0) and jj * k + r < nv
        off_score = up * 256.0
        if okeys is not None:
            # counters r * 256 + t of the sub-op's key
            nz = trandom.uniform(okeys[jj], (k * 256,))[r * 256:(r + 1) * 256]
            off_score = off_score + nz * 255.0
        off0 = int(torch.argmax(off_score))
        not_prim = iota != off0
        if joint:
            content = int(subop.joint_content_plain(
                up[None, None], dw[None, None], (row * C)[None, None], flat,
                C, torch.tensor([[off0]]), not_prim[None, None]))
        else:
            content = int(tb[off0])
        sc = flat[row * C + (content & (C - 1))].to(torch.float32)
        score = dw - sc
        sl = torch.where((up > 0.0) & (score > 0.0) & not_prim, score, -1.0)
        offs, comp = [], torch.zeros(256, dtype=torch.bool)
        for _ in range(3):
            o = int(torch.argmax(sl))
            hit = bool(sl[o] > 0.0)
            offs.append(o if hit else off0)
            comp[o] |= hit
            sl[o] = -1.0
        if real:
            up.copy_(torch.where(comp, sc, up))
            by.copy_(torch.where(comp, float(content), by))
            keep = float(sc[off0]) if joint else 0.0
            up[off0], dw[off0], by[off0] = keep, keep, float(content)
            rec = [page + 32, content, off0] + offs
        else:
            rec = [32, pad, 0, 0, 0, 0]
        ops[s, b, jj, r] = torch.tensor(rec, dtype=torch.uint8)


def encode_body_cluster(up, dw, banks, lanes_tgt_b, bytes_tgt_b, frame,
                        bank, table, keys, nvalid, s0, Sc, ops, mode, joint,
                        c):
    """The body as the cluster kernel indexes it, c CTAs per movie."""
    B = up.shape[0]
    k = ops.shape[3]
    C = table.shape[1]
    flat = table.view(-1)
    n_values = table.shape[0] // spec_for_mode(mode).N_LANES
    rows = body.sc_row_index(lanes_tgt_b[:, frame], bank, n_values,
                             mode).to(torch.int64)
    P = 32 // c
    for b in range(B):
        pad = int(bytes_tgt_b[b, frame, bank, 0, 0])
        key = None if keys is None else tuple(
            int(x) & trandom.MASK32 for x in keys[b])
        ctas = [dict(
            up=up[b, bank, q * P:(q + 1) * P].to(torch.float32),
            dw=dw[b, bank, q * P:(q + 1) * P].to(torch.float32),
            by=banks[b, bank, q * P:(q + 1) * P].to(torch.float32),
            tb=bytes_tgt_b[b, frame, bank, q * P:(q + 1) * P].clone(),
            row=rows[b, q * P:(q + 1) * P]) for q in range(c)]
        for s in range(s0, s0 + Sc):
            nv = int(nvalid[s])
            if nv == 0:
                continue
            okeys = nonce_p = None
            if key is not None:
                skey = trandom.fold_in(tuple(torch.tensor(x) for x in key),
                                       torch.tensor(s))
                nonce_p = trandom.uniform(trandom.fold_in(skey, 0), (32,))
                okeys = [trandom.fold_in(skey, 1 + jj)
                         for jj in range(ops.shape[2])]
            # warp w of CTA q: page q * P + w's score into every CTA's copy
            copies = torch.empty((c, 32))
            for q in range(c):
                for w in range(P):
                    page = q * P + w
                    sc = ctas[q]["up"][w].max() * 256.0
                    if nonce_p is not None:
                        sc = sc + nonce_p[page] * 255.0
                    copies[:, page] = sc
            # each warp ranks its own page from its CTA's copy
            for q in range(c):
                for w in range(P):
                    page = q * P + w
                    sq, sp = copies[q], copies[q, page]
                    r = int(((sq > sp) | ((sq == sp)
                                          & (torch.arange(32) < page))).sum())
                    if r < k:
                        run_slot(ctas[q], w, page, r, s, b, nv, okeys, k,
                                 flat, C, joint, pad, ops)
        for q, cta in enumerate(ctas):
            pages = slice(q * P, (q + 1) * P)
            up[b, bank, pages] = cta["up"].to(torch.int32)
            dw[b, bank, pages] = cta["dw"].to(torch.int32)
            banks[b, bank, pages] = cta["by"].to(torch.int32)


def body_case(mode, k, j, B, seed):
    """Bodies of a one-second plan (30 fps, every 2nd frame) with random
    targets and state: the first body and the first that holds a padded
    step, else a partial one."""
    rng = np.random.RandomState(seed)
    plan, n_enc = encoder.plan_movie(
        n_frames=30, n_audio_ticks=14700, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=mode, k=k,
        j=j)
    Sc, nv = plan.chunk_steps, np.asarray(plan.step_nvalid)
    starts = range(0, len(nv), Sc)
    odd = [b0 for b0 in starts if (nv[b0:b0 + Sc] == 0).any()] or \
        [b0 for b0 in starts if (nv[b0:b0 + Sc] < k * j).any()]
    nb = chunk_start.n_banks(mode)
    hi = 128 if nb == 2 else 256
    tgt = rng.randint(0, hi, (B, n_enc, 2, 32, 256))
    bytes_tgt = torch.as_tensor(tgt, dtype=torch.int32)
    lanes = chunk_start.masked_lanes(bytes_tgt[:, :, :nb], mode).contiguous()
    state = [torch.as_tensor(x, dtype=torch.int32) for x in (
        rng.randint(0, 3000, (B, nb, 32, 256))
        * rng.randint(0, 2, (B, nb, 32, 256)),
        rng.randint(0, 900, (B, nb, 32, 256)),
        rng.randint(0, hi, (B, nb, 32, 256)))]
    dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    table = dist.store_cost16.reshape(-1, dist.n_contents)
    nvalid = torch.tensor(nv, dtype=torch.int32)
    return plan, [0, odd[0]], state, lanes, bytes_tgt, table, nvalid


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("mode,k,j,seeded,joint", [
    (DHGR, 16, 4, True, False), (DHGR, 8, 1, False, False),
    (DHGR, 16, 4, True, True)])
def test_cluster_indexing_equals_the_plain_body(mode, k, j, seeded, joint,
                                                cluster):
    """The emulation of c CTAs per movie writes the plain body's state and
    records, bit for bit, on two bodies of a one-second plan (one with a
    padded or partial step), B = 2."""
    B = 2
    plan, bodies, state, lanes, bytes_tgt, table, nvalid = body_case(
        mode, k, j, B, 7 + k + 3 * joint)
    keys = trandom.key_words([11, 12], "cpu") if seeded else None
    S = len(plan.step_frame)
    got = [x.clone() for x in state] + [
        torch.full((S, B, j, k, 6), 7, dtype=torch.uint8)]
    want = [x.clone() for x in got]
    for b0 in bodies:
        frame, bank = int(plan.step_frame[b0]), int(plan.step_bank[b0])
        args = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0,
                plan.chunk_steps)
        encode_body_cluster(*got[:3], *args, got[3], mode, joint, cluster)
        body.encode_body_plain(*want[:3], *args, want[3], mode, joint)
    for g, w, what in zip(got, want, ("up", "dw", "banks", "ops")):
        assert torch.equal(g, w), what
    assert (got[3] != 7).any() and not torch.equal(got[0], state[0])
