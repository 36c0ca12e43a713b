"""The chunk start as the body kernel's prologue (csrc/body.cu), on the CPU:

- `body.encode_body(..., sub=...)` equals `chunk_start_plain` followed by
  `body.encode_body(..., sub=None)`, bit for bit (up, dw, banks, records),
  for DHGR banks 0 and 1 and HGR under the window, mono and yiq models,
  both content rules, seeded and deterministic;
- the same entry against the JAX package's recompute (`dist_lane_pairs` on
  the bank's two lanes, interleaved, zero at the holes, the priority
  update) followed by the port's plain body;
- an executable spec of the prologue's indexing: a torch emulation of the
  threads of CTA q of each movie's cluster - the cells a thread owns
  (kPerLane of them, e = i * 32 P + t), both banks' page rows staged as
  bytes, each masked lane read from the neighbour bytes of its page row
  (zero past the page edges), the colour codes derived when a DP step
  needs them (each from the one before, `lane_code_next`, held equal to
  the `lane_code` rule), kChains chains side by side - held bit-equal to
  `chunk_start_plain` at every cluster size;
- the wrapper refusing a cost basis of the wrong shape, dtype or device
  before anything runs.
"""

import numpy as np
import pytest
import torch

from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import _build, encoder, screen
from iivision_tpu_torch.ops import body, chunk_start, distance, yiq
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

DHGR, HGR = VideoMode.DHGR, VideoMode.HGR
PER_LANE = 8  # cells a thread owns: kPerLane in csrc/warp_argmax.cuh
CHAINS = 4  # DP chains a thread runs side by side: kChains in csrc/body.cu


def basis(mode, model):
    """The recompute's int32 cost basis (ComputedDistance.sub's form)."""
    return torch.as_tensor(distance.sub_for(mode, Palette.NTSC, model)
                           .astype(np.int32))


def body_case(mode, k, j, B, seed):
    """A one-second plan (30 frames at 30 fps, every 2nd encoded) and B
    movies' seeded random targets and state, the window store-cost table.
    Returns (plan, state [up, dw, banks], lanes, bytes_tgt, table,
    nvalid)."""
    rng = np.random.RandomState(seed)
    plan, n_enc = encoder.plan_movie(
        n_frames=30, n_audio_ticks=14700, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=mode, k=k,
        j=j)
    nb = chunk_start.n_banks(mode)
    hi = 128 if nb == 2 else 256
    tgt = rng.randint(0, hi, (B, n_enc, 2, 32, 256))
    if nb == 1:
        tgt[:, :, 1] = tgt[:, :, 0]
    bytes_tgt = torch.as_tensor(tgt, dtype=torch.int32)
    lanes = chunk_start.masked_lanes(bytes_tgt[:, :, :nb], mode).contiguous()
    state = [torch.as_tensor(x, dtype=torch.int32) for x in (
        rng.randint(0, 3000, (B, nb, 32, 256))
        * rng.randint(0, 2, (B, nb, 32, 256)),
        rng.randint(0, 900, (B, nb, 32, 256)),
        rng.randint(0, 256, (B, nb, 32, 256)))]
    dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    table = dist.store_cost16.reshape(-1, dist.n_contents)
    nvalid = torch.tensor(plan.step_nvalid, dtype=torch.int32)
    return plan, state, lanes, bytes_tgt, table, nvalid


def recompute_body(plan, bank: int):
    """First step of the first recomputing body on `bank`."""
    Sc = plan.chunk_steps
    return next(b0 for b0 in range(0, len(plan.step_frame), Sc)
                if plan.step_recompute[b0] and plan.step_bank[b0] == bank)


CASES = [(DHGR, 0, "window"), (DHGR, 1, "window"), (DHGR, 0, "mono"),
         (DHGR, 1, "yiq"), (HGR, 0, "window"), (HGR, 0, "mono"),
         (HGR, 0, "yiq")]


@pytest.mark.parametrize("joint,seeded", [(False, True), (True, False)])
@pytest.mark.parametrize("mode,bank,model", CASES)
def test_fused_entry_equals_chunk_start_then_body(mode, bank, model, joint,
                                                  seeded):
    """encode_body with the cost basis writes what chunk_start_plain then
    encode_body without it write: up, dw, banks and the records, bit for
    bit, B = 2 movies on a recomputing body of a one-second plan."""
    B, k, j = 2, 4, 2
    plan, state, lanes, bytes_tgt, table, nvalid = body_case(
        mode, k, j, B, 3 + bank + 5 * joint)
    b0 = recompute_body(plan, bank)
    frame = int(plan.step_frame[b0])
    keys = trandom.key_words([5, 6], "cpu") if seeded else None
    sub = basis(mode, model)
    S, Sc = len(plan.step_frame), plan.chunk_steps
    got = [x.clone() for x in state] + [
        torch.full((S, B, j, k, 6), 7, dtype=torch.uint8)]
    want = [x.clone() for x in got]
    args = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0, Sc)
    body.encode_body(*got[:3], *args, got[3], mode, joint, sub=sub)
    chunk_start.chunk_start_plain(want[2], lanes, frame, bank, sub,
                                  want[0], want[1], mode)
    body.encode_body(*want[:3], *args, want[3], mode, joint)
    for g, w, what in zip(got, want, ("up", "dw", "banks", "ops")):
        assert torch.equal(g, w), what
    assert (got[3][b0:b0 + Sc] != 7).any()
    assert not torch.equal(got[1][:, bank], state[1][:, bank])


@pytest.mark.parametrize("mode,bank,model", [
    (DHGR, 0, "window"), (DHGR, 1, "yiq"), (HGR, 0, "mono"),
    (HGR, 0, "yiq")])
def test_fused_entry_equals_jax_recompute_then_body(mode, bank, model):
    """The reference's recompute, from the JAX package's screen and
    distance modules (masked lanes of both banks, dist_lane_pairs on the
    bank's two lanes, interleave_bank_lanes, zero at the holes, then
    up = where(d == 0, 0, up) + d and dw = d), followed by the port's plain
    body, against encode_body with the cost basis: exact, seeded, B = 2."""
    B, k, j = 2, 4, 2
    plan, state, lanes, bytes_tgt, table, nvalid = body_case(
        mode, k, j, B, 21 + bank)
    b0 = recompute_body(plan, bank)
    frame = int(plan.step_frame[b0])
    keys = trandom.key_words([8, 9], "cpu")
    jmode = JVideoMode[mode.name]
    b_np = state[2].numpy()
    cur = (jscreen.dhgr_masked_lanes(b_np[:, 0], b_np[:, 1])
           if mode == DHGR else jscreen.hgr_masked_lanes(b_np[:, 0]))
    tl = lanes[:, frame].numpy()
    sub_np = jdist.sub_for(jmode, JPalette.NTSC, model)
    le, lo = jscreen.spec_for_mode(jmode).bank_lanes(bank == 1)
    d2 = [np.asarray(jdist.dist_lane_pairs(cur[..., l], tl[..., l], jmode, l,
                                           sub_np)) for l in (le, lo)]
    d = jscreen.interleave_bank_lanes(d2[0], d2[1]).astype(np.int64)
    d = (d * ~jscreen.SCREEN_HOLES).astype(np.int32)
    assert d.max() > 0 and (d == 0).any()
    S, Sc = len(plan.step_frame), plan.chunk_steps
    want = [x.clone() for x in state] + [
        torch.full((S, B, j, k, 6), 7, dtype=torch.uint8)]
    got = [x.clone() for x in want]
    dt = torch.as_tensor(d)
    want[0][:, bank] = torch.where(dt == 0, 0, want[0][:, bank]) + dt
    want[1][:, bank] = dt
    args = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0, Sc)
    body.encode_body_plain(*want[:3], *args, want[3], mode)
    body.encode_body(*got[:3], *args, got[3], mode,
                     sub=basis(mode, model))
    for g, w, what in zip(got, want, ("up", "dw", "banks", "ops")):
        assert torch.equal(g, w), what


def lane_code(dots, i: int, phase):
    """The colour code at dot i (lane_codes.cuh `lane_code`): the 4-dot
    window rotated left by (phase + i) mod 4."""
    w = (dots >> i) & 0xF
    r = (phase + i) & 3
    return ((w << r) | (w >> (4 - r))) & 0xF


def lane_code_next(code, x, k: int, phase):
    """The code at dot k from the one at k - 1 (lane_codes.cuh
    `lane_code_next`), x = (dots ^ (dots >> 4)) << phase: the bit of dot
    k - 1 replaced by dot k + 3's, at the same position."""
    n = k - 1 + phase
    return code ^ ((x >> (n & ~3)) & (1 << (n & 3)))


def lane_at(rows, e, ln, mode):
    """Masked lane ln of each thread's cell e, from the CTA's staged rows
    (2, P * 256) uint8 (main, then aux): the bytes of columns 2c-1 ..
    2c+2 of the cell's page row, zero past the page's edges (body.cu
    `dhgr_lane_at` / `hgr_lane_at`)."""
    page0 = e & ~255
    c = (e & 255) >> 1
    c2 = 2 * c

    def byte(bank, col, valid=None):
        v = rows[bank, page0 + col.clamp(0, 255)].to(torch.int32)
        return v if valid is None else torch.where(valid, v, 0)

    if mode == DHGR:
        a0, m0 = byte(1, c2) & 0x7F, byte(0, c2) & 0x7F
        a1, m1 = byte(1, c2 + 1) & 0x7F, byte(0, c2 + 1) & 0x7F
        hdr = (byte(0, c2 - 1, c > 0) & 0x7F) >> 4
        ftr = byte(1, c2 + 2, c < 127) & 0b111
        lanes = [hdr | (a0 << 3) | ((m0 & 0b111) << 10),
                 (a0 >> 4) | (m0 << 3) | ((a1 & 0b111) << 10),
                 (m0 >> 4) | (a1 << 3) | ((m1 & 0b111) << 10),
                 (a1 >> 4) | (m1 << 3) | (ftr << 10)]
    else:
        even, odd = byte(0, c2), byte(0, c2 + 1)
        prev_odd = byte(0, c2 - 1, c > 0)
        next_even = byte(0, c2 + 2, c < 127)
        hdr = ((prev_odd >> 5) & 0b011) | ((prev_odd >> 5) & 0b100)
        ftr = ((next_even >> 7) & 1) | ((next_even & 0b11) << 1)
        packed = (hdr | (even << 3) | ((odd & 0x80) << 4)
                  | ((odd & 0x7F) << 12) | (ftr << 19))
        lanes = [packed & 0x3FFF, (packed >> 8) & 0x3FFF]
    out = torch.zeros_like(e, dtype=torch.int32)
    for l, v in enumerate(lanes):
        out = torch.where(ln == l, v, out)
    return out


def prologue_cta(banks, lanes_tgt, up, frame, bank, sub, mode, movie, q, c):
    """CTA q of `movie`'s cluster of c CTAs running the recompute: returns
    the (P * 256,) int32 up and dw it puts into its shared memory, cell e
    holding page q * P + (e >> 8), offset e & 255."""
    P = 32 // c
    T = P * 32  # threads of the CTA
    t = torch.arange(T)
    nb = chunk_start.n_banks(mode)
    dhgr = mode == DHGR
    le, lo = chunk_start.bank_lanes(mode, bank)
    # the staged page rows of both banks, as bytes
    rows = torch.zeros((2, P * 256), dtype=torch.uint8)
    for b in range(nb):
        rows[b] = banks[movie, b, q * P:(q + 1) * P].reshape(-1).to(
            torch.uint8)
    up_s = torch.zeros(P * 256, dtype=torch.int32)
    dw_s = torch.zeros(P * 256, dtype=torch.int32)
    for i0 in range(0, PER_LANE, CHAINS):
        # kChains cells of every thread, side by side
        e = torch.stack([(i0 + x) * T + t for x in range(CHAINS)])
        g = q * P * 256 + e  # the cell in the bank
        o = g & 255
        ln = torch.where((o & 1) == 1, lo, le)
        tgt = lanes_tgt[movie, frame, g >> 8, o >> 1, ln]
        cur = lane_at(rows, e, ln, mode)
        if dhgr:
            da, db = cur, tgt
            phase = torch.tensor([1, 0, 3, 2], dtype=torch.int32)[ln]
        else:
            da = torch.where(ln == 0, screen.hgr_to_dots(cur, 0),
                             screen.hgr_to_dots(cur, 1))
            db = torch.where(ln == 0, screen.hgr_to_dots(tgt, 0),
                             screen.hgr_to_dots(tgt, 1))
            phase = torch.tensor([1, 3], dtype=torch.int32)[ln]
        if sub.dim() == 4:
            L = yiq.n_pixels(mode)
            d = torch.zeros_like(da)
            for w in range(L):
                d = d + sub[ln, w, (da >> w) & 0x7F, (db >> w) & 0x7F]
        else:
            L = int(screen.spec_for_mode(mode).MASKED_DOTS)
            flat = sub.reshape(-1)
            ap, bp = lane_code(da, 0, phase), lane_code(db, 0, phase)
            xa, xb = (da ^ (da >> 4)) << phase, (db ^ (db >> 4)) << phase
            d_m2, d = torch.zeros_like(da), flat[ap * 16 + bp]
            for k in range(1, L):
                ak = lane_code_next(ap, xa, k, phase)
                bk = lane_code_next(bp, xb, k, phase)
                assert torch.equal(ak, lane_code(da, k, phase))
                assert torch.equal(bk, lane_code(db, k, phase))
                dk = d + flat[ak * 16 + bk]
                swap = (ak == bp) & (ap == bk)
                dk = torch.where(swap, torch.minimum(dk, d_m2 + 1), dk)
                d_m2, d, ap, bp = d, dk, ak, bk
        d = torch.where((e & 127) >= 120, 0, d)  # a screen hole
        up0 = up[movie, bank, g >> 8, o]
        up_s[e] = torch.where(d == 0, 0, up0) + d
        dw_s[e] = d
    return up_s, dw_s


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("mode,bank,model", [
    (DHGR, 0, "window"), (DHGR, 1, "yiq"), (HGR, 0, "mono"),
    (HGR, 0, "yiq")])
def test_prologue_indexing_equals_chunk_start_plain(mode, bank, model,
                                                    cluster):
    """The emulated CTAs of every movie's cluster put chunk_start_plain's
    up and dw into shared memory, bit for bit, B = 2 movies on random
    8-bit bank bytes."""
    B, F, frame = 2, 3, 1
    rng = np.random.RandomState(40 + cluster + bank)
    nb = chunk_start.n_banks(mode)
    banks = torch.as_tensor(rng.randint(0, 256, (B, nb, 32, 256)),
                            dtype=torch.int32)
    tgt = torch.as_tensor(rng.randint(0, 256, (B * F, nb, 32, 256)),
                          dtype=torch.int32)
    lanes = chunk_start.masked_lanes(tgt, mode).reshape(
        (B, F, 32, 128, -1)).contiguous()
    up0 = torch.as_tensor(rng.randint(0, 5000, (B, nb, 32, 256)),
                          dtype=torch.int32)
    sub = basis(mode, model)
    up, dw = up0.clone(), torch.zeros_like(up0)
    chunk_start.chunk_start_plain(banks, lanes, frame, bank, sub, up, dw,
                                  mode)
    assert (dw[:, bank] > 0).any() and (dw[:, bank] == 0).any()
    P = 32 // cluster
    for movie in range(B):
        for q in range(cluster):
            up_s, dw_s = prologue_cta(banks, lanes, up0, frame, bank, sub,
                                      mode, movie, q, cluster)
            pages = slice(q * P, (q + 1) * P)
            assert torch.equal(up_s, up[movie, bank, pages].reshape(-1))
            assert torch.equal(dw_s, dw[movie, bank, pages].reshape(-1))


def wrong_basis(what: str) -> torch.Tensor:
    """A DHGR window basis spoiled one way."""
    ok = basis(DHGR, "window")
    if what == "HGR's yiq costs":
        return basis(HGR, "yiq")
    return {"shape": lambda: ok[:, :15].contiguous(),
            "int64": lambda: ok.to(torch.int64),
            "float32": lambda: ok.to(torch.float32),
            "not contiguous": ok.t,
            "device": lambda: ok.to("meta")}[what]()


@pytest.mark.parametrize("what", ["shape", "int64", "float32",
                                  "not contiguous", "HGR's yiq costs",
                                  "device"])
def test_encode_body_refuses_a_wrong_cost_basis(what, monkeypatch):
    """A cost basis that is not contiguous int32 (16, 16), or the mode's
    (n_lanes, L, 128, 128) yiq costs, on the state's device raises
    ValueError before anything runs: neither the plain body nor a launch
    is reached."""
    def never(*args, **kw):
        raise AssertionError("ran before the cost basis was checked")

    monkeypatch.setattr(body, "encode_body_plain", never)
    monkeypatch.setattr(_build, "launch", never)
    st = torch.zeros((1, 2, 32, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="cost basis"):
        body.encode_body(st, st, st, None, None, 0, 0, None, None, None, 0,
                         1, torch.zeros((1, 1, 1, 1, 6), dtype=torch.uint8),
                         DHGR, sub=wrong_basis(what))
