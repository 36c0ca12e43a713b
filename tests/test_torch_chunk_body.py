"""The encoder's chunk-start and body pieces in iivision_tpu_torch on the
CPU: the per-offset lane indexing the body kernel's recompute prologue
uses, against the vectorised masked lanes; the plain chunk start and the
body entry that runs it (window, mono and yiq models) against a diff
built from the JAX package's screen and distance modules; the yiq
recompute's per-offset window indexing against the plain chunk start; the
body kernel's nonce indexing against jax.random; the key words; foreign
enums refused by each public entry point; the body wrappers refusing
devices without a kernel; and encoder.py calling only the kernel
wrappers, a chunk start as the body's `sub`.  Everything is exact
(integer or bit-equal)."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import encoder, quality, screen
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.ops import body, chunk_start, distance, yiq
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.video_mode import VideoMode

MODES = [VideoMode.DHGR, VideoMode.HGR]


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def random_banks(B, mode, seed):
    """(B, n_banks, 32, 256) int32 screen bytes, 8-bit (the masked-lane
    derivation must handle the DHGR palette bit it masks off)."""
    rng = np.random.RandomState(seed)
    nb = 2 if mode == VideoMode.DHGR else 1
    return torch.as_tensor(rng.randint(0, 256, (B, nb, 32, 256)),
                           dtype=torch.int32)


@pytest.mark.parametrize("mode", MODES)
def test_masked_lane_at_matches_vectorised_lanes(mode):
    """screen.masked_lane_at (lane at column c from bytes 2c-1 .. 2c+2, as
    the kernel derives one offset's lane) equals the vectorised
    dhgr/hgr_masked_lanes at every column, page edges included, and the
    kernel's hole test equals SCREEN_HOLES."""
    banks = random_banks(3, mode, 1)
    main = banks[:, 0]
    aux = banks[:, 1] if mode == VideoMode.DHGR else None
    want = chunk_start.masked_lanes(banks, mode)
    col = torch.arange(128)
    for lane in range(screen.spec_for_mode(mode).N_LANES):
        got = screen.masked_lane_at(main, aux, mode, lane, col)
        assert got.dtype == torch.int32
        assert torch.equal(got, want[..., lane]), lane
    offsets = np.arange(256)[None, :].repeat(32, 0)
    assert np.array_equal((offsets & 127) >= 120, screen.SCREEN_HOLES)


@pytest.mark.parametrize("mode,bank,model", [
    (VideoMode.DHGR, 0, "window"), (VideoMode.DHGR, 1, "window"),
    (VideoMode.DHGR, 1, "mono"), (VideoMode.HGR, 0, "window"),
    (VideoMode.HGR, 0, "mono"), (VideoMode.DHGR, 0, "yiq"),
    (VideoMode.DHGR, 1, "yiq"), (VideoMode.HGR, 0, "yiq")])
def test_chunk_start_plain_matches_jax_diff(mode, bank, model):
    """B = 2 movies: random modelled banks, targets and priorities.  The
    reference is the JAX encoder's do_recompute written from
    iivision_tpu.screen and iivision_tpu.ops.distance (numpy): the masked
    lanes of the banks, dist_lane_pairs on the bank's two lanes,
    interleaved, zero at the holes; up = where(d == 0, 0, up) + d, dw = d.
    Both chunk_start_plain and the body entry that runs it (encode_body
    with `sub`, on a body of one padded step, which changes nothing
    after the recompute) write it; the entry takes the plain form on the
    CPU."""
    B, F, frame = 2, 3, 1
    banks = random_banks(B, mode, 2)
    tgt = random_banks(B * F, mode, 3).reshape((B, F) + banks.shape[1:])
    lanes_tgt = chunk_start.masked_lanes(tgt, mode).contiguous()
    rng = np.random.RandomState(4)
    up0 = torch.as_tensor(rng.randint(0, 5000, banks.shape),
                          dtype=torch.int32)
    dw0 = torch.as_tensor(rng.randint(0, 900, banks.shape),
                          dtype=torch.int32)
    dist = distance.ComputedDistance(mode, Palette.NTSC, model, device="cpu")
    sub_np = jdist.sub_for(jm(mode), JPalette.NTSC, model)

    b_np = banks.numpy()
    if mode == VideoMode.DHGR:
        cur = jscreen.dhgr_masked_lanes(b_np[:, 0], b_np[:, 1])
    else:
        cur = jscreen.hgr_masked_lanes(b_np[:, 0])
    tl = lanes_tgt[:, frame].numpy()
    le, lo = jscreen.spec_for_mode(jm(mode)).bank_lanes(bank == 1)
    d2 = [jdist.dist_lane_pairs(cur[..., l], tl[..., l], jm(mode), l, sub_np)
          for l in (le, lo)]
    d = jscreen.interleave_bank_lanes(d2[0], d2[1]).astype(np.int64)
    d = d * ~jscreen.SCREEN_HOLES
    want_up = up0.numpy().copy()
    want_dw = dw0.numpy().copy()
    want_up[:, bank] = np.where(d == 0, 0, want_up[:, bank]) + d
    want_dw[:, bank] = d
    assert d.max() > 0 and (d == 0).any()

    for fn in (chunk_start.chunk_start_plain, recompute_in_body):
        up, dw = up0.clone(), dw0.clone()
        fn(banks, lanes_tgt, frame, bank, dist.sub, up, dw, mode)
        assert up.dtype == dw.dtype == torch.int32
        assert np.array_equal(up.numpy(), want_up)
        assert np.array_equal(dw.numpy(), want_dw)


def recompute_in_body(banks, lanes_tgt, frame: int, bank: int, sub, up, dw,
                      mode):
    """The chunk start through the body entry: `body.encode_body` with the
    cost basis `sub`, on one padded step (nvalid 0), so the body keeps the
    recompute's state.  The bank bytes are left as they were."""
    B, F = lanes_tgt.shape[:2]
    n_lanes = screen.spec_for_mode(mode).N_LANES
    table = torch.zeros((n_lanes * 4, 128), dtype=torch.int16)
    ops = torch.zeros((1, B, 1, 1, 6), dtype=torch.uint8)
    bytes_tgt = torch.zeros((B, F, 2, 32, 256), dtype=torch.int32)
    kept = banks.clone()
    body.encode_body(up, dw, banks, lanes_tgt, bytes_tgt, frame, bank, table,
                     None, torch.zeros(1, dtype=torch.int32), 0, 1, ops, mode,
                     sub=sub)
    assert torch.equal(banks, kept)


def yiq_diff_at(banks, lanes_tgt, frame: int, bank: int, sub, mode):
    """The yiq chunk-start diff per page offset, as the kernel's yiq
    instantiation indexes it: offset o takes lane bank_lanes(bank)[o & 1]
    at column o >> 1, derives the modelled lane from the bank bytes around
    it (screen.masked_lane_at) and reads the target lane; both expand to
    dots (DHGR: the lane itself; HGR: hgr_to_dots with the lane as byte
    offset); window j is (dots >> j) & 0x7F, and d = sum_j sub[lane, j,
    wa_j, wb_j], zero where o & 127 >= 120.  Returns (B, 32, 256) int32."""
    main = banks[:, 0]
    aux = banks[:, 1] if mode == VideoMode.DHGR else None
    L = yiq.n_pixels(mode)
    col = torch.arange(128)
    d = torch.zeros(banks.shape[0], 32, 256, dtype=torch.int32)
    for parity, lane in enumerate(chunk_start.bank_lanes(mode, bank)):
        cur = screen.masked_lane_at(main, aux, mode, lane, col)
        tgt = lanes_tgt[:, frame, :, :, lane]
        if mode == VideoMode.HGR:
            cur, tgt = (screen.hgr_to_dots(x, lane) for x in (cur, tgt))
        acc = torch.zeros_like(cur)
        for j in range(L):
            acc += sub[lane, j, (cur >> j) & 0x7F, (tgt >> j) & 0x7F]
        d[..., parity::2] = acc
    d[..., (torch.arange(256) & 127) >= 120] = 0
    return d


@pytest.mark.parametrize("mode,bank", [(VideoMode.DHGR, 0),
                                       (VideoMode.DHGR, 1),
                                       (VideoMode.HGR, 0)])
def test_yiq_window_indexing_matches_plain(mode, bank):
    """yiq_diff_at (the yiq kernel's per-offset indexing) equals the dw
    that chunk_start_plain writes for the yiq model, B = 2 movies."""
    B, F, frame = 2, 3, 2
    banks = random_banks(B, mode, 5)
    tgt = random_banks(B * F, mode, 6).reshape((B, F) + banks.shape[1:])
    lanes_tgt = chunk_start.masked_lanes(tgt, mode).contiguous()
    dist = distance.ComputedDistance(mode, Palette.NTSC, "yiq", device="cpu")
    assert dist.sub.shape == (screen.spec_for_mode(mode).N_LANES,
                              yiq.n_pixels(mode), 128, 128)
    up = torch.zeros(banks.shape, dtype=torch.int32)
    dw = torch.zeros(banks.shape, dtype=torch.int32)
    chunk_start.chunk_start_plain(banks, lanes_tgt, frame, bank, dist.sub,
                                  up, dw, mode)
    got = yiq_diff_at(banks, lanes_tgt, frame, bank, dist.sub, mode)
    assert got.max() > 0 and (got == 0).any()
    assert torch.equal(got, dw[:, bank])


def test_encoder_calls_only_kernel_wrappers():
    """encoder.py calls no `*_plain` function: every body goes through the
    wrapper that launches a kernel on a card (the CPU form runs inside
    it), once per body, passing the cost basis as `sub` so that a
    recomputing body's chunk start runs in the same launch; nothing calls
    a chunk start of its own."""
    path = os.path.join(os.path.dirname(encoder.__file__), "encoder.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    called, body_calls = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", ""))
            called.add(name)
            if name == "encode_body":
                body_calls.append({kw.arg for kw in node.keywords})
    assert "encode_body" in called
    assert body_calls == [{"sub"}], body_calls
    assert not [n for n in called if "chunk_start" in n], called
    assert not [n for n in called if n.endswith("_plain")], called


@pytest.mark.parametrize("seed", [0, 7])
def test_nonce_indexing_matches_jax_random(seed):
    """body.nonce_plain, the per-element form of the body kernel's nonce
    indexing (fold_in(key, step), then fold_in(., 0) for page p or
    fold_in(., 1 + jj) for sub-op jj at counter slot * 256 + offset), for
    B = 2 keys over several steps, bit for bit against jax.random."""
    k, j = 4, 3
    for b, s in enumerate((seed, seed + 1)):
        key = jax.random.PRNGKey(s)
        words = [int(x) for x in np.asarray(key)]
        for step in (0, 1, 37, 1 << 20):
            skey = jax.random.fold_in(key, step)
            pages = np.asarray(jax.random.uniform(
                jax.random.fold_in(skey, 0), (32,), jnp.float32))
            for p in (0, 5, 31):
                got = np.float32(body.nonce_plain(words, step, 0, p))
                assert got.view(np.uint32) == pages[p].view(np.uint32)
            for jj in range(j):
                offs = np.asarray(jax.random.uniform(
                    jax.random.fold_in(skey, 1 + jj), (k, 256), jnp.float32))
                for r, t in ((0, 0), (1, 255), (3, 17)):
                    got = np.float32(body.nonce_plain(words, step, 1 + jj,
                                                      r * 256 + t))
                    assert got.view(np.uint32) == offs[r, t].view(np.uint32)


def test_key_words_are_jax_keys():
    """random.key_words: (B, 2) int32 holding the uint32 words of
    jax.vmap(PRNGKey)(seeds), negative seeds included."""
    seeds = [0, 3, 2 ** 31 - 1, -5]
    got = trandom.key_words(seeds, "cpu")
    assert got.dtype == torch.int32 and got.shape == (4, 2)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _tiny_encode_inputs():
    rng = np.random.RandomState(0)
    fmain = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
    plan, _ = encoder.plan_movie(
        n_frames=1, n_audio_ticks=100, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=VideoMode.DHGR, k=8)
    return fmain, faux, plan


@pytest.mark.parametrize("entry", [
    "ComputedDistance_mode", "ComputedDistance_palette", "prepare_targets",
    "plan_movie", "encode_movies", "Movie_mode", "Movie_palette",
    "ingest_movies_batch_mode", "ingest_movies_batch_palette",
    "replay_frame_errors", "score_screens"])
def test_public_entry_points_refuse_foreign_enums(entry):
    """A JAX package enum compares unequal to every port member: each
    public entry point raises TypeError instead of taking a wrong branch."""
    J, JP = JVideoMode.DHGR, JPalette.NTSC
    fmain, faux, plan = _tiny_encode_inputs()
    dist = distance.ComputedDistance(VideoMode.DHGR, Palette.NTSC,
                                     device="cpu")
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, VideoMode.DHGR,
                                            "cpu")
    rgb = torch.zeros((1, 1, 192, 140, 3), dtype=torch.uint8)
    calls = {
        "ComputedDistance_mode": lambda: distance.ComputedDistance(
            J, Palette.NTSC, device="cpu"),
        "ComputedDistance_palette": lambda: distance.ComputedDistance(
            VideoMode.DHGR, JP, device="cpu"),
        "prepare_targets": lambda: encoder.prepare_targets(fmain, faux, J,
                                                           "cpu"),
        "plan_movie": lambda: encoder.plan_movie(
            n_frames=1, n_audio_ticks=100, input_frame_rate=30.0,
            ticks_per_second=14700.0, every_n_video_frames=1, mode=J),
        "encode_movies": lambda: encoder.encode_movies(
            dist, lanes[None], bytes_[None], plan, J, None),
        "Movie_mode": lambda: Movie(frames_source=rgb[0].numpy(),
                                    video_mode=J, device="cpu"),
        "Movie_palette": lambda: Movie(frames_source=rgb[0].numpy(),
                                       palette=JP, device="cpu"),
        "ingest_movies_batch_mode": lambda: mesh.ingest_movies_batch(
            rgb, J, Palette.NTSC),
        "ingest_movies_batch_palette": lambda: mesh.ingest_movies_batch(
            rgb, VideoMode.DHGR, JP),
        "replay_frame_errors": lambda: quality.replay_frame_errors(
            np.zeros((plan.n_ops, 6), np.uint8) + 32, plan, lanes, J, dist),
        "score_screens": lambda: quality.score_screens(
            np.zeros((1, 2, 32, 256), np.uint8), lanes, J, dist.sub),
    }
    with pytest.raises(TypeError, match="its own"):
        calls[entry]()


def test_new_wrappers_refuse_devices_without_a_kernel():
    """No fallback: the body wrapper on the meta device raises, with the
    chunk start's cost basis (the recompute in its prologue) and without,
    and the threefry hook runs only on a card."""
    meta = torch.zeros((1, 2, 32, 256), dtype=torch.int32, device="meta")
    sub = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        body.encode_body(meta, meta, meta, meta, meta, 0, 0, sub, None,
                         sub, 0, 1, meta, VideoMode.DHGR, sub=sub)
    with pytest.raises(ValueError, match="no kernel"):
        body.encode_body(meta, meta, meta, meta, meta, 0, 0, sub, None,
                         sub, 0, 1, meta, VideoMode.DHGR)
    with pytest.raises(ValueError, match="card"):
        body.threefry_uniform(torch.zeros((1, 2), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 8, 1)


def test_body_skips_padded_steps():
    """A body whose steps are all padding (nvalid 0) changes no state and
    keeps the padding records, seeded or not."""
    fmain, faux, plan = _tiny_encode_inputs()
    mode = VideoMode.DHGR
    dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    lanes, bytes_ = encoder.prepare_targets(fmain[None], faux[None], mode,
                                            "cpu")
    table = dist.store_cost16.reshape(-1, dist.n_contents)
    rng = np.random.RandomState(3)
    state = [torch.as_tensor(rng.randint(0, 900, (1, 2, 32, 256)),
                             dtype=torch.int32) for _ in range(3)]
    ops = torch.full((4, 1, 1, 8, 6), 7, dtype=torch.uint8)
    nvalid = torch.tensor([5, 0, 0, 3], dtype=torch.int32)
    for keys in (None, trandom.key_words([3], "cpu")):
        st = [x.clone() for x in state]
        out = ops.clone()
        body.encode_body(*st, lanes, bytes_, 0, 1, table, keys, nvalid, 1, 2,
                         out, mode)
        assert all(torch.equal(a, b) for a, b in zip(st, state))
        assert torch.equal(out, ops)


def test_plan_is_the_jax_plan():
    """The port's copied plan_movie gives the JAX encoder's schedule on a
    case with continuation bodies and padded steps."""
    kw = dict(n_frames=2, n_audio_ticks=900, input_frame_rate=36.0,
              ticks_per_second=14700.0, every_n_video_frames=1, k=4, j=1)
    got, n = encoder.plan_movie(mode=VideoMode.HGR, **kw)
    want, jn = jenc.plan_movie(mode=JVideoMode.HGR, **kw)
    assert n == jn and got.chunk_steps == want.chunk_steps == 8
    assert (got.step_nvalid == 0).any()
    for f in ("step_frame", "step_bank", "step_recompute", "step_nvalid",
              "op_tick_index"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
