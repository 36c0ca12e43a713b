"""Multi-device batch sharding in iivision_tpu_torch (parallel.mesh) on CPU
meshes against the port's unsharded calls and the JAX package's sharded
ones on its virtual 8-device CPU mesh (tests/conftest.py).

A port mesh may name the CPU more than once: each entry is a shard run in
a host thread of its own, which is the port's counterpart of XLA's virtual
host devices.  Everything here is bit-exact: the sharded encode, ingest,
fetches and LUT rows equal the unsharded ones and JAX's."""

import sys
import threading

import numpy as np
import pytest
import torch

from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.parallel import mesh as jmesh
from iivision_tpu_torch import _build, encoder
from iivision_tpu_torch.ops import editdist
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist
from tests.test_torch_batch import batch_targets, flat_plan, jm
from tests.test_torch_joint import torch_dist

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR
B = 4
SEEDS = [7, 0, 3, 12]


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded B=4 DHGR batch encode at k=8 (2 frames)."""
    plan = flat_plan(DHGR, 8, 1)
    main, aux = batch_targets(DHGR, B, 2, 90)
    lanes, bytes_ = encoder.prepare_targets(main, aux, DHGR, "cpu")
    ops, fin_main, fin_aux = mesh.encode_movies_batch(
        torch_dist(DHGR), lanes, bytes_, plan, DHGR, seeds=SEEDS)
    return plan, lanes, bytes_, ops, fin_main, fin_aux


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_encode_matches_unsharded_and_jax(unsharded, n):
    """B=4 movies sharded over a CPU mesh of n entries: ops and final
    screens byte-equal to the unsharded encode and to JAX's
    encode_movies_batch sharded over n virtual devices."""
    plan, lanes, bytes_, ops, fin_main, fin_aux = unsharded
    m = mesh.make_mesh(n, "cpu")
    assert m == (torch.device("cpu"),) * n
    s_ops, s_main, s_aux = mesh.encode_movies_batch(
        torch_dist(DHGR), lanes, bytes_, plan, DHGR, seeds=SEEDS, mesh=m)
    assert len(s_ops) == len(s_main) == len(s_aux) == n
    assert all(len(o) == B // n for o in s_ops)
    assert np.array_equal(mesh.fetch_ops(s_ops, plan),
                          mesh.fetch_ops(ops, plan))
    assert torch.equal(torch.cat(s_main), fin_main)
    assert torch.equal(torch.cat(s_aux), fin_aux)

    j_ops, j_main, _ = jmesh.encode_movies_batch(
        get_dist(jm(DHGR)), lanes.numpy(), bytes_.numpy(), plan, jm(DHGR),
        seeds=np.asarray(SEEDS), mesh=jmesh.make_mesh(n))
    S = len(plan.step_frame)
    assert np.array_equal(mesh.fetch_ops(s_ops, plan),
                          jmesh.fetch_ops(j_ops, plan)[:, :S])
    assert np.array_equal(torch.cat(s_main).numpy(), np.asarray(j_main))


def test_encode_of_ingested_shards_names_their_mesh(unsharded):
    """A batch given as shards (what ingest returns on a mesh) encodes on
    their devices with mesh=None, and a one-entry mesh runs unsharded and
    returns tensors."""
    plan, lanes, bytes_, ops, _, _ = unsharded
    m = mesh.make_mesh(2, "cpu")
    s_ops, _, _ = mesh.encode_movies_batch(
        torch_dist(DHGR), mesh.shard_batch(lanes, m),
        mesh.shard_batch(bytes_, m), plan, DHGR, seeds=SEEDS)
    assert len(s_ops) == 2
    assert np.array_equal(mesh.fetch_ops(s_ops, plan),
                          mesh.fetch_ops(ops, plan))
    one, _, _ = mesh.encode_movies_batch(
        torch_dist(DHGR), lanes, bytes_, plan, DHGR, seeds=SEEDS,
        mesh=mesh.make_mesh(1, "cpu"))
    assert isinstance(one, torch.Tensor) and torch.equal(one, ops)


def test_encode_movies_mixed_on_a_mesh():
    """encode_movies_mixed with a mesh of 2 equals the unsharded call op
    for op (tests/test_torch_batch.py holds that one against JAX)."""
    movies = []
    for nf, nt, sd in [(4, 2000, 0), (2, 900, 1)]:
        main, aux = batch_targets(DHGR, 1, nf, 40 + sd)
        movies.append((main[0], aux[0], nf, nt))
    kw = dict(input_frame_rate=12.0, ticks_per_second=14700.0,
              every_n_video_frames=1, k=8, seeds=[3, 4])
    flats, plan_max, n_ops = mesh.encode_movies_mixed(
        torch_dist(DHGR), movies, DHGR, **kw)
    s_flats, s_plan, s_n = mesh.encode_movies_mixed(
        torch_dist(DHGR), movies, DHGR, mesh=mesh.make_mesh(2, "cpu"), **kw)
    assert s_n == n_ops and s_plan is plan_max
    for got, want in zip(s_flats, flats):
        assert np.array_equal(got, want)


def test_fetches_take_shards(unsharded):
    """fetch_ops, fetch_ops_compact, fetch_ops_parallel (compact or not,
    on shards and on slices of one tensor) and its future all give the
    unsharded fetch, in batch order."""
    plan, lanes, bytes_, ops, _, _ = unsharded
    shards = mesh.shard_batch(ops, mesh.make_mesh(2, "cpu"))
    full = mesh.fetch_ops(ops, plan)
    compact = mesh.fetch_ops_compact(ops, plan)
    assert compact.shape == (B, plan.n_ops, 6)
    assert np.array_equal(mesh.fetch_ops(shards, plan), full)
    assert np.array_equal(mesh.fetch_ops_compact(shards, plan), compact)
    assert np.array_equal(mesh.fetch_ops_parallel(shards, plan), compact)
    assert np.array_equal(
        mesh.fetch_ops_parallel(shards, plan, compact=False), full)
    for streams in (1, 2, 3, 7):
        assert np.array_equal(
            mesh.fetch_ops_parallel(ops, plan, streams=streams), compact)
    fut = mesh.fetch_ops_parallel_future(shards, plan)
    assert np.array_equal(fut.result(timeout=60), compact)
    fut = mesh.fetch_ops_parallel_future(ops, plan, compact=False)
    assert np.array_equal(fut.result(timeout=60), full)


@pytest.mark.parametrize("mode,h,w,n", [(DHGR, 192, 280, 2),
                                        (HGR, 240, 320, 4)])
def test_sharded_ingest_matches_unsharded(mode, h, w, n):
    """ingest_movies_batch over a CPU mesh: shards in batch order, each
    equal to the unsharded ingest of its movies (the resize included)."""
    rgb = torch.as_tensor(np.random.RandomState(5).randint(
        0, 256, (4, 3, h, w, 3)).astype(np.uint8))
    lanes, bytes_ = mesh.ingest_movies_batch(rgb, mode, Palette.NTSC)
    s_lanes, s_bytes = mesh.ingest_movies_batch(
        rgb, mode, Palette.NTSC, mesh=mesh.make_mesh(n, "cpu"))
    assert len(s_lanes) == len(s_bytes) == n
    assert torch.equal(torch.cat(s_lanes), lanes)
    assert torch.equal(torch.cat(s_bytes), bytes_)


@pytest.mark.parametrize("mode,n", [(DHGR, 2), (DHGR, 4), (HGR, 2)])
def test_build_tables_sharded_matches_jax_and_pair_distance(mode, n):
    """The first 64 rows of every lane's LUT, row-sharded over a CPU mesh:
    equal to JAX's build_tables_sharded on n virtual devices and to the
    port's pair_distance rows."""
    n_rows = 64
    got = mesh.build_tables_sharded(mode, Palette.NTSC,
                                    mesh.make_mesh(n, "cpu"), n_rows=n_rows)
    lanes = 4 if mode == DHGR else 2
    N = 1 << (13 if mode == DHGR else 14)
    assert got.shape == (lanes, n_rows * N) and got.dtype == torch.uint16
    want = np.asarray(jmesh.build_tables_sharded(
        jm(mode), JPalette.NTSC, jmesh.make_mesh(n), n_rows=n_rows))
    assert np.array_equal(got.numpy(), want)
    sub = editdist.cost_matrix(Palette.NTSC, "cpu")
    for lane in range(lanes):
        codes = editdist.lane_codes(mode, lane, "cpu")
        rows = editdist.pair_distance(codes[:n_rows].clone(), codes, sub)
        assert torch.equal(got[lane].reshape(n_rows, N).view(torch.int16),
                           rows.view(torch.int16)), lane


def test_mesh_refuses_an_undivided_batch(unsharded):
    """A mesh must divide the batch; and an unsharded call never moves the
    distance model to the targets' device (only a mesh names devices)."""
    plan, lanes, bytes_, _, _, _ = unsharded
    with pytest.raises(ValueError, match="distance model on meta"):
        mesh.encode_movies_batch(torch_dist(DHGR).to("meta"), lanes, bytes_,
                                 plan, DHGR, seeds=SEEDS)
    m = mesh.make_mesh(3, "cpu")
    with pytest.raises(ValueError, match="does not split over a mesh of 3"):
        mesh.encode_movies_batch(torch_dist(DHGR), lanes, bytes_, plan,
                                 DHGR, seeds=SEEDS, mesh=m)
    with pytest.raises(ValueError, match="does not split"):
        mesh.ingest_movies_batch(torch.zeros((4, 1, 192, 140, 3),
                                             dtype=torch.uint8),
                                 DHGR, Palette.NTSC, mesh=m)
    with pytest.raises(ValueError, match="does not split"):
        mesh.build_tables_sharded(DHGR, Palette.NTSC, m, n_rows=64)


def test_a_shard_that_raises_fails_the_call(unsharded, monkeypatch):
    """One shard's failure makes the whole sharded encode raise, after the
    other shard has ended; nothing comes back short."""
    plan, lanes, bytes_, _, _, _ = unsharded
    real = encoder.encode_movies
    ran = []

    def flaky(dist, lanes_b, bytes_b, plan_, mode, seeds, joint=False):
        if seeds[0] == SEEDS[2]:
            raise RuntimeError("shard 1 failed")
        ran.append(seeds)
        return real(dist, lanes_b, bytes_b, plan_, mode, seeds, joint)

    monkeypatch.setattr(encoder, "encode_movies", flaky)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        mesh.encode_movies_batch(torch_dist(DHGR), lanes, bytes_, plan,
                                 DHGR, seeds=SEEDS,
                                 mesh=mesh.make_mesh(2, "cpu"))
    assert ran == [SEEDS[:2]]


def test_launch_counts_lose_no_update_across_threads():
    """Sixteen threads count 2000 launches each with a tiny switch
    interval: the locked counter ends at the exact total."""
    def fn():
        pass

    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(fn) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16 * 2000


def test_make_mesh_and_replicate():
    """make_mesh on the CPU, a mesh with no card on this host, and
    replicate: entries on the value's device share it, the distance model
    included."""
    assert mesh.make_mesh(device="cpu") == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA card"):
            mesh.make_mesh(2)
    with pytest.raises(TypeError, match="make_mesh"):
        mesh.as_mesh(2)
    d = torch_dist(HGR)
    assert mesh.replicate(d, mesh.make_mesh(2, "cpu")) == (d, d)
    x = torch.arange(6)
    assert all(t is x for t in mesh.replicate(x, ["cpu", "cpu"]))
    moved = d.to("meta")
    assert moved is not d and moved.device == torch.device("meta")
    assert moved.sub.device.type == moved.store_cost16.device.type == "meta"
    assert moved.mode == d.mode and moved.n_contents == d.n_contents
    assert d.sub.device.type == "cpu"
