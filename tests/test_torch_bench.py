"""The port's measuring programs (`iivision_tpu_torch.bench`,
`bench_configs`, `bench_solo_floor`) against the JAX benchmark's own
functions on the same seeds, and every configuration's record at a tiny
size on the CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu.ops import dither as jdither
from iivision_tpu.ops import resize as jresize
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu_torch import audio, bench, bench_solo_floor, movie
from iivision_tpu_torch.ops import dither, resize
from iivision_tpu_torch.palettes import Palette

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's tensors are tiny: one intra-op thread runs it as fast as
    a team of them, and leaves the cores to the other test workers (among
    six workers, each with a team of threads, it took 40 times as long as
    alone)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def jbench():
    """The repo's JAX benchmark module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_under_test", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seconds,phase", [(0.2, 0.0), (0.1, 1.3)])
def test_synth_clip_equals_jax_bench(jbench, seconds, phase):
    got = bench.synth_clip(seconds, phase=phase)
    want = jbench.synth_clip(seconds=seconds, phase=phase)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_synth_movies_device_within_one_count_of_jax(jbench):
    """float32 sines on two libraries: within one count of uint8 on at
    most 0.1% of values."""
    B, F, h, w = 2, 3, 24, 20
    for seed in (0, 5000):
        got = bench.synth_movies_device(B, F, seed, "cpu", h=h, w=w).numpy()
        want = np.asarray(jbench.synth_movies_device(B, F, seed, h=h, w=w))
        assert got.shape == want.shape == (B, F, h, w, 3)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_audio_levels_device_equals_jax_bench():
    """bench.py:416-419's expression, jitted, against the port's on the
    same float32 tone and normalization; and within 0.1% of the host
    levels, as bench.py:467-469 holds it."""
    @jax.jit
    def jax_levels(x, norm):
        lv = jnp.trunc(x / 16384.0 * norm * 16).astype(jnp.int32)
        return jnp.clip(lv, -15, 16)

    wave = bench.tone(0.5)
    aud = audio.Audio(data=wave, rate=14700, bitrate=14700, device="cpu")
    got = bench.audio_levels_device(torch.as_tensor(wave),
                                    aud.normalization).numpy()
    want = np.asarray(jax_levels(jnp.asarray(wave), aud.normalization))
    assert np.array_equal(got, want)
    assert (got != aud.levels()).mean() < 1e-3


def test_hostfed_movie_equals_jax_bench():
    """The host-fed decode stand-in (bench.py:570) and the host targets
    made from it (:571-573) equal the JAX package's functions'."""
    sel = bench.synth_clip(0.2, phase=1.0)[::2]
    for seed, i in ((100, 0), (100, 31), (7, 3)):
        src = bench.hostfed_source(sel, seed, i)
        assert np.array_equal(src, np.roll(sel, (seed + i * 7) % 280,
                                           axis=2))
    rs = resize.resize_host(src, 192, 140)
    assert np.array_equal(rs, jresize.resize_batch(src, 192, 140))
    codes = dither.quantize_ordered_host(rs, Palette.NTSC)
    assert np.array_equal(codes, jdither.quantize_ordered_host(
        rs, JPalette.NTSC))
    for got, want in zip(dither.dhgr_pack_host(codes),
                         jdither.dhgr_pack_host(codes)):
        assert np.array_equal(got, want)


def test_pipelined_streams_equal_one_shot():
    ctx = bench.Context("cpu", seed=3)
    case = bench.pipelined_dhgr(ctx, B=2, seconds=0.5, R=2)
    try:
        _, (streams, seed) = case.run(1)
        bs = bench.BatchSetup(ctx, 2, 0.5)
        _, want = bs.one_shot(seed)
        assert len(streams) == 2 and streams == want["streams"]
        assert streams[0] != streams[1]
        assert all(bench.all_streams_valid(streams, bs.n_ops,
                                           bs.levels).values())
    finally:
        case.close()


def test_bare_cuda_names_the_current_card(monkeypatch):
    """`--device cuda` (the default of every entry point) resolves to the
    current card's index, so a distance model made there compares equal
    to the targets' device (the whole-movie encode refused "cuda" against
    "cuda:0")."""
    from iivision_tpu_torch import require_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert require_device("cuda") == torch.device("cuda", 1)
    assert require_device("cuda:0") == torch.device("cuda", 0)
    assert require_device("cpu") == torch.device("cpu")


def test_summarize_equals_numpy_percentile():
    rng = np.random.RandomState(0)
    for n in (1, 2, 5, 11):
        x = rng.rand(n)
        got = bench.summarize(list(x))
        q1, med, q3 = np.percentile(x, [25, 50, 75])
        assert got == {"n": n, "median": med, "q1": q1, "q3": q3,
                       "min": x.min(), "max": x.max()}


def test_fit_floor_on_exact_linear_data():
    subops = [1950, 3900, 7800]
    seconds = [0.0042 + 2.5e-6 * s for s in subops]
    slope, intercept = bench_solo_floor.fit_floor(subops, seconds)
    assert slope == pytest.approx(2.5, abs=1e-9)
    assert intercept == pytest.approx(4.2, abs=1e-9)


def test_quality_baseline_bounds():
    """The sweep's k=16 j=4 line is held to the committed row as
    tests/test_quality_regression.py holds it: 1.01x on the mean, 1.02x +
    0.05 on the final error."""
    from iivision_tpu_torch import bench_configs

    name = "dhgr_ntsc_k16_j4_seed0"
    with open(bench_configs.QUALITY_BASELINE) as f:
        row = json.load(f)["rows"][name]
    at = {"mean_error": row["mean_error"] * 1.01,
          "final_error": row["final_error"] * 1.02 + 0.05}
    got = bench_configs.baseline_checks(at, name)
    assert got["mean_error_within_baseline"] is True
    assert got["final_error_within_baseline"] is True
    for key in at:
        worse = dict(at, **{key: at[key] + 0.01})
        checks = bench_configs.baseline_checks(worse, name)
        assert checks[key + "_within_baseline"] is False


@pytest.mark.parametrize("mode", ["DHGR", "HGR"])
def test_build_tables_rows_equal_sharded_rows(mode):
    """A tiny LUT run's rows (`build_tables(n_rows=)`, the card's entry
    point) equal `build_tables_sharded`'s over a one-device mesh."""
    from iivision_tpu_torch.ops import editdist
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.video_mode import VideoMode

    got = editdist.build_tables(VideoMode[mode], Palette.NTSC, "cpu",
                                n_rows=2)
    want = mesh.build_tables_sharded(VideoMode[mode], Palette.NTSC,
                                     ("cpu",), n_rows=2)
    assert got.dtype == torch.uint16 and torch.equal(got, want)


STATS = {"unit", "n", "median", "q1", "q3", "min", "max"}


@pytest.mark.parametrize("name", list(bench.all_configs()))
def test_config_record_on_cpu(name, monkeypatch):
    """Every configuration at a tiny size on the CPU: a passing record
    with its fields, every timing summarised with its unit, and no
    device metric."""
    # the 80 s soak's check wants the streaming encoder at any length
    monkeypatch.setattr(movie, "STREAM_MIN_FRAMES", 2)
    entry = bench.all_configs()[name]
    rec = bench.run_case(name, entry, bench.Context("cpu", seed=1), 1,
                         **entry.tiny)
    assert rec["ok"], rec
    assert rec["config"] == (entry.group or name) and rec["name"] == name
    assert rec["device"] == {"platform": "cpu", "name": "cpu"}
    assert rec["trace"] == rec["roofline"] == "not measured"
    assert "launches" not in rec
    assert "wall_s" in rec["first_rep"] and rec["checks"]
    for key, stats in rec["timings"].items():
        assert set(stats) == STATS and stats["n"] == 1, key
        assert stats["unit"] == bench.unit_of(key)
        assert stats["min"] <= stats["q1"] <= stats["median"] <= \
            stats["q3"] <= stats["max"]
    assert not [k for k in rec["timings"] if "peak_" in k]
    if name.startswith("k_sweep"):
        assert "encode_realtime_x" in rec["timings"]
        assert {"mean_error", "final_error"} <= set(rec["checks"])
    if name == "dhgr_ntsc_yiq":
        assert {"mean_error_yiq", "mean_error_window"} <= set(rec["checks"])
    if name == "long_dhgr_80s_k16_j4":
        assert rec["checks"]["encoder_used"] == "streaming"
        assert rec["checks"]["machine65_exit"] == "TERMINATED"
    if name == "solo_floor_dhgr_k32_j10":
        assert [r["seconds"] for r in rec["checks"]["rows"]] == \
            [0.05, 0.1, 0.15]


def test_failed_check_and_error_exit_nonzero(tmp_path, capsys):
    def make(ok):
        def factory(ctx):
            if ok is None:
                raise ValueError("broken setup")
            return bench.Case(run=lambda i: ({"x_s": 0.5}, i),
                              check=lambda out: {"holds": ok})
        return factory

    out = tmp_path / "recs.jsonl"
    table = {"good": bench.Entry(make(True), 1, {}),
             "bad": bench.Entry(make(False), 1, {}),
             "raises": bench.Entry(make(None), 1, {})}
    assert bench.main(["--device", "cpu", "--only", "good",
                       "--out", str(out)], configs=table) == 0
    assert bench.main(["--device", "cpu", "--out", str(out)],
                      configs=table) == 1
    recs = [json.loads(line) for line in open(out)]
    assert [(r["name"], r["ok"]) for r in recs] == [
        ("good", True), ("good", True), ("bad", False), ("raises", False)]
    assert recs[-1]["error"] == "ValueError: broken setup"
    assert recs[0]["timings"]["x_s"]["median"] == 0.5
    assert len(capsys.readouterr().out.splitlines()) == 4


def test_bench_refuses_to_run_without_a_card():
    """No card visible and no `--device cpu`: a message, no record, a
    non-zero exit (the CPU is never a fallback)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "iivision_tpu_torch.bench", "--only",
         "lut_dhgr_ntsc"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "--device cpu" in proc.stderr


@pytest.mark.parametrize("program", ["bench_configs", "bench_solo_floor"])
def test_programs_refuse_to_run_without_a_card(program, monkeypatch,
                                               capsys):
    import importlib

    mod = importlib.import_module("iivision_tpu_torch." + program)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([], configs=mod.CONFIGS) == 2
    assert capsys.readouterr().out == ""
