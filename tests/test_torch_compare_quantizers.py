"""The port's image-level quantizer harness (compare_quantizers) against
the JAX package's on tests/fixtures/parity_frames.npz.

Given the same 140-wide source frames, the quantizer variants and their
scores are equal exactly.  `compare` resizes the source itself: the port
sums the Lanczos products in float64, the JAX package in float32
(ops/resize.py), so about 2.5% of the 140-wide pixels land one uint8 level
apart and every averaged score moves by at most 0.02 on this fixture; the
rows are held to 0.05 (dB of PSNR, or CIEDE2000 units)."""

import os
import shutil

import numpy as np
import pytest
import torch

from iivision_tpu import compare_quantizers as jcq
from iivision_tpu.ops import resize as jresize
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu_torch import compare_quantizers as cq
from iivision_tpu_torch.ops import dither
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_torch_batch import jm

FIXTURE = "tests/fixtures/parity_frames.npz"
ROW_TOL = 0.05
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def src280():
    return jcq.load_frames(FIXTURE, 2)


def test_load_frames_and_resize(src280):
    """The port loads the fixture's frames as JAX does (they are 280x192
    already, so nothing is resized); its resize to 140 wide is within one
    level of JAX's on at most 5% of the pixels."""
    got = cq.load_frames(FIXTURE, 2, "cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, src280)
    j140 = np.asarray(jresize.resize_batch(src280, 192, 140))
    p140 = cq._resize(src280, 192, 140, CPU)
    d = np.abs(j140.astype(np.int32) - p140.astype(np.int32))
    assert p140.shape == j140.shape == (2, 192, 140, 3)
    assert d.max() <= 1 and (d > 0).mean() < 0.05


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_variants_and_scores_equal_jax(src280, mode):
    """On the same 140-wide frames, our_variants gives JAX's names and
    screens, and score_screen JAX's numbers, exactly."""
    src140 = np.asarray(jresize.resize_batch(src280, 192, 140))
    for i in range(len(src140)):
        want = list(jcq.our_variants(src140[i], jm(mode), JPalette.NTSC))
        got = list(cq.our_variants(src140[i], mode, Palette.NTSC))
        assert [g[0] for g in got] == [w[0] for w in want]
        for (name, m, a), (_, wm, wa) in zip(got, want):
            assert np.array_equal(m, np.asarray(wm)), name
            assert (a is None) == (wa is None), name
            if a is not None:
                assert np.array_equal(a, np.asarray(wa)), name
            score = cq.score_screen(m, a, src140[i], mode, Palette.NTSC)
            assert score == jcq.score_screen(
                np.asarray(wm), None if wa is None else np.asarray(wa),
                src140[i], jm(mode), JPalette.NTSC), name


def test_compare_matches_jax_within_tolerance(src280, tmp_path):
    """compare on the fixture, with a reference cache built from the
    buckels kernel: JAX's rows in JAX's order of names, each score within
    ROW_TOL; the cache row equals the buckels row, as in JAX's test."""
    src140 = cq._resize(src280, 192, 140, CPU)
    cache = tmp_path / "DHGR" / "NTSC"
    cache.mkdir(parents=True)
    for i in range(2):
        c = dither.quantize_error_diffusion(
            src140[i].astype(np.float32), Palette.NTSC, kernel="buckels")
        m, a = dither.dhgr_pack_host(np.asarray(c, np.uint8)[None])
        m[0].tofile(str(cache / ("%08d.BIN" % i)))
        a[0].tofile(str(cache / ("%08d.AUX" % i)))
    got = dict(cq.compare(FIXTURE, VideoMode.DHGR, Palette.NTSC, n_frames=2,
                          reference_cache=str(cache), device="cpu"))
    assert abs(got["bmp2dhr_cache"]["psnr"] - got["buckels"]["psnr"]) < 1e-9
    del got["bmp2dhr_cache"]
    for mode in (VideoMode.DHGR, VideoMode.HGR):
        if mode == VideoMode.HGR:
            got = dict(cq.compare(FIXTURE, mode, Palette.NTSC, n_frames=2,
                                  device="cpu"))
        want = dict(jcq.compare(FIXTURE, jm(mode), JPalette.NTSC,
                                n_frames=2))
        assert set(got) == set(want)
        for name, scores in want.items():
            assert set(got[name]) == set(scores), name
            for metric, v in scores.items():
                assert abs(got[name][metric] - v) < ROW_TOL, (name, metric)


def test_format_table_equals_jax():
    rows = [("ordered", dict(psnr=14.8828, cie2000=13.7002,
                             psnr_yiq=14.7764)),
            ("bmp2dhr_D9", dict(psnr=15.25, cie2000=12.5))]
    got = cq.format_table(rows, VideoMode.DHGR, Palette.NTSC, FIXTURE, 2)
    assert got == jcq.format_table(rows, jm(VideoMode.DHGR), JPalette.NTSC,
                                   FIXTURE, 2)
    assert "| bmp2dhr_D9 | 15.25 | 12.50 | - |" in got


def test_main_prints_the_table_without_report(tmp_path, capsys):
    """main on a copy of the fixture, on the CPU, without --report: the
    table goes to stdout and AB_REPORT.md is left as it was."""
    clip = str(tmp_path / "frames.npz")
    shutil.copy(FIXTURE, clip)
    report = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(cq.__file__))), "AB_REPORT.md")
    before = open(report, "rb").read() if os.path.exists(report) else None
    assert cq.main([clip, "--frames", "1", "--video_mode", "HGR",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "## Quantizer image-level comparison (HGR/NTSC, 1 frames of " \
           "frames.npz)" in out
    assert "| ordered |" in out
    after = open(report, "rb").read() if os.path.exists(report) else None
    assert after == before
