"""The generators give the same inputs for the same seed, and others for
another."""

import numpy as np
import pytest
import torch

from benchmark.control import sample_clips
from benchmark.gen import clips as gen
from benchmark import harness


def test_phases_per_seed():
    a = gen.phases(np.random.default_rng(2 ** 31 + 5), 8)
    b = gen.phases(np.random.default_rng(2 ** 31 + 5), 8)
    c = gen.phases(np.random.default_rng(2 ** 31 + 6), 8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert ((a >= 0) & (a < 2 * np.pi)).all()


def test_synth_is_deterministic_and_distinct():
    ph = np.array([0.5, 2.0])
    a = gen.synth_movies_device(ph, 4, "cpu", h=16, w=24)
    b = gen.synth_movies_device(ph, 4, "cpu", h=16, w=24)
    assert a.dtype == torch.uint8 and a.shape == (2, 4, 16, 24, 3)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])


def test_rolled_and_tone():
    clip = np.arange(2 * 3 * 40 * 3, dtype=np.uint8).reshape(2, 3, 40, 3)
    long = gen.rolled(clip, 3)
    assert long.shape == (6, 3, 40, 3)
    assert np.array_equal(long[2:4], np.roll(clip, 52, axis=2))
    assert gen.rolled(clip, 1) is clip
    t = gen.tone(0.5, 14700, 440.0)
    assert t.dtype == np.float32 and len(t) == 7350
    assert np.array_equal(t, gen.tone(0.5, 14700, 440.0))


def test_rolled_encoded_is_rolled_then_skipped():
    pattern = np.random.default_rng(4).integers(
        0, 256, (5, 3, 40, 3), dtype=np.uint8)
    for n in (3, 5, 7, 12, 13):
        for every in (1, 2, 3):
            want = gen.rolled(pattern, -(-n // 5))[:n][::every]
            assert np.array_equal(gen.rolled_encoded(pattern, n, every),
                                  want)


def test_tones_per_seed():
    a = gen.tones(np.random.default_rng(2 ** 33 + 1), 4, 0.5, 14700,
                  (220, 880))
    b = gen.tones(np.random.default_rng(2 ** 33 + 1), 4, 0.5, 14700,
                  (220, 880))
    c = gen.tones(np.random.default_rng(2 ** 33 + 2), 4, 0.5, 14700,
                  (220, 880))
    assert a.dtype == np.float32 and a.shape == (4, 7350)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])  # each clip its own tone
    assert np.abs(a).max() <= 16000


def test_control_clips_per_seed(mixed_cell):
    man = harness.manifest()
    for name, tiny in (("dhgr_batch32_10s", dict(clip_seconds=0.2)),
                       ("dhgr_solo_10s", dict(clip_seconds=0.2)),
                       (mixed_cell, {})):
        w = harness.cell(man, name)
        cfg, tr = harness.config_of(man, w), harness.traffic_of(w)
        tr = dict(tr, **tiny)
        a = sample_clips(cfg, tr, 2 ** 32 + 1, "cpu")
        b = sample_clips(cfg, tr, 2 ** 32 + 1, "cpu")
        c = sample_clips(cfg, tr, 2 ** 32 + 2, "cpu")
        assert [x.seed for x in a] == [x.seed for x in b]
        assert all(np.array_equal(np.asarray(x.rgb), np.asarray(y.rgb))
                   for x, y in zip(a, b))
        assert not np.array_equal(np.asarray(a[0].rgb), np.asarray(c[0].rgb))
        assert all(np.array_equal(x.wave, y.wave) for x, y in zip(a, b))
        assert not np.array_equal(a[0].wave, a[1].wave)
        assert all(0 < x.seed < 2 ** 31 for x in a)


def test_mixed_control_clips_take_their_lengths(mixed_cell):
    """The mixed client's control clips: the shortest length and others
    drawn from the traffic's lengths, each with its frames, tone and
    source count."""
    man = harness.manifest()
    w = harness.cell(man, mixed_cell)
    cfg, tr = harness.config_of(man, w), harness.traffic_of(w)
    L = np.sort(np.asarray(tr["lengths_s"]))
    clips = sample_clips(cfg, tr, 2 ** 32 + 3, "cpu")
    assert len(clips) == tr["sample_clips"]
    assert clips[0].n_source == int(round(L[0] * 30))
    for c in clips:
        seconds = c.n_source / 30
        assert min(abs(L - seconds)) < 1 / 30
        assert len(c.wave) == int(L[np.argmin(abs(L - seconds))] * 14700)
        assert len(c.rgb) == len(range(0, c.n_source, 2))
