"""The ingest kernel (csrc/ingest.cu, `ops/ingest.ingest_batch`) against
the torch chain it replaces (`mesh.ingest_batch_plain`), on a CUDA card.

Every test here is marked `card` and skips where no card is present (the
kernel has no CPU form); the CPU tests of its tables are in
tests/test_torch_ingest.py.  The card's machine has no JAX, so run these
there without tests/conftest.py:

    python -m pytest tests/test_torch_ingest_kernel.py -q -m card \\
        --noconftest -p no:cacheprovider

The comparisons are `chip_smoke.ingest_case`'s, which the smoke runs too:
lanes and bytes equal on every element, or, on random frames only, fewer
than `chip_smoke.INGEST_RANDOM_SHARE` of them apart (a float64 resize sum
on a rounding half-tie)."""

import pytest
import torch

import chip_smoke
from iivision_tpu_torch import trace
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.video_mode import VideoMode

pytestmark = pytest.mark.card

MODES = [VideoMode.DHGR, VideoMode.HGR]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ingest kernel runs on one only")
    from iivision_tpu_torch import _build

    _build.library()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("h,w", chip_smoke.INGEST_SOURCES)
@pytest.mark.parametrize("palette", [Palette.NTSC, Palette.IIGS])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_equals_the_chain(card, mode, palette, h, w):
    """Random frames and the benchmark's synthetic clips at (B, F) = (1, 1),
    (3, 300) (past the chain's 256-frame chunk) and (32, 150)."""
    seed = 1000 * h + w
    for B, F in chip_smoke.INGEST_BATCHES:
        for content in ("random", "synth"):
            seed += 1
            c = chip_smoke.ingest_case(card, mode, palette, h, w, B, F,
                                       content, seed)
            assert c["ok"], (B, F, content, c)


@pytest.mark.parametrize("mode", MODES)
def test_a_second_call_copies_nothing(card, mode):
    """After the first call has built the constants, a call makes no
    host<->device copy or sync, counts one launch and runs one kernel and
    no other device activity."""
    rgb = chip_smoke.ingest_frames(card, "synth", 4, 20, 192, 280, 3)
    assert chip_smoke.ingest_copies(card, Palette.NTSC, rgb, (mode,)) == {
        mode.name: dict(launches=1, kernels=1), "other": {}}


@pytest.mark.parametrize("mode", MODES)
def test_one_launch_per_batch_or_shard(card, mode):
    """ingest_movies_batch counts one kernel launch a batch, and one a
    shard on the mesh (cuda:0, cuda:0), whose shards equal the unsharded
    batch."""
    rgb = chip_smoke.ingest_frames(card, "synth", 4, 30, 192, 280, 9)
    before = trace.counters()["ingest_batch.launches"]
    lanes, bytes_ = mesh.ingest_movies_batch(rgb, mode, Palette.NTSC)
    assert trace.counters()["ingest_batch.launches"] == before + 1
    s_lanes, s_bytes = mesh.ingest_movies_batch(rgb, mode, Palette.NTSC,
                                                mesh=(card, card))
    assert trace.counters()["ingest_batch.launches"] == before + 3
    assert torch.equal(torch.cat(s_lanes), lanes)
    assert torch.equal(torch.cat(s_bytes), bytes_)
