"""What the benchmark imports: never `jax`, `jaxlib`, `flax` or the JAX
package `iivision_tpu` (top-level names compared whole, since the port's
`iivision_tpu_torch` begins with `iivision_tpu`); and the yardstick (the
reference, the generators and the model) nothing of the program either."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "iivision_tpu"}
PROGRAM = {"iivision_tpu_torch", "bench", "bench_configs",
           "bench_solo_floor", "bench_recompute", "bench_ab_reference",
           "__graft_entry__", "tools"}
YARDSTICK = ("reference", "gen", "model")


def _sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        if os.sep + "tests" in d or ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_levels(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(_sources())


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if os.path.relpath(
        p, harness.BENCH_DIR).split(os.sep)[0] in YARDSTICK],
    ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_yardstick_imports_nothing_of_the_program(path):
    assert not set(_top_levels(path)) & (PROGRAM | FORBIDDEN)


def test_whole_name_comparison():
    from benchmark.run import forbidden_modules

    assert forbidden_modules(["iivision_tpu_torch.ops.body", "numpy"]) == []
    assert forbidden_modules(["iivision_tpu.encoder", "jaxlib.xla"]) == [
        "iivision_tpu", "jaxlib"]


BLOCK = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "iivision_tpu"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from benchmark import run
code, line, lines = run.run_cell(
    "hgr_batch32_10s", 5, 0.5, False, on_card=False,
    traffic_override=dict(clip_seconds=0.2, batch=2, pool=1, sample_span=1,
                          sample_rounds=1, sample_movies=1))
import benchmark.control, benchmark.reference.check
assert code == 0, lines
assert not {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib",
                                                     "flax", "iivision_tpu"}
print("OK")
"""


def test_a_run_with_jax_blocked():
    """A whole run on the CPU in a process that cannot import JAX or the
    JAX package."""
    out = subprocess.run([sys.executable, "-c", BLOCK], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
