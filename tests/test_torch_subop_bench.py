"""The sub-op microbenchmark's plain torch math against the JAX tool's own
(tools/bench_subop_pallas.py, loaded by file path): T sequential sub-ops
through `jax.lax.scan` over `_sub_op_math` / `_sub_op_math_int` (the tool's
`xla` variants, which the tool holds digest-equal to its Pallas kernel)
and through the port's eager loops.  Tolerance: bit-equal."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu_torch import bench_subop
from iivision_tpu_torch.ops import subop_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_subop_pallas", os.path.join(REPO, "tools",
                                           "bench_subop_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def fresh(R, salt):
    """The tool's `fresh()` inputs: uniform rows scaled by 100/50/30/20."""
    r = np.random.RandomState(salt)
    return [r.rand(R, 256).astype(np.float32) * s
            for s in (100.0, 50.0, 30.0, 20.0)]


def jax_scan(step, T, up, dw, by, tb):
    def body(carry, jj):
        return step(*carry, tb, jj), ()

    (up, dw, by), _ = jax.jit(lambda c: jax.lax.scan(
        body, c, jnp.arange(T, dtype=jnp.int32)))((up, dw, by))
    return [np.asarray(a) for a in (up, dw, by)]


@pytest.mark.parametrize("T", [1, 7, 40])
def test_sub_op_math_matches_tool_xla(T):
    up, dw, by, tb = fresh(2 * 4, 100 + T)
    want = jax_scan(TOOL._sub_op_math, T, *(jnp.asarray(a)
                                            for a in (up, dw, by, tb)))
    got = subop_bench.run_plain(*(torch.as_tensor(a)
                                  for a in (up, dw, by, tb)), T)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))
    # the state really moved: primaries and companions were stored
    assert not np.array_equal(want[0], up)
    # on a CPU tensor the kernel's wrapper runs the plain loop
    wrapped = subop_bench.run_kernel(*(torch.as_tensor(a)
                                       for a in (up, dw, by, tb)), T)
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T", [1, 7, 40])
def test_sub_op_math_int_matches_tool_xla_i16(T):
    """The int16-carry variant: int16 state between sub-ops, int32 math."""
    up, dw, by, tb = fresh(2 * 4, 200 + T)
    tb16 = (jnp.asarray(tb) * 40.0).astype(jnp.int16).astype(jnp.int32)

    def step(u, d, b, _tb, jj):
        out = TOOL._sub_op_math_int(u.astype(jnp.int32), d.astype(jnp.int32),
                                    b.astype(jnp.int32), tb16, jj)
        return tuple(x.astype(jnp.int16) for x in out)

    init = [(jnp.asarray(a) * 40.0).astype(jnp.int16) for a in (up, dw, by)]
    want = jax_scan(step, T, *init, None)
    got = subop_bench.run_plain_i16(*(torch.as_tensor(a)
                                      for a in (up, dw, by, tb)), T)
    for g, w in zip(got, want):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), w)


def test_nonce_wraps_like_int32():
    """The hash wraps in int32 in JAX; the low 16 bits agree."""
    jj = 4000  # jj * 507279793 overflows int32
    iota = jnp.arange(256, dtype=jnp.int32)
    want = np.asarray((jnp.int32(jj) * 507279793 + iota * 40503) & 0xffff)
    got = subop_bench.nonce_bits(jj, "cpu").numpy()
    assert np.array_equal(got, want)


def test_bench_cli_on_cpu(tmp_path, capsys):
    """The benchmark entry point at a tiny size on the CPU: one JSON line
    per point and per fit, equal states across the float variants, and the
    `kernel` variant refused on the CPU (it never times the plain loop in
    the kernel's place)."""
    out = str(tmp_path / "bench.jsonl")
    bench_subop.main(["--device", "cpu", "--B", "2", "--K", "2", "--ts",
                      "2,5", "--variants", "plain,plain_i16", "--out", out])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    points = [r for r in lines if "T" in r]
    fits = [r for r in lines if r.get("fit")]
    assert {(r["variant"], r["T"]) for r in points} == {
        ("plain", 2), ("plain", 5), ("plain_i16", 2), ("plain_i16", 5)}
    assert all(r["device"] == "cpu" and r["best_s"] > 0 for r in points)
    assert {r["variant"] for r in fits} == {"plain", "plain_i16"}
    assert [json.loads(x) for x in open(out)] == lines
    with pytest.raises(SystemExit):
        bench_subop.main(["--device", "cpu", "--variants", "kernel"])
    assert "CUDA" in capsys.readouterr().err


def test_kernel_wrapper_refuses_devices_without_a_kernel():
    """No fallback: off the CPU the wrapper launches kernel C or raises
    (the meta device has no kernel)."""
    meta = [torch.empty((4, 256), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel"):
        subop_bench.run_kernel(*meta, 3)
