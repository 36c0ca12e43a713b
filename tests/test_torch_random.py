"""iivision_tpu_torch threefry nonces against jax.random, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu_torch.ops import random as trandom


def test_partitionable_threefry_is_the_reference():
    # the port reproduces the partitionable bit layout (JAX's default)
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1, -5])
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    tk = trandom.prng_key(seed, "cpu")
    assert [int(x) for x in tk] == [int(x) for x in np.asarray(key)]
    data = torch.tensor([0, 1, 7, 4095, 123456, 2 ** 31 - 1])
    got = trandom.fold_in(tk, data)
    for i, d in enumerate(data.tolist()):
        want = np.asarray(jax.random.fold_in(key, d))
        assert [int(got[0][i]), int(got[1][i])] == [int(x) for x in want]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k,j", [(8, 1), (16, 4)])
def test_step_nonces_match_jax(seed, k, j):
    """The encoder's page (32,) and offset (k, 256) nonces for several
    absolute step indices, drawn in one vectorised call."""
    key = jax.random.PRNGKey(seed)
    steps = [0, 1, 2, 37, 999, 18403]
    nonce_p, nonce_o = trandom.step_nonces(
        trandom.prng_key(seed, "cpu"), torch.tensor(steps), k, j)
    assert nonce_p.shape == (len(steps), 32)
    assert nonce_o.shape == (len(steps), j, k, 256)
    assert nonce_p.dtype == nonce_o.dtype == torch.float32
    for i, s in enumerate(steps):
        skey = jax.random.fold_in(key, s)
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(skey, 0), (32,), jnp.float32))
        assert np.array_equal(nonce_p[i].numpy().view(np.uint32),
                              want.view(np.uint32)), s
        for jj in range(j):
            want = np.asarray(jax.random.uniform(
                jax.random.fold_in(skey, 1 + jj), (k, 256), jnp.float32))
            assert np.array_equal(nonce_o[i, jj].numpy().view(np.uint32),
                                  want.view(np.uint32)), (s, jj)

