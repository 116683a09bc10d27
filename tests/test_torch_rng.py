"""The port's threefry keys (opendrift_tpu_torch/rng.py) against jax.random.

Tolerances: keys, ``fold_in`` and ``bits`` are integer hashes and must be
bit-equal to ``jax.random`` under ``jax_threefry_partitionable=True``
(set by conftest.py).  ``uniform`` is exact: the same 23 mantissa bits,
with XLA's fused multiply-add reproduced in float64.  ``normal`` evaluates
XLA's float32 inverse error function on the same uniforms; ``log1p`` may
differ by an ulp between the libraries, which moves a normal by at most
a few ulp (3 measured): normals are held at 4 ulp of their magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu_torch import rng


def _jkey(key):
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5, 2 ** 32 + 7, -3])
def test_prngkey_and_fold_in_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    assert _jkey(jk) == tuple(tk)
    for data in (0, 1, 987654, 2 ** 31 + 5):
        assert _jkey(jax.random.fold_in(jk, data)) == \
            tuple(rng.fold_in(tk, data))
    # the engine's nesting: interval, step, use
    jn = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jk, 3),
                                               7), 1)
    tn = rng.fold_in(rng.fold_in(rng.fold_in(tk, 3), 7), 1)
    assert _jkey(jn) == tuple(tn)


@pytest.mark.parametrize("shape", [(), (1,), (5,), (2, 37)])
def test_bits_bit_equal(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tk = rng.fold_in(rng.PRNGKey(11), 4)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    got = rng.bits(tk, shape, device="cpu")
    if shape == ():
        assert got == int(want)
    else:
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_uniform_exact():
    jk = jax.random.PRNGKey(5)
    tk = rng.PRNGKey(5)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-1.0, 2.5)):
        want = np.asarray(jax.random.uniform(jk, (4099,), minval=lo,
                                             maxval=hi))
        got = rng.uniform(tk, (4099,), lo, hi, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_normal_within_ulps():
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 9)
    tk = rng.fold_in(rng.PRNGKey(2), 9)
    want = np.asarray(jax.random.normal(jk, (2, 5000)))
    got = rng.normal(tk, (2, 5000), device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 4.0, ulps.max()
