"""The port's Threefry streams (`repro_torch.prng`) against ``jax.random``
on the CPU, under the reference's ``jax_threefry_partitionable=True``.

Tolerances, stated per comparison:
* keys, splits, fold-ins, raw bits and uniforms: exact;
* ``normal``: within a relative 5.8e-6 (``torch.erfinv`` in place of
  XLA's float32 polynomial; measured maximum 5.78e-6 over 24M draws, equal
  on 41% of them);
* the model init: a relative 5.9e-6 (normal's 5.8e-6 and one more float32
  rounding, of the 0.01 product, 6e-8); the perturbed replicas
  ``w + 0.01 normal`` also 2.5e-7 absolute, normal's largest absolute
  error (2.2e-5) carried through the perturbation, which cancellation in
  the sum can leave larger than the relative bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.models import small as jsmall
from repro_torch import prng
from repro_torch.core import bridge
from repro_torch.models import small

NORMAL_RTOL = 5.8e-6
INIT_RTOL = 5.9e-6
SALTS = (0x6E657430, 0x636D6D30, 0x77697230, 0x61647630, 0x74727530)


def test_reference_runs_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1, 2**31 + 5, 2**32 + 5, -1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split(n):
    for seed in (0, 7, 99):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n), want)


@pytest.mark.parametrize("data", [0, 1, 1234, 2**31 - 1, *SALTS])
def test_fold_in(data):
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(jax.random.fold_in(key, data))
    np.testing.assert_array_equal(prng.fold_in(np.asarray(key), data), want)


def test_known_values():
    key = prng.PRNGKey(7)
    np.testing.assert_array_equal(key, [0, 7])
    np.testing.assert_array_equal(prng.split(key), [[3625411723, 1954958720],
                                                    [195045567, 4062205631]])
    np.testing.assert_array_equal(prng.fold_in(key, 1234), [3399320635, 43968868])


@pytest.mark.parametrize("shape", [(7,), (50, 7850), (12, 62, 128)])
def test_bits_and_uniform(shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 0x636D6D30)
    key = np.asarray(jkey)
    got = prng.bits(key, shape, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    u = prng.uniform(key, shape, "cpu")
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(jkey, shape)))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(prng.uniform(key, shape, "cpu", lo, 1.0).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0)))


@pytest.mark.parametrize("shape", [(7,), (50, 7850), (12, 62, 128)])
def test_normal_within_tolerance(shape):
    for seed in (0, 5):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
        want = np.asarray(jax.random.normal(jkey, shape))
        got = prng.normal(np.asarray(jkey), shape, "cpu").numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
        if got.size > 1000:
            assert (got == want).mean() > 0.4


def test_fma_f32_rounds_once():
    """`fma_f32` against exact rational arithmetic, on products whose float64
    sum would round twice."""
    from fractions import Fraction

    from repro_torch.kernels.ref import fma_f32

    rng = np.random.default_rng(0)
    a = rng.normal(size=4000).astype(np.float32)
    b = (rng.normal(size=4000) * 1e-4).astype(np.float32)
    c = rng.normal(size=4000).astype(np.float32)
    a[:100] = np.float32(1 + 2**-23)
    b[:100] = np.float32(1 + 2**-23)
    c[:100] = np.float32(-1)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, i


def test_init_linear_and_replicate_match_reference():
    jkey = jax.random.PRNGKey(3)
    want = jax.tree_util.tree_map(np.asarray, jsmall.init_linear(jkey))
    got = small.init_linear(np.asarray(jkey), device="cpu")
    np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=INIT_RTOL, atol=0)
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    jrep = jbridge.replicate(jax.tree_util.tree_map(jnp.asarray, want), 12, perturb=0.01, key=jkey)
    rep = bridge.replicate({k: torch.as_tensor(v) for k, v in want.items()}, 12, perturb=0.01,
                           key=np.asarray(jkey))
    for k in ("b", "w"):
        np.testing.assert_allclose(rep[k].numpy(), np.asarray(jrep[k]), rtol=INIT_RTOL, atol=2.5e-7)
    unperturbed = bridge.replicate(got, 4)
    assert all(torch.equal(unperturbed["w"][i], got["w"]) for i in range(4))


def test_draws_follow_the_tensor_device():
    key = prng.PRNGKey(1)
    assert prng.normal(key, (3, 4), "cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        prng.bits(np.zeros(3, np.uint32), (2,), "cpu")
