"""Row 4 of the kernel table: the pairwise squared distances of BRIDGE-K and
BRIDGE-B (`repro_torch.kernels.ref.pairwise_sq_dists`, the plain version,
and `repro_torch.kernels.pairwise`, the wrapper of ``csrc/pairwise.cu``)
against the reference on the CPU.

Inputs are made with numpy from a seed: normal rows, with a NaN row, a
+inf and a -inf entry, and a 1e30 row where stated.

Tolerances, stated per comparison:
* against ``repro.kernels.ref.pairwise_sq_dists_ref`` and
  ``pairwise_sq_dists_pallas(..., interpret=True)``: the float32
  dot-product bound ``4 d 2^-24 (sq_i + sq_j)`` per finite entry (each of
  the two Grams is within ``d 2^-24`` of the exact one, relative to
  ``|x_i| |x_j|``, and ``2 |x_i| |x_j| <= sq_i + sq_j``), the norms taken
  in float64; the measured maximum is far below it.  Non-finite entries
  (NaN, inf) sit at the same places;
* symmetry and the zero diagonal: exact (``d2 == d2.T``, ``d2_ii == 0``
  for finite rows);
* the kernel against the plain version on the card: the same bound, exact
  symmetry and zero diagonal, the same NaN/inf pattern, in
  ``test_torch_kernels.py`` (``cuda``-marked), which imports no JAX, as
  the card's machine has none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.krum import pairwise_sq_dists_pallas
from repro_torch.kernels import ops, pairwise, ref
from test_torch_kernels import check_within_bound, dist_rows


@pytest.mark.parametrize("d", [100, 700])
@pytest.mark.parametrize("n", [5, 17, 33])
def test_plain_vs_reference_oracle(n, d):
    x = dist_rows(n, d, seed=n + d)
    got = ref.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.pairwise_sq_dists_ref(jnp.asarray(x)))
    ratio = check_within_bound(got, want, x)
    assert ratio < 0.05  # measured: a few thousandths of the bound


@pytest.mark.parametrize("d", [100, 700])
@pytest.mark.parametrize("n", [5, 17, 33])
def test_plain_vs_pallas_interpret(n, d):
    x = dist_rows(n, d, seed=2 * n + d)
    got = ref.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    want = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(x), block_d=256, interpret=True))
    check_within_bound(got, want, x)


@pytest.mark.parametrize("n", [5, 17, 33, 70])
def test_plain_symmetric_with_zero_diagonal(n):
    x = dist_rows(n, 300, seed=n)
    x[4] = 1e30  # its squared norm overflows: inf and NaN entries, still symmetric
    d2 = ref.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(d2, d2.T)
    finite_rows = np.isfinite(x).all(axis=1) & (np.abs(x).max(axis=1) < 1e18)
    assert (np.diagonal(d2)[finite_rows] == 0.0).all()
    assert finite_rows.sum() >= n - 4


def test_plain_clamp_keeps_nan_like_jnp_maximum():
    """``where(v < 0, 0, v)``: negatives (cancellation) become +0 and NaN
    stays NaN, as ``jnp.maximum(v, 0)`` does."""
    v = np.array([-1e-7, -0.0, 0.0, 3.5, np.nan, np.inf, -np.inf], np.float32)
    want = np.asarray(jnp.maximum(jnp.asarray(v), 0.0))
    tv = torch.from_numpy(v)
    got = torch.where(tv < 0, 0.0, tv).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    x = np.zeros((3, 4), np.float32)
    x[1, 0] = np.nan
    d2 = ref.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    assert np.isnan(d2[1]).all() and np.isnan(d2[:, 1]).all()
    assert d2[0, 2] == 0.0 and d2[2, 0] == 0.0


def test_batched_plain_equals_per_node():
    x = dist_rows(6, 50, seed=3, special=False)
    stacked = np.stack([x, x[::-1].copy()])
    got = ref.pairwise_sq_dists(torch.from_numpy(stacked)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], ref.pairwise_sq_dists(torch.from_numpy(stacked[i])).numpy())


@pytest.mark.parametrize("n,d", [(50, 7850), (100, 7850), (512, 7850), (5, 100), (3, 33)])
def test_split_plan_covers_the_coordinates(n, d):
    plan = pairwise.split_plan(n, d)
    assert plan.split_len % pairwise.CHUNK == 0
    # the least whole-stage split length whose splits together cover d
    assert d <= plan.splits * plan.split_len
    assert plan.split_len - pairwise.CHUNK < -(-d // plan.splits)
    assert plan.rows_per_thread in pairwise.ROWS_PER_THREAD
    assert 1 <= plan.cluster <= pairwise.MAX_CLUSTER and plan.splits == pairwise.UNITS * plan.cluster
    assert pairwise.smem_bytes(plan) <= 227 * 1024  # a block's shared-memory limit
    pairwise.check_plan(plan, n, d)


@pytest.mark.parametrize("n,d", [(1, 1), (20, 7850), (50, 7850), (100, 7850), (512, 7850),
                                 (64, 999), (130, 1000), (512, 777), (4096, 300), (32768, 16)])
def test_split_plan_is_a_function_of_the_shape(n, d):
    """The plan (and so the summation order) depends on [n, d] alone: the
    same from a fresh computation, and every candidate within the limits."""
    plan = pairwise.split_plan(n, d)
    fresh = min(pairwise.candidates(n, d), key=lambda p: pairwise.cost(p, n))
    assert plan == fresh
    for cand in pairwise.candidates(n, d):
        pairwise.check_plan(cand, n, d)
        assert pairwise.smem_bytes(cand) <= 227 * 1024


@pytest.mark.parametrize("n,d", [(0, 10), (pairwise.MAX_ROWS + 1, 10), (5, 0),
                                 (5, pairwise.MAX_COORDS + 1)])
def test_split_plan_raises_outside_its_limits(n, d):
    with pytest.raises(ValueError):
        pairwise.split_plan(n, d)


@pytest.mark.parametrize("bad", [dict(rows_per_thread=5), dict(rows_per_thread=16), dict(cluster=0),
                                 dict(cluster=pairwise.MAX_CLUSTER + 1), dict(split_len=24),
                                 dict(split_len=16), dict(split_len=16000)])
def test_check_plan_refuses_plans_the_kernel_does_not_take(bad):
    """R, G and C outside their limits, a split that is not the least
    multiple of the 16-coordinate stage that covers d over the splits."""
    base = pairwise.split_plan(512, 7850)
    plan = pairwise.Plan(**{**base.__dict__, **bad})
    with pytest.raises(ValueError):
        pairwise.check_plan(plan, 512, 7850)


def test_cpu_wrapper_runs_plain_version_without_launching():
    x = torch.from_numpy(dist_rows(9, 64, seed=1))
    before = pairwise.pairwise_sq_dists.launches
    out = ops.pairwise_sq_dists(x)
    want = ref.pairwise_sq_dists(x)
    assert ((out == want) | (out.isnan() & want.isnan())).all()
    assert pairwise.pairwise_sq_dists.launches == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "empty", "contiguous"])
def test_wrapper_rejects_bad_operands(bad):
    x = {"dtype": torch.zeros(4, 8, dtype=torch.float64), "ndim": torch.zeros(2, 4, 8),
         "empty": torch.zeros(0, 8), "contiguous": torch.zeros(8, 4).t()}[bad]
    with pytest.raises((TypeError, ValueError)):
        pairwise.pairwise_sq_dists(x)
