"""The port's screening (`repro_torch.core.screening`, the plain PyTorch
versions of the kernels) against the reference on the CPU.

Inputs are made with numpy from a seed and go through both packages.  The
reference is ``repro.core.screening.screen_all_banked`` under ``jax.jit``
with the adjacency and ``b`` as operands (``self_vals`` is the broadcast
itself), which for BRIDGE-T and BRIDGE-M is the program the reference
trainer runs (its ``b`` is an operand).  For ``mean``, whose divisor
depends on the adjacency alone, the reference trainer closes over the
adjacency and XLA multiplies by the reciprocal of ``count + 1``; the
reference here is that closed-over program, as the port's dense ``mean``
is.

Tolerances, stated per comparison:
* up to 64 rows, exact (NaN-aware ``==``, under which +0 == -0): the
  reference sums kept ranks left to right and so does the port;
* above 64 rows the reference sums with ``jnp.sum`` and the port with
  ``torch.sum``: the float32 summation bound
  ``2 n eps (count + 1) max|x| / den`` per coordinate, exact where non-finite;
  the median has no sum and stays exact;
* against the Pallas kernels (interpret mode, as ``tests/test_kernels.py``
  runs them): the median exactly; the trimmed mean within rtol 1e-6,
  atol 1e-6 * max|v|, because the Pallas kernel drops extremes one at a time
  and sums survivors in row order rather than rank order;
* against ``kernels/ref.py::trimmed_mean_ref`` (unclamped trim) only at
  nodes with count >= 2b + 1, within the same tolerance (it sums with
  ``jnp.sum``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import screening as jscreening
from repro.kernels import ref as jref
from repro.kernels.median import median_pallas
from repro.kernels.trimmed_mean import trimmed_mean_pallas
from repro_torch.core import screening
from repro_torch.kernels import ref
from test_torch_kernels import edge_inputs, nan_equal

RULES = ("trimmed_mean", "median", "mean")
D = 40
EPS32 = float(np.finfo(np.float32).eps)


@jax.jit
def _jax_screen_tm(w, adj, b):
    return jscreening.screen_all_banked(w, adj, ("trimmed_mean",), 0, b, chunk=1 << 20, self_vals=w)


@jax.jit
def _jax_screen_median(w, adj, b):
    return jscreening.screen_all_banked(w, adj, ("median",), 0, b, chunk=1 << 20, self_vals=w)


def _jax_screen_mean(w, adj, b):
    """The trainer's form: the adjacency closed over."""
    fn = jax.jit(lambda w_, b_: jscreening.screen_all_banked(
        w_, jnp.asarray(adj), ("mean",), 0, b_, chunk=1 << 20, self_vals=w_))
    return fn(w, b)


JAX_SCREEN = {"trimmed_mean": _jax_screen_tm, "median": _jax_screen_median, "mean": _jax_screen_mean}


def jax_screen(rule, w, adj, b):
    adj = adj if rule == "mean" else jnp.asarray(adj)
    return np.asarray(JAX_SCREEN[rule](jnp.asarray(w), adj, jnp.asarray(b, jnp.int32)))


def port_screen(rule, w, adj, b, self_vals=None):
    sv = None if self_vals is None else torch.from_numpy(self_vals)
    return screening.screen_all(torch.from_numpy(w), torch.from_numpy(adj), rule=rule, b=b,
                                self_vals=sv).numpy()


@pytest.mark.parametrize("b", [0, 1, 2, 4])
@pytest.mark.parametrize("n", [5, 12, 20, 50])
@pytest.mark.parametrize("rule", RULES)
def test_screen_all_bit_exact(rule, n, b):
    w, adj = edge_inputs(n, D, seed=100 * n + b)
    got = port_screen(rule, w, adj, b)
    want = jax_screen(rule, w, adj, b)
    bad = ~nan_equal(got, want)
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} entries differ"


def summation_bound(w, adj, b):
    """Per-entry float32 bound on the difference of two summation orders
    of the kept ranks plus self, after the division."""
    count = adj.sum(axis=1).astype(np.float64)
    b_eff = np.minimum(b, np.maximum((count - 1) // 2, 0))
    den = count - 2 * b_eff + 1
    finite = np.where(np.isfinite(w), np.abs(w), 0.0)
    colmax = finite.max(axis=0)[None, :]
    return 2.0 * w.shape[0] * EPS32 * colmax * (count[:, None] + 1.0) / den[:, None]


@pytest.mark.parametrize("b", [0, 1, 2, 4])
@pytest.mark.parametrize("n", [100, 129, 200])
@pytest.mark.parametrize("rule", RULES)
def test_screen_all_above_64_rows(rule, n, b):
    """Above 64 rows, and above the card's register networks (128 rows),
    where the card screens through its wide path."""
    w, adj = edge_inputs(n, D, seed=7 + b if n == 100 else n + b)
    got = port_screen(rule, w, adj, b)
    want = jax_screen(rule, w, adj, b)
    if rule == "median":
        assert nan_equal(got, want).all()
        return
    if rule == "mean":  # mean keeps every row: divisor count + 1
        b = 0
    finite = np.isfinite(got) & np.isfinite(want)
    assert nan_equal(got[~finite], want[~finite]).all()
    tol = summation_bound(w, adj, b)
    assert (np.abs(got[finite] - want[finite]) <= tol[finite]).all()


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_self_vals_separate_from_broadcast(rule):
    """``self_vals`` distinct from the screened matrix (the reference's
    codec path): the trimmed mean adds it unsanitized, the median ranks it
    sanitized."""
    n, b = 12, 2
    w, adj = edge_inputs(n, D, seed=3)
    sv = np.random.default_rng(4).normal(size=(n, D)).astype(np.float32)
    sv[0, :3] = [np.nan, np.inf, -np.inf]
    got = port_screen(rule, w, adj, b, self_vals=sv)
    want = np.asarray(jax.jit(
        lambda w_, a_, s_: jscreening.screen_all_banked(w_, a_, (rule,), 0, b, self_vals=s_))(
        jnp.asarray(w), jnp.asarray(adj), jnp.asarray(sv)))
    assert nan_equal(got, want).all()


def stacked_views(w, adj):
    """The Pallas kernels' operands: every node's ``[n, d]`` view of the
    broadcast and its ``[n]`` mask."""
    n = w.shape[0]
    return np.broadcast_to(w, (n,) + w.shape).copy(), adj


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("n", [5, 12])
def test_trimmed_mean_vs_pallas(n, b):
    w, adj = edge_inputs(n, D, seed=11 * n + b)
    views, mask = stacked_views(w, adj)
    want = np.asarray(trimmed_mean_pallas(jnp.asarray(views), jnp.asarray(mask), jnp.asarray(w), b,
                                          block_d=128, interpret=True))
    got = port_screen("trimmed_mean", w, adj, b)
    finite = np.isfinite(got) & np.isfinite(want)
    assert nan_equal(got[~finite], want[~finite]).all()
    vmax = float(np.max(np.where(np.isfinite(w), np.abs(w), 0.0)))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6 * vmax)


@pytest.mark.parametrize("n", [5, 12])
def test_median_vs_pallas(n):
    w, adj = edge_inputs(n, D, seed=13 * n)
    views = np.concatenate([np.broadcast_to(w, (n,) + w.shape), w[:, None, :]], axis=1)
    mask = np.concatenate([adj, np.ones((n, 1), bool)], axis=1)
    want = np.asarray(median_pallas(jnp.asarray(views), jnp.asarray(mask), block_d=128,
                                    interpret=True))
    got = port_screen("median", w, adj, 0)
    assert nan_equal(got, want).all()


@pytest.mark.parametrize("b", [1, 2])
def test_trimmed_mean_vs_kernel_oracle(b):
    """``trimmed_mean_ref`` does not clamp b: compare where count >= 2b + 1."""
    n = 12
    w, adj = edge_inputs(n, D, seed=17 + b)
    views, mask = stacked_views(w, adj)
    want = np.asarray(jref.trimmed_mean_ref(jnp.asarray(views), jnp.asarray(mask), jnp.asarray(w), b))
    got = port_screen("trimmed_mean", w, adj, b)
    ok_rows = adj.sum(axis=1) >= 2 * b + 1
    assert ok_rows.sum() >= 3
    g, e = got[ok_rows], want[ok_rows]
    finite = np.isfinite(g) & np.isfinite(e)
    assert nan_equal(g[~finite], e[~finite]).all()
    vmax = float(np.max(np.where(np.isfinite(w), np.abs(w), 0.0)))
    np.testing.assert_allclose(g[finite], e[finite], rtol=1e-6, atol=1e-6 * vmax)


def test_effective_trim_matches_reference():
    count = np.arange(0, 20)
    for b in range(0, 6):
        want = np.asarray(jscreening.effective_trim(b, jnp.asarray(count)))
        got = ref.effective_trim(b, torch.as_tensor(count)).numpy()
        np.testing.assert_array_equal(got, want)


def test_min_neighbors_match_reference():
    assert set(screening.RULES) == set(jscreening.RULES)
    for rule in screening.RULES:
        for b in range(6):
            assert screening.min_neighbors(rule, b) == jscreening.min_neighbors(rule, b)
    with pytest.raises(ValueError):
        screening.min_neighbors("nope", 1)
    with pytest.raises(ValueError):
        screening.screen_all(torch.zeros(3, 4), torch.zeros(3, 3, dtype=torch.bool), rule="nope", b=0)
