"""The rules beyond BRIDGE-T, BRIDGE-M and DGD — ``krum`` (BRIDGE-K), ``bulyan``
(BRIDGE-B), ``geomedian``, ``clipped_mean``, ``rep_trimmed_mean``,
``rep_median`` — and the dense ``mean``'s folded divisor, in
`repro_torch.core.screening`, against `repro.core.screening` on the CPU.

Inputs are made with numpy from a seed.  Two reference programs:
* the trainer's form: ``screen_all_banked`` (dense) or
  ``screen_views_banked(table.gather_rows(w), table.valid_dev, ...)``
  (sparse) under ``jax.jit`` with the adjacency or table closed over and
  ``b`` an operand, as `repro.core.bridge` builds it; held against the
  port's `screen_all` / `screen_gathered`;
* the operand form: ``screen_views_banked`` with views, mask and ``b`` as
  operands; held against the port's `screen_views`.

Tolerances, stated per comparison:
* ``mean``, ``rep_trimmed_mean``, ``rep_median``: exact (NaN-aware ``==``,
  under which +0 == -0), on edge-case payloads (NaN, +-inf, 1e30, ties);
* ``krum``, ``bulyan``: exact, on an honest cluster with far outliers,
  where every node's winning Krum score beats the runner-up by more than
  twice the float32 bound on a score (the sum of its distances' bounds
  ``4 d 2^-24 (sq_i + sq_j)``, `test_torch_krum.py`): Krum copies a row,
  and Bulyan's trimmed mean over the same selection is the reference's
  exactly.  On random inputs the picks are compared at the nodes outside
  that gap; the count inside it is printed;
* ``geomedian``, ``clipped_mean``: ``4 eps max|x|`` per node (eps the
  float32 machine epsilon, ``max|x|`` over the node's rows and itself).
  Their squared norms are ``torch.sum`` over d (XLA sums in another
  order) and XLA evaluates ``a / sqrt(s)`` as ``a * rsqrt(s)`` with its own
  approximation (87.7% correctly rounded on 4e5 CPU samples,
  ``tools/xla_divisor_forms.py``); well inside the bound here;
* the port's dense and sparse ``krum`` and ``bulyan``: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import screening as jscreening
from repro.core.neighbors import NeighborTable as JTable
from repro_torch.core import neighbors, screening
from test_torch_kernels import edge_inputs, nan_equal

EPS32 = float(np.finfo(np.float32).eps)
U32 = 2.0 ** -24
NEW_RULES = ("krum", "bulyan", "geomedian", "clipped_mean", "rep_trimmed_mean", "rep_median")
EXACT_RULES = ("mean", "rep_trimmed_mean", "rep_median")


@functools.cache
def _dense_program(rule, adj_bytes, n):
    adj = jnp.asarray(np.frombuffer(adj_bytes, bool).reshape(n, n))
    return jax.jit(lambda w, sv, b: jscreening.screen_all_banked(w, adj, (rule,), 0, b, self_vals=sv))


def jax_dense(rule, w, adj, b, self_vals=None):
    """The reference trainer's dense screen: adjacency closed over."""
    sv = w if self_vals is None else self_vals
    fn = _dense_program(rule, np.ascontiguousarray(adj).tobytes(), adj.shape[0])
    return np.asarray(fn(jnp.asarray(w), jnp.asarray(sv), jnp.int32(b)))


def jax_sparse(rule, w, adj, b, self_vals=None):
    """The reference trainer's sparse screen: the table closed over."""
    jt = JTable.from_adjacency(adj)
    sv = w if self_vals is None else self_vals
    fn = jax.jit(lambda w_, s_, b_: jscreening.screen_views_banked(
        jt.gather_rows(w_), jt.valid_dev, s_, (rule,), 0, b_))
    return np.asarray(fn(jnp.asarray(w), jnp.asarray(sv), jnp.int32(b)))


def jax_views(rule, views, mask, self_vals, b):
    fn = jax.jit(lambda v, m, s, b_: jscreening.screen_views_banked(v, m, s, (rule,), 0, b_))
    return np.asarray(fn(jnp.asarray(views), jnp.asarray(mask), jnp.asarray(self_vals),
                         jnp.int32(b)))


def port_dense(rule, w, adj, b, self_vals=None):
    sv = None if self_vals is None else torch.from_numpy(self_vals)
    return screening.screen_all(torch.from_numpy(w), torch.from_numpy(adj), rule=rule, b=b,
                                self_vals=sv).numpy()


def port_sparse(rule, w, adj, b, self_vals=None, widen=0):
    table = neighbors.NeighborTable.from_adjacency(adj, k=int(adj.sum(1).max()) + widen,
                                                   device="cpu")
    sv = None if self_vals is None else torch.from_numpy(self_vals)
    return screening.screen_gathered(torch.from_numpy(w), table, rule=rule, b=b,
                                     self_vals=sv).numpy()


def cluster_inputs(n, d, seed, outliers=3):
    """An honest cluster around 0 and ``outliers`` far rows, on a graph
    dense enough for Bulyan at b = 2 (min in-degree >= 9)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, d)).astype(np.float32)
    w[:outliers] = 100.0 * rng.normal(size=(outliers, d)).astype(np.float32) + 50.0
    adj = rng.random((n, n)) < 0.85
    np.fill_diagonal(adj, False)
    return w, adj


def per_node_scale(x_rows, adj, self_vals):
    """max |x| over each node's in-neighbors and itself."""
    return np.array([max(np.abs(x_rows[adj[j]]).max(initial=0.0), np.abs(self_vals[j]).max())
                     for j in range(adj.shape[0])])


def assert_close_rule(got, want, w, adj, self_vals):
    finite = np.isfinite(got) & np.isfinite(want)
    assert nan_equal(got[~finite], want[~finite]).all()
    tol = 4 * EPS32 * per_node_scale(w, adj, self_vals)[:, None]
    err = np.abs(got - want)
    assert (err[finite] <= np.broadcast_to(tol, got.shape)[finite]).all(), \
        f"max err/tol {np.max(err[finite] / np.broadcast_to(tol, got.shape)[finite])}"


def check_rule(rule, got, want, w, adj, self_vals):
    if rule in ("geomedian", "clipped_mean"):
        assert_close_rule(got, want, w, adj, self_vals)
    else:
        bad = ~nan_equal(got, want)
        assert not bad.any(), f"{int(bad.sum())} of {bad.size} entries differ"


def rule_inputs(rule, n, d, seed):
    if rule in ("krum", "bulyan"):
        return cluster_inputs(n, d, seed)
    if rule in EXACT_RULES:
        return edge_inputs(n, d, seed)
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0, size=(n, 1))).astype(np.float32)
    w[:2] *= 30.0
    adj = rng.random((n, n)) < 0.6
    np.fill_diagonal(adj, False)
    return w, adj


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", [12, 20])
@pytest.mark.parametrize("rule", NEW_RULES + ("mean",))
def test_dense_vs_reference_trainer_form(rule, n, b):
    w, adj = rule_inputs(rule, n, 40, seed=7 * n + b)
    check_rule(rule, port_dense(rule, w, adj, b), jax_dense(rule, w, adj, b), w, adj, w)


@pytest.mark.parametrize("rule", NEW_RULES + ("mean",))
def test_dense_self_vals_separate(rule):
    """``self_vals`` distinct from the screened rows (the codec path): for
    Krum and Bulyan the distances then run over ``cat([w, self_vals])``."""
    n, b = 16, 2
    w, adj = rule_inputs(rule, n, 40, seed=5)
    sv = (w + np.random.default_rng(6).normal(size=w.shape).astype(np.float32) * 0.01)
    check_rule(rule, port_dense(rule, w, adj, b, sv), jax_dense(rule, w, adj, b, sv), w, adj, sv)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("rule", NEW_RULES + ("mean",))
def test_sparse_vs_reference_trainer_form(rule, b):
    w, adj = rule_inputs(rule, 20, 40, seed=3 + b)
    for widen in (0, 3):
        check_rule(rule, port_sparse(rule, w, adj, b, widen=widen), jax_sparse(rule, w, adj, b),
                   w, adj, w)


@pytest.mark.parametrize("rule", NEW_RULES + ("mean",))
def test_views_vs_reference_operand_form(rule):
    b = 2
    w, adj = rule_inputs(rule, 20, 40, seed=11)
    jt = JTable.from_adjacency(adj)
    views = np.array(jt.gather_rows(jnp.asarray(w)))
    got = screening.screen_views(torch.from_numpy(views), torch.from_numpy(jt.valid),
                                 torch.from_numpy(w), rule=rule, b=b).numpy()
    check_rule(rule, got, jax_views(rule, views, jt.valid, w, b), w, adj, w)


@pytest.mark.parametrize("self_mode", ["broadcast", "separate"])
@pytest.mark.parametrize("rule", ["krum", "bulyan"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_dense_sparse_bitwise(rule, seed, self_mode):
    """One distance matrix per tick, gathered per node on both layouts:
    the dense and the sparse BRIDGE-K / BRIDGE-B agree bit for bit, on
    random inputs too (where the picks may differ from the reference's)."""
    rng = np.random.default_rng(seed)
    n = 24
    w = rng.normal(size=(n, 40)).astype(np.float32)
    adj = rng.random((n, n)) < 0.7
    np.fill_diagonal(adj, False)
    sv = None if self_mode == "broadcast" else w + np.float32(0.01) * rng.normal(
        size=w.shape).astype(np.float32)
    dense = port_dense(rule, w, adj, 2, sv)
    for widen in (0, 4):
        np.testing.assert_array_equal(port_sparse(rule, w, adj, 2, sv, widen=widen), dense)


def krum_gaps(w, adj, b):
    """Per node: the reference's Krum pick, the gap between its score and
    the runner-up's, and twice the larger of the two scores' float32 bounds
    (each the sum of its taken distances' bounds)."""
    n, d = w.shape
    picks, gaps, bounds = [], [], []
    x64 = w.astype(np.float64)
    sq = np.sum(x64 * x64, axis=1)
    for j in range(n):
        d2, fm = jscreening.pairwise_sq_dists(jnp.asarray(w), jnp.asarray(adj[j]), jnp.asarray(w[j]))
        count = int(adj[j].sum())
        k = max(count - b - 2, 1)
        scores = np.asarray(jscreening._krum_scores(d2, fm, jnp.int32(count), b))[:-1]
        scores = np.where(adj[j], scores, np.inf)
        order = np.argsort(scores, kind="stable")
        idx = np.append(np.arange(n), j)  # rows of node j's matrix: the n rows, then self
        dm = np.where(np.eye(n + 1, dtype=bool), np.inf, np.asarray(d2))
        entry = 4.0 * d * U32 * (sq[idx][:, None] + sq[idx][None, :])

        def score_bound(i):
            return entry[i, np.argsort(dm[i], kind="stable")[:k]].sum()

        picks.append(int(order[0]))
        gaps.append(scores[order[1]] - scores[order[0]])
        bounds.append(2.0 * max(score_bound(order[0]), score_bound(order[1])))
    return np.array(picks), np.array(gaps), np.array(bounds)


@pytest.mark.parametrize("inputs", ["cluster", "random"])
def test_krum_picks_outside_the_rounding_gap(inputs):
    n, b = 30, 2
    if inputs == "cluster":
        w, adj = cluster_inputs(n, 64, seed=4)
    else:
        rng = np.random.default_rng(4)
        w = rng.normal(size=(n, 64)).astype(np.float32)
        adj = rng.random((n, n)) < 0.7
        np.fill_diagonal(adj, False)
    picks, gaps, bounds = krum_gaps(w, adj, b)
    outside = gaps > bounds
    got = port_dense("krum", w, adj, b)
    for j in np.nonzero(outside)[0]:
        np.testing.assert_array_equal(got[j], w[picks[j]])
    print(f"krum {inputs}: {int((~outside).sum())} of {n} picks inside twice the rounding bound")
    if inputs == "cluster":
        assert outside.all()


@pytest.mark.parametrize("rule", ["rep_trimmed_mean", "rep_median"])
def test_rep_rules_with_weights(rule):
    """The ``weights`` operand of the rep rules (dyadic weights, so every
    weighted sum is exact) against the reference's rule under ``vmap``."""
    n, b = 14, 2
    w, adj = edge_inputs(n, 40, seed=21)
    wts = np.random.default_rng(22).choice([0.0, 0.25, 0.5, 1.0], size=(n, n)).astype(np.float32)
    fn = getattr(jscreening, rule)
    want = np.asarray(jax.jit(jax.vmap(lambda m, s, wt: fn(jnp.asarray(w), m, s, b, weights=wt)))(
        jnp.asarray(adj), jnp.asarray(w), jnp.asarray(wts)))
    port_fn = getattr(screening, rule)
    args = (torch.from_numpy(w)[None], torch.from_numpy(adj), torch.from_numpy(w))
    got = (port_fn(*args, b, weights=torch.from_numpy(wts)) if rule == "rep_trimmed_mean"
           else port_fn(*args, weights=torch.from_numpy(wts))).numpy()
    assert nan_equal(got, want).all()


def test_dense_mean_matches_trainer_program_bitwise():
    """The reference trainer closes over the adjacency, so XLA multiplies
    by the reciprocal of ``count + 1`` (a division matches it on only 72.3%
    of coordinates here, ``tools/xla_divisor_forms.py``); the port's dense
    ``mean`` does too, and equals the sparse ``mean`` bit for bit."""
    topo = jgraph.erdos_renyi(50, 0.5, 4, seed=0)
    w = np.random.default_rng(0).normal(size=(50, 7850)).astype(np.float32)
    want = jax_dense("mean", w, topo.adjacency, 4)
    got = port_dense("mean", w, topo.adjacency, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_sparse("mean", w, topo.adjacency, 4), got)


def test_sparse_vector_graph_meets_bulyan_bound():
    """``chip_smoke.py``'s sparse BRIDGE-K / BRIDGE-B graph,
    ``small_world(512, 8, 2)``, has in-degrees 12-20 (a K = 20 table) and
    meets Bulyan's bound of 9 at b = 2; the BRIDGE-T / BRIDGE-M graph,
    ``small_world(512, 6, 2)`` (minimum 8), does not, and the reference
    refuses it too."""
    kb = jgraph.small_world(512, 8, 2, rewire_prob=0.2, seed=0)
    assert (kb.in_degrees.min(), kb.in_degrees.max()) == (12, 20)
    kb.validate_for_rule("bulyan")
    tm = jgraph.small_world(512, 6, 2, rewire_prob=0.2, seed=0)
    assert tm.in_degrees.min() == 8
    with pytest.raises(ValueError):
        tm.validate_for_rule("bulyan")
