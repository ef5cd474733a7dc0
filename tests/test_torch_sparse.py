"""The port's sparse ``[M, K]`` layout against the reference on the CPU:
`small_world`, `NeighborTable`, the plain gather screens and
`screen_views` / `screen_gathered`.

Inputs are made with numpy from a seed.  The reference screens through
``screen_views_banked(neighbors.gather_rows(w), valid, self_vals, ...)``
under ``jax.jit``, with the views, the mask and ``b`` as operands.

Tolerances, stated per comparison:
* the graph and the table: ``np.array_equal``;
* the plain gather screens and `screen_views` against
  ``screen_views_banked``: exact (NaN-aware ``==``, under which +0 == -0)
  up to K = 64 — the same sort, the same left-to-right sum; above, the
  median exact and the trimmed mean within the float32 summation bound
  ``2 K eps (count + 1) max|x| / den`` (``jnp.sum`` against ``torch.sum``);
* against ``gather_screen_pallas`` in interpret mode: the median exactly,
  the trimmed mean within rtol 1e-6, atol 1e-6 * max|w| (the Pallas kernel
  sums survivors in row order, not rank order);
* the port's dense and sparse layouts: bit for bit for BRIDGE-T,
  BRIDGE-M and ``mean``, which on both layouts multiplies by the
  reciprocal of the divisor as the reference trainer's program does
  (exact against it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import screening as jscreening
from repro.core.neighbors import NeighborTable as JTable
from repro.core.neighbors import edge_id_grid as jedge_id_grid
from repro.kernels.gather_screen import gather_screen_pallas
from repro_torch.core import graph, neighbors, screening
from repro_torch.kernels import gather_screen, ref
from test_torch_kernels import edge_inputs, nan_equal, sparse_inputs

D = 40


@pytest.fixture(scope="module")
def jax_views_screen():
    fns = {rule: jax.jit(lambda v, m, s, b, r=rule: jscreening.screen_views_banked(
        v, m, s, (r,), 0, b, chunk=1 << 20)) for rule in ("trimmed_mean", "median", "mean")}

    def run(rule, views, mask, self_vals, b):
        return np.asarray(fns[rule](jnp.asarray(views), jnp.asarray(mask), jnp.asarray(self_vals),
                                    jnp.asarray(b, jnp.int32)))

    return run


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,nearest,b", [(40, 3, 1), (64, 4, 2), (512, 6, 2)])
def test_small_world_equal(m, nearest, b, seed):
    want = jgraph.small_world(m, nearest, b, rewire_prob=0.2, seed=seed)
    got = graph.small_world(m, nearest, b, rewire_prob=0.2, seed=seed)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert got.num_byzantine == want.num_byzantine


def test_small_world_checks():
    for args in ((10, 5, 1), (20, 1, 1)):
        with pytest.raises(ValueError):
            graph.small_world(*args)
    with pytest.raises(ValueError):
        graph.small_world(40, 3, 1, max_degree=5)


@pytest.mark.parametrize("widen", [0, 3])
def test_neighbor_table_equal(widen):
    topo = graph.small_world(64, 4, 2, seed=3)
    jt = JTable.from_adjacency(topo.adjacency)
    k = jt.k + widen
    jt = JTable.from_adjacency(topo.adjacency, k=k)
    pt = neighbors.NeighborTable.from_adjacency(topo, k=k, device="cpu")
    assert pt.k == jt.k == k and pt.num_nodes == 64
    np.testing.assert_array_equal(pt.idx, jt.idx)
    np.testing.assert_array_equal(pt.valid, jt.valid)
    np.testing.assert_array_equal(pt.safe_idx.numpy(), np.asarray(jt.safe_idx))
    np.testing.assert_array_equal(pt.valid_dev.numpy(), np.asarray(jt.valid_dev))
    np.testing.assert_array_equal(pt.edge_ids.numpy(), np.asarray(jt.edge_ids))
    np.testing.assert_array_equal(neighbors.edge_id_grid(9), jedge_id_grid(9))
    w = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    np.testing.assert_array_equal(pt.gather_rows(torch.from_numpy(w)).numpy(),
                                  np.asarray(jt.gather_rows(jnp.asarray(w))))
    mask = np.arange(64) % 3 == 0
    np.testing.assert_array_equal(
        pt.gather_senders(torch.from_numpy(mask), fill=False).numpy(),
        np.asarray(jt.gather_senders(jnp.asarray(mask), fill=False)))
    with pytest.raises(ValueError):
        neighbors.NeighborTable.from_adjacency(topo, k=jt.k - widen - 1, device="cpu")


def views_summation_bound(views, valid, self_vals, b):
    """Per-entry float32 bound on two summation orders of the kept ranks of
    K views plus self, after the division (above 64 rows the reference sums
    with ``jnp.sum``, the plain version with ``torch.sum``)."""
    count = valid.sum(axis=1).astype(np.float64)
    b_eff = np.minimum(b, np.maximum((count - 1) // 2, 0))
    den = count - 2 * b_eff + 1
    fin = lambda x: np.where(np.isfinite(x), np.abs(x), 0.0)
    colmax = np.maximum(fin(views).max(axis=(0, 1))[None, :], fin(self_vals))
    eps = float(np.finfo(np.float32).eps)
    return 2.0 * views.shape[1] * eps * colmax * (count[:, None] + 1.0) / den[:, None]


@pytest.mark.parametrize("b", [0, 1, 2, 4])
@pytest.mark.parametrize("k", [3, 8, 16, 40, 63, 64, 100])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_plain_gather_screens_bit_exact(jax_views_screen, rule, k, b):
    """Bit for bit up to K = 64 (the reference's sequential sum); above, the
    median still exact and the trimmed mean within the summation bound.
    K = 64 and 100 are tables the card screens through its wide path."""
    w, adj = sparse_inputs(k, D, seed=10 * k + b)
    jt = JTable.from_adjacency(adj, k=k)
    views = np.array(jt.gather_rows(jnp.asarray(w)))
    sv = np.random.default_rng(k).normal(size=w.shape).astype(np.float32)
    sv[0, :3] = [np.nan, np.inf, -np.inf]
    pt = neighbors.NeighborTable.from_adjacency(adj, k=k, device="cpu")
    tw, tsv = torch.from_numpy(w), torch.from_numpy(sv)
    for self_vals, tself in ((w, tw), (sv, tsv)):
        want = jax_views_screen(rule, views, jt.valid, self_vals, b)
        if rule == "trimmed_mean":
            got = ref.gather_trimmed_mean(tw, pt.safe_idx, pt.valid_dev, tself, b)
        else:
            got = ref.gather_median(tw, pt.safe_idx, pt.valid_dev, tself)
        got_views = screening.screen_views(torch.from_numpy(views), torch.from_numpy(jt.valid), tself,
                                           rule=rule, b=b)
        got_table = screening.screen_gathered(tw, pt, rule=rule, b=b, self_vals=tself)
        for out in (got, got_views, got_table):
            out = out.numpy()
            if rule == "trimmed_mean" and k > ref.MAX_EXACT_ROWS:
                finite = np.isfinite(out) & np.isfinite(want)
                assert nan_equal(out[~finite], want[~finite]).all()
                tol = views_summation_bound(views, jt.valid, self_vals, b)
                assert (np.abs(out[finite] - want[finite]) <= tol[finite]).all()
                continue
            bad = ~nan_equal(out, want)
            assert not bad.any(), f"{int(bad.sum())} of {bad.size} entries differ"


@pytest.mark.parametrize("k", [8, 40])
def test_screen_views_mean_bit_exact(jax_views_screen, k):
    w, adj = sparse_inputs(k, D, seed=k)
    w = np.where(np.isfinite(w), w, 1.0).astype(np.float32)
    jt = JTable.from_adjacency(adj, k=k)
    views = np.array(jt.gather_rows(jnp.asarray(w)))
    want = jax_views_screen("mean", views, jt.valid, w, 0)
    got = screening.screen_views(torch.from_numpy(views), torch.from_numpy(jt.valid),
                                 torch.from_numpy(w), rule="mean", b=0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_mean_matches_trainer_program():
    """The reference trainer closes over the table's mask: XLA folds the
    divisor and multiplies by its reciprocal; `screen_gathered` does so."""
    topo = jgraph.erdos_renyi(12, 0.6, 2, seed=0)
    jt = JTable.from_adjacency(topo.adjacency)
    w = np.random.default_rng(0).normal(size=(12, 7850)).astype(np.float32)
    want = np.asarray(jax.jit(lambda w_, b_: jscreening.screen_views_banked(
        jt.gather_rows(w_), jt.valid_dev, w_, ("mean",), 0, b_))(jnp.asarray(w), jnp.int32(2)))
    pt = neighbors.NeighborTable.from_adjacency(topo, device="cpu")
    got = screening.screen_gathered(torch.from_numpy(w), pt, rule="mean", b=2).numpy()
    np.testing.assert_array_equal(got, want)
    dense = screening.screen_all(torch.from_numpy(w), torch.from_numpy(topo.adjacency),
                                 rule="mean", b=2).numpy()
    np.testing.assert_array_equal(dense, got)


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
@pytest.mark.parametrize("k", [8, 16])
def test_plain_vs_pallas_interpret(rule, k):
    w, adj = sparse_inputs(k, D, seed=3 * k)
    jt = JTable.from_adjacency(adj, k=k)
    want = np.asarray(gather_screen_pallas(jnp.asarray(w), jnp.asarray(jt.idx), jnp.asarray(jt.valid),
                                           jnp.asarray(w), 2, rule=rule, block_d=128,
                                           interpret=True))
    pt = neighbors.NeighborTable.from_adjacency(adj, k=k, device="cpu")
    tw = torch.from_numpy(w)
    if rule == "median":
        got = ref.gather_median(tw, pt.safe_idx, pt.valid_dev, tw).numpy()
        assert nan_equal(got, want).all()
        return
    got = ref.gather_trimmed_mean(tw, pt.safe_idx, pt.valid_dev, tw, 2).numpy()
    finite = np.isfinite(got) & np.isfinite(want)
    assert nan_equal(got[~finite], want[~finite]).all()
    vmax = float(np.max(np.where(np.isfinite(w), np.abs(w), 0.0)))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6 * vmax)


@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "mean"])
@pytest.mark.parametrize("n", [12, 50])
def test_port_dense_sparse_bitwise(rule, n):
    w, adj = edge_inputs(n, D, seed=n + 1)
    tw, tadj = torch.from_numpy(w), torch.from_numpy(adj)
    dense = screening.screen_all(tw, tadj, rule=rule, b=2)
    for widen in (0, 5):
        table = neighbors.NeighborTable.from_adjacency(adj, k=int(adj.sum(1).max()) + widen,
                                                       device="cpu")
        sparse = screening.screen_gathered(tw, table, rule=rule, b=2)
        assert nan_equal(dense.numpy(), sparse.numpy()).all()


def test_cpu_wrappers_run_plain_versions_without_launching():
    w, adj = sparse_inputs(8, D, seed=2)
    table = neighbors.NeighborTable.from_adjacency(adj, k=8, device="cpu")
    tw = torch.from_numpy(w)
    before = (gather_screen.gather_screen_trimmed_mean.launches,
              gather_screen.gather_screen_median.launches)
    out_t = gather_screen.gather_screen_trimmed_mean(tw, table.safe_idx,
                                                     table.valid_dev.to(torch.uint8), tw, 1)
    out_m = gather_screen.gather_screen_median(tw, table.safe_idx, table.valid_dev, tw)
    assert nan_equal(out_t.numpy(), ref.gather_trimmed_mean(tw, table.safe_idx, table.valid_dev,
                                                            tw, 1).numpy()).all()
    assert nan_equal(out_m.numpy(), ref.gather_median(tw, table.safe_idx, table.valid_dev,
                                                      tw).numpy()).all()
    assert (gather_screen.gather_screen_trimmed_mean.launches,
            gather_screen.gather_screen_median.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "valid_dtype", "shape", "contiguous", "b"])
def test_gather_wrappers_reject_bad_operands(bad):
    w = torch.zeros(6, 10)
    idx = torch.zeros(6, 3, dtype=torch.int32)
    valid = torch.ones(6, 3, dtype=torch.bool)
    b = 1
    if bad == "dtype":
        w = w.double()
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "valid_dtype":
        valid = valid.float()
    elif bad == "shape":
        valid = torch.ones(6, 4, dtype=torch.bool)
    elif bad == "contiguous":
        idx = torch.zeros(3, 6, dtype=torch.int32).t()
    elif bad == "b":
        b = -1
    with pytest.raises((TypeError, ValueError)):
        gather_screen.gather_screen_trimmed_mean(w, idx, valid, w, b)
    if bad != "b":
        with pytest.raises((TypeError, ValueError)):
            gather_screen.gather_screen_median(w, idx, valid, w)


def test_unknown_rule_raises():
    table = neighbors.NeighborTable.from_adjacency(np.ones((3, 3), bool) & ~np.eye(3, dtype=bool),
                                                   device="cpu")
    with pytest.raises(ValueError):
        screening.screen_gathered(torch.zeros(3, 4), table, rule="nope", b=0)
    with pytest.raises(ValueError):
        screening.screen_views(torch.zeros(3, 2, 4), torch.ones(3, 2, dtype=torch.bool),
                               torch.zeros(3, 4), rule="nope", b=0)
