"""The screening rules' decision twins and the decide-banked dispatch in
the port (`repro_torch.core.screening`: ``RULES_WITH_DECISIONS``,
``screen_all_decide_banked``, ``screen_gathered_decide_banked``,
``screen_views_decide_banked``), on the CPU against the reference's
(`repro.core.screening`) under ``jax.jit``.

The inputs carry NaN, +-inf and 1e30 payloads, ties at the kept window's
boundaries, ``-0.0`` beside ``+0.0`` and starved nodes (count 0, 1, 2 <=
2b).  Tolerances, and why:

* ``trim``: bit for bit (the fraction is the count of trimmed columns times
  the float32 reciprocal of their number, the form ``jnp.mean`` compiles
  to, ``tools/xla_divisor_forms.py``); geomedian's soft decision within 4
  ulps (its distances are ``torch.sum`` over d, XLA sums in its own order);
* ``y``: bit for bit the port's plain banked path (the trace-inertness
  contract); against the reference bit for bit but for geomedian and
  clipped_mean (a few ulps: XLA's ``rsqrt``, ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import screening as js
from repro.core.neighbors import NeighborTable as JTable
from repro_torch.core import screening as ts
from repro_torch.core.neighbors import NeighborTable

M, D, B = 9, 37, 2
ULPS = {"geomedian": 4e-6, "clipped_mean": 4e-6}  # relative, the rsqrt rules' y


def payload(rng, shape):
    """Normals with NaN, +-inf, 1e30, ties (one column all equal, integers
    in another) and signed zeros."""
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 3] = np.round(x[..., 3])
    x[..., 5] = 0.5
    for frac, val in ((0.04, np.nan), (0.03, np.inf), (0.03, -np.inf), (0.04, 1e30),
                      (0.04, -0.0), (0.04, 0.0)):
        x[rng.random(shape) < frac] = val
    return x


def views_inputs(seed: int):
    """Views ``[M, n, d]`` (n = M), a mask whose first nodes are starved
    (0, 1, 2 rows: count <= 2b), self values and weights."""
    rng = np.random.default_rng(seed)
    views = payload(rng, (M, M, D))
    mask = rng.random((M, M)) < 0.7
    for j, deg in enumerate((0, 1, 2)):
        mask[j] = False
        mask[j, rng.choice(M, size=deg, replace=False)] = True
    self_vals = rng.normal(size=(M, D)).astype(np.float32)
    weights = rng.uniform(size=(M, M)).astype(np.float32)
    return views, mask, self_vals, weights


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.array_equal(a.view(np.int32), b.view(np.int32))


def close_or_equal(got, want, rule):
    got, want = np.asarray(got), np.asarray(want)
    if rule in ULPS:
        np.testing.assert_allclose(got, want, rtol=ULPS[rule], atol=1e-30)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("rule", ts.RULES)
def test_decision_twins_match_the_reference(rule, stride):
    """Each ``<rule>_with_decisions`` over every node's views against the
    reference's, vmapped over the nodes under jit (the mask an operand:
    true divisions)."""
    views, mask, sv, wt = views_inputs(7)
    jfn = js.RULES_WITH_DECISIONS[rule]
    kw = {"weights": None} if rule in js.WEIGHTED_RULES else {}
    if rule in js.WEIGHTED_RULES:
        jy, jt = jax.jit(jax.vmap(lambda v, m, s, w: jfn(v, m, s, B, weights=w,
                                                         decide_stride=stride)))(
            jnp.asarray(views), jnp.asarray(mask), jnp.asarray(sv), jnp.asarray(wt))
        kw = {"weights": torch.from_numpy(wt)}
    else:
        jy, jt = jax.jit(jax.vmap(lambda v, m, s: jfn(v, m, s, B, decide_stride=stride)))(
            jnp.asarray(views), jnp.asarray(mask), jnp.asarray(sv))
    if rule in ("mean", "geomedian", "clipped_mean"):
        kw = {"folded": False}
    y, trim = ts.RULES_WITH_DECISIONS[rule](torch.from_numpy(views), torch.from_numpy(mask),
                                            torch.from_numpy(sv), B, decide_stride=stride, **kw)
    assert trim.shape == (M, M) and trim.dtype == torch.float32
    close_or_equal(trim.numpy(), jt, rule if rule == "geomedian" else None)
    close_or_equal(y.numpy(), jy, rule)
    assert float(trim[0].abs().sum()) == 0.0  # a node with no rows decides nothing


def _cells(seed: int, e: int):
    rng = np.random.default_rng(seed)
    w = payload(rng, (e, M, D))
    self_vals = rng.normal(size=(e, M, D)).astype(np.float32)
    adj = jgraph.erdos_renyi(M, 0.6, B, seed=seed).adjacency
    adj[0] = False  # a starved node
    adj[1, :] = False
    adj[1, 2] = True
    return rng, w, self_vals, adj


BANKS = [("trimmed_mean", "median", "krum"), ("bulyan", "geomedian", "clipped_mean"),
         ("mean", "rep_trimmed_mean", "rep_median")]


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("stride", [1, 4])
def test_screen_all_decide_banked_matches_the_reference(bank, stride):
    """Dense, a rule a cell from a bank of three, per-cell b, the adjacency
    closed over (folded divisors): ``y`` the plain banked path's bit for
    bit, ``trim [E, M, M]`` the reference's."""
    e = 3
    rng, w, sv, adj = _cells(11, e)
    if "bulyan" in bank:  # Bulyan's in-degree
        adj = jgraph.complete_graph(M, 1).adjacency
    rule_idx, b = (0, 1, 2), (1, 2, 1)
    ja = jnp.asarray(adj)
    jy, jt = jax.jit(jax.vmap(lambda w_, s_, r, b_: js.screen_all_decide_banked(
        w_, ja, bank, r, b_, self_vals=s_, decide_stride=stride)))(
        jnp.asarray(w), jnp.asarray(sv), jnp.asarray(rule_idx), jnp.asarray(b))
    tw, tsv, tadj = torch.from_numpy(w), torch.from_numpy(sv), torch.from_numpy(adj)
    y, trim = ts.screen_all_decide_banked(tw, tadj, bank, rule_idx, b, self_vals=tsv,
                                          decide_stride=stride)
    plain = ts.screen_all_banked(tw, tadj, bank, rule_idx, b, self_vals=tsv)
    assert bits_equal(y, plain)
    for i, rule in enumerate(bank):
        close_or_equal(trim[i].numpy(), jt[i], rule if rule == "geomedian" else None)
        close_or_equal(y[i].numpy(), jy[i], rule)


@pytest.mark.parametrize("weighted", [False, True])
def test_screen_all_decide_banked_with_evictions_matches_the_reference(weighted):
    """The trust layer's form: a mask a cell (evictions cleared, a run-time
    value: true divisions) and reputation weights for the rep rules."""
    e = 3
    bank = ("mean", "rep_trimmed_mean", "trimmed_mean")
    rng, w, sv, adj = _cells(13, e)
    evicted = rng.random((e, M, M)) < 0.2
    adj_e = adj[None] & ~evicted
    wts = rng.uniform(size=(e, M, M)).astype(np.float32) if weighted else None
    jy, jt = jax.jit(jax.vmap(lambda w_, s_, a_, r, wt: js.screen_all_decide_banked(
        w_, a_, bank, r, 1, self_vals=s_, decide_stride=2,
        weights=wt if weighted else None)))(
        jnp.asarray(w), jnp.asarray(sv), jnp.asarray(adj_e), jnp.asarray((0, 1, 2)),
        jnp.asarray(wts if weighted else np.zeros((e, M, M), np.float32)))
    y, trim = ts.screen_all_decide_banked(
        torch.from_numpy(w), torch.from_numpy(adj_e), bank, (0, 1, 2), 1,
        self_vals=torch.from_numpy(sv), decide_stride=2,
        weights=None if wts is None else torch.from_numpy(wts), folded=False)
    np.testing.assert_array_equal(trim.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("bank", BANKS[:1] + BANKS[2:])
def test_screen_gathered_decide_banked_matches_the_reference(bank, stride):
    """Sparse: the reference screens the table's gathered rows
    (``screen_views_decide_banked`` over ``gather_rows``, the table's mask
    closed over); the port reads them through the gather kernels' decide
    form.  ``trim [E, M, K]`` by slot; y the plain banked path's."""
    e = 3
    rng, w, sv, adj = _cells(17, e)
    jtab, tab = JTable.from_adjacency(adj), NeighborTable.from_adjacency(adj, device="cpu")
    rule_idx, b = (0, 1, 2), (2, 1, 2)
    jy, jt = jax.jit(jax.vmap(lambda w_, s_, r, b_: js.screen_views_decide_banked(
        jtab.gather_rows(w_), jtab.valid_dev, s_, bank, r, b_, decide_stride=stride)))(
        jnp.asarray(w), jnp.asarray(sv), jnp.asarray(rule_idx), jnp.asarray(b))
    tw, tsv = torch.from_numpy(w), torch.from_numpy(sv)
    y, trim = ts.screen_gathered_decide_banked(tw, tab, bank, rule_idx, b, self_vals=tsv,
                                               decide_stride=stride)
    assert trim.shape == (e, M, tab.k)
    assert bits_equal(y, ts.screen_gathered_banked(tw, tab, bank, rule_idx, b, self_vals=tsv))
    np.testing.assert_array_equal(trim.numpy(), np.asarray(jt))
    for i, rule in enumerate(bank):
        close_or_equal(y[i].numpy(), jy[i], rule)
    # evictions: a cell's own table mask, true divisions
    valid_e = tab.valid_dev[None] & (torch.rand((e, M, tab.k),
                                                generator=torch.Generator().manual_seed(1)) < 0.8)
    jy2, jt2 = jax.jit(jax.vmap(lambda w_, s_, v_, r, b_: js.screen_views_decide_banked(
        jtab.gather_rows(w_), v_, s_, bank, r, b_, decide_stride=stride)))(
        jnp.asarray(w), jnp.asarray(sv), jnp.asarray(valid_e.numpy()), jnp.asarray(rule_idx),
        jnp.asarray(b))
    y2, trim2 = ts.screen_gathered_decide_banked(tw, tab, bank, rule_idx, b, self_vals=tsv,
                                                 valid=valid_e, decide_stride=stride,
                                                 folded=False)
    np.testing.assert_array_equal(trim2.numpy(), np.asarray(jt2))
    np.testing.assert_array_equal(y2.numpy(), np.asarray(jy2))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bank", BANKS)
def test_screen_views_decide_banked_matches_the_reference(bank, weighted):
    """The runtime's operand form over E cells' views ``[E, M, W, d]`` under
    a usable mask a cell, weights for the rep rules; y the plain banked
    path's bit for bit."""
    e = 3
    rng = np.random.default_rng(19)
    views = payload(rng, (e, M, M, D))
    mask = rng.random((e, M, M)) < (0.95 if "bulyan" in bank else 0.7)
    mask[:, 0] = False
    sv = rng.normal(size=(e, M, D)).astype(np.float32)
    wts = rng.uniform(size=(e, M, M)).astype(np.float32)
    rule_idx, b = (0, 1, 2), (1, 1, 2)
    jy, jt = jax.jit(jax.vmap(lambda v, m, s, r, b_, wt: js.screen_views_decide_banked(
        v, m, s, bank, r, b_, decide_stride=4, weights=wt if weighted else None)))(
        jnp.asarray(views), jnp.asarray(mask), jnp.asarray(sv), jnp.asarray(rule_idx),
        jnp.asarray(b), jnp.asarray(wts))
    tv, tm, tsv = (torch.from_numpy(x) for x in (views, mask, sv))
    y, trim = ts.screen_views_decide_banked(tv, tm, tsv, bank, rule_idx, b, decide_stride=4,
                                            weights=torch.from_numpy(wts) if weighted else None)
    if not weighted:
        assert bits_equal(y, ts.screen_views_banked(tv, tm, tsv, bank, rule_idx, b))
    for i, rule in enumerate(bank):
        close_or_equal(trim[i].numpy(), jt[i], rule if rule == "geomedian" else None)
        close_or_equal(y[i].numpy(), jy[i], rule)


@pytest.mark.parametrize("layout", ["dense", "gathered", "views"])
def test_rep_median_decides_through_the_median_decide_kernel(layout, monkeypatch):
    """``rep_median``'s decisions are the unweighted median's, so each
    layout takes them from its median decide entry (the kernel on the
    card), once a call: its trim equals that of ``median`` over the same
    mask, whatever the weights, and its y the plain banked path's."""
    from repro_torch.kernels import ops

    entry = {"dense": "median_decide", "gathered": "gather_median_decide",
             "views": "views_median_decide"}[layout]
    calls = []
    inner = getattr(ops, entry)
    monkeypatch.setattr(ops, entry, lambda *a: calls.append(1) or inner(*a))
    e = 2
    rng, w, sv, adj = _cells(23, e)
    tw, tsv = torch.from_numpy(w), torch.from_numpy(sv)
    if layout == "dense":
        mask = torch.from_numpy(adj[None] & (rng.random((e, M, M)) < 0.8))
        run = lambda bank, **kw: ts.screen_all_decide_banked(  # noqa: E731
            tw, mask, bank, (0, 0), 1, self_vals=tsv, decide_stride=2, **kw)
        plain = ts.screen_all_banked(tw, mask, ("rep_median",), (0, 0), 1, self_vals=tsv)
    elif layout == "gathered":
        tab = NeighborTable.from_adjacency(adj, device="cpu")
        mask = tab.valid_dev  # the table's own (per-cell masks: the tests above)
        run = lambda bank, **kw: ts.screen_gathered_decide_banked(  # noqa: E731
            tw, tab, bank, (0, 0), 1, self_vals=tsv, decide_stride=2, **kw)
        plain = ts.screen_gathered_banked(tw, tab, ("rep_median",), (0, 0), 1, self_vals=tsv)
    else:
        views = torch.from_numpy(payload(rng, (e, M, M, D)))
        mask = torch.from_numpy(rng.random((e, M, M)) < 0.7)
        run = lambda bank, **kw: ts.screen_views_decide_banked(  # noqa: E731
            views, mask, tsv, bank, (0, 0), 1, decide_stride=2, **kw)
        plain = ts.screen_views_banked(views, mask, tsv, ("rep_median",), (0, 0), 1)
    wts = torch.from_numpy(rng.uniform(size=(e, *mask.shape[-2:])).astype(np.float32))
    y, trim = run(("rep_median",))
    assert len(calls) == 1
    _, want = run(("median",))
    assert bits_equal(trim, want) and bits_equal(y, plain)
    calls.clear()
    y_w, trim_w = run(("rep_median",), weights=wts)
    assert len(calls) == 1 and bits_equal(trim_w, want)
    assert not bits_equal(y_w, y)


def test_decision_registries_and_the_fraction_form():
    """The registries are the reference's; a fraction is the trimmed
    columns' count times the float32 reciprocal of their number, which
    differs from the quotient on some counts."""
    assert set(ts.RULES_WITH_DECISIONS) == set(js.RULES_WITH_DECISIONS) == set(ts.RULES)
    assert ts.WEIGHTED_RULES == js.WEIGHTED_RULES
    from repro_torch.kernels import ref

    counts = torch.arange(7851)
    frac = ref.count_fraction(counts, 7850)
    quot = (counts.to(torch.float32) / torch.tensor(7850.0)).numpy()
    assert not np.array_equal(frac.numpy(), quot)
    np.testing.assert_array_equal(
        frac.numpy(), counts.numpy().astype(np.float32) * (np.float32(1) / np.float32(7850)))
    with pytest.raises(ValueError, match="decide_stride"):
        from repro_torch.kernels import screen_decide

        w = torch.zeros((4, 8))
        screen_decide.trimmed_mean_dense_decide(w, torch.ones((4, 4), dtype=torch.bool), w, 1, 0)


WIDE_RULES = ("trimmed_mean", "median")


@pytest.mark.parametrize("layout", ["dense", "gathered"])
def test_decide_twins_above_the_register_networks_match_the_reference(layout):
    """The shapes the card's wide decide form takes: dense M = 129 (above
    the 128-row networks) and a table of K = 64 slots (above the tile
    kernel's 63), T and M in one bank at b = 3, strides 1 and 4.  ``trim``
    the reference's bit for bit; ``y`` the plain banked path's bit for bit
    and the reference's exactly, but the trimmed mean above 64 rows, whose
    kept ranks the twin sums with ``torch.sum`` and XLA with its own
    order: within 4 ulps relative.  The gathered layout at stride 4 only
    (the reference's 64-slot decide compiles for 15 s a stride)."""
    m = 129 if layout == "dense" else 80
    rng = np.random.default_rng(23)
    w = payload(rng, (2, m, 16))
    sv = rng.normal(size=(2, m, 16)).astype(np.float32)
    if layout == "dense":
        adj = jgraph.erdos_renyi(m, 0.9, 3, seed=3).adjacency
        adj[1:3] = True  # 129 rows to sort at nodes 1 and 2
        adj[0] = False
    else:
        adj = jgraph.erdos_renyi(m, 0.6, 3, seed=3).adjacency
        adj[1] = False
        adj[1, 2:66] = True  # a full table row: 64 slots, 65 rows for the median
    rule_idx, b = (0, 1), (3, 3)
    tw, tsv = torch.from_numpy(w), torch.from_numpy(sv)
    for stride in (1, 4) if layout == "dense" else (4,):
        if layout == "dense":
            ja = jnp.asarray(adj)
            jy, jt = jax.jit(jax.vmap(lambda w_, s_, r, b_: js.screen_all_decide_banked(
                w_, ja, WIDE_RULES, r, b_, self_vals=s_, decide_stride=stride)))(
                jnp.asarray(w), jnp.asarray(sv), jnp.asarray(rule_idx), jnp.asarray(b))
            tadj = torch.from_numpy(adj)
            y, trim = ts.screen_all_decide_banked(tw, tadj, WIDE_RULES, rule_idx, b,
                                                  self_vals=tsv, decide_stride=stride)
            plain = ts.screen_all_banked(tw, tadj, WIDE_RULES, rule_idx, b, self_vals=tsv)
            assert int(adj.sum(axis=1).max()) == m
        else:
            jtab = JTable.from_adjacency(adj, k=64)
            tab = NeighborTable.from_adjacency(adj, k=64, device="cpu")
            jy, jt = jax.jit(jax.vmap(lambda w_, s_, r, b_: js.screen_views_decide_banked(
                jtab.gather_rows(w_), jtab.valid_dev, s_, WIDE_RULES, r, b_,
                decide_stride=stride)))(
                jnp.asarray(w), jnp.asarray(sv), jnp.asarray(rule_idx), jnp.asarray(b))
            y, trim = ts.screen_gathered_decide_banked(tw, tab, WIDE_RULES, rule_idx, b,
                                                       self_vals=tsv, decide_stride=stride)
            plain = ts.screen_gathered_banked(tw, tab, WIDE_RULES, rule_idx, b, self_vals=tsv)
            assert trim.shape == (2, m, 64)
        assert bits_equal(y, plain)
        np.testing.assert_array_equal(trim.numpy(), np.asarray(jt))
        assert float(trim.sum()) > 0.0
        np.testing.assert_array_equal(y[1].numpy(), np.asarray(jy[1]))
        if layout == "dense":
            np.testing.assert_allclose(y[0].numpy(), np.asarray(jy[0]), rtol=4.8e-7, atol=0)
        else:
            np.testing.assert_array_equal(y[0].numpy(), np.asarray(jy[0]))
