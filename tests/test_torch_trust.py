"""The trust layer in the port (`repro_torch.trust`: reputation, eviction,
the echo protocol) through the trainers, the grids, breakdown and the
sweep, on the CPU against the reference (`repro.trust`).

Tolerances, and why:

* ``trust.update``, ``edge_weights``, ``summarize``, ``scatter_dense`` and
  ``equivocation_evidence`` on the same inputs: bit for bit (trim fractions
  over a power-of-two column count, whose per-receiver sums are exact in
  any order);
* ``digest_matrix``: within the port's normals' rtol 5.8e-6
  (`repro_torch.prng`, ``torch.erfinv``);
* trainers with trust against the reference's, 8 ticks: parameters and
  suspicion within rtol 1e-5 (`alie`'s and `equivocate`'s crafted rows are
  a few ulps from XLA's), evictions and echo counts exactly;
* trust on but inert, and every trust-grid cell against its own trainer
  run: bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary.breakdown import BreakdownConfig as JBConfig
from repro.adversary.breakdown import BreakdownEngine as JBEngine
from repro.core import complete_graph as jcomplete_graph
from repro.core.bridge import BridgeConfig as JConfig
from repro.core.bridge import BridgeTrainer as JTrainer
from repro.core.bridge import replicate as jreplicate
from repro.core.graph import erdos_renyi as jerdos_renyi
from repro.core.neighbors import NeighborTable as JTable
from repro.net import AsyncBridgeConfig as JAsyncConfig
from repro.net import AsyncBridgeTrainer as JAsyncTrainer
from repro.net import ChannelConfig as JChannel
from repro.trust import TrustSpec as JSpec
from repro.trust import echo as jecho
from repro.trust import reputation as jrep
from repro_torch import convert, prng
from repro_torch.adversary.breakdown import BreakdownConfig, BreakdownEngine
from repro_torch.core import BridgeConfig, BridgeTrainer, complete_graph, erdos_renyi, replicate
from repro_torch.core.neighbors import NeighborTable
from repro_torch.launch import sweep
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer, ChannelConfig
from repro_torch.sim import Cell, ExperimentGrid, GridEngine
from repro_torch.trust import TrustSpec, echo, reputation

M, D, T = 10, 64, 8


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


def jqgrad(params, batch):
    w, c = params["w"], batch
    return 0.5 * jnp.sum((w - c) ** 2), {"w": w - c}


def init_fn(seed, m=M):
    return replicate({"w": torch.zeros(D)}, m, perturb=0.1, key=prng.PRNGKey(seed))


def jinit_fn(seed, m=M):
    return jreplicate({"w": jnp.zeros(D)}, m, perturb=0.1, key=jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def targets():
    return np.random.default_rng(0).normal(size=(M, D)).astype(np.float32)


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-6)


def dyadic(rng, shape, cols=64):
    """Trim fractions over ``cols`` columns (a power of two: exact sums)."""
    return (rng.integers(0, cols + 1, size=shape) / cols).astype(np.float32)


# ---------------------------------------------------------------------------
# reputation and echo functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("echo_on", [False, True])
def test_trust_update_matches_the_reference_over_ticks(echo_on):
    rng = np.random.default_rng(1)
    kw = dict(warmup=3, decay=0.7, evict_threshold=0.1)
    js, ts = JSpec(**kw), TrustSpec(**kw)
    e = 3
    jst = jrep.init_state(js, M, M, lead=(e,))
    st = reputation.init_state(ts, M, M, lead=(e,), device="cpu")
    up = jax.jit(jax.vmap(lambda s, tr, lv, ev, t: jrep.update(
        js, s, t=t, trim_frac=tr, live=lv, echo_evidence=ev if echo_on else None),
        in_axes=(0, 0, 0, 0, None)))
    for t in range(8):
        live = rng.uniform(size=(e, M, M)) < 0.7
        trim = np.where(live, dyadic(rng, (e, M, M)) ** 2, 0.0).astype(np.float32)
        ev = (rng.uniform(size=(e, M, M)) < 0.1).astype(np.float32)
        jst = up(jst, jnp.asarray(trim), jnp.asarray(live), jnp.asarray(ev), t)
        st = reputation.update(ts, st, t=t, trim_frac=torch.from_numpy(trim),
                               live=torch.from_numpy(live),
                               echo_evidence=torch.from_numpy(ev) if echo_on else None)
        for f in jrep.TrustState._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                          err_msg=f"{f} at tick {t}")
    np.testing.assert_array_equal(reputation.edge_weights(ts, st).numpy(),
                                  np.asarray(jax.vmap(lambda s: jrep.edge_weights(js, s))(jst)))
    assert int(st.evicted.sum()) > 0
    senders = np.where(rng.uniform(size=(M, M)) < 0.8, np.arange(M)[None], -1)
    byz = np.zeros(M, bool)
    byz[[2, 5]] = True
    one = reputation.TrustState(*(x[0] for x in st))
    jone = jrep.TrustState(*(x[0] for x in jst))
    assert (reputation.summarize(ts, one, byz_mask=byz, senders=senders)
            == jrep.summarize(js, jone, byz_mask=byz, senders=senders))
    np.testing.assert_array_equal(
        reputation.accumulate_trim(torch.from_numpy(trim[0]), torch.from_numpy(trim[1]),
                                   0.25).numpy(),
        np.asarray(jrep.accumulate_trim(jnp.asarray(trim[0]), jnp.asarray(trim[1]), 0.25)))


def test_trust_spec_checks():
    with pytest.raises(ValueError, match="invalid TrustSpec"):
        TrustSpec(decay=1.0)
    with pytest.raises(ValueError, match="invalid TrustSpec"):
        TrustSpec(evict_threshold=0.0)
    assert TrustSpec() == TrustSpec(warmup=8) and hash(TrustSpec(echo=False))
    assert reputation.init_state(None, M, M, device="cpu") is None


def test_echo_functions_match_the_reference():
    rng = np.random.default_rng(2)
    key = np.asarray(jax.random.PRNGKey(7))
    close(echo.digest_matrix(key, D, 4, "cpu"), jecho.digest_matrix(jnp.asarray(key), D, 4),
          rtol=5.8e-6)
    # scatter_dense against the reference's over a sparse table
    adj = erdos_renyi(M, 0.5, 2, seed=3).adjacency
    tab, jtab = NeighborTable.from_adjacency(adj, device="cpu"), JTable.from_adjacency(adj)
    x = rng.normal(size=(M, tab.k, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        echo.scatter_dense(tab, torch.from_numpy(x), 0.0, tail=1).numpy(),
        np.asarray(jecho.scatter_dense(jtab, jnp.asarray(x), 0.0)))
    g = rng.integers(-3, 3, size=(M, tab.k)).astype(np.int32)
    np.testing.assert_array_equal(echo.scatter_dense(tab, torch.from_numpy(g)[None], -9)[0].numpy(),
                                  np.asarray(jecho.scatter_dense(jtab, jnp.asarray(g), -9)))
    # the quorum on shared digests: equivocators' rows split in two groups,
    # slanderers forge their own rows
    dig = np.repeat(rng.normal(size=(1, M, 4)), M, axis=0).astype(np.float32)
    dig[::2, 3] += 5.0  # sender 3 told the even receivers another story
    dig[7] += 1e3  # node 7 gossips forged rows
    gens = np.where(rng.uniform(size=(M, M)) < 0.9, 4, rng.integers(0, 4, size=(M, M)))
    gens = gens.astype(np.int32)
    valid = rng.uniform(size=(M, M)) < 0.85
    gossip = rng.uniform(size=(M, M)) < 0.8
    for b in (1, 2):
        jev, jm = jecho.equivocation_evidence(jnp.asarray(dig), jnp.asarray(gens),
                                              jnp.asarray(valid), jnp.asarray(gossip), b,
                                              tol=1e-3)
        ev, mism = echo.equivocation_evidence(torch.from_numpy(dig), torch.from_numpy(gens),
                                              torch.from_numpy(valid), torch.from_numpy(gossip),
                                              b, tol=1e-3)
        np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
        np.testing.assert_array_equal(mism.numpy(), np.asarray(jm))
        assert ev[:, 3].sum() > 0
    # stacked cells with a bound each
    evs, _ = echo.equivocation_evidence(*(torch.from_numpy(np.stack([a, a])) for a in
                                          (dig, gens, valid, gossip)), [1, 2], tol=1e-3)
    for i, b in enumerate((1, 2)):
        one, _ = echo.equivocation_evidence(*(torch.from_numpy(a) for a in
                                              (dig, gens, valid, gossip)), b, tol=1e-3)
        assert torch.equal(evs[i], one)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


def _pair(path: str, rule: str, adversary: str, attack: str, spec_kw: dict):
    """The reference's trainer and the port's on one path."""
    kw = dict(rule=rule, num_byzantine=2, attack=attack, adversary=adversary, lam=1.0, t0=10.0)
    topo, jtopo = complete_graph(M, 2), jcomplete_graph(M, 2)
    if path in ("dense", "sparse"):
        jt = JTrainer(JConfig(topology=jtopo, sparse=path == "sparse", trust=JSpec(**spec_kw),
                              **kw), jqgrad)
        tt = BridgeTrainer(BridgeConfig(topology=topo, sparse=path == "sparse",
                                        trust=TrustSpec(**spec_kw), **kw), qgrad, device="cpu")
    else:
        sparse = path == "net_sparse"
        jt = JAsyncTrainer(JAsyncConfig(topology=jtopo, channel=JChannel(drop_prob=0.1),
                                        staleness_bound=2, sparse=sparse,
                                        trust=JSpec(**spec_kw), **kw), jqgrad)
        tt = AsyncBridgeTrainer(AsyncBridgeConfig(topology=topo,
                                                  channel=ChannelConfig(drop_prob=0.1),
                                                  staleness_bound=2, sparse=sparse,
                                                  trust=TrustSpec(**spec_kw), **kw),
                                qgrad, device="cpu")
    return jt, tt


@pytest.mark.parametrize("path,rule,adversary,attack", [
    ("dense", "rep_trimmed_mean", "none", "alie"),
    ("sparse", "trimmed_mean", "none", "sign_flip"),
    ("net_dense", "rep_trimmed_mean", "equivocate", "none"),
    ("net_sparse", "rep_median", "slander", "none"),
])
def test_trainers_with_trust_follow_the_reference(targets, path, rule, adversary, attack):
    """Dense and sparse synchronous, dense and sparse runtime with the echo
    (``equivocate``, ``slander``), 8 ticks: trajectories and trust states
    the reference's."""
    jt, tt = _pair(path, rule, adversary, attack, dict(warmup=2, decide_stride=4))
    js, ts = jt.init(jinit_fn(0), seed=0), tt.init(init_fn(0), seed=0)
    assert np.array_equal(tt.byz_mask.numpy(), np.asarray(jt.byz_mask))
    for _ in range(T):
        js, jm = jt.step(js, jnp.asarray(targets))
        ts, tm = tt.step(ts, torch.from_numpy(targets))
    close(ts.params["w"], js.params["w"])
    close(ts.trust.suspicion, js.trust.suspicion)
    np.testing.assert_array_equal(ts.trust.evicted.numpy(), np.asarray(js.trust.evicted))
    np.testing.assert_array_equal(ts.trust.echo_mism.numpy(), np.asarray(js.trust.echo_mism))
    close(tm["trust_evicted_frac"], jm["trust_evicted_frac"])
    if adversary == "equivocate":
        assert int(ts.trust.evicted.sum()) > 0 and float(ts.trust.echo_mism.sum()) > 0
    # the state crosses over with its trust carry
    moved = convert.state_from_jax({k: np.asarray(v) for k, v in js.params.items()}, js.t,
                                   key=np.asarray(js.key), trust=tuple(np.asarray(x)
                                                                       for x in js.trust),
                                   device="cpu")
    for f in jrep.TrustState._fields:
        np.testing.assert_array_equal(getattr(moved.trust, f).numpy(),
                                      np.asarray(getattr(js.trust, f)))


@pytest.mark.parametrize("path", ["dense", "sparse", "net_dense"])
def test_trust_on_but_inert_is_bit_identical(targets, path):
    """A plain rule and a warmup past the horizon: reputation runs but
    cannot act, so the trajectory is the trust-free one bit for bit (with a
    forensic trace on too)."""
    from repro_torch.obs import TraceSpec

    runs = []
    for spec in (None, TrustSpec(warmup=T + 1)):
        kw = dict(topology=complete_graph(M, 2), rule="trimmed_mean", num_byzantine=2,
                  attack="alie", lam=1.0, t0=10.0, sparse=path == "sparse", trust=spec,
                  trace=None if spec is None else TraceSpec(decide_stride=2))
        tr = (AsyncBridgeTrainer(AsyncBridgeConfig(channel=ChannelConfig(drop_prob=0.05),
                                                   staleness_bound=2, **kw), qgrad, device="cpu")
              if path == "net_dense" else BridgeTrainer(BridgeConfig(**kw), qgrad, device="cpu"))
        st = tr.init(init_fn(0), seed=0)
        for _ in range(T):
            st, _ = tr.step(st, torch.from_numpy(targets))
        runs.append(st)
    assert torch.equal(runs[0].params["w"], runs[1].params["w"])
    assert runs[1].trust is not None and not bool(runs[1].trust.evicted.any())
    assert float(runs[1].trust.suspicion.max()) > 0.0


# ---------------------------------------------------------------------------
# grids, breakdown, the sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", [False, True])
def test_trust_grid_cells_equal_their_trainer_runs(targets, net):
    """Each cell of a trust grid (sync dense, net dense with the echo,
    grouped) is its own trainer run bit for bit, its trust state included;
    `sender_grid` and `summarize` name its edges."""
    spec = TrustSpec(warmup=2)
    grid = ExperimentGrid(complete_graph(M, 2), ("rep_trimmed_mean",), ("none",), (2,), (0,),
                          scenarios=("ideal",) if net else None,
                          adversaries=("equivocate", "slander"), lam=1.0, t0=10.0)
    eng = GridEngine(grid, qgrad, num_ticks=T if net else None, trust=spec, device="cpu")
    tg = torch.from_numpy(targets)
    final, metrics = eng.run(eng.init(init_fn), torch.stack([tg] * T))
    assert metrics["trust_evicted_frac"].shape == (2, T)
    senders = eng.sender_grid()
    for i, cell in enumerate(eng.cells):
        kw = dict(topology=grid.topology, rule=cell.rule, num_byzantine=cell.b,
                  adversary=cell.adversary, lam=1.0, t0=10.0, byzantine_seed=cell.mask_seed,
                  trust=spec)
        tr = (AsyncBridgeTrainer(AsyncBridgeConfig(**kw, schedule=eng.runtime.schedule_for(
            "ideal")), qgrad, device="cpu") if net
              else BridgeTrainer(BridgeConfig(**kw), qgrad, device="cpu"))
        st = tr.init(init_fn(0), seed=0)
        for _ in range(T):
            st, _ = tr.step(st, tg)
        assert torch.equal(final.params["w"][i], st.params["w"]), cell
        for got, want in zip(final.trust, st.trust, strict=True):
            assert torch.equal(got[i], want), cell
        rec = reputation.summarize(spec, reputation.TrustState(*(x[i] for x in final.trust)),
                                   byz_mask=eng.byz_masks[i], senders=senders)
        assert rec["honest_evicted"] == 0
        if net and cell.adversary == "equivocate":
            assert rec["byz_evicted"] > 0


def test_breakdown_with_trust_matches_the_reference():
    """`BreakdownEngine(trust=)` through the net grids (``ideal``): the
    rep rule's ``b + 1`` requirement, every verdict and b* the
    reference's."""
    m, ticks = 8, 4
    rng = np.random.default_rng(3)
    tg = rng.normal(size=(m, D)).astype(np.float32)
    cfg = dict(mode="ladder", b_max=3, loss_ratio=50.0)
    jres = JBEngine(jcomplete_graph(m, 3), ("rep_trimmed_mean",), ("equivocate",), jqgrad,
                    lambda s: jinit_fn(s, m), jnp.asarray(np.stack([tg] * ticks)), lam=1.0,
                    t0=10.0, config=JBConfig(**cfg), scenario="ideal",
                    trust=JSpec(warmup=2)).run()
    eng = BreakdownEngine(complete_graph(m, 3), ("rep_trimmed_mean",), ("equivocate",), qgrad,
                          lambda s: init_fn(s, m), torch.from_numpy(np.stack([tg] * ticks)),
                          lam=1.0, t0=10.0, config=BreakdownConfig(**cfg), scenario="ideal",
                          trust=TrustSpec(warmup=2), device="cpu")
    res = eng.run()
    assert res["meta"]["trust"] and jres["meta"]["trust"]
    mine = res["rules"]["rep_trimmed_mean"]
    ref = jres["rules"]["rep_trimmed_mean"]
    assert mine["feasible_b"] == ref["feasible_b"] == 3
    for b, p in ref["adversaries"]["equivocate"]["probes"].items():
        assert mine["adversaries"]["equivocate"]["probes"][b]["survived"] == p["survived"], b
    assert (mine["adversaries"]["equivocate"]["bstar"]
            == ref["adversaries"]["equivocate"]["bstar"])
    assert all(e._trust_spec is not None for e in eng.round_engines)


def test_sweep_trust_runs_in_grid_and_breakdown_modes(tmp_path):
    out = str(tmp_path / "g")
    sweep.main(["--mode", "grid", "--out", out, "--device", "cpu", "--rules",
                "rep_trimmed_mean", "--attacks", "alie", "--grid-nodes", "10", "--grid-ticks",
                "3", "--grid-train", "300", "--grid-test", "50", "--trust", "--trust-warmup",
                "1"])
    with open(os.path.join(out, "GridResult.json")) as f:
        cells = json.load(f)["cells"]
    assert len(cells) == 1 and "mean_trust_evicted_frac" in cells[0]
    bout = str(tmp_path / "b")
    res = sweep.main(["--mode", "breakdown", "--out", bout, "--device", "cpu", "--rules",
                      "rep_trimmed_mean", "--adversaries", "equivocate", "--breakdown-b-max",
                      "2", "--breakdown-scenario", "ideal", "--grid-nodes", "10",
                      "--grid-ticks", "3", "--grid-train", "300", "--grid-test", "50",
                      "--trust"])
    assert res["meta"]["trust"] and res["rules"]["rep_trimmed_mean"]["feasible_b"] == 2
    # --metrics, refused before, streams the trusting cells' rings (the
    # evicted share in the ring's evicted_frac column)
    from repro_torch.obs import read_metrics

    mdir = str(tmp_path / "m")
    sweep.main(["--mode", "grid", "--out", str(tmp_path / "g2"), "--device", "cpu", "--rules",
                "rep_trimmed_mean", "--attacks", "alie", "--grid-nodes", "10", "--grid-ticks",
                "3", "--grid-train", "300", "--grid-test", "50", "--trust", "--trust-warmup",
                "1", "--metrics", mdir])
    rows = read_metrics(os.path.join(mdir, "metrics.jsonl"))
    assert [r["tick"] for r in rows] == [0, 1, 2]
    assert all(r["evicted_frac"] is not None for r in rows)
