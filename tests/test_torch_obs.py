"""The observability layer's forensics-free half in the port
(`repro_torch.obs`: the trace's sentinel, loss trace and reservoir; the
event log) and the ``bridge.obs`` stage of the trainer and the grid, on the
CPU against the reference (`repro.obs`, `repro.core.bridge`).

Tolerances, and why:

* ``trace.update`` against ``jax.jit`` of the reference's over ticks: bit
  for bit (the EMA written as the fused multiply-add XLA compiles);
* the obs stage: bit-inert (the traced trajectory equals the untraced
  one bit for bit, on trainers and grid cells); against the reference's
  traced trainer, the sentinel and the reservoir's ticks exactly, the loss
  trace within rtol 1e-5 (the honest loss of a run that agrees step for
  step at that tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BridgeConfig as JConfig
from repro.core import BridgeTrainer as JTrainer
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.obs import EventLog as JEventLog
from repro.obs import TraceSpec as JSpec
from repro.obs import read_events as jread_events
from repro.obs import trace as jtrace
from repro_torch import convert, prng
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer
from repro_torch.obs import EventLog, TraceSpec, read_events
from repro_torch.obs import trace as obs_trace
from repro_torch.sim import ExperimentGrid, GridEngine

M, D, T = 10, 4, 8


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


def jqgrad(params, batch):
    w, c = params["w"], batch
    return 0.5 * jnp.sum((w - c) ** 2), {"w": w - c}


def init_fn(seed):
    return replicate({"w": torch.zeros(D)}, M, perturb=0.1, key=prng.PRNGKey(seed))


def jinit_fn(seed):
    return jreplicate({"w": jnp.zeros(D)}, M, perturb=0.1, key=jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def targets():
    return (3.0 * np.random.default_rng(0).normal(size=(M, D))).astype(np.float32)


def topo():
    return erdos_renyi(M, 0.8, 2, seed=1)


def spec_kw(ema=0.0, reservoir=3, stride=2):
    return dict(forensics=False, ema=ema, reservoir=reservoir, stride=stride)


def assert_states_equal(a, b) -> None:
    """Parameters, key and every carried tensor bit for bit (NaN-aware)."""
    for k in a.params:
        assert torch.equal(torch.nan_to_num(a.params[k]), torch.nan_to_num(b.params[k])), k
    assert np.array_equal(np.asarray(a.key), np.asarray(b.key)) and a.t == b.t
    for field in ("comm", "net", "adv"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            for u, v in zip(x, y, strict=True):
                assert torch.equal(torch.nan_to_num(u), torch.nan_to_num(v)), field


@pytest.mark.parametrize("ema,reservoir,stride", [(0.0, 3, 2), (0.9, 4, 1), (0.3, 0, 1)])
def test_trace_update_matches_the_reference(ema, reservoir, stride):
    """Eight ticks over 16 cells, a NaN loss at tick 5 and an inf
    consensus at tick 6: every field of the state bit for bit."""
    rng = np.random.default_rng(1)
    js, ts = JSpec(**spec_kw(ema, reservoir, stride)), TraceSpec(**spec_kw(ema, reservoir, stride))
    jst = jtrace.init_state(js, M, M, lead=(16,))
    st = obs_trace.init_state(ts, lead=(16,), device="cpu")
    up = jax.jit(lambda s, t, lo, c: jax.vmap(
        lambda s, lo, c: jtrace.update(js, s, t=t, loss=lo, consensus=c))(s, lo, c))
    for t in range(T):
        loss = (rng.normal(size=16) * 10.0 ** rng.uniform(-3, 3, 16)).astype(np.float32)
        cons = np.abs(rng.normal(size=16)).astype(np.float32)
        loss[3 if t == 5 else 0] = np.nan if t == 5 else loss[0]
        cons[7] = np.inf if t == 6 else cons[7]
        jst = up(jst, t, jnp.asarray(loss), jnp.asarray(cons))
        st = obs_trace.update(ts, st, t=t, loss=torch.from_numpy(loss),
                              consensus=torch.from_numpy(cons))
        for f in jtrace.TraceState._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                          err_msg=f)
    assert st.first_bad[3] == 5 and st.first_bad[7] == 6 and int((st.first_bad >= 0).sum()) == 2
    one = obs_trace.TraceState(*(x[7] for x in st))  # its consensus went inf at tick 6
    jone = jtrace.TraceState(*(x[7] for x in jst))
    assert obs_trace.summarize(ts, one) == jtrace.summarize(js, jone)


def test_trace_spec_checks_and_the_forensics_refusal():
    """The spec's checks; forensics, refused before, now builds its [M, W]
    counters (the reference's shapes); the grid's metrics spec, refused
    before, now builds its stacked rings."""
    with pytest.raises(ValueError, match="invalid TraceSpec"):
        TraceSpec(reservoir=-1)
    with pytest.raises(ValueError, match="invalid TraceSpec"):
        TraceSpec(stride=0)
    assert TraceSpec() == TraceSpec(forensics=True) and hash(TraceSpec(forensics=False))
    assert obs_trace.init_state(None, device="cpu") is None
    st = obs_trace.init_state(TraceSpec(reservoir=2), M, 6, lead=(3,), device="cpu")
    jst = jtrace.init_state(JSpec(reservoir=2), M, 6, lead=(3,))
    for f in jtrace.TraceState._fields:
        assert getattr(st, f).shape == getattr(jst, f).shape, f
    tr = BridgeTrainer(BridgeConfig(topology=topo(), trace=TraceSpec()), qgrad, device="cpu")
    assert tr.init(init_fn(0)).obs.edge_seen.shape == (M, M)
    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("none",), (1,))
    from repro_torch.obs import MetricSpec

    eng = GridEngine(grid, qgrad, metrics=MetricSpec(capacity=3), device="cpu")
    assert eng.init(init_fn).mets.buf.shape == (1, 3, 12)


def test_event_log_round_trip(tmp_path):
    """The reference's record shape and tags; either package reads the
    other's file, a truncated last line included."""
    path, jpath = str(tmp_path / "ev.jsonl"), str(tmp_path / "jev.jsonl")
    for cls, p in ((EventLog, path), (JEventLog, jpath)):
        with cls(p) as ev:
            ev.emit("run.start", kind="grid", cells=np.int64(3), wall_s=np.float32(0.5))
            ev.emit("obs.divergence", cell="c0", first_bad_tick=4, arr=np.arange(2))
        ev.emit("run.end")  # after close: dropped
    for p in (path, jpath):
        with open(p, "a") as f:
            f.write('{"tag": "run.e')  # an interrupted write
    mine, ref = read_events(jpath), jread_events(path)
    for recs in (mine, ref, read_events(path)):
        assert [r["tag"] for r in recs] == ["run.start", "obs.divergence"]
        assert all({"tag", "wall", "time"} <= r.keys() for r in recs)
        assert recs[0]["cells"] == 3 and recs[1]["arr"] == [0, 1]
    strip = lambda rs: [{k: v for k, v in r.items() if k not in ("wall", "time")} for r in rs]
    assert strip(read_events(path)) == strip(mine)


@pytest.mark.parametrize("path", ["dense", "sparse", "runtime"])
def test_obs_stage_is_bit_inert_in_a_trainer(path, targets):
    """A traced trainer's trajectory equals the untraced one bit for bit
    (an adversary and a codec carry included); its trace is the loss's."""
    kw = dict(topology=topo(), rule="trimmed_mean", num_byzantine=2, adversary="alie_online",
              codec="int8", lam=1.0, t0=10.0, sparse=path == "sparse")
    spec = TraceSpec(**spec_kw(0.5, 3, 2))
    runs = []
    for trace in (None, spec):
        if path == "runtime":
            tr = AsyncBridgeTrainer(AsyncBridgeConfig(trace=trace, **kw), qgrad, device="cpu")
        else:
            tr = BridgeTrainer(BridgeConfig(trace=trace, **kw), qgrad, device="cpu")
        st = tr.init(init_fn(0), seed=0)
        losses = []
        for _ in range(T):
            st, m = tr.step(st, torch.from_numpy(targets))
            losses.append(m["loss"])
        runs.append((st, torch.stack(losses)))
    (plain, lp), (traced, lt) = runs
    assert plain.obs is None and traced.obs is not None
    assert_states_equal(plain, traced)
    assert torch.equal(lp, lt)
    assert int(traced.obs.first_bad) == -1
    assert traced.obs.res_tick.tolist() == [6, 2, 4]
    assert torch.equal(traced.obs.res_loss, lt[[6, 2, 4]])


def test_trainer_trace_matches_the_reference_and_crosses_over(targets):
    """The reference's traced trainer: the sentinel and the reservoir's
    ticks exactly, the loss trace within rtol 1e-5; its state (the trace's
    included) crosses over through `convert.state_from_jax(obs=)`."""
    kw = dict(rule="trimmed_mean", num_byzantine=2, attack="alie", lam=1.0, t0=10.0)
    js = JSpec(**spec_kw(0.9, 4, 1))
    jtr = JTrainer(JConfig(topology=jerdos_renyi(M, 0.8, 2, seed=1), trace=js, **kw), jqgrad)
    tr = BridgeTrainer(BridgeConfig(topology=topo(), trace=TraceSpec(**spec_kw(0.9, 4, 1)), **kw),
                       qgrad, device="cpu")
    jst, st = jtr.init(jinit_fn(0), seed=0), tr.init(init_fn(0), seed=0)
    for _ in range(T):
        jst, _ = jtr.step(jst, jnp.asarray(targets))
        st, _ = tr.step(st, torch.from_numpy(targets))
    assert st.obs.res_tick.tolist() == np.asarray(jst.obs.res_tick).tolist()
    assert int(st.obs.first_bad) == int(jst.obs.first_bad) == -1
    for f in ("loss_trace", "res_loss"):
        np.testing.assert_allclose(getattr(st.obs, f).numpy(), np.asarray(getattr(jst.obs, f)),
                                   rtol=1e-5)
    moved = convert.state_from_jax({k: np.asarray(v) for k, v in jst.params.items()}, jst.t,
                                   key=np.asarray(jst.key),
                                   obs=tuple(np.asarray(x) for x in jst.obs), device="cpu")
    for f in jtrace.TraceState._fields:
        np.testing.assert_array_equal(getattr(moved.obs, f).numpy(),
                                      np.asarray(getattr(jst.obs, f)))
    jst2, _ = jtr.step(jst, jnp.asarray(targets))
    st2, _ = tr.step(moved, torch.from_numpy(targets))
    assert st2.obs.res_tick.tolist() == np.asarray(jst2.obs.res_tick).tolist()
    np.testing.assert_allclose(st2.obs.loss_trace.numpy(), np.asarray(jst2.obs.loss_trace),
                               rtol=1e-5)


def test_sentinel_dates_the_first_bad_tick_in_a_trainer(targets):
    """An inf target at tick 3 drives the honest loss non-finite: the
    sentinel keeps the first such tick, as the reference's does."""
    bad_at = 3
    kw = dict(rule="trimmed_mean", num_byzantine=2, attack="alie", lam=1.0, t0=10.0)
    jtr = JTrainer(JConfig(topology=jerdos_renyi(M, 0.8, 2, seed=1),
                           trace=JSpec(forensics=False), **kw), jqgrad)
    tr = BridgeTrainer(BridgeConfig(topology=topo(), trace=TraceSpec(forensics=False), **kw),
                       qgrad, device="cpu")
    jst, st = jtr.init(jinit_fn(0), seed=0), tr.init(init_fn(0), seed=0)
    for i in range(T):
        c = np.full_like(targets, np.inf) if i == bad_at else targets
        jst, _ = jtr.step(jst, jnp.asarray(c))
        st, _ = tr.step(st, torch.from_numpy(c))
    assert int(st.obs.first_bad) == int(jst.obs.first_bad) == bad_at
    assert obs_trace.summarize(TraceSpec(forensics=False), st.obs)["first_bad_tick"] == bad_at


@pytest.mark.parametrize("scenario,group", [(None, True), (None, False), ("lossy", True)])
def test_obs_stage_is_bit_inert_in_a_grid_cell(scenario, group, targets, tmp_path):
    """A traced grid (sync or net, grouped or banked, chunked) equals the
    untraced one bit for bit; each cell's trace equals its own traced
    trainer's; the events log holds the reference's run bracket, one
    ``grid.chunk`` a chunk and an ``obs.divergence`` per diverged cell."""
    t = topo()
    grid = ExperimentGrid(t, ("trimmed_mean", "median"), ("none",), (1, 2), (0,),
                          scenarios=None if scenario is None else (scenario,),
                          adversaries=("alie_online", "ipm"), lam=1.0, t0=10.0)
    spec = TraceSpec(**spec_kw(0.0, 2, 3))
    path = str(tmp_path / "ev.jsonl")
    runs = []
    with EventLog(path) as ev:
        engines = [GridEngine(grid, qgrad, num_ticks=T, group=group, trace=trace,
                              events=ev if trace else None, device="cpu")
                   for trace in (None, spec)]
        # a node Byzantine in some cells only sees a NaN target at the last
        # tick: the cells where it is honest diverge there
        some = engines[0].byz_masks.any(axis=0) & ~engines[0].byz_masks.all(axis=0)
        batches = torch.from_numpy(targets)[None].expand(T, M, D).contiguous()
        batches[T - 1, int(np.nonzero(some)[0][0])] = torch.nan
        for eng in engines:
            runs.append(eng.run(eng.init(init_fn), batches, chunk=3))
    (plain, mp), (traced, mt) = runs
    assert_states_equal(plain, traced)
    for k in mp:
        assert torch.equal(torch.nan_to_num(mp[k]), torch.nan_to_num(mt[k])), k
    # node 0 is honest in some cells (its loss goes NaN there), Byzantine in others
    diverged = ~torch.isfinite(mt["loss"]).all(dim=1)
    first = torch.where(diverged, T - 1, -1).to(torch.int32)
    assert torch.equal(traced.obs.first_bad, first)
    assert bool(diverged.any()) and not bool(diverged.all())
    assert torch.equal(torch.nan_to_num(traced.obs.loss_trace), torch.nan_to_num(mt["loss"][:, -1]))
    assert traced.obs.res_tick[0].tolist() == [6, 3]
    recs = read_events(path)
    tags = [r["tag"] for r in recs]
    assert tags[0] == "run.start" and tags.count("run.end") == 1
    assert tags.count("grid.chunk") == len(eng._bounds) + sum(
        (hi - lo - 1) // 3 for lo, hi in eng._bounds)
    cells = [r["cell"] for r in recs if r["tag"] == "obs.divergence"]
    assert cells == [c.tag for c, d in zip(eng.cells, diverged.tolist(), strict=True) if d]
    # one cell against its own traced trainer
    c = eng.cells[0]
    cfg = dict(topology=t, rule=c.rule, num_byzantine=c.b, adversary=c.adversary, lam=1.0,
               t0=10.0, byzantine_seed=grid.byzantine_seed if c.mask_seed is None else c.mask_seed,
               trace=spec)
    if scenario is None:
        tr = BridgeTrainer(BridgeConfig(**cfg), qgrad, device="cpu")
        st = tr.init(init_fn(0), seed=0)
        for i in range(T):
            st, _ = tr.step(st, batches[i])
        for f in obs_trace.TraceState._fields:
            assert torch.equal(torch.nan_to_num(getattr(traced.obs, f)[0]),
                               torch.nan_to_num(getattr(st.obs, f))), f


def test_grid_state_crosses_over_with_its_trace(targets):
    """`convert.grid_state_from_jax(obs=)` refuses a trace of another
    cell count and carries the stacked `TraceState`."""
    st = obs_trace.init_state(TraceSpec(**spec_kw()), lead=(3,), device="cpu")
    arrays = tuple(x.numpy() for x in st)
    params = {"w": np.zeros((3, M, D), np.float32)}
    keys = np.zeros((3, 2), np.uint32)
    moved = convert.grid_state_from_jax(params, 0, keys, obs=arrays, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(moved.obs, st, strict=True))
    with pytest.raises(ValueError, match="obs carry"):
        convert.grid_state_from_jax(params, 0, keys[:2], obs=arrays, device="cpu")


# ---------------------------------------------------------------------------
# the trace's forensics
# ---------------------------------------------------------------------------


def _forensic_tick(rng, e, w):
    live = rng.random((e, M, w)) < 0.7
    trim = np.where(live, rng.integers(0, 65, size=(e, M, w)) / 64.0, 0.0).astype(np.float32)
    byz = rng.random((e, M, w)) < 0.2
    stale = rng.integers(0, 40, size=(e, M, w)).astype(np.int32)
    return live, trim, byz, stale


@pytest.mark.parametrize("reservoir,stride,with_net", [(3, 2, True), (0, 1, False)])
def test_trace_update_with_forensics_matches_the_reference(reservoir, stride, with_net):
    """``trace.update`` with forensics over 8 ticks and 4 cells against
    ``jax.jit`` of the reference's, bit for bit: the per-edge counters, the
    survival sums (fractions over 64 columns: exact sums), the staleness
    and wire-bits histograms, the reservoir's trim matrices."""
    e, w, d = 4, 7, 1000
    rng = np.random.default_rng(5)
    js = JSpec(reservoir=reservoir, stride=stride, hist_bins=8, stale_max=20)
    ts = TraceSpec(reservoir=reservoir, stride=stride, hist_bins=8, stale_max=20)
    jst = jtrace.init_state(js, M, w, lead=(e,))
    st = obs_trace.init_state(ts, M, w, lead=(e,), device="cpu")
    bits = (32000, 8000, 33000, 64)
    up = jax.jit(jax.vmap(lambda s, lo, c, tr, lv, bz, sl, wb, le, t: jtrace.update(
        js, s, t=t, loss=lo, consensus=c, trim_frac=tr, live=lv, byz_edge=bz,
        staleness=sl if with_net else None, wire_bits=wb, live_edges=le, d=d),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None)))
    for t in range(8):
        live, trim, byz, stale = _forensic_tick(rng, e, w)
        loss = rng.normal(size=e).astype(np.float32)
        le = rng.integers(10, 50, size=e).astype(np.float32)
        jst = up(jst, jnp.asarray(loss), jnp.asarray(loss), jnp.asarray(trim), jnp.asarray(live),
                 jnp.asarray(byz), jnp.asarray(stale), jnp.asarray(bits), jnp.asarray(le), t)
        st = obs_trace.update(ts, st, t=t, loss=torch.from_numpy(loss),
                              consensus=torch.from_numpy(loss), trim_frac=torch.from_numpy(trim),
                              live=torch.from_numpy(live), byz_edge=torch.from_numpy(byz),
                              staleness=torch.from_numpy(stale) if with_net else None,
                              wire_bits=bits, live_edges=torch.from_numpy(le), d=d)
        for f in jtrace.TraceState._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                          err_msg=f"{f} at tick {t}")
    senders = np.where(rng.random((M, w)) < 0.8, rng.integers(0, M, size=(M, w)), -1)
    byz_mask = np.zeros(M, bool)
    byz_mask[[1, 4]] = True
    one = obs_trace.TraceState(*(x[1] for x in st))
    jone = jtrace.TraceState(*(x[1] for x in jst))
    assert (obs_trace.summarize(ts, one, byz_mask=byz_mask, senders=senders)
            == jtrace.summarize(js, jone, byz_mask=byz_mask, senders=senders))


def test_ranking_auc_sender_grid_and_staleness_are_the_reference():
    rng = np.random.default_rng(3)
    for scores, labels in ((rng.normal(size=40), rng.random(40) < 0.3),
                           (np.round(rng.normal(size=40)), rng.random(40) < 0.5),
                           (np.zeros(5), np.ones(5, bool))):
        assert obs_trace.ranking_auc(scores, labels) == jtrace.ranking_auc(scores, labels)
    adj = jerdos_renyi(M, 0.5, 2, seed=3).adjacency
    np.testing.assert_array_equal(obs_trace.sender_grid(M, adjacency=adj),
                                  jtrace.sender_grid(M, adjacency=adj))
    np.testing.assert_array_equal(obs_trace.sender_grid(M), jtrace.sender_grid(M))
    from repro.core.neighbors import NeighborTable as JTable
    from repro_torch.core.neighbors import NeighborTable

    np.testing.assert_array_equal(
        obs_trace.sender_grid(M, neighbors=NeighborTable.from_adjacency(adj, device="cpu")),
        jtrace.sender_grid(M, neighbors=JTable.from_adjacency(adj)))
    from repro.net import mailbox as jmb
    from repro_torch.net import mailbox as tmb

    ticks = rng.integers(-3, 9, size=(M, M)).astype(np.int32)
    ticks[ticks < 0] = tmb.NEVER
    net = tmb.MailboxState(*(torch.zeros(1) for _ in tmb.MailboxState._fields))._replace(
        send_tick=torch.from_numpy(ticks))
    jnet = type("Net", (), {"send_tick": jnp.asarray(ticks)})()
    np.testing.assert_array_equal(obs_trace.staleness_of(net, 9).numpy(),
                                  np.asarray(jtrace.staleness_of(jnet, 9)))
    assert obs_trace.staleness_of(None, 3) is None
    np.testing.assert_array_equal(
        tmb.generation_match(torch.from_numpy(ticks), torch.from_numpy(ticks.T.copy())).numpy(),
        np.asarray(jmb.generation_match(jnp.asarray(ticks), jnp.asarray(ticks.T))))


@pytest.mark.parametrize("path", ["dense", "sparse", "runtime"])
def test_forensic_trace_is_bit_inert_and_matches_the_reference(path, targets):
    """Forensics on: the trajectory is the untraced one bit for bit, and
    the counters, the survival sums and ``obs_trim_frac`` are the
    reference's traced trainer's (an `alie` run that agrees within rtol
    1e-5: counters exact, sums within rtol 1e-5)."""
    from repro.net import AsyncBridgeConfig as JAsyncConfig
    from repro.net import AsyncBridgeTrainer as JAsyncTrainer
    from repro.net import ChannelConfig as JChannel
    from repro_torch.net import ChannelConfig

    kw = dict(rule="trimmed_mean", num_byzantine=2, attack="alie", lam=1.0, t0=10.0,
              sparse=path == "sparse")
    spec_kw_ = dict(decide_stride=2, reservoir=2, stride=3)
    runs = []
    for trace in (None, TraceSpec(**spec_kw_)):
        if path == "runtime":
            tr = AsyncBridgeTrainer(AsyncBridgeConfig(topology=topo(), trace=trace,
                                                      channel=ChannelConfig(drop_prob=0.1),
                                                      staleness_bound=2, **kw), qgrad,
                                    device="cpu")
        else:
            tr = BridgeTrainer(BridgeConfig(topology=topo(), trace=trace, **kw), qgrad,
                               device="cpu")
        st = tr.init(init_fn(0), seed=0)
        for _ in range(T):
            st, m = tr.step(st, torch.from_numpy(targets))
        runs.append((st, m))
    assert_states_equal(runs[0][0], runs[1][0])
    st, m = runs[1]
    jtopo = jerdos_renyi(M, 0.8, 2, seed=1)
    if path == "runtime":
        jtr = JAsyncTrainer(JAsyncConfig(topology=jtopo, trace=JSpec(**spec_kw_),
                                         channel=JChannel(drop_prob=0.1), staleness_bound=2,
                                         **kw), jqgrad)
    else:
        jtr = JTrainer(JConfig(topology=jtopo, trace=JSpec(**spec_kw_), **kw), jqgrad)
    jst = jtr.init(jinit_fn(0), seed=0)
    for _ in range(T):
        jst, jm = jtr.step(jst, jnp.asarray(targets))
    for f in ("edge_seen", "stale_hist", "bits_hist", "byz_seen", "hon_seen", "res_tick"):
        np.testing.assert_array_equal(getattr(st.obs, f).numpy(), np.asarray(getattr(jst.obs, f)),
                                      err_msg=f)
    for f in ("edge_trim", "byz_trim", "hon_trim", "res_trim"):
        np.testing.assert_allclose(getattr(st.obs, f).numpy(), np.asarray(getattr(jst.obs, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(float(m["obs_trim_frac"]), float(jm["obs_trim_frac"]), rtol=1e-5)
    assert float(st.obs.edge_seen.sum()) > 0


def test_forensic_grid_cells_equal_their_trainer_runs(targets):
    """A forensic trace over a grid's cells (sync, sparse, banked): each
    cell's aggregates its own traced trainer's, bit for bit."""
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median"), ("alie",), (1, 2), (0,),
                          lam=1.0, t0=10.0)
    spec = TraceSpec(decide_stride=2)
    eng = GridEngine(grid, qgrad, trace=spec, sparse=True, group=False, device="cpu")
    tg = torch.from_numpy(targets)
    final, _ = eng.run(eng.init(init_fn), torch.stack([tg] * T))
    assert final.obs.edge_seen.shape == (4, M, eng.neighbors.k)
    for i, c in enumerate(eng.cells):
        tr = BridgeTrainer(BridgeConfig(topology=grid.topology, rule=c.rule, num_byzantine=c.b,
                                        attack=c.attack, lam=1.0, t0=10.0, sparse=True,
                                        byzantine_seed=grid.byzantine_seed, trace=spec),
                           qgrad, device="cpu")
        st = tr.init(init_fn(0), seed=0)
        for _ in range(T):
            st, _ = tr.step(st, tg)
        for f in obs_trace.TraceState._fields:
            assert torch.equal(getattr(final.obs, f)[i], getattr(st.obs, f)), (c, f)
