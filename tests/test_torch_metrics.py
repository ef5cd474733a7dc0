"""The live metric rings, the chunked runner and ``screen_chunk`` in the port
(`repro_torch.obs.metrics`, `BridgeTrainer.run_chunks`,
`GridEngine(metrics=)`, `screening._streams`), on the CPU against the
reference (`repro.obs.metrics`, `repro.core.bridge`, `repro.core.screening`).

Tolerances, and why:

* the ring's own arithmetic (`update`, `rows_of`, the non-finite column)
  against the reference's `update` under ``jax.jit``: bit for bit;
* ``stale_quantiles`` against ``jnp.nanquantile`` on integer ages: bit for
  bit (linear interpolation between small integers is exact);
* metrics on against off, `run_chunks` against the step loop: bit for bit
  (the ring only reads what the step computes; a chunk is the same steps);
* the ring's rows against the reference's ring for the same run: tick, wire
  bits, the stale quantiles and the sentinel exactly, ``rho`` within 1 ulp
  (rtol 1.2e-7), loss, consensus and grad norm within rtol 1e-5 (sums over
  d in XLA's order against torch's);
* ``screen_chunk``: the chunked ``geomedian`` and ``clipped_mean`` within
  ``4 eps max|x|`` per node of the reference's chunked result (the rule
  tests' bound), every other rule bit for bit (the kernel rules run whole).
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BridgeConfig as JConfig
from repro.core import BridgeTrainer as JTrainer
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.core import screening as jscreening
from repro.core.neighbors import NeighborTable as JTable
from repro.net import AsyncBridgeConfig as JAsyncConfig
from repro.net import AsyncBridgeTrainer as JAsyncTrainer
from repro.net import ChannelConfig as JChannel
from repro.obs import metrics as jmetrics
from repro_torch import convert
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, screening
from repro_torch.core.neighbors import NeighborTable
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer, ChannelConfig
from repro_torch.obs import EventLog, TraceSpec, read_events
from repro_torch.obs.metrics import (COLUMNS, AlertEngine, AlertRules, MetricSpec, MetricWriter,
                                     init_state, read_metrics, rows_of, stale_quantiles, update)
from repro_torch.sim import ExperimentGrid, GridEngine
from repro_torch.stream import StreamBridgeTrainer
from test_torch_rules import assert_close_rule, nan_equal

M, D, T = 12, 5, 25
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


def jqgrad(params, batch):
    w, c = params["w"], batch
    return 0.5 * jnp.sum((w - c) ** 2), {"w": w - c}


def jinit(seed=0):
    return jreplicate({"w": jnp.zeros(D)}, M, perturb=0.1, key=jax.random.PRNGKey(seed))


def init_fn(seed=0):
    """The reference's replicas, carried over (the port's normals are within
    rtol 5.8e-6 of the reference's; a parity run starts from the same
    values)."""
    return convert.params_from_jax({"w": np.asarray(jinit(seed)["w"])}, device="cpu")


@pytest.fixture(scope="module")
def targets():
    return torch.tensor(np.random.default_rng(0).normal(size=(M, D)), dtype=torch.float32)


def topo():
    return erdos_renyi(M, 0.8, 2, seed=1)


def cfg_kw(**kw):
    base = dict(topology=topo(), rule="trimmed_mean", num_byzantine=2, attack="alie",
                lam=1.0, t0=10.0)
    base.update(kw)
    return base


def sync_run(targets, *, stream=False, ticks=T, **kw):
    cls = StreamBridgeTrainer if stream else BridgeTrainer
    tr = cls(BridgeConfig(**cfg_kw(**kw)), qgrad, device="cpu")
    st = tr.init(init_fn(0), seed=0)
    streams = {"loss": [], "consensus_dist": []}
    for _ in range(ticks):
        st, m = tr.step(st, targets)
        for k in streams:
            streams[k].append(m[k])
    return st, {k: torch.stack(v) for k, v in streams.items()}


def net_cfg(metrics=None, cls=AsyncBridgeConfig, chan=ChannelConfig, graph=erdos_renyi):
    return cls(topology=graph(M, 0.8, 2, seed=1), rule="trimmed_mean", num_byzantine=2,
               attack="sign_flip", channel=chan(drop_prob=0.1), staleness_bound=2, lam=1.0,
               t0=10.0, metrics=metrics)


def col(buf, name):
    return np.asarray(buf)[..., COLUMNS.index(name)]


# ---------------------------------------------------------------------------
# the ring itself
# ---------------------------------------------------------------------------


def test_ring_wraparound_decode_and_the_reference_update():
    """Ten ticks through a four-slot ring: the last four survive, tick
    ordered; `after` dedups; absent columns are None.  Every slot bit for
    bit the reference's `update` under ``jax.jit`` on the same values."""
    spec, jspec = MetricSpec(capacity=4), jmetrics.MetricSpec(capacity=4)
    st, jst = init_state(spec, device="cpu"), jmetrics.init_state(jspec)
    jup = jax.jit(lambda s, t, lo, c, r: jmetrics.update(
        jspec, s, t=t, vals={"loss": lo, "consensus_dist": c, "rho": r}))
    rng = np.random.default_rng(3)
    for t in range(10):
        lo, c, r = (np.float32(x) for x in rng.normal(size=3))
        st = update(spec, st, t=t, vals={"loss": torch.tensor(lo), "consensus_dist": c, "rho": r})
        jst = jup(jst, t, lo, c, r)
    assert int(st.count) == 10
    assert nan_equal(st.buf.numpy(), np.asarray(jst.buf)).all()
    rows = rows_of(st.buf, st.count)
    assert [r["tick"] for r in rows] == [6, 7, 8, 9]
    assert [r["tick"] for r in rows_of(st.buf, st.count, after=7)] == [8, 9]
    assert rows[0]["evicted_frac"] is None and rows[0]["stale_p50"] is None
    assert rows == jmetrics.rows_of(jst.buf, jst.count)
    with pytest.raises(ValueError):
        MetricSpec(capacity=0)


def test_short_first_chunk_and_the_nonfinite_column():
    spec = MetricSpec(capacity=8)
    st = init_state(spec, lead=(2,), device="cpu")
    st = update(spec, st, t=0, vals={"loss": torch.tensor([1.0, 2.0]),
                                     "consensus_dist": torch.tensor([0.0, 0.0])})
    st = update(spec, st, t=1, vals={"loss": torch.tensor([float("nan"), 1.0]),
                                     "consensus_dist": torch.tensor([0.0, float("inf")])})
    for e in range(2):
        rows = rows_of(st.buf[e], st.count[e])
        assert [r["tick"] for r in rows] == [0, 1]
        assert rows[0]["nonfinite"] == 0.0 and rows[1]["nonfinite"] == 1.0
    assert rows_of(st.buf[0], st.count[0])[1]["loss"] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stale_quantiles_match_jnp_nanquantile(seed):
    """Integer ages under a live mask (a row with no live slot included):
    the p50 and p90 bit for bit ``jnp.nanquantile``'s."""
    rng = np.random.default_rng(seed)
    ages = rng.integers(0, 6, size=(3, M, 7)).astype(np.int32)
    live = rng.random((3, M, 7)) < 0.6
    live[2] = False
    got = stale_quantiles(torch.from_numpy(ages), torch.from_numpy(live))
    for e in range(3):
        want = jmetrics.stale_quantiles(jnp.asarray(ages[e]), jnp.asarray(live[e]))
        for k in ("stale_p50", "stale_p90"):
            assert nan_equal(got[k][e].numpy(), np.asarray(want[k])), (k, e)


# ---------------------------------------------------------------------------
# metrics on: bit-inert, and the reference's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,attack,codec,stream", [
    ("trimmed_mean", "alie", "identity", False),
    ("median", "random", "int8", False),
    ("mean", "sign_flip", "identity", False),
    ("trimmed_mean", "random", "identity", True),
    ("median", "sign_flip", "int8", True),
])
def test_sync_metrics_bit_inert(targets, rule, attack, codec, stream):
    off, ms_off = sync_run(targets, rule=rule, attack=attack, codec=codec, stream=stream,
                           ticks=10)
    on, ms_on = sync_run(targets, rule=rule, attack=attack, codec=codec, stream=stream,
                         ticks=10, metrics=MetricSpec(capacity=10))
    assert off.mets is None and on.mets is not None
    assert torch.equal(off.params["w"], on.params["w"])
    assert np.array_equal(off.key, on.key)
    for k in ms_off:
        assert torch.equal(ms_off[k], ms_on[k]), k
    assert [r["tick"] for r in rows_of(on.mets.buf, on.mets.count)] == list(range(10))


def test_net_metrics_bit_inert_and_staleness_columns(targets):
    batches = torch.stack([targets] * T)
    runs = []
    for spec in (None, MetricSpec(capacity=T)):
        tr = AsyncBridgeTrainer(net_cfg(spec), qgrad, device="cpu")
        runs.append(tr.run_scan(tr.init(init_fn(0)), batches))
    (off, ms_off), (on, ms_on) = runs
    assert off.mets is None
    assert torch.equal(off.params["w"], on.params["w"])
    for k in ms_off:
        assert torch.equal(ms_off[k], ms_on[k]), k
    assert np.isfinite(col(on.mets.buf, "stale_p50")).any()


def assert_rows_match(buf, jbuf, stale: bool):
    for name in COLUMNS:
        got, want = col(buf, name), col(jbuf, name)
        if name in ("loss", "consensus_dist", "grad_norm"):
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        elif name == "rho":
            np.testing.assert_allclose(got, want, rtol=1.2e-7, err_msg=name)
        else:
            assert nan_equal(got, want).all(), name
    assert np.isfinite(col(buf, "stale_p90")).any() == stale


def test_ring_rows_match_the_reference_sync_and_runtime(targets):
    """The same seeded run in both packages: the synchronous trainer (int8
    codec, wire bits in the ring) and the runtime (the stale quantiles)."""
    spec, jspec = MetricSpec(capacity=T), jmetrics.MetricSpec(capacity=T)
    kw = dict(rule="trimmed_mean", num_byzantine=2, attack="sign_flip", lam=1.0, t0=10.0,
              codec="int8")
    tr = BridgeTrainer(BridgeConfig(topology=topo(), metrics=spec, **kw), qgrad, device="cpu")
    jtr = JTrainer(JConfig(topology=jerdos_renyi(M, 0.8, 2, seed=1), metrics=jspec, **kw),
                   jqgrad)
    st, jst = tr.init(init_fn(0)), jtr.init(jinit(0))
    jt = jnp.asarray(targets.numpy())
    for _ in range(T):
        st, _ = tr.step(st, targets)
        jst, _ = jtr.step(jst, jt)
    assert int(st.mets.count) == int(jst.mets.count) == T
    assert_rows_match(st.mets.buf.numpy(), np.asarray(jst.mets.buf), stale=False)

    ntr = AsyncBridgeTrainer(net_cfg(spec), qgrad, device="cpu")
    jntr = JAsyncTrainer(net_cfg(jspec, JAsyncConfig, JChannel, jerdos_renyi), jqgrad)
    nst, _ = ntr.run_scan(ntr.init(init_fn(0)), torch.stack([targets] * T))
    jnst, _ = jntr.run_scan(jntr.init(jinit(0)), jnp.stack([jt] * T))
    assert_rows_match(nst.mets.buf.numpy(), np.asarray(jnst.mets.buf), stale=True)


# ---------------------------------------------------------------------------
# run_chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream,chunk,net", [(False, 7, False), (False, T, False),
                                              (True, 7, False), (False, 7, True)])
def test_run_chunks_matches_step_loop(targets, stream, chunk, net):
    """Chunks of 7 (25 = 3 x 7 + 4) and one of 25: the state, the ring and
    every metric stream the step loop's, bit for bit."""
    spec = MetricSpec(capacity=T)
    if net:
        make = lambda: AsyncBridgeTrainer(net_cfg(spec), qgrad, device="cpu")
    else:
        cls = StreamBridgeTrainer if stream else BridgeTrainer
        make = lambda: cls(BridgeConfig(**cfg_kw(metrics=spec)), qgrad, device="cpu")
    tr = make()
    st = tr.init(init_fn(0))
    loop = []
    for _ in range(T):
        st, m = tr.step(st, targets)
        loop.append(m)
    tr2 = make()
    st2, ms = tr2.run_chunks(tr2.init(init_fn(0)), lambda i: targets, T, chunk=chunk)
    assert torch.equal(st.params["w"], st2.params["w"])
    assert torch.equal(torch.nan_to_num(st.mets.buf), torch.nan_to_num(st2.mets.buf))
    for k in loop[0]:
        want = torch.stack([torch.as_tensor(m[k], dtype=torch.float32) for m in loop])
        assert torch.equal(ms[k], want), k
    assert int(st2.mets.count) == T


def test_run_chunks_chunk_errors_and_defaults(targets):
    tr = BridgeTrainer(BridgeConfig(**cfg_kw(metrics=MetricSpec(capacity=4))), qgrad,
                       device="cpu")
    st = tr.init(init_fn(0))
    with pytest.raises(ValueError, match="capacity"):
        tr.run_chunks(st, lambda i: targets, 8, chunk=6)
    with pytest.raises(ValueError, match=">= 1"):
        tr.run_chunks(st, lambda i: targets, 8, chunk=0)
    # no chunk: the ring's capacity, so a writer flushing a chunk loses nothing
    st6, ms = tr.run_chunks(st, lambda i: targets, 10)
    assert int(st6.mets.count) == 10 and ms["loss"].shape == (10,)
    # no spec: chunks of 64; `start` offsets the batches
    plain = BridgeTrainer(BridgeConfig(**cfg_kw()), qgrad, device="cpu")
    seen = []
    plain.run_chunks(plain.init(init_fn(0)), lambda i: seen.append(i) or targets, 3, start=5)
    assert seen == [5, 6, 7]


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def test_writer_streams_gapless_rows_and_chunk_events(targets, tmp_path):
    path, epath = str(tmp_path / "metrics.jsonl"), str(tmp_path / "events.jsonl")
    tr = BridgeTrainer(BridgeConfig(**cfg_kw(metrics=MetricSpec(capacity=8))), qgrad,
                       device="cpu")
    with EventLog(epath) as ev, MetricWriter(path, events=ev) as w:
        tr.run_chunks(tr.init(init_fn(0)), lambda i: targets, T, writer=w, events=ev)
    rows = read_metrics(path)
    assert [r["tick"] for r in rows] == list(range(T))
    assert all(r["tag"] == "train" for r in rows)
    walls = [r["wall"] for r in rows]
    assert walls == sorted(walls)
    chunks = [e for e in read_events(epath) if e["tag"] == "train.chunk"]
    assert [(e["lo"], e["hi"]) for e in chunks] == [(0, 8), (8, 16), (16, 24), (24, 25)]
    assert all(e["train_tag"] == "train" and e["dispatch_s"] >= 0 for e in chunks)
    # the reference's reader parses the port's lines, keys in the reference's order
    assert jmetrics.read_metrics(path) == rows
    with open(path) as f:
        assert list(json.loads(f.readline())) == ["tag", "wall", *COLUMNS]


def test_writer_close_drains_durably(tmp_path):
    spec = MetricSpec(capacity=16)
    st = init_state(spec, device="cpu")
    for t in range(16):
        st = update(spec, st, t=t, vals={"loss": 1.0, "consensus_dist": 0.0})
    path = str(tmp_path / "m.jsonl")
    w = MetricWriter(path, flush_interval=60.0)
    w.flush(st, tag="a")
    w.flush(st, tag="b")
    w.flush(st, tag="a")  # the same ticks again: nothing written
    w.close()
    assert w.rows_written == 32 and len(read_metrics(path)) == 32
    assert len(read_metrics(path, tag="a")) == 16
    assert len(read_metrics(path, after=9, tag="b")) == 6
    w.close()
    w.flush(st, tag="c")  # after close: dropped
    assert len(read_metrics(path)) == 32


def test_writer_emits_alert_events(tmp_path):
    spec = MetricSpec(capacity=4)
    st = init_state(spec, device="cpu")
    st = update(spec, st, t=0, vals={"loss": 1.0, "consensus_dist": 0.0})
    st = update(spec, st, t=1, vals={"loss": float("nan"), "consensus_dist": 0.0})
    epath = str(tmp_path / "e.jsonl")
    with EventLog(epath) as ev:
        with MetricWriter(str(tmp_path / "m.jsonl"), alerts=AlertRules(), events=ev) as w:
            w.flush(st, tag="cell0")
    alerts = [e for e in read_events(epath) if e["tag"] == "obs.alert"]
    assert [(a["kind"], a["stream"], a["tick"]) for a in alerts] == [("divergence", "cell0", 1)]


@pytest.mark.parametrize("rows,rules", [
    ([{"tick": 3, "nonfinite": 1.0}, {"tick": 4, "nonfinite": 1.0}], AlertRules()),
    ([{"tick": 0, "loss": 5.0}, {"tick": 1, "loss": 1.0}, {"tick": 2, "loss": 9.0},
      {"tick": 3, "loss": 11.0}], AlertRules(loss_spike_factor=10.0)),
    ([{"tick": 0, "evicted_frac": 0.5, "wire_bytes_total": 60.0},
      {"tick": 1, "evicted_frac": 0.5, "wire_bytes_total": 60.0}],
     AlertRules(evict_spike=0.2, wire_budget_bytes=100.0)),
])
def test_alert_engine_matches_the_reference(rows, rules):
    eng = AlertEngine(rules)
    jeng = jmetrics.AlertEngine(jmetrics.AlertRules(**dataclasses.asdict(rules)))
    for tag in ("t", "u"):
        for r in rows:
            assert eng.feed(tag, r) == jeng.feed(tag, r)


# ---------------------------------------------------------------------------
# the grid engine
# ---------------------------------------------------------------------------


def test_grid_engine_streams_per_cell_tags(targets, tmp_path):
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median"), ("alie",), (2,), (0, 1),
                          lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, metrics=MetricSpec(capacity=8), device="cpu")
    path = str(tmp_path / "m.jsonl")
    with MetricWriter(path) as w:
        final, ms = engine.run(engine.init(lambda s: init_fn(s)), torch.stack([targets] * 8),
                               chunk=1, metric_writer=w)
    tags = {c.tag for c in engine.cells}
    assert len(tags) == 4 and {r["tag"] for r in read_metrics(path)} == tags
    for i, c in enumerate(engine.cells):
        rows = read_metrics(path, tag=c.tag)
        assert [r["tick"] for r in rows] == list(range(8))
        np.testing.assert_array_equal([r["loss"] for r in rows], ms["loss"][i].numpy())
    # metrics on: the cells' states those of the metric-free engine
    plain = GridEngine(grid, qgrad, device="cpu")
    pf, _ = plain.run(plain.init(lambda s: init_fn(s)), torch.stack([targets] * 8))
    assert torch.equal(pf.params["w"], final.params["w"])


def test_grid_engine_small_ring_keeps_tail_and_needs_a_spec(targets, tmp_path):
    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("alie",), (2,), (0,), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, metrics=MetricSpec(capacity=4), device="cpu")
    path = str(tmp_path / "m.jsonl")
    with MetricWriter(path) as w:
        engine.run(engine.init(lambda s: init_fn(s)), torch.stack([targets] * 8),
                   metric_writer=w)
    assert [r["tick"] for r in read_metrics(path)] == [4, 5, 6, 7]
    bare = GridEngine(grid, qgrad, device="cpu")
    with MetricWriter(str(tmp_path / "x.jsonl")) as w, pytest.raises(ValueError, match="metrics"):
        bare.run(bare.init(lambda s: init_fn(s)), torch.stack([targets] * 2), metric_writer=w)


# ---------------------------------------------------------------------------
# screen_chunk
# ---------------------------------------------------------------------------

CHUNK = 16
STREAM_RULES = ("geomedian", "clipped_mean", "mean", "rep_trimmed_mean", "rep_median",
                "trimmed_mean", "median")


def chunk_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0, size=(n, 1))).astype(np.float32)
    w[:2] *= 30.0
    adj = rng.random((n, n)) < 0.7
    np.fill_diagonal(adj, False)
    return w, adj


def jax_chunked(rule, w, adj, b, chunk, sparse):
    """The reference trainer's screen with its topology closed over."""
    if sparse:
        jt = JTable.from_adjacency(adj)
        fn = jax.jit(lambda w_: jscreening.screen_views_banked(
            jt.gather_rows(w_), jt.valid_dev, w_, (rule,), 0, b, chunk=chunk))
    else:
        a = jnp.asarray(adj)
        fn = jax.jit(lambda w_: jscreening.screen_all_banked(w_, a, (rule,), 0, b, chunk=chunk))
    return np.asarray(fn(jnp.asarray(w)))


def port_chunked(rule, w, adj, b, chunk, sparse):
    wt = torch.from_numpy(w)[None]
    if sparse:
        table = NeighborTable.from_adjacency(adj, device="cpu")
        y = screening.screen_gathered_banked(wt, table, (rule,), (0,), b, chunk=chunk)
    else:
        y = screening.screen_all_banked(wt, torch.from_numpy(adj), (rule,), (0,), b, chunk=chunk)
    return y[0].numpy()


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("d", [64, 60])
@pytest.mark.parametrize("rule", STREAM_RULES)
def test_screen_chunk_matches_the_references_chunked_result(rule, d, sparse):
    """d = 64 in four chunks of 16 and d = 60 with a 12-wide tail (the
    reference zero-pads it)."""
    n, b = 8, 1
    w, adj = chunk_inputs(n, d, seed=d)
    got = port_chunked(rule, w, adj, b, CHUNK, sparse)
    want = jax_chunked(rule, w, adj, b, CHUNK, sparse)
    if rule in ("geomedian", "clipped_mean"):
        assert_close_rule(got, want, w, adj, w)
        # the chunking changes these rules' answer, and both packages agree on it
        whole = jax_chunked(rule, w, adj, b, None, sparse)
        assert np.abs(whole - want).max() > 1e-3
    else:
        assert nan_equal(got, want).all()
        if rule != "mean":  # coordinate-wise and no folded divisor: chunked is whole
            assert nan_equal(port_chunked(rule, w, adj, b, None, sparse), got).all()


@pytest.mark.parametrize("rule", ["geomedian", "rep_median", "trimmed_mean"])
def test_screen_chunk_on_views_and_the_decide_refusal(rule):
    """The runtime's views entry streams too; the decision path refuses
    where the reference refuses (any rule but Krum / Bulyan past the
    chunk), in a trainer's step as well."""
    rng = np.random.default_rng(5)
    views = rng.normal(size=(6, 5, 64)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.8
    sv = rng.normal(size=(6, 64)).astype(np.float32)
    got = screening.screen_views_banked(torch.from_numpy(views)[None], torch.from_numpy(mask),
                                        torch.from_numpy(sv)[None], (rule,), (0,), 1,
                                        chunk=CHUNK)[0].numpy()
    want = np.asarray(jax.jit(lambda v, m, s: jscreening.screen_views_banked(
        v, m, s, (rule,), 0, 1, chunk=CHUNK))(jnp.asarray(views), jnp.asarray(mask),
                                              jnp.asarray(sv)))
    if rule == "geomedian":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 1.2e-7 * np.abs(views).max())
    else:
        assert nan_equal(got, want).all()
    for bad in (rule, "median"):
        with pytest.raises(ValueError, match="cannot stream coordinates"):
            screening.check_decide_streams((bad,), 64, CHUNK)
        with pytest.raises(ValueError) as jerr:
            jscreening.check_decide_streams((bad,), 64, CHUNK)
        assert "cannot stream" in str(jerr.value)
    screening.check_decide_streams(("krum", "bulyan"), 64, CHUNK)
    screening.check_decide_streams((rule,), 64, None)
    tr = BridgeTrainer(BridgeConfig(topology=erdos_renyi(8, 0.8, 1, seed=1),
                                    trace=TraceSpec(), screen_chunk=CHUNK), qgrad, device="cpu")
    w0 = {"w": torch.zeros(8, 64)}
    with pytest.raises(ValueError, match="forensics cannot stream"):
        tr.step(tr.init(w0), torch.ones(8, 64))


def test_trainer_screen_chunk_follows_the_reference():
    """``BridgeConfig.screen_chunk`` through both trainers: geomedian at
    d = 64 in chunks of 16 for 3 ticks, within the rule bound's scale."""
    d, m = 64, 8
    rng = np.random.default_rng(2)
    tg = rng.normal(size=(m, d)).astype(np.float32)
    w0 = jreplicate({"w": jnp.zeros(d)}, m, perturb=0.5, key=jax.random.PRNGKey(4))
    kw = dict(rule="geomedian", num_byzantine=1, attack="sign_flip", lr=0.1, screen_chunk=CHUNK)
    jtr = JTrainer(JConfig(topology=jerdos_renyi(m, 0.8, 1, seed=1), **kw), jqgrad)
    tr = BridgeTrainer(BridgeConfig(topology=erdos_renyi(m, 0.8, 1, seed=1), **kw), qgrad,
                       device="cpu")
    whole = BridgeTrainer(BridgeConfig(topology=erdos_renyi(m, 0.8, 1, seed=1),
                                       **dict(kw, screen_chunk=None)), qgrad, device="cpu")
    jst = jtr.init(w0)
    st = tr.init(convert.params_from_jax({"w": np.asarray(w0["w"])}, device="cpu"))
    wst = whole.init(convert.params_from_jax({"w": np.asarray(w0["w"])}, device="cpu"))
    for _ in range(3):
        jst, _ = jtr.step(jst, jnp.asarray(tg))
        st, _ = tr.step(st, torch.from_numpy(tg))
        wst, _ = whole.step(wst, torch.from_numpy(tg))
    want = np.asarray(jst.params["w"])
    np.testing.assert_allclose(st.params["w"].numpy(), want, rtol=0,
                               atol=16 * 1.2e-7 * np.abs(want).max())
    assert np.abs(wst.params["w"].numpy() - want).max() > 1e-4


def test_the_port_imports_no_jax():
    """No module of `src/repro_torch/` imports jax or the reference."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    bad += [f"{path}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not bad, bad
