"""The port's network runtime pieces (`repro_torch.net`, the graph builders,
the neighbor table's schedule forms, the message attacks, the row-key
random streams and the views screens' plain versions) against the
reference's, on the CPU, at small sizes (M = 6-12, d = 16-64).

Every comparison is bit for bit (``np.array_equal``; NaN-aware where NaN
payloads travel), except the Byzantine senders' messages of the random
attack, whose normal draw is within a relative 5.9e-6 of the reference's
(``test_torch_prng.py``), and of the attacks built on the honest mean,
within 4 ulps (see `test_message_attacks_equal_reference`).  The views
kernels against their plain versions need the card: they are in
``test_torch_kernels.py`` (``-m cuda``), which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import byzantine as jbyz
from repro.core import graph as jgraph
from repro.core import neighbors as jneighbors
from repro.core import screening as jscreening
from repro.net import channel as jchannel
from repro.net import dynamic as jdynamic
from repro.net import mailbox as jmb
from repro.net import runtime as jruntime
from repro.net import scenarios as jscenarios
from repro_torch import prng
from repro_torch.core import byzantine, graph, neighbors, screening
from repro_torch.kernels import ops, ref, views_screen
from repro_torch.net import channel, dynamic, runtime, scenarios
from repro_torch.net import mailbox as mb
from test_torch_kernels import views_inputs

CPU = "cpu"


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(a, b):
    a, b = np_of(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f"{np.sum(a != b)} entries differ"


# ---------------------------------------------------------------------------
# Row-key random streams (the per-link codec's keys)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_row_keys_equal_vmapped_jax(seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    ids = np.array([0, 1, 13, 500, 2**31 - 1, 4095], np.int32)
    jk = jax.vmap(lambda e: jax.random.fold_in(key, e))(jnp.asarray(ids))
    pk = prng.fold_in(np.asarray(key), torch.as_tensor(ids))
    same(pk, np.asarray(jk).astype(np.int64))
    same(prng.fold_in(pk, 9), np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jk)))
    same(prng.split(pk, 3), np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jk)))
    e = len(ids)
    same(prng.bits(pk, (e, 5, 3), CPU),
         np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5, 3)))(jk)).astype(np.int64))
    same(prng.uniform(pk, (e, 7, 129), CPU),
         np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (7, 129)))(jk)))
    same(prng.randint(pk, (e, 11), -128, 128, torch.int32, CPU),
         np.asarray(jax.vmap(lambda k: jax.random.randint(k, (11,), -128, 128, jnp.int32))(jk)))
    with pytest.raises(ValueError, match="leading axis"):
        prng.uniform(pk, (e + 1, 3), CPU)


# ---------------------------------------------------------------------------
# Graph builders and the neighbor table's schedule forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda g: g.ring_of_cliques(4, 3, 1),
    lambda g: g.ring_of_cliques(2, 5, 0),
    lambda g: g.random_geometric(40, 1, seed=3),
    lambda g: g.random_geometric(30, 0, radius=0.3, seed=1),
    lambda g: g.toroidal_grid(4, 5, 1),
    lambda g: g.toroidal_grid(3, 4, 3, diagonal=True),
    lambda g: g.make_topology("small_world:3", 24, 1, seed=2),
    lambda g: g.make_topology("geometric", 36, 1, seed=5),
    lambda g: g.make_topology("torus", 36, 1),
    lambda g: g.make_topology("torus:3", 12, 1),
    lambda g: g.make_topology("erdos_renyi:0.7", 10, 1, seed=4),
    lambda g: g.make_topology("complete", 6, 1),
])
def test_graph_builders_equal_reference(build):
    want, got = build(jgraph), build(graph)
    same(got.adjacency, want.adjacency)
    assert got.num_byzantine == want.num_byzantine


def test_graph_builders_refuse_what_the_reference_refuses():
    for bad in (lambda g: g.toroidal_grid(2, 5, 0), lambda g: g.toroidal_grid(3, 3, 2),
                lambda g: g.make_topology("torus:5", 12, 1), lambda g: g.make_topology("x", 8, 1)):
        with pytest.raises(ValueError):
            bad(jgraph)
        with pytest.raises(ValueError):
            bad(graph)


def test_from_schedule_live_schedule_gather_edges():
    topo = jgraph.erdos_renyi(10, 0.5, 1, seed=0)
    sched = jdynamic.edge_churn(topo, 6, 0.4, seed=3)
    jt = jneighbors.NeighborTable.from_schedule(sched, k=8)
    pt = neighbors.NeighborTable.from_schedule(sched, k=8, device=CPU)
    same(pt.idx, jt.idx)
    same(pt.valid, jt.valid)
    same(pt.live_schedule(sched), jt.live_schedule(sched))
    rng = np.random.default_rng(0)
    mat = rng.integers(-5, 5, size=(10, 10)).astype(np.int32)
    same(pt.gather_edges(torch.as_tensor(mat)), jt.gather_edges(jnp.asarray(mat)))
    same(pt.gather_edges(torch.as_tensor(mat), fill=-1), jt.gather_edges(jnp.asarray(mat), -1))
    bmat = rng.random((10, 10)) < 0.5
    same(pt.gather_edges(torch.as_tensor(bmat), fill=True),
         jt.gather_edges(jnp.asarray(bmat), fill=True))
    with pytest.raises(ValueError):
        neighbors.NeighborTable.from_schedule(np.zeros((4, 4), bool), device=CPU)


# ---------------------------------------------------------------------------
# Schedules and scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda d, t: d.static_schedule(t.adjacency, 5),
    lambda d, t: d.edge_churn(t, 7, 0.3, seed=1),
    lambda d, t: d.edge_churn(t, 7, 0.5, seed=2, symmetric=False),
    lambda d, t: d.node_join_leave(t, 8, {0: (1, 4), 5: (2, 6)}),
    lambda d, t: d.partition_and_heal(t, 9, np.arange(12) % 3, cut_start=2, cut_end=5),
    lambda d, t: d.node_presence_schedule(t, np.random.default_rng(0).random((4, 12)) < 0.7),
    lambda d, t: d.scenario_schedule("churn", t, 10, seed=4, churn_prob=0.2),
    lambda d, t: d.scenario_schedule("partition", t, 10),
    lambda d, t: d.scenario_schedule("join_leave", t, 10),
])
def test_schedule_generators_equal_reference(make):
    jt, pt = jgraph.erdos_renyi(12, 0.5, 1, seed=0), graph.erdos_renyi(12, 0.5, 1, seed=0)
    want, got = make(jdynamic, jt), make(dynamic, pt)
    same(got, want)
    assert dynamic.schedule_stats(got) == jdynamic.schedule_stats(want)


def test_scenarios_equal_reference():
    assert list(scenarios.NET_SCENARIOS) == list(jscenarios.NET_SCENARIOS)
    jt, pt = jgraph.erdos_renyi(12, 0.5, 1, seed=0), graph.erdos_renyi(12, 0.5, 1, seed=0)
    for name, spec in scenarios.NET_SCENARIOS.items():
        jspec = jscenarios.get_scenario(name)
        assert (spec.channel.__dict__, spec.schedule_kind, spec.staleness_bound,
                spec.churn_prob, spec.topology) == (
            jspec.channel.__dict__, jspec.schedule_kind, jspec.staleness_bound,
            jspec.churn_prob, jspec.topology)
        same(scenarios.build_schedule(spec, pt, 9, seed=3),
             jscenarios.build_schedule(jspec, jt, 9, seed=3))
        if spec.topology is not None:
            same(scenarios.build_topology(spec, 36, 1, seed=2).adjacency,
                 jscenarios.build_topology(jspec, 36, 1, seed=2).adjacency)
    with pytest.raises(ValueError):
        scenarios.get_scenario("nope")


# ---------------------------------------------------------------------------
# Channel draws
# ---------------------------------------------------------------------------


CHANNELS = [dict(), dict(drop_prob=0.2), dict(latency_max=3), dict(latency_min=1, latency_max=4),
            dict(drop_prob=0.5, latency_max=2), dict(drop_prob=1.0), dict(latency_min=2, latency_max=2),
            dict(bandwidth_cap=5), dict(bits_per_tick=1000)]


@pytest.mark.parametrize("kw", CHANNELS)
@pytest.mark.parametrize("seed", [0, 3])
def test_channel_sample_and_coord_mask_equal_reference(kw, seed):
    jch, pch = jchannel.ChannelConfig(**kw), channel.ChannelConfig(**kw)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    jd, jdr = jch.sample(key, 9)
    pd, pdr = pch.sample(np.asarray(key), 9, CPU)
    assert pd.dtype == torch.int32 and pdr.dtype == torch.bool
    same(pd, jd)
    same(pdr, jdr)
    for d in (3, 5, 40):
        jm, pm = jch.coord_mask(key, d), pch.coord_mask(np.asarray(key), d, CPU)
        assert (jm is None) == (pm is None)
        if pm is not None:
            same(pm, jm)
    for bits in (None, 0, 999, 1000, 1001, 251200):
        assert pch.serial_ticks(bits) == int(jch.serial_ticks(bits) or 0)
        assert pch.max_total_latency(bits) == jch.max_total_latency(bits)
    assert pch.is_ideal == jch.is_ideal


def test_channel_refuses_bad_settings():
    for kw in (dict(drop_prob=1.5), dict(latency_min=2, latency_max=1), dict(bandwidth_cap=0),
               dict(bits_per_tick=0)):
        with pytest.raises(ValueError):
            channel.ChannelConfig(**kw)


# ---------------------------------------------------------------------------
# Mailboxes
# ---------------------------------------------------------------------------


def mailbox_pair(m, w, d, max_delay):
    return jmb.init_mailbox(m, d, max_delay, width=w), mb.init_mailbox(m, d, max_delay, width=w,
                                                                        device=CPU)


def same_mailbox(pst, jst):
    for got, want in zip(pst, jst, strict=True):
        same(got, want)
    assert pst.send_tick.dtype == pst.ring_send.dtype == torch.int32


@pytest.mark.parametrize("max_delay", [0, 3])
def test_mailbox_special_payloads(max_delay):
    """-0.0, NaN and +-inf payloads: at L = 1 the reference keeps -0.0, at
    L > 1 its masked sum over the ring returns +0.0; the port does both."""
    payload = np.array([-0.0, np.nan, np.inf, -np.inf, 0.0, 1.5], np.float32)
    msgs = np.broadcast_to(payload, (3, 3, 6)).copy()
    jst, pst = mailbox_pair(3, 3, 6, max_delay)
    send = np.ones((3, 3), bool)
    delay = np.zeros((3, 3), np.int32)
    jst = jmb.push(jst, jnp.asarray(msgs), jnp.asarray(send), jnp.asarray(delay), jnp.int32(0))
    pst = mb.push(pst, torch.as_tensor(msgs), torch.as_tensor(send), torch.as_tensor(delay), 0)
    jst, ja = jmb.deliver(jst, jnp.int32(0))
    pst, pa = mb.deliver(pst, 0)
    same(pa, ja)
    same_mailbox(pst, jst)
    assert np.array_equal(np.signbit(pst.values.numpy()), np.signbit(np.asarray(jst.values)))


def test_mailbox_random_traffic_equals_reference():
    """Random sends, delays and drops over 12 ticks, out-of-order arrivals
    included: every state, arrival mask, usable mask and staleness equal."""
    rng = np.random.default_rng(5)
    m, w, d, L = 6, 4, 7, 4
    jst, pst = mailbox_pair(m, w, d, L - 1)
    for t in range(12):
        msgs = rng.normal(size=(m, w, d)).astype(np.float32)
        send = rng.random((m, w)) < 0.6
        delay = rng.integers(0, L, size=(m, w)).astype(np.int32)
        jst = jmb.push(jst, jnp.asarray(msgs), jnp.asarray(send), jnp.asarray(delay), jnp.int32(t))
        pst = mb.push(pst, torch.as_tensor(msgs), torch.as_tensor(send), torch.as_tensor(delay), t)
        jst, ja = jmb.deliver(jst, jnp.int32(t))
        pst, pa = mb.deliver(pst, t)
        same(pa, ja)
        same_mailbox(pst, jst)
        for bound in (0, 2):
            same(mb.usable_mask(pst, t, bound), jmb.usable_mask(jst, jnp.int32(t), bound))
        same(mb.staleness(pst, t), jmb.staleness(jst, jnp.int32(t)))
        same(mb.generation_match(pst.send_tick, pst.send_tick.flip(0)),
             jmb.generation_match(jst.send_tick, jst.send_tick[::-1]))


def test_mailbox_out_of_order_keeps_newest():
    pst = mb.init_mailbox(1, 1, 3, device=CPU)
    ones = torch.ones((1, 1), dtype=torch.bool)
    pst = mb.push(pst, torch.full((1, 1, 1), 10.0), ones, torch.full((1, 1), 3, dtype=torch.int32), 0)
    pst = mb.push(pst, torch.full((1, 1, 1), 20.0), ones, torch.zeros((1, 1), dtype=torch.int32), 1)
    pst, _ = mb.deliver(pst, 1)
    assert float(pst.values[0, 0, 0]) == 20.0
    before = pst
    pst, arrived = mb.deliver(pst, 3)  # the stale copy lands late
    assert bool(arrived[0, 0]) and float(pst.values[0, 0, 0]) == 20.0
    assert int(pst.send_tick[0, 0]) == 1
    assert bool(before.ring_valid[0, 0, 3]) and not bool(pst.ring_valid[0, 0, 3])


def test_staleness_saturates_at_int32():
    jst, pst = mailbox_pair(2, 2, 3, 1)
    send = np.zeros((2, 2), bool)
    send[0, 0] = True
    zeros = np.zeros((2, 2), np.int32)
    ones = np.ones((2, 2, 3), np.float32)
    jst = jmb.push(jst, jnp.asarray(ones), jnp.asarray(send), jnp.asarray(zeros), jnp.int32(0))
    pst = mb.push(pst, torch.as_tensor(ones), torch.as_tensor(send), torch.as_tensor(zeros), 0)
    jst, _ = jmb.deliver(jst, jnp.int32(0))
    pst, _ = mb.deliver(pst, 0)
    for t in (5, 2**30, 2**31 - 2):
        stale = mb.staleness(pst, t)
        assert stale.dtype == torch.int32
        same(stale, jmb.staleness(jst, jnp.int32(t)))
        assert int(stale[1, 1]) == np.iinfo(np.int32).max and int(stale[0, 0]) == t
        same(mb.usable_mask(pst, t, 10), jmb.usable_mask(jst, jnp.int32(t), 10))


# ---------------------------------------------------------------------------
# Message attacks
# ---------------------------------------------------------------------------


def attack_inputs(m=10, d=24, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, d)).astype(np.float32)
    byz = np.zeros(m, bool)
    byz[[2, 7]] = True
    adj = rng.random((m, m)) < 0.5
    np.fill_diagonal(adj, False)
    return w, byz, adj


@pytest.mark.parametrize("name", sorted(byzantine.MESSAGE_ATTACKS))
@pytest.mark.parametrize("sparse", [False, True])
def test_message_attacks_equal_reference(name, sparse):
    """Each attack's dense ``[M, M, d]`` or sparse ``[M, K, d]`` messages
    and the self-view: honest senders' messages exact; Byzantine ones exact
    except ``random`` (normal's tolerance) and the values crafted from the
    honest mean (``alie``, ``shift``, ``selective_victim``), within 4 ulps:
    XLA sums the mean in an order of its own, and its jitted ``sqrt`` is not
    correctly rounded on every input (the broadcast attacks' tolerance in
    ``test_torch_bridge.py``)."""
    w, byz, adj = attack_inputs()
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    ja, pa = jbyz.get_message_attack(name), byzantine.get_message_attack(name)
    jw, jb, jadj = jnp.asarray(w), jnp.asarray(byz), jnp.asarray(adj)
    tw, tb, tadj = torch.as_tensor(w), torch.as_tensor(byz), torch.as_tensor(adj)
    if sparse:
        jt = jneighbors.NeighborTable.from_adjacency(adj)
        pt = neighbors.NeighborTable.from_adjacency(adj, device=CPU)
        live = adj.copy()
        live[0] = False  # a node with no live slot this tick
        jlive, plive = jt.gather_edges(jnp.asarray(live), False), pt.gather_edges(
            torch.as_tensor(live), False)
        want = jax.jit(lambda w_, b_, l_: jbyz.apply_sparse_message_attack_bank(
            (ja,), 0, w_, b_, jt, l_, key, 3))(jw, jb, jlive)
        got, self_view = byzantine.messages_and_self(pa, tw, tb, plive, np.asarray(key), 3, pt)
        sender_byz = np.asarray(jt.gather_senders(jb, False))
    else:
        want = jax.jit(lambda w_, b_, a_: jbyz.apply_message_attack_bank(
            (ja,), 0, w_, b_, a_, key, 3))(jw, jb, jadj)
        got, self_view = byzantine.messages_and_self(pa, tw, tb, tadj, np.asarray(key), 3)
        sender_byz = np.broadcast_to(byz[None, :], adj.shape)
        assert got.shape == (10, 10, 24)
    want_self = np.asarray(jax.jit(lambda w_, b_: jbyz.apply_self_view_bank(
        (ja,), 0, w_, b_, key, 3))(jw, jb))
    got, want = got.numpy(), np.asarray(want)
    same(got[~sender_byz], want[~sender_byz])
    same(self_view.numpy()[~byz], want_self[~byz])
    if name == "random":
        np.testing.assert_allclose(got, want, rtol=5.9e-6, atol=0)
        np.testing.assert_allclose(self_view.numpy(), want_self, rtol=5.9e-6, atol=0)
    elif name in ("alie", "shift", "selective_victim"):
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
        np.testing.assert_array_max_ulp(self_view.numpy(), want_self, maxulp=4)
    else:
        same(got, want)
        same(self_view, want_self)
    direct = (byzantine.apply_sparse_message_attack(pa, tw, tb, pt, plive, np.asarray(key), 3)
              if sparse else byzantine.apply_message_attack(pa, tw, tb, tadj, np.asarray(key), 3))
    same(direct, got)
    same(byzantine.apply_self_view(pa, tw, tb, np.asarray(key), 3), self_view)


def test_selective_victim_median_of_an_even_count():
    """``jnp.median`` of the in-degrees averages the two middle counts:
    with in-degrees (1, 1, 2, 3) the median is 1.5, so the receivers of
    in-degree 1 are victims and those of 2 are not (``torch.median``'s
    lower middle, 1, gives the same split here; (1, 2, 2, 3) -> 2.0 keeps
    both 2s)."""
    for degs in ((1, 1, 2, 3), (1, 2, 2, 3), (1, 2, 3, 4)):
        x = torch.tensor(degs)
        assert float(byzantine._median_of_counts(x)) == float(jnp.median(jnp.asarray(degs)))


def test_message_attack_registry():
    assert set(byzantine.MESSAGE_ATTACKS) == set(jbyz.MESSAGE_ATTACKS)
    assert byzantine.get_message_attack("scale_abuse").name == "none"
    with pytest.raises(ValueError, match="network runtime"):
        byzantine.get_attack("selective_victim")
    with pytest.raises(ValueError):
        byzantine.get_message_attack("nope")


# ---------------------------------------------------------------------------
# Runtimes
# ---------------------------------------------------------------------------


RUNTIMES = [
    ("sync", None), ("dense", dict()), ("dense", dict(drop_prob=0.3, latency_max=2)),
    ("dense", dict(bandwidth_cap=9)), ("dense", dict(bits_per_tick=100)),
    ("sparse", dict(drop_prob=0.3, latency_max=2)), ("sparse", dict(bandwidth_cap=9)),
]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("kind,kw", RUNTIMES)
def test_runtime_exchange_equals_reference(kind, kw, static):
    """Five ticks of random messages through each runtime, on a churned
    schedule or on a static graph (whose live-edge count the reference's
    program holds as a constant, dividing by its reciprocal), M = 10:
    views, masks, stats and the carried state equal; the state handed in
    is never written (it is checked after the tick)."""
    m, d, ticks = 10, 20, 5
    topo = jgraph.erdos_renyi(m, 0.6, 1, seed=2)
    sched = topo if static else jdynamic.edge_churn(topo, ticks, 0.3, seed=1)
    if kind == "sync":
        jrt, prt = jruntime.SynchronousRuntime(sched), runtime.SynchronousRuntime(sched, device=CPU)
    elif kind == "dense":
        jrt = jruntime.UnreliableRuntime(sched, jchannel.ChannelConfig(**kw), staleness_bound=2)
        prt = runtime.UnreliableRuntime(sched, channel.ChannelConfig(**kw), staleness_bound=2,
                                        device=CPU)
    else:
        jrt = jruntime.SparseUnreliableRuntime(sched, jchannel.ChannelConfig(**kw),
                                               staleness_bound=2)
        prt = runtime.SparseUnreliableRuntime(sched, channel.ChannelConfig(**kw),
                                              staleness_bound=2, device=CPU)
        same(prt.neighbors.idx, jrt.neighbors.idx)
    assert prt.describe() == jrt.describe()
    width = m if kind != "sparse" else prt.neighbors.k
    jnet, pnet = jrt.init(m, d, max_wire_bits=350), prt.init(m, d, max_wire_bits=350)
    rng = np.random.default_rng(3)
    for t in range(ticks):
        msgs = rng.normal(size=(m, width, d)).astype(np.float32)
        self_vals = rng.normal(size=(m, d)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(9), t)
        padj = prt.adjacency_at(t)
        same(padj, jrt.adjacency_at(jnp.int32(t)))
        jnet, jv, jmask, jstats = jax.jit(lambda n, x, s_, k, tt: jrt.exchange(
            n, x, s_, jrt.adjacency_at(tt), k, tt, wire_bits=350))(
            jnet, jnp.asarray(msgs), jnp.asarray(self_vals), key, jnp.int32(t))
        snapshot = None if pnet is None else [x.clone() for x in pnet]
        new, pv, pmask, pstats = prt.exchange(pnet, torch.as_tensor(msgs),
                                              torch.as_tensor(self_vals), padj, np.asarray(key),
                                              t, wire_bits=350)
        if snapshot is not None:
            for before, after in zip(snapshot, pnet, strict=True):
                same(after, before.numpy())
            same_mailbox(new, jnet)
        pnet = new
        same(pv, jv)
        same(pmask, jmask)
        assert set(pstats) == set(jstats)
        for k, v in pstats.items():
            assert v.dtype == torch.float32 and float(v) == float(jstats[k]), k
        if kind != "sync":
            cm = prt.delivered_coord_mask(np.asarray(key), d)
            jcm = jrt.delivered_coord_mask(key, d)
            assert (cm is None) == (jcm is None)
            if cm is not None:
                same(cm, jcm)


def test_runtime_checks():
    topo = graph.erdos_renyi(6, 0.6, 1, seed=0)
    with pytest.raises(ValueError):
        runtime.UnreliableRuntime(topo, staleness_bound=-1, device=CPU)
    with pytest.raises(ValueError):
        runtime.UnreliableRuntime(topo, device=CPU).init(7, 4)
    with pytest.raises(ValueError):
        runtime.SparseUnreliableRuntime(np.zeros((2, 3, 4), bool), device=CPU)
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else TypeError):
        runtime.UnreliableRuntime(topo)  # the default device is the card


# ---------------------------------------------------------------------------
# The views screens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,w,d,stride0", [(8, 8, 16, False), (6, 12, 40, False),
                                           (10, 10, 33, True), (7, 3, 64, False)])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_views_screens_plain_equal_reference(m, w, d, stride0, rule):
    """`screen_views` on the CPU (the views wrappers' plain versions) equals
    the reference's ``screen_views_banked`` with the mask as an operand,
    starved nodes included (a node with no usable view gets its own
    value, finite where self is)."""
    views, mask, self_vals = views_inputs(m, w, d, seed=m + w, stride0=stride0)
    for b in (0, 1, 2):
        want = jax.jit(lambda v, mk, s, b_: jscreening.screen_views_banked(
            v, mk, s, (rule,), 0, b_))(jnp.asarray(views.numpy()), jnp.asarray(mask.numpy()),
                                      jnp.asarray(self_vals.numpy()), b)
        got = screening.screen_views(views, mask, self_vals, rule=rule, b=b)
        same(got, want)
        assert bool((torch.isfinite(got[0]) == torch.isfinite(self_vals[0])).all())


def test_views_wrappers_run_plain_on_cpu_without_launching():
    views, mask, self_vals = views_inputs(6, 6, 20, seed=1)
    before = (views_screen.views_screen_trimmed_mean.launches,
              views_screen.views_screen_median.launches)
    same(views_screen.views_screen_trimmed_mean(views, mask, self_vals, 1),
         ref.trimmed_mean_views(views, mask, self_vals, 1).numpy())
    same(views_screen.views_screen_median(views, mask.to(torch.uint8), self_vals),
         ref.median_views(views, mask, self_vals).numpy())
    assert (views_screen.views_screen_trimmed_mean.launches,
            views_screen.views_screen_median.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "mask_dtype", "shape", "stride", "self", "b"])
def test_views_wrappers_reject_bad_operands(bad):
    views, mask, self_vals = views_inputs(6, 5, 8, seed=2)
    b = 1
    if bad == "dtype":
        views = views.double()
    elif bad == "mask_dtype":
        mask = mask.float()
    elif bad == "shape":
        mask = mask[:, :4].contiguous()
    elif bad == "stride":
        views = torch.zeros(6, 8, 5).transpose(1, 2)
    elif bad == "self":
        self_vals = torch.zeros(6, 9)
    else:
        b = -1
    with pytest.raises((TypeError, ValueError)):
        views_screen.views_screen_trimmed_mean(views, mask, self_vals, b)


def test_views_distance_rules_refused_off_the_cpu():
    """Krum and Bulyan over views take each node's distances from the
    batched distance kernel's wrapper: on the CPU its plain version (each
    node's stacked ``[W + 1, d]`` views' `ref.pairwise_sq_dists`), and on a
    device with no kernel it refuses before any launch rather than falling
    back (a ``meta`` tensor stands in for such a device)."""
    views = torch.empty((4, 4, 8), device="meta")
    mask = torch.empty((4, 4), dtype=torch.bool, device="meta")
    for rule in ("krum", "bulyan"):
        with pytest.raises(ValueError, match="no pairwise_sq_dists kernel"):
            screening.screen_views(views, mask, views[:, 0], rule=rule, b=1)
    views, mask, self_vals = views_inputs(6, 5, 8, seed=3)
    got = ops.pairwise_sq_dists_batched(views, self_vals)
    stacked = torch.cat([views, self_vals[:, None]], dim=1)
    want = torch.stack([ref.pairwise_sq_dists(node) for node in stacked])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)