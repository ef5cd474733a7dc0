"""Asynchronous BRIDGE in the port (`repro_torch.net.AsyncBridgeTrainer`,
`BridgeTrainer(runtime=...)`) against the reference's, on the CPU.

Most cases run a quadratic task (M = 8, d = 32, the reference's
``tests/test_net.py`` kind: node j pulls towards a per-tick target), whose
gradient has no matrix product; one runs the linear task (M = 10, the full
784 x 10 model).  Tolerances, stated per comparison:

* parameters after each of 5 ticks, every node: rtol 1e-5, atol 1e-6.
  Under ``alie`` and ``selective_victim`` the crafted values differ from
  the reference's by a few ulps (its jitted ``sqrt`` and summation order,
  ``test_torch_net.py``), which the screens pass on; with attacks that do
  not read the honest mean (``sign_flip``, the wire attacks) the runs are
  equal bit for bit, and are held so;
* the runtime's stats (``delivered_frac``, ``mean_staleness``,
  ``active_links``, ``usable_in``) and ``screened_frac``: equal, as are the
  keys; they depend only on the channel draws and the masks;
* the linear task: one tick from the reference's carried state (parameters,
  key, mailboxes, per-link codec carry) at rtol 1e-5, atol 1e-6 on honest
  rows, the mailboxes and the honest senders' carry exactly;
* port-internal: the ideal channel against the synchronous trainer, and the
  dense runtime against the sparse one, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core import graph as jgraph
from repro.net import AsyncBridgeConfig as JConfig
from repro.net import AsyncBridgeTrainer as JTrainer
from repro.net import scenarios as jscenarios
from repro.sim import tasks as jtasks
from repro_torch import convert
from repro_torch.core import bridge, graph, screening
from repro_torch.models import small
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer, ChannelConfig, scenarios
from repro_torch.net.runtime import SparseUnreliableRuntime, SynchronousRuntime, UnreliableRuntime

M, D, T, B = 8, 32, 5, 1
STATS = ("delivered_frac", "mean_staleness", "active_links", "usable_in", "screened_frac")


def jgrad(params, batch):
    diff = params["w"] - batch
    return 0.5 * jnp.sum(diff * diff), {"w": diff}


def pgrad(params, batch):
    diff = params["w"] - batch
    return 0.5 * torch.sum(diff * diff, dim=1), {"w": diff}


def quad_data(seed=0, m=M, d=D, ticks=T):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ticks, m, d)).astype(np.float32),
            (0.1 * rng.normal(size=(m, d))).astype(np.float32))


def configs(name, rule, attack, *, codec="identity", sparse=False, ticks=T, m=M, b=B, p=0.6):
    """The reference's and the port's `AsyncBridgeConfig` for scenario
    ``name`` on ``erdos_renyi(m, p, b)`` (bundled topologies are not
    used: every scenario runs on this graph, as the net benchmark does)."""
    out = []
    for g, sc, cfg in ((jgraph, jscenarios, JConfig), (graph, scenarios, AsyncBridgeConfig)):
        topo = g.erdos_renyi(m, p, b, seed=0)
        spec = sc.get_scenario(name)
        out.append(cfg(topology=topo, rule=rule, num_byzantine=b, attack=attack, t0=10,
                       codec=codec, sparse=sparse, channel=sc.get_scenario(name).channel,
                       staleness_bound=spec.staleness_bound,
                       schedule=sc.build_schedule(spec, topo, ticks, seed=0)))
    return out


def run_both(name, rule, attack, *, exact=False, **kw):
    """5 ticks of both trainers from one init; compares every tick."""
    jcfg, pcfg = configs(name, rule, attack, **kw)
    jtr, ptr = JTrainer(jcfg, jgrad), AsyncBridgeTrainer(pcfg, pgrad, device="cpu")
    targets, w0 = quad_data(m=kw.get("m", M))
    js = jtr.init({"w": jnp.asarray(w0)})
    ps = ptr.init({"w": torch.from_numpy(w0.copy())})
    np.testing.assert_array_equal(ptr.byz_mask.numpy(), np.asarray(jtr.byz_mask))
    for t in range(T):
        js, jm = jtr.step(js, jnp.asarray(targets[t]))
        ps, pm = ptr.step(ps, torch.from_numpy(targets[t]))
        got, want = ps.params["w"].numpy(), np.asarray(js.params["w"])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ps.key, np.asarray(js.key))
        for k in STATS:
            assert float(pm[k]) == float(jm[k]), (t, k)
        for k in ("wire_bits_per_edge", "wire_bytes_total"):
            assert float(pm[k]) == float(jm[k]), (t, k)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        if exact and js.comm is not None:
            for a, b_ in zip(ps.comm, js.comm, strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    return ps, js


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
@pytest.mark.parametrize("name", list(scenarios.NET_SCENARIOS))
def test_async_trainer_matches_reference_every_scenario(name, rule):
    run_both(name, rule, "alie")


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_selective_victim_under_lossy(rule, sparse):
    run_both("lossy", rule, "selective_victim", sparse=sparse)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
@pytest.mark.parametrize("attack", ["alie", "sign_flip"])
def test_int8_per_link_codec_under_lossy(attack, rule, sparse):
    """The per-link carries ``[M, W, d]`` under per-edge keys; with
    ``sign_flip`` parameters and carries are bit for bit."""
    run_both("lossy", rule, attack, codec="int8", sparse=sparse, exact=attack == "sign_flip")


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("codec,attack", [("int8", "scale_abuse"), ("int8", "garbage_codeword"),
                                          ("identity", "garbage_codeword"),
                                          ("topk25_int8", "index_lie"), ("randk25", "none")])
def test_wire_attacks_per_link_bitwise(codec, attack, sparse):
    """Wire attacks on each link's codeword, their random draws under the
    edge's own key, and the sparse codecs' supports: bit for bit."""
    run_both("lossy_laggy", "trimmed_mean", attack, codec=codec, sparse=sparse, exact=True)


@pytest.mark.parametrize("rule", ["krum", "bulyan", "mean", "geomedian"])
def test_other_rules_on_views_cpu(rule):
    """Krum and Bulyan over views run their plain version on the CPU (the
    card refuses them); the plain rules as on the broadcast path."""
    run_both("lossy", rule, "sign_flip", m=10, p=1.0)


@pytest.fixture(scope="module")
def linear_run():
    """The reference's linear task, M = 10, b = 2, under ``lossy_laggy``
    with the int8 per-link codec: its states after ticks 0..3."""
    task = jtasks.linear_task(10, 4, partition="iid", batch=16, num_train=400, num_test=80)
    (jcfg, _) = configs("lossy_laggy", "trimmed_mean", "sign_flip", codec="int8", m=10, b=2)
    jcfg = JConfig(**{**jcfg.__dict__, "t0": 30.0})
    tr = JTrainer(jcfg, task.grad_fn)
    state = tr.init(task.init_fn(0))
    snap = lambda st: (jax.tree_util.tree_map(np.asarray, st.params), np.asarray(st.key),
                       tuple(np.asarray(x) for x in st.comm), tuple(np.asarray(x) for x in st.net))
    states = [snap(state)]
    for i in range(3):
        state, _ = tr.step(state, jax.tree_util.tree_map(lambda x, i=i: x[i], task.batches))
        states.append(snap(state))
    return task, states, np.asarray(tr.byz_mask)


def test_linear_task_one_tick_from_carried_state(linear_run):
    task, states, byz = linear_run
    (_, pcfg) = configs("lossy_laggy", "trimmed_mean", "sign_flip", codec="int8", m=10, b=2)
    pcfg = AsyncBridgeConfig(**{**pcfg.__dict__, "t0": 30.0})
    trainer = AsyncBridgeTrainer(pcfg, small.linear_loss_and_grad, device="cpu")
    for t in range(3):
        params, key, comm, net = states[t]
        state = convert.state_from_jax(params, t, key=key, comm=comm, net=net, device="cpu")
        batch = tuple(torch.as_tensor(np.array(x[t])) for x in task.batches)
        new, _ = trainer.step(state, batch)
        want_params, want_key, want_comm, want_net = states[t + 1]
        np.testing.assert_array_equal(new.key, want_key)
        for k in ("b", "w"):
            np.testing.assert_allclose(new.params[k].numpy()[~byz], want_params[k][~byz],
                                       rtol=1e-5, atol=1e-6)
        for got, want in zip(new.net, want_net, strict=True):
            np.testing.assert_array_equal(got.numpy(), want)
        honest_links = ~np.broadcast_to(byz[None, :], (10, 10))
        for got, want in zip(new.comm, want_comm, strict=True):
            np.testing.assert_array_equal(got.numpy()[honest_links], want[honest_links])


# ---------------------------------------------------------------------------
# Port-internal identities
# ---------------------------------------------------------------------------


def port_pair(attack, rule, **kw):
    topo = graph.erdos_renyi(M, 0.6, B, seed=0)
    cfg = bridge.BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack=attack, t0=10, **kw)
    return topo, cfg


@pytest.mark.parametrize("attack", ["random", "alie"])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_ideal_channel_equals_synchronous_trainer(rule, attack):
    """The ideal channel (and the synchronous runtime) reproduce the
    synchronous broadcast trainer bit for bit over 20 ticks, from one init
    state shared by all three (nothing writes into it)."""
    topo, cfg = port_pair(attack, rule)
    sync = bridge.BridgeTrainer(cfg, pgrad, device="cpu")
    ideal = AsyncBridgeTrainer(AsyncBridgeConfig(**cfg.__dict__, channel=ChannelConfig.ideal(),
                                                 staleness_bound=0), pgrad, device="cpu")
    hooked = bridge.BridgeTrainer(cfg, pgrad, runtime=SynchronousRuntime(topo, device="cpu"),
                                  device="cpu")
    targets, w0 = quad_data(ticks=20)
    s0 = sync.init({"w": torch.from_numpy(w0)})
    s1, s2, s3 = s0, ideal.init(s0.params), hooked.init(s0.params)
    for t in range(20):
        batch = torch.from_numpy(targets[t])
        s1, _ = sync.step(s1, batch)
        s2, m2 = ideal.step(s2, batch)
        s3, _ = hooked.step(s3, batch)
        np.testing.assert_array_equal(s2.params["w"].numpy(), s1.params["w"].numpy())
        np.testing.assert_array_equal(s3.params["w"].numpy(), s1.params["w"].numpy())
        assert float(m2["delivered_frac"]) == 1.0 and float(m2["mean_staleness"]) == 0.0
    np.testing.assert_array_equal(s0.params["w"].numpy(), w0)


@pytest.mark.parametrize("codec", ["identity", "int8"])
@pytest.mark.parametrize("name,rule", [("lossy_laggy", "trimmed_mean"), ("churn", "median"),
                                       ("bandwidth64", "trimmed_mean")])
def test_dense_and_sparse_runtimes_bitwise(name, rule, codec):
    (_, dense_cfg) = configs(name, rule, "alie", codec=codec, ticks=10)
    sparse_cfg = AsyncBridgeConfig(**{**dense_cfg.__dict__, "sparse": True})
    dense = AsyncBridgeTrainer(dense_cfg, pgrad, device="cpu")
    sparse = AsyncBridgeTrainer(sparse_cfg, pgrad, device="cpu")
    assert isinstance(sparse.runtime, SparseUnreliableRuntime)
    targets, w0 = quad_data(ticks=10)
    sd = dense.init({"w": torch.from_numpy(w0)})
    ss = sparse.init({"w": torch.from_numpy(w0)})
    for t in range(10):
        sd, md = dense.step(sd, torch.from_numpy(targets[t]))
        ss, ms = sparse.step(ss, torch.from_numpy(targets[t]))
        np.testing.assert_array_equal(ss.params["w"].numpy(), sd.params["w"].numpy())
        for k in STATS:
            assert float(ms[k]) == float(md[k]), k


def test_starved_nodes_keep_their_iterate():
    """Every message dropped: no node ever holds a usable view, so every
    node takes the local step ``w - rho g`` from its own value, exactly."""
    topo, cfg = port_pair("none", "trimmed_mean")
    tr = AsyncBridgeTrainer(AsyncBridgeConfig(**cfg.__dict__,
                                              channel=ChannelConfig(drop_prob=1.0)),
                            pgrad, device="cpu")
    targets, w0 = quad_data()
    state = tr.init({"w": torch.from_numpy(w0)})
    w = torch.from_numpy(w0)
    for t in range(T):
        state, m = tr.step(state, torch.from_numpy(targets[t]))
        w = w - cfg.step_size(t) * (w - torch.from_numpy(targets[t]))
        np.testing.assert_array_equal(state.params["w"].numpy(), w.numpy())
        assert float(m["screened_frac"]) == 0.0 and float(m["delivered_frac"]) == 0.0


def test_partially_starved_nodes_keep_their_iterate():
    """A node cut off by the schedule keeps its own value while the others
    screen: its row equals the local step, bit for bit."""
    topo, cfg = port_pair("none", "median")
    sched = np.broadcast_to(topo.adjacency, (T, M, M)).copy()
    sched[:, 3, :] = False  # node 3 hears nobody
    tr = AsyncBridgeTrainer(AsyncBridgeConfig(**cfg.__dict__, schedule=sched, staleness_bound=0),
                            pgrad, device="cpu")
    targets, w0 = quad_data()
    state = tr.init({"w": torch.from_numpy(w0)})
    for t in range(T):
        w3 = state.params["w"][3].clone()
        state, m = tr.step(state, torch.from_numpy(targets[t]))
        want = w3 - cfg.step_size(t) * (w3 - torch.from_numpy(targets[t][3]))
        np.testing.assert_array_equal(state.params["w"][3].numpy(), want.numpy())
        assert float(m["screened_frac"]) == (M - 1) / M


def test_run_ticks_equals_step_loop_and_state_is_reusable():
    (_, cfg) = configs("lossy_laggy", "trimmed_mean", "alie", codec="int8")
    tr = AsyncBridgeTrainer(cfg, pgrad, device="cpu")
    targets, w0 = quad_data()
    s0 = tr.init({"w": torch.from_numpy(w0)})
    s_scan, ms = tr.run_ticks(s0, lambda i: torch.from_numpy(targets[i]), T)
    s_loop = s0
    for t in range(T):
        s_loop, m = tr.step(s_loop, torch.from_numpy(targets[t]))
        assert float(ms["delivered_frac"][t]) == float(m["delivered_frac"])
    assert ms["loss"].shape == (T,)
    np.testing.assert_array_equal(s_scan.params["w"].numpy(), s_loop.params["w"].numpy())
    for a, b_ in zip(s_scan.net, s_loop.net, strict=True):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
    stacked = bridge.stack_batches(lambda i: (torch.from_numpy(targets[i]), torch.ones(2)), T,
                                   device="cpu")
    assert stacked[0].shape == (T, M, D) and stacked[1].shape == (T, 2)


def test_trainer_refusals():
    topo, cfg = port_pair("alie", "trimmed_mean")
    with pytest.raises(ValueError, match="dense runtime"):
        bridge.BridgeTrainer(bridge.BridgeConfig(**{**cfg.__dict__, "sparse": True}), pgrad,
                             runtime=UnreliableRuntime(topo, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="network runtime"):
        bridge.BridgeTrainer(bridge.BridgeConfig(**{**cfg.__dict__, "attack": "selective_victim"}),
                             pgrad, device="cpu")
    # BRIDGE-K over views runs on the card (the batched distance kernel);
    # without a card the default device refuses, as every entry point does
    kcfg = AsyncBridgeConfig(**{**cfg.__dict__, "rule": "krum",
                                "topology": graph.complete_graph(M, B)})
    if torch.cuda.is_available():
        AsyncBridgeTrainer(kcfg, pgrad)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AsyncBridgeTrainer(kcfg, pgrad)
    AsyncBridgeTrainer(kcfg, pgrad, device="cpu")


def test_net_stats_follow_the_reference_stack_batches():
    """`stack_batches` stacks what the reference's does."""
    targets, _ = quad_data()
    want = jbridge.stack_batches(lambda i: jnp.asarray(targets[i]), T)
    got = bridge.stack_batches(lambda i: torch.from_numpy(targets[i]), T, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
