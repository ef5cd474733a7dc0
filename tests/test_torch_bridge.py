"""The port's trainer (`repro_torch.core.bridge`) against the reference's
`repro.core.bridge.BridgeTrainer` on the linear task (M = 12, the full
784 x 10 model), on the CPU, dense and sparse, identity and int8 codec.

Tolerances, stated per comparison:
* one step from a carried reference state (parameters, key and codec
  carry): rtol 1e-5, atol 1e-6 on every honest node.  Screening is exact
  (``test_torch_screening.py``, ``test_torch_sparse.py``); the difference
  is the gradient's matrix products, summed in another order by XLA and by
  PyTorch.  A Byzantine node's own iterate can grow until ``y - rho g``
  cancels entry by entry (sign flip feeds it its own negated broadcast), so
  its rows are held to rtol 1e-5 in the row's 2-norm.  DGD (``mean``)
  under ``random`` averages the Byzantine noise into honest rows, so they
  also carry normal's error: atol 7.5e-5 there (normal's absolute 2.2e-5
  times 10, from each of up to b = 2 Byzantine senders, over count + 1 >= 6
  rows);
* the int8 codec's carry after that step: exact on every row a
  deterministic attack sends, and on the honest rows under ``random``
  (whose Byzantine rows carry normal's tolerance into the codes);
* the loss, consensus distance and step size: rtol 1e-5; the residual
  norm: rtol 1e-5, and 5e-5 under ``random``, where it sums the Byzantine
  senders' residuals too, whose codes and scales carry normal's error
  (measured 1.3e-5);
* a free 20-tick run from one seed, the reference's key and the port's
  Threefry streams (random attack) or none (sign flip): rtol 1e-4,
  atol 1e-5 on honest nodes; the first tick's broadcast from one iterate
  equal on honest rows and within a relative 5.9e-6 on Byzantine rows
  (normal's 5.8e-6, ``test_torch_prng.py``, and the rounding of ``10 *``);
* the random attack given the reference's noise: exact;
* the port's dense and sparse trainers: bit for bit over 5 ticks.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core import byzantine as jbyz
from repro.core import graph as jgraph
from repro.models import small as jsmall
from repro.sim import tasks as jtasks
from repro_torch import convert, prng
from repro_torch.core import bridge, byzantine, graph
from repro_torch.models import small
from repro_torch.sim import tasks

M, B, TICKS = 12, 2, 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jtask():
    return jtasks.linear_task(M, TICKS, batch=16, num_train=600, num_test=120)


@pytest.fixture
def ptask():
    # function scope: ``batch_fn`` advances its own generator on every call,
    # as the reference's does, so each test takes a fresh one
    return tasks.linear_task(M, batch=16, num_train=600, num_test=120, device="cpu")


_JAX_RUNS: dict = {}


def rule_topology(graph_module, rule):
    """``erdos_renyi(M, p, B)`` at the first ``p`` from 0.6 up whose
    in-degrees meet ``rule``'s Table II bound (Bulyan's needs p near 1);
    both packages draw the same graph."""
    for p in (0.6, 0.7, 0.8, 0.9, 1.0):
        topo = graph_module.erdos_renyi(M, p, B, seed=0)
        try:
            topo.validate_for_rule(rule)
            return topo
        except ValueError:
            continue
    raise AssertionError(f"no graph for {rule}")


def jax_run(jtask, rule, attack, ticks, *, sparse=False, codec="identity"):
    """The reference's trajectory: states (params, key and codec carry as
    numpy) at ticks 0..ticks and the per-tick metrics, memoized per
    configuration."""
    key = (rule, attack, sparse, codec)
    if key not in _JAX_RUNS or len(_JAX_RUNS[key][0]) < ticks + 1:
        cfg = jbridge.BridgeConfig(topology=rule_topology(jgraph, rule), rule=rule,
                                   num_byzantine=B, attack=attack, t0=30, sparse=sparse,
                                   codec=codec)
        trainer = jbridge.BridgeTrainer(cfg, jtask.grad_fn)
        state = trainer.init(jtask.init_fn(0))
        snap = lambda st: (jax.tree_util.tree_map(np.asarray, st.params), np.asarray(st.key),
                           None if st.comm is None else tuple(np.asarray(x) for x in st.comm))
        states, mets = [snap(state)], []
        for i in range(ticks):
            state, m = trainer.step(state, jax.tree_util.tree_map(lambda x, i=i: x[i], jtask.batches))
            states.append(snap(state))
            mets.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[key] = (states, mets, np.asarray(trainer.byz_mask))
    return _JAX_RUNS[key]


def port_trainer(rule, attack, *, sparse=False, codec="identity"):
    cfg = bridge.BridgeConfig(topology=rule_topology(graph, rule), rule=rule,
                              num_byzantine=B, attack=attack, t0=30, sparse=sparse, codec=codec)
    return bridge.BridgeTrainer(cfg, small.linear_loss_and_grad, device="cpu")


def torch_batch(jtask, i):
    return tuple(torch.as_tensor(np.array(x[i])) for x in jtask.batches)


def check_one_step(jtask, rule, attack, ticks, *, sparse=False, codec="identity"):
    """Each of ``ticks`` steps taken by the port from the reference's
    carried state equals the reference's next state (see the tolerances)."""
    states, mets, byz = jax_run(jtask, rule, attack, ticks, sparse=sparse, codec=codec)
    trainer = port_trainer(rule, attack, sparse=sparse, codec=codec)
    np.testing.assert_array_equal(trainer.byz_mask.numpy(), byz)
    for t in range(ticks):
        params, key, comm = states[t]
        state = convert.state_from_jax(params, t, key=key, comm=comm, device="cpu")
        new, m = trainer.step(state, torch_batch(jtask, t))
        want_params, want_key, want_comm = states[t + 1]
        np.testing.assert_array_equal(new.key, want_key)
        atol = 7.5e-5 if (rule, attack) == ("mean", "random") else 1e-6
        for k in ("b", "w"):
            got, want = new.params[k].numpy(), want_params[k]
            np.testing.assert_allclose(got[~byz], want[~byz], rtol=1e-5, atol=atol)
            if byz.any():
                rows = lambda a: a[byz].reshape(int(byz.sum()), -1)
                err = np.linalg.norm(rows(got - want), axis=1)
                assert (err <= 1e-5 * np.linalg.norm(rows(want), axis=1)).all()
        for k in ("loss", "consensus_dist", "rho"):
            np.testing.assert_allclose(float(m[k]), mets[t][k], rtol=1e-5, err_msg=k)
        for k in ("wire_bits_per_edge", "wire_bytes_total"):
            assert float(m[k]) == mets[t][k], k
        np.testing.assert_allclose(float(m["ef_residual_norm"]), mets[t]["ef_residual_norm"],
                                   rtol=5e-5 if attack == "random" else 1e-5)
        if codec != "identity":
            rows = ~byz if attack == "random" else slice(None)
            for got, want in zip(new.comm, want_comm, strict=True):
                np.testing.assert_array_equal(got.numpy()[rows], want[rows])
        else:
            assert new.comm is None and want_comm is None


@pytest.mark.parametrize("rule,attack", [
    ("trimmed_mean", "none"), ("trimmed_mean", "sign_flip"), ("trimmed_mean", "alie"),
    ("median", "none"), ("median", "sign_flip"), ("median", "alie"), ("mean", "none"),
])
def test_one_step_parity_from_carried_state(jtask, rule, attack):
    check_one_step(jtask, rule, attack, 10)


@pytest.mark.parametrize("attack", ["none", "sign_flip", "random"])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "mean"])
def test_one_step_parity_sparse(jtask, rule, attack):
    check_one_step(jtask, rule, attack, 3, sparse=True)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rule", ["krum", "bulyan", "geomedian", "clipped_mean",
                                  "rep_trimmed_mean", "rep_median"])
def test_one_step_parity_new_rules(jtask, rule, sparse):
    """The rules beyond BRIDGE-T, BRIDGE-M and DGD, one step at a time from the reference's
    carried state (sign flip), at the same tolerances: Krum and Bulyan
    pick the reference's rows here (picks a rounding can flip are rare at
    one step from one iterate; over long runs they are not, so longer
    runs are compared by accuracy), and geomedian's and clipped mean's
    ulp-level differences (test_torch_rules.py) sit far below them."""
    check_one_step(jtask, rule, "sign_flip", 2, sparse=sparse)


@pytest.mark.parametrize("attack", ["sign_flip", "random"])
@pytest.mark.parametrize("sparse", [False, True])
def test_one_step_parity_int8_codec(jtask, sparse, attack):
    check_one_step(jtask, "trimmed_mean", attack, 3, sparse=sparse, codec="int8")


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_free_run_sign_flip(jtask, ptask, rule):
    states, _, byz = jax_run(jtask, rule, "sign_flip", TICKS)
    trainer = port_trainer(rule, "sign_flip")
    state = convert.state_from_jax(states[0][0], 0, device="cpu")
    state, _ = trainer.run(state, ptask.batch_fn, TICKS)
    assert state.t == TICKS
    final = states[TICKS][0]
    for k in ("b", "w"):
        np.testing.assert_allclose(state.params[k].numpy()[~byz], final[k][~byz],
                                   rtol=1e-4, atol=1e-5)
    acc_port = ptask.eval_accuracy(state.params, trainer.honest_mask)
    acc_ref = jtask.eval_accuracy(jax.tree_util.tree_map(jnp.asarray, final), ~byz)
    assert abs(acc_port - acc_ref) <= 1.0 / 120


@pytest.fixture(scope="module")
def jtask_iid():
    return jtasks.linear_task(M, TICKS, partition="iid", batch=16, num_train=600, num_test=120)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_free_run_random_attack_same_seed(jtask_iid, rule, sparse):
    """No noise injected: both packages draw init and attack from seed 0."""
    cfg = jbridge.BridgeConfig(topology=jgraph.erdos_renyi(M, 0.6, B, seed=0), rule=rule,
                               num_byzantine=B, attack="random", t0=30, sparse=sparse)
    jtrainer = jbridge.BridgeTrainer(cfg, jtask_iid.grad_fn)
    jstate = jtrainer.init(jtask_iid.init_fn(0))
    w0, _ = jbridge.stack_flatten(jstate.params)
    sub0 = jax.random.split(jstate.key)[1]
    jbcast = np.asarray(jbyz.ATTACKS["random"](w0, jtrainer.byz_mask, sub0, 0))
    for i in range(TICKS):
        jstate, _ = jtrainer.step(jstate, jax.tree_util.tree_map(lambda x, i=i: x[i],
                                                                  jtask_iid.batches))
    ptask = tasks.linear_task(M, partition="iid", batch=16, num_train=600, num_test=120,
                              device="cpu")
    trainer = port_trainer(rule, "random", sparse=sparse)
    state = trainer.init(ptask.init_fn(0))
    bcast = trainer.attack(torch.from_numpy(np.array(w0)), trainer.byz_mask,
                           prng.split(state.key)[1], 0).numpy()
    byz = np.asarray(jtrainer.byz_mask)
    np.testing.assert_array_equal(bcast[~byz], jbcast[~byz])
    np.testing.assert_allclose(bcast[byz], jbcast[byz], rtol=5.9e-6, atol=0)
    state, _ = trainer.run(state, ptask.batch_fn, TICKS)
    np.testing.assert_array_equal(state.key, np.asarray(jstate.key))
    for k in ("b", "w"):
        np.testing.assert_allclose(state.params[k].numpy()[~byz], np.asarray(jstate.params[k])[~byz],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("codec", ["identity", "int8"])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum", "bulyan"])
def test_dense_sparse_trainers_bitwise(rule, codec):
    ptask = tasks.linear_task(M, partition="iid", batch=16, num_train=600, num_test=120,
                              device="cpu")
    init = ptask.init_fn(1)
    batches = [ptask.batch_fn(i) for i in range(5)]
    finals = []
    for sparse in (False, True):
        trainer = port_trainer(rule, "random", sparse=sparse, codec=codec)
        state = trainer.init({k: v.clone() for k, v in init.items()}, seed=3)
        for batch in batches:
            state, _ = trainer.step(state, batch)
        finals.append(state)
    for k in ("b", "w"):
        assert torch.equal(finals[0].params[k], finals[1].params[k])
    if codec == "int8":
        assert all(torch.equal(a, b) for a, b in zip(finals[0].comm, finals[1].comm, strict=True))


def test_random_attack_with_reference_noise_is_exact():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(M, 300)).astype(np.float32)
    mask = byzantine.pick_byzantine_mask(M, 3, 1)
    key, t = jax.random.PRNGKey(5), 7
    want = np.asarray(jbyz.ATTACKS["random"](jnp.asarray(w), jnp.asarray(mask), key, t))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, t), w.shape, jnp.float32))
    got = byzantine.random_body(torch.from_numpy(w), torch.from_numpy(mask), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("attack", ["sign_flip", "same_value", "alie", "shift", "none"])
def test_deterministic_attacks_match_reference(attack):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(M, 200)).astype(np.float32)
    mask = byzantine.pick_byzantine_mask(M, 3, 0)
    want = np.asarray(jbyz.ATTACKS[attack](jnp.asarray(w), jnp.asarray(mask), None, 0))
    got = byzantine.get_attack(attack)(torch.from_numpy(w), torch.from_numpy(mask), None, 0).numpy()
    honest = ~mask
    np.testing.assert_array_equal(got[honest], want[honest])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_random_attack_draws_from_generator():
    """The random attack's noise is the reference's Threefry draw
    ``10 * normal(fold_in(key, t))`` (within normal's tolerance and one
    rounding), and the same
    key and tick draw the same noise."""
    w = torch.zeros(M, 500)
    mask_np = byzantine.pick_byzantine_mask(M, 3, 0)
    mask = torch.from_numpy(mask_np)
    key = np.asarray(jax.random.split(jax.random.PRNGKey(0))[1])
    out = byzantine.get_attack("random")(w, mask, key, 4)
    assert torch.equal(out[~mask], w[~mask])
    assert 9.0 < float(out[mask].std()) < 11.0
    assert torch.equal(out, byzantine.get_attack("random")(w, mask, key.copy(), 4))
    assert not torch.equal(out, byzantine.get_attack("random")(w, mask, key, 5))
    want = np.asarray(jbyz.ATTACKS["random"](jnp.zeros((M, 500)), jnp.asarray(mask_np),
                                              jnp.asarray(key), 4))
    np.testing.assert_allclose(out.numpy(), want, rtol=5.9e-6, atol=0)


def test_stack_flatten_order_and_roundtrip(jtask):
    params = jax.tree_util.tree_map(np.asarray, jtask.init_fn(0))
    want, _ = jbridge.stack_flatten(jax.tree_util.tree_map(jnp.asarray, params))
    tparams = convert.params_from_jax(params, device="cpu")
    got, unflatten = bridge.stack_flatten(tparams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unflatten(got)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), params[k])


def test_loss_and_grad_match_reference(jtask):
    params = jax.tree_util.tree_map(np.asarray, jtask.init_fn(3))
    batch = tuple(np.array(x[0]) for x in jtask.batches)
    jl, jg = jax.vmap(jtask.grad_fn)(jax.tree_util.tree_map(jnp.asarray, params),
                                     tuple(jnp.asarray(x) for x in batch))
    tparams = convert.params_from_jax(params, device="cpu")
    tl, tg = small.linear_loss_and_grad(tparams, tuple(torch.as_tensor(x) for x in batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for k in ("b", "w"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-6)
    one = {k: v[0] for k, v in tparams.items()}
    single = small.linear_loss(one, (torch.as_tensor(batch[0][0]), torch.as_tensor(batch[1][0])))
    want_single = jsmall.linear_loss({k: jnp.asarray(v[0]) for k, v in params.items()},
                                     (jnp.asarray(batch[0][0]), jnp.asarray(batch[1][0])))
    np.testing.assert_allclose(float(single), float(want_single), rtol=1e-5)
    xt, yt = np.array(jtask.x_test), np.array(jtask.y_test)
    acc = small.linear_accuracy(one, torch.as_tensor(xt), torch.as_tensor(yt))
    want_acc = jsmall.linear_accuracy({k: jnp.asarray(v[0]) for k, v in params.items()}, xt, yt)
    assert float(acc) == float(want_acc)


def test_step_size_float32_exact():
    cell = jbridge.CellParams(rule_idx=0, attack_idx=0, b=0, byz_mask=None,
                              lam=jnp.float32(0.7), t0=jnp.float32(30.0), lr=jnp.float32(0.0))
    for t in (0, 1, 7, 99, 12345):
        want = float(jax.jit(jbridge.cell_step_size)(cell, jnp.int32(t)))
        assert bridge.cell_step_size(0.7, 30.0, 0.0, t) == want
    assert bridge.cell_step_size(0.7, 30.0, 0.05, 3) == float(np.float32(0.05))


def test_linear_task_matches_reference(jtask, ptask):
    np.testing.assert_array_equal(ptask.x_test.numpy(), np.asarray(jtask.x_test))
    np.testing.assert_array_equal(ptask.y_test.numpy(), np.asarray(jtask.y_test))
    for i in range(3):
        for got, want in zip(ptask.batch_fn(i), jtask.batches, strict=True):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))
    params = ptask.init_fn(0)
    assert params["w"].shape == (M, 784, 10) and params["b"].shape == (M, 10)
    assert float(params["w"].std()) > 0.005


def test_trainer_checks():
    topo = graph.erdos_renyi(M, 0.6, B, seed=0)
    cfg = bridge.BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=B, attack="sign_flip")
    trainer = bridge.BridgeTrainer(cfg, small.linear_loss_and_grad, device="cpu")
    assert int(trainer.honest_mask.sum()) == M - B
    with pytest.raises(ValueError):
        trainer.init({"w": torch.zeros(M + 1, 784, 10), "b": torch.zeros(M + 1, 10)})
    with pytest.raises(ValueError):  # Table II: min in-degree 2b + 1 for b = 8
        bridge.BridgeTrainer(bridge.BridgeConfig(topology=graph.Topology(topo.adjacency, 8),
                                                 rule="trimmed_mean", num_byzantine=8),
                             small.linear_loss_and_grad, device="cpu")
    with pytest.raises(ValueError):
        bridge.BridgeTrainer(bridge.BridgeConfig(topology=topo, attack="krum_lie"),
                             small.linear_loss_and_grad, device="cpu")
    none = bridge.BridgeTrainer(bridge.BridgeConfig(topology=topo, num_byzantine=B),
                                small.linear_loss_and_grad, device="cpu")
    assert not bool(none.byz_mask.any())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    topo = graph.complete_graph(4, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.BridgeTrainer(bridge.BridgeConfig(topology=topo), small.linear_loss_and_grad)
    with pytest.raises(RuntimeError, match="cuda"):
        tasks.linear_task(10)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_jax({"b": np.zeros((2, 3), np.float32)})


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[. ])", re.M)


def _port_sources():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_reference():
    files = _port_sources()
    assert len(files) > 22
    for path in files:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.sim.tasks, repro_torch.convert, "
            "repro_torch.prng, repro_torch.core.neighbors, repro_torch.comm.codec, "
            "repro_torch.comm.exchange, repro_torch.kernels.gather_screen, "
            "repro_torch.kernels.dequant, repro_torch.kernels.ops, repro_torch.kernels.pairwise, "
            "repro_torch.core.byrdie, repro_torch.core.brdso, repro_torch.sim.variants, "
            "repro_torch.net, repro_torch.net.channel, repro_torch.net.dynamic, "
            "repro_torch.net.mailbox, repro_torch.net.runtime, repro_torch.net.scenarios, "
            "repro_torch.net.async_bridge, repro_torch.kernels.views_screen; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tf32_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
