"""The paper's baselines — ByRDiE (`repro_torch.core.byrdie`) and
BRDSO (`repro_torch.core.brdso`) — against `repro.core.byrdie` /
`repro.core.brdso` on the CPU, and the port of the variants comparison
(`repro_torch.sim.variants`).

Each step starts from the reference's carried state (parameters, counter,
key), handed over as numpy arrays (`repro_torch.convert`).

Tolerances, stated per comparison:
* BRDSO, 3 steps each from the reference's state: rtol 1e-5, atol 1e-6 on
  honest rows, as the trainer's one-step parity (`test_torch_bridge.py`):
  the sign sum is exact, the update is XLA's two fused multiply-adds
  (`ref.fma_f32`), and what differs is the gradient's matrix products;
* ByRDiE, one sweep (16 blocks of 512): rtol 1e-5, atol 1e-6 on honest
  rows: the gradient is recomputed at the current iterate before each
  block, so the products' rounding carries from block to block;
* ByRDiE's block screen alone: exact.  The reference's ``b`` is static and
  its adjacency closed over, so XLA multiplies the kept total by the
  reciprocal of its divisor; the port asks the trimmed-mean kernel for
  that form (``recip=True``);
* the key, the counters and ``scalars_sent``: exact; the loss: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brdso as jbrdso
from repro.core import byrdie as jbyrdie
from repro.core import graph as jgraph
from repro.core import screening as jscreening
from repro.sim import tasks as jtasks
from repro_torch import convert
from repro_torch.core import brdso, byrdie, graph, screening
from repro_torch.models import small
from repro_torch.sim import variants

M, B = 10, 1


@pytest.fixture(scope="module")
def jtask():
    return jtasks.linear_task(M, 4, partition="iid", batch=16, num_train=400, num_test=100)


def batch_at(jtask, i):
    return (jax.tree_util.tree_map(lambda x: x[i], jtask.batches),
            tuple(torch.as_tensor(np.array(x[i])) for x in jtask.batches))


def snap(params):
    return jax.tree_util.tree_map(np.asarray, params)


def check_params(got, want, byz):
    for k in ("b", "w"):
        np.testing.assert_allclose(got[k].numpy()[~byz], want[k][~byz], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("attack", ["none", "sign_flip", "random"])
def test_brdso_steps_from_carried_state(jtask, attack):
    cfg = dict(num_byzantine=B, attack=attack, t0=30)
    jtr = jbrdso.BrdsoTrainer(jbrdso.BrdsoConfig(topology=jgraph.erdos_renyi(M, 0.5, B, seed=0),
                                                 **cfg), jtask.grad_fn)
    ptr = brdso.BrdsoTrainer(brdso.BrdsoConfig(topology=graph.erdos_renyi(M, 0.5, B, seed=0),
                                               **cfg), small.linear_loss_and_grad, device="cpu")
    byz = np.asarray(jtr.byz_mask)
    np.testing.assert_array_equal(ptr.byz_mask.numpy(), byz)
    jstate = jtr.init(jtask.init_fn(0))
    for i in range(3):
        state = convert.brdso_state_from_jax(snap(jstate.params), int(jstate.t),
                                             key=np.asarray(jstate.key), device="cpu")
        jb, tb = batch_at(jtask, i)
        jstate, jm = jtr.step(jstate, jb)
        new, m = ptr.step(state, tb)
        np.testing.assert_array_equal(new.key, np.asarray(jstate.key))
        assert new.t == int(jstate.t)
        check_params(new.params, snap(jstate.params), byz)
        for k in ("loss", "consensus_dist"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("attack", ["none", "random"])
def test_byrdie_sweep_from_carried_state(jtask, attack):
    cfg = dict(num_byzantine=B, attack=attack, t0=30, block=512)
    jtr = jbyrdie.ByrdieTrainer(jbyrdie.ByrdieConfig(
        topology=jgraph.erdos_renyi(M, 0.5, B, seed=0), **cfg), jtask.grad_fn)
    ptr = byrdie.ByrdieTrainer(byrdie.ByrdieConfig(
        topology=graph.erdos_renyi(M, 0.5, B, seed=0), **cfg), small.linear_loss_and_grad,
        device="cpu")
    byz = np.asarray(jtr.byz_mask)
    jstate = jtr.init(jtask.init_fn(0))
    jstate, _ = jtr.sweep(jstate, batch_at(jtask, 0)[0])  # carry a state past sweep 0
    state = convert.byrdie_state_from_jax(snap(jstate.params), int(jstate.t),
                                          key=np.asarray(jstate.key),
                                          scalars_sent=float(jstate.scalars_sent), device="cpu")
    jb, tb = batch_at(jtask, 1)
    jstate, jm = jtr.sweep(jstate, jb)
    new, m = ptr.sweep(state, tb)
    np.testing.assert_array_equal(new.key, np.asarray(jstate.key))
    assert new.t == int(jstate.t) == 2
    assert new.scalars_sent == float(jstate.scalars_sent) == 2 * 7850
    check_params(new.params, snap(jstate.params), byz)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)


def test_brdso_sign_sum_in_blocks_equals_one_tensor(monkeypatch):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(9, 30)).astype(np.float32))
    wb = w.clone()
    wb[0] = 5.0
    adj = torch.from_numpy(rng.random((9, 9)) < 0.5)
    whole = torch.sum(torch.where(adj[:, :, None], torch.sign(w[:, None] - wb[None]), 0.0), dim=1)
    monkeypatch.setattr(brdso, "TV_BLOCK_ELEMS", 2 * 9 * 30)  # blocks of two nodes
    np.testing.assert_array_equal(brdso.tv_subgradient(w, wb, adj).numpy(), whole.numpy())


def test_variants_entry_prints_all_rows(capsys):
    rows = variants.main(["--nodes", "8", "--byzantine", "1", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    labels = [r["variant"] for r in rows]
    assert labels == ["DGD", "BRIDGE-T", "BRIDGE-M", "BRIDGE-K", "BRIDGE-B", "ByRDiE", "BRDSO"]
    for label in labels:
        assert f"\n{label} " in out
    assert all(0.0 <= r["accuracy"] <= 1.0 for r in rows)
    assert rows[5]["scalars_sent"] == 2 * 7850
    assert rows[0]["wire_bits_per_edge"] == 32 * 7850


@pytest.mark.parametrize("m,b,seed", [(20, 2, 2), (10, 1, 0), (30, 3, 1)])
def test_byrdie_block_screen_bit_exact(m, b, seed):
    """The reference's block screen, jitted with the adjacency closed over
    and ``b`` static, as `repro.core.byrdie` runs it, against the port's
    reciprocal form; the division (the BRIDGE trainer's form) is not it."""
    topo = jgraph.erdos_renyi(m, 0.5, b, seed=seed)
    w = np.random.default_rng(seed).normal(size=(m, 512)).astype(np.float32)
    adj = jnp.asarray(topo.adjacency)
    want = np.asarray(jax.jit(lambda w_: jscreening.screen_all(w_, adj, rule="trimmed_mean",
                                                               b=b))(jnp.asarray(w)))
    tw, ta = torch.from_numpy(w), torch.from_numpy(topo.adjacency)
    got = screening.screen_all(tw, ta, rule="trimmed_mean", b=b, recip=True).numpy()
    np.testing.assert_array_equal(got, want)
    divided = screening.screen_all(tw, ta, rule="trimmed_mean", b=b).numpy()
    assert (divided != want).any()


@pytest.mark.parametrize("argv", [["--adversary", "ipm"], ["--codec", "int4"],
                                  ["--attack", "garbage_codeword"]])
def test_variants_unported_options_raise(argv, capsys):
    """Every option runs now, the adaptive adversary included (it replaces
    the attack in the table's header); the codecs and the wire attacks
    run, the baselines under the reference's ``random`` in place of a wire
    attack."""
    run = lambda: variants.main([*argv, "--nodes", "8", "--byzantine", "1", "--steps", "1",
                                 "--device", "cpu", "--no-baselines"])
    rows = run()
    if argv[0] == "--adversary":
        assert "attack=ipm" in capsys.readouterr().out
        assert len(rows) == 5 and all(0.0 <= r["accuracy"] <= 1.0 for r in rows)
        return
    codecs = ["identity", "int4"] if argv[0] == "--codec" else ["identity"]
    assert [r["codec"] for r in rows] == codecs * 5
    assert f"attack={argv[1] if argv[0] == '--attack' else 'random'}" in capsys.readouterr().out
    if argv[0] == "--codec":
        assert rows[1]["wire_bits_per_edge"] == 4 * 7850 + 32 * 62


def test_variants_int4_under_scale_abuse_with_baselines(capsys):
    """The row set `chip_smoke.py` adds: ``--codec int4 --attack
    scale_abuse``, every variant uncompressed and compressed, then the
    baselines under ``random``."""
    rows = variants.main(["--codec", "int4", "--attack", "scale_abuse", "--nodes", "8",
                          "--byzantine", "1", "--steps", "1", "--device", "cpu"])
    assert [r["variant"] for r in rows] == [v for _, v in variants.VARIANTS for _ in (0, 1)] + [
        "ByRDiE", "BRDSO"]
    assert all(0.0 <= r["accuracy"] <= 1.0 for r in rows)
    assert variants.baseline_attack("scale_abuse") == "random"
    assert variants.baseline_attack("alie") == "alie"
