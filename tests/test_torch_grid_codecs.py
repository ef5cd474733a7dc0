"""The grid's codec axis (`repro_torch.comm.exchange`'s bank forms, the
wire attacks over cells, `GridEngine` with lossy codecs) on the CPU.

* `encode_bank` / `decode_bank` over a leading axis of cells, each with its
  own codec of a mixed bank, against the reference's ``vmap`` of its
  ``encode_bank`` / ``decode_bank`` on the same inputs and keys: codewords
  bit for bit (padded to the bank's largest, as the reference's switch
  branches are), decodes within 1 ulp (the reference's own allowance for a
  multi-codec program, `repro.sim.engine`; absolute 4.8e-7 here, where the
  decodes are of order 1);
* every cell of a grid under each codec and wire attack equals its own
  trainer run bit for bit: synchronous dense and sparse
  (`BridgeTrainer`), net dense and sparse (`AsyncBridgeTrainer` over the
  cell's schedule; parameters under ``torch.equal``, which reads ``-0.0``
  and ``+0.0`` as equal, as the net grids' cells are held), with one
  ``dequant_carry`` call per group and tick;
* a banked (``group=False``) multi-codec grid against its grouped twin:
  identity cells exactly, lossy cells within rtol 1e-5 (ulps a tick
  through the carry, as the reference allows);
* from the reference `GridEngine`'s carried state (``comm`` included),
  the port's grid follows it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codec as jcodec
from repro.comm import exchange as jexchange
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.sim import ExperimentGrid as JGrid
from repro.sim import GridEngine as JEngine
from repro.sim.engine import stack_batches as jstack_batches
from repro_torch import convert, prng
from repro_torch.comm import codec, exchange
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate
from repro_torch.kernels import dequant
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer
from repro_torch.net.runtime import SparseUnreliableRuntime
from repro_torch.net.scenarios import get_scenario
from repro_torch.sim import ExperimentGrid, GridEngine

M, D, T = 10, 24, 4


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
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32))


def topo():
    return erdos_renyi(M, 0.8, 2, seed=1)


BANK = ("identity", "int8", "int4", "topk25_int8", "randk25")


@pytest.mark.parametrize("d", [24, 300])
def test_bank_encode_decode_match_the_reference(d):
    """Five cells, each its own codec of a mixed bank, over ``[E, M, d]``
    with the cells' keys: codewords bit for bit, decodes within 1 ulp."""
    rng = np.random.default_rng(d)
    e = len(BANK)
    x = rng.normal(size=(e, M, d)).astype(np.float32)
    est = (rng.normal(size=(e, M, d)) * 0.5).astype(np.float32)
    resid = (rng.normal(size=(e, M, d)) * 0.01).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(100 + i)) for i in range(e)])
    idx = np.arange(e)
    jbank = jcodec.codec_bank(BANK)

    def jone(i, k, xx, es, rs):
        st = jexchange.CommState(es, rs)
        msg, target = jexchange.encode_bank(jbank, i, k, xx, st)
        x_hat, st2 = jexchange.decode_bank(jbank, i, msg, target, st, k)
        return msg, target, x_hat, st2

    jmsg, jtarget, jx, jst = jax.jit(jax.vmap(jone))(
        jnp.asarray(idx, jnp.int32), jnp.asarray(keys), jnp.asarray(x), jnp.asarray(est),
        jnp.asarray(resid))
    bank = codec.codec_bank(BANK)
    st = exchange.CommState(torch.from_numpy(est), torch.from_numpy(resid))
    msg, target = exchange.encode_bank(bank, idx, keys, torch.from_numpy(x), st)
    for got, want in zip(msg, jmsg, strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(target.numpy(), np.asarray(jtarget))
    x_hat, st2 = exchange.decode_bank(bank, idx, msg, target, st, keys)
    for got, want in ((x_hat, jx), (st2.est, jst.est), (st2.resid, jst.resid)):
        # one rounding apart: an ulp of the decode's inputs (the residual
        # cancels to a few ulps of the target's magnitude)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1.2e-7 * 4)
    assert exchange.wire_bits_bank(bank, idx, d) == tuple(c.wire_bits(d) for c in bank)
    assert exchange.max_wire_bits(bank, d) == max(c.wire_bits(d) for c in bank)
    assert exchange.wire_bits_blocks(bank, (1, 1), (d, d)) == 2 * bank[1].wire_bits(d)


def sync_run(cell, targets, sparse):
    cfg = BridgeConfig(topology=topo(), rule=cell.rule, num_byzantine=cell.b, attack=cell.attack,
                       codec=cell.codec, lam=1.0, t0=10.0, byzantine_seed=cell.mask_seed,
                       sparse=sparse)
    tr = BridgeTrainer(cfg, qgrad, device="cpu")
    st = tr.init(init_fn(cell.seed), seed=cell.seed)
    losses = []
    for _ in range(T):
        st, m = tr.step(st, targets)
        losses.append(m["loss"])
    return st, torch.stack(losses)


def net_run(engine, cell, targets):
    spec = get_scenario(cell.scenario)
    kw = dict(topology=engine.grid.topology, rule=cell.rule, num_byzantine=cell.b,
              attack=cell.attack, codec=cell.codec, lam=1.0, t0=10.0,
              byzantine_seed=cell.mask_seed)
    sched = engine.runtime.schedule_for(cell.scenario)
    if engine.sparse:
        rt = SparseUnreliableRuntime(sched, spec.channel, staleness_bound=spec.staleness_bound,
                                     neighbors=engine.neighbors, device="cpu")
        tr = BridgeTrainer(BridgeConfig(**kw, sparse=True), qgrad, runtime=rt, device="cpu")
    else:
        tr = AsyncBridgeTrainer(AsyncBridgeConfig(**kw, channel=spec.channel,
                                                  staleness_bound=spec.staleness_bound,
                                                  schedule=sched), qgrad, device="cpu")
    st = tr.init(init_fn(cell.seed), seed=cell.seed)
    losses = []
    for _ in range(T):
        st, m = tr.step(st, targets)
        losses.append(m["loss"])
    return st, torch.stack(losses)


@pytest.mark.parametrize("net,sparse", [(False, False), (False, True), (True, False),
                                        (True, True)])
def test_grid_cells_under_codecs_equal_their_trainer_runs(targets, net, sparse):
    """Median and trimmed mean x random / scale_abuse / garbage_codeword x
    int8 / topk25_int8 (and int4 on net cells), every cell its trainer
    run; one ``dequant_carry`` call a dense group and tick."""
    codecs = ("int8", "int4", "topk25_int8") if net else ("int8", "topk25_int8")
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median"),
                          ("random", "scale_abuse", "garbage_codeword"), (2,), (0,),
                          scenarios=("lossy",) if net else None, codecs=codecs,
                          lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, sparse=sparse, num_ticks=T if net else None, device="cpu")
    calls = []
    real = dequant.dequant_carry
    dequant.dequant_carry = lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k)
    try:
        final, metrics = engine.run(engine.init(init_fn), torch.stack([targets] * T))
    finally:
        dequant.dequant_carry = real
    dense_groups = sum(1 for c in engine.codec_bank if codec.get_codec(c).mode == "dense") * 6
    assert len(calls) == dense_groups * T  # one launch a dense group and tick
    assert final.comm is not None and final.comm.est.shape[0] == engine.num_cells
    for i, cell in enumerate(engine.cells):
        st, loss = net_run(engine, cell, targets) if net else sync_run(cell, targets, sparse)
        assert torch.equal(final.params["w"][i], st.params["w"]), cell
        assert torch.equal(metrics["loss"][i], loss), cell
        for got, want in zip(final.comm, st.comm, strict=True):
            assert torch.equal(got[i], want), cell
        assert np.array_equal(final.key[i], st.key)
        assert float(metrics["wire_bits_per_edge"][i, 0]) == codec.get_codec(
            cell.codec).wire_bits(D)


def test_banked_multi_codec_grid_against_its_grouped_twin(targets):
    """``group=False`` over identity, int8 and topk25_int8 under random and
    scale_abuse: identity cells equal their grouped twins exactly, the
    lossy ones within rtol 1e-5 (the carry accumulates an ulp where the
    bank's decode rounds differently: one wire attack rewriting the scale
    makes every cell decode in two roundings)."""
    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("random", "scale_abuse"), (2,), (0, 1),
                          codecs=("identity", "int8", "topk25_int8"), lam=1.0, t0=10.0)
    batches = torch.stack([targets] * T)
    grouped = GridEngine(grid, qgrad, device="cpu")
    banked = GridEngine(grid, qgrad, group=False, device="cpu")
    assert banked.num_steps_built == 1
    fg, mg = grouped.run(grouped.init(init_fn), batches)
    fb, mb = banked.run(banked.init(init_fn), batches)
    for i, cell in enumerate(grouped.cells):
        if cell.codec == "identity":
            assert torch.equal(fb.params["w"][i], fg.params["w"][i]), cell
        else:
            np.testing.assert_allclose(fb.params["w"][i].numpy(), fg.params["w"][i].numpy(),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mb["loss"].numpy(), mg["loss"].numpy(), rtol=1e-5, atol=1e-6)


def test_grid_follows_the_reference_grid_from_its_carried_codec_state(targets):
    """The reference net grid under int8 / topk25_int8 and scale_abuse runs
    2 ticks; its state (the per-link codec carry included)
    crosses with `grid_state_from_jax(comm=...)` and the port's grid
    follows it for 3 ticks at rtol 1e-5."""
    tgt = jnp.asarray(targets.numpy())
    scen = ("lossy",)
    args = (("trimmed_mean",), ("scale_abuse",), (2,), (0, 1))
    kw = dict(scenarios=scen, codecs=("int8", "topk25_int8"), lam=1.0, t0=10.0)
    jengine = JEngine(JGrid(jerdos_renyi(M, 0.8, 2, seed=1), *args, **kw), jqgrad,
                      num_ticks=8)
    jstate, _ = jengine.run(jengine.init(jinit_fn), jstack_batches(lambda i: tgt, 2))
    jfinal, jm = jengine.run(jstate, jstack_batches(lambda i: tgt, 3))
    engine = GridEngine(ExperimentGrid(topo(), *args, **kw), qgrad,
                        num_ticks=8, device="cpu")
    assert [c.tag for c in engine.cells] == [c.tag for c in jengine.cells]
    net_state = tuple(np.asarray(x) for x in jstate.net)
    state = convert.grid_state_from_jax(
        {"w": np.asarray(jstate.params["w"])}, np.asarray(jstate.t), np.asarray(jstate.key),
        net=net_state, comm=tuple(np.asarray(x) for x in jstate.comm), device="cpu")
    final, metrics = engine.run(state, torch.stack([targets] * 3))
    honest = ~engine.byz_masks
    np.testing.assert_allclose(final.params["w"].numpy()[honest],
                               np.asarray(jfinal.params["w"])[honest], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final.comm.est.numpy(), np.asarray(jfinal.comm.est),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(final.key, np.asarray(jfinal.key))
    with pytest.raises(ValueError, match="E=2"):
        convert.grid_state_from_jax({"w": np.zeros((2, M, D), np.float32)}, 0,
                                    np.zeros((2, 2), np.uint32),
                                    comm=(np.zeros((3, M, D)), np.zeros((3, M, D))),
                                    device="cpu")
