"""The port's net-scenario grids (`repro_torch.sim.GridNetRuntime`,
`GridEngine(..., num_ticks=...)`) against the port's own asynchronous
trainer and against the reference's grid engine, on the CPU.

* every cell of a net grid equals its own trainer run over
  ``schedule_for(scenario)`` bit for bit (params and loss streams),
  grouped and banked, dense and sparse — the reference's anchor
  (``tests/test_grid.py``).  A cell shares the grid's mailbox ring, sized
  for the slowest scenario, where its own run has a ring of its own
  latency: the ring's arrival slot adds ``0.0`` when it holds more than one
  slot, so a ``-0.0`` payload may arrive as ``+0.0`` in one and not the
  other.  ``torch.equal`` treats the two zeros alike, as the reference's
  ``assert_array_equal`` does;
* dense and sparse net grids are bit-identical (``tests/test_sparse.py``'s
  smoke subset, identity codec);
* chunked equals unchunked with the mailboxes carried; `set_cells` keeps
  the engine's steps;
* from a reference net grid's state after 2 ticks (mailboxes included),
  the port's grid follows the reference's: T / M at rtol 1e-5, the channel
  stats and the keys equal;
* the views plain versions over ``[E, ...]`` with per-cell b equal the
  per-experiment calls (the kernels against them on the card:
  ``tests/test_torch_kernels.py``, ``cuda``-marked).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.sim import ExperimentGrid as JGrid
from repro.sim import GridEngine as JEngine
from repro.sim.engine import stack_batches as jstack_batches
from repro_torch import convert, prng
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate
from repro_torch.kernels import ref, views_screen
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer
from repro_torch.net.runtime import SparseUnreliableRuntime
from repro_torch.net.scenarios import get_scenario
from repro_torch.sim import ExperimentGrid, GridEngine

M, D, T = 12, 5, 6


def qgrad(params, batch):
    """The reference test's quadratic loss, per node, over any leading
    axes."""
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


def trainer_run(engine, cell, targets, ticks=T):
    """The cell's own asynchronous trainer over its scenario's schedule
    (sparse: on the engine's union table, so its K is the grid's)."""
    spec = get_scenario(cell.scenario)
    kw = dict(topology=engine.grid.topology, rule=cell.rule, num_byzantine=cell.b,
              attack=cell.attack, lam=1.0, t0=10.0, byzantine_seed=cell.mask_seed)
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
    losses, stats = [], []
    for _ in range(ticks):
        st, m = tr.step(st, targets)
        losses.append(m["loss"])
        stats.append((m["delivered_frac"], m["mean_staleness"]))
    return st, torch.stack(losses), stats


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("group", [True, False])
def test_net_grid_cells_equal_their_trainer_runs(targets, group, sparse):
    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("random", "selective_victim"), (2,),
                          (0, 1), scenarios=("ideal", "lossy_laggy", "churn"), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, num_ticks=T, group=group, sparse=sparse, device="cpu")
    final, metrics = engine.run(engine.init(init_fn), torch.stack([targets] * T))
    assert engine.num_steps_built == (2 if group else 1)
    assert final.net.values.shape[:2] == (12, M)
    for i, cell in enumerate(engine.cells):
        st, losses, stats = trainer_run(engine, cell, targets)
        assert torch.equal(final.params["w"][i], st.params["w"]), f"params diverged for {cell}"
        assert torch.equal(metrics["loss"][i], losses), f"loss diverged for {cell}"
        assert np.array_equal(final.key[i], st.key)
        for k, col in (("delivered_frac", 0), ("mean_staleness", 1)):
            assert torch.equal(metrics[k][i], torch.stack([s[col] for s in stats])), k


@pytest.mark.parametrize("rules,attacks", [(("trimmed_mean", "median"), ("random",
                                                                        "selective_victim")),
                                           (("krum", "bulyan"), ("alie",))])
def test_dense_and_sparse_net_grids_are_bit_identical(targets, rules, attacks):
    topology = erdos_renyi(M, 0.9, 1, seed=1)
    out = {}
    for sparse in (False, True):
        grid = ExperimentGrid(topology, rules, attacks, (1,), (0,),
                              scenarios=("lossy_laggy", "churn"), lam=1.0, t0=10.0)
        engine = GridEngine(grid, qgrad, num_ticks=T, sparse=sparse, device="cpu")
        out[sparse] = engine.run(engine.init(init_fn), torch.stack([targets] * T))
    assert torch.equal(out[False][0].params["w"], out[True][0].params["w"])
    assert torch.equal(out[False][1]["loss"], out[True][1]["loss"])
    assert torch.equal(out[False][1]["delivered_frac"], out[True][1]["delivered_frac"])


def test_net_grid_chunked_equals_unchunked_and_set_cells_keeps_the_engine(targets):
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median"), ("alie",), (1, 2), (0, 1, 2),
                          scenarios=("lossy", "laggy"), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, num_ticks=4, device="cpu")
    batches = torch.stack([targets] * 4)
    whole, mw = engine.run(engine.init(init_fn), batches)
    for chunk in (1, 5):  # ragged tails: groups of 12 cells
        part, mp = engine.run(engine.init(init_fn), batches, chunk=chunk)
        assert torch.equal(part.params["w"], whole.params["w"])
        assert all(torch.equal(a, b) for a, b in zip(part.net, whole.net, strict=True))
        assert torch.equal(mp["loss"], mw["loss"])
        assert torch.equal(mp["mean_staleness"], mw["mean_staleness"])
    # two ticks, then two more from the carried mailboxes
    half, _ = engine.run(engine.init(init_fn), batches[:2])
    rest, _ = engine.run(half, batches[2:])
    assert torch.equal(rest.params["w"], whole.params["w"])
    built, steps = engine.num_steps_built, list(engine._steps)
    moved = [c._replace(seed=c.seed + 5, mask_seed=c.mask_seed + 5,
                        scenario="laggy" if c.scenario == "lossy" else "lossy")
             for c in engine.cells]
    engine.set_cells(moved)
    assert engine.num_steps_built == built and engine._steps == steps
    got, _ = engine.run(engine.init(init_fn), batches)
    fresh = GridEngine(grid, qgrad, cells=moved, num_ticks=4, device="cpu")
    want, _ = fresh.run(fresh.init(init_fn), batches)
    assert torch.equal(got.params["w"], want.params["w"])
    with pytest.raises(ValueError, match="outside"):
        engine.set_cells([c._replace(scenario="churn") for c in moved])
    with pytest.raises(ValueError, match="sync/net"):
        engine.set_cells([c._replace(scenario=None) for c in moved])
    with pytest.raises(ValueError, match="num_ticks"):
        GridEngine(grid, qgrad, device="cpu")
    with pytest.raises(ValueError, match="cannot mix"):
        GridEngine(grid, qgrad, cells=[moved[0], moved[1]._replace(scenario=None)],
                   num_ticks=4, device="cpu")


@pytest.mark.parametrize("sparse", [False, True])
def test_net_grid_follows_the_reference_grid_from_its_state(targets, sparse):
    """From the reference net grid's state after 2 ticks (its stacked
    mailboxes through `convert`), the port's grid follows it for 3 ticks:
    T / M at rtol 1e-5 (alie crafts values a few ulps from the
    reference's), the channel stats and the keys equal."""
    tgt = jnp.asarray(targets.numpy())
    scenarios = ("lossy_laggy", "churn")
    jgrid = JGrid(jerdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean", "median"), ("alie",), (2,),
                  (0, 1), scenarios=scenarios, lam=1.0, t0=10.0)
    jengine = JEngine(jgrid, jqgrad, num_ticks=5, sparse=sparse)
    jstate, _ = jengine.run(jengine.init(jinit_fn), jstack_batches(lambda i: tgt, 2))
    jfinal, jm = jengine.run(jstate, jstack_batches(lambda i: tgt, 3))
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median"), ("alie",), (2,), (0, 1),
                          scenarios=scenarios, lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, num_ticks=5, sparse=sparse, device="cpu")
    assert [c.tag for c in engine.cells] == [c.tag for c in jengine.cells]
    assert np.array_equal(engine.runtime.schedule_for("churn"),
                          jengine.runtime.schedule_for("churn"))
    state = convert.grid_state_from_jax(
        {"w": np.asarray(jstate.params["w"])}, np.asarray(jstate.t), np.asarray(jstate.key),
        net=tuple(np.asarray(x) for x in jstate.net), device="cpu")
    assert state.t == 2 and state.net.values.shape == tuple(jstate.net.values.shape)
    final, metrics = engine.run(state, torch.stack([targets] * 3))
    honest = ~engine.byz_masks
    got, want = final.params["w"].numpy(), np.asarray(jfinal.params["w"])
    np.testing.assert_allclose(got[honest], want[honest], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5,
                               atol=1e-6)
    for k in ("delivered_frac", "mean_staleness"):
        assert np.array_equal(metrics[k].numpy(), np.asarray(jm[k])), k
    assert np.array_equal(final.key, np.asarray(jfinal.key))
    assert np.array_equal(final.net.send_tick.numpy(), np.asarray(jfinal.net.send_tick))


def views_cells(e, m, w, d, seed, stride0=False):
    rng = np.random.default_rng(seed)
    shape = (e, 1 if stride0 else m, w, d)
    v = rng.normal(size=shape).astype(np.float32)
    v[rng.random(shape) < 0.05] = np.nan
    v[rng.random(shape) < 0.03] = np.inf
    v[rng.random(shape) < 0.03] = -1e30
    views = torch.from_numpy(v)
    if stride0:
        views = views.expand(e, m, w, d)
    s = torch.from_numpy(rng.normal(size=(e, m, d)).astype(np.float32))
    return views, s, rng


@pytest.mark.parametrize("per_mask,stride0", [(False, False), (True, False), (False, True)])
def test_views_plain_screens_over_cells_equal_per_experiment(per_mask, stride0):
    """The views wrappers' plain versions over ``[E, M, W, d]`` (one mask or
    one a cell, a receiver stride of 0) with a per-cell b equal E calls of
    the one-cell form."""
    e, m, w, d = 4, 12, 9, 33
    views, s, rng = views_cells(e, m, w, d, seed=3, stride0=stride0)
    mask = torch.from_numpy(rng.random((e, m, w) if per_mask else (m, w)) < 0.7)
    b = torch.tensor([0, 1, 2, 4], dtype=torch.int32)
    at = lambda i: mask[i] if per_mask else mask  # noqa: E731
    got = views_screen.views_screen_trimmed_mean(views, mask, s, b)
    want = torch.stack([ref.trimmed_mean_views(views[i], at(i), s[i], int(b[i]))
                        for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    got = views_screen.views_screen_median(views, mask, s)
    want = torch.stack([views_screen.views_screen_median(views[i], at(i), s[i])
                        for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="must be"):
        views_screen.views_screen_median(views, mask[..., :-1], s)


def test_runtime_step_refuses_codecs_over_cells_and_flattens_views_in_place(targets):
    """A lossy codec over more than one cell, refused before, runs and
    needs the carry (a state without it raises); the distance kernel's
    E M elements are the views themselves, no copy."""
    from repro_torch.core import screening
    from repro_torch.core.bridge import build_cell_runtime_step
    from repro_torch.core.byzantine import get_message_attack

    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("random",), (2,), (0, 1),
                          scenarios=("lossy",), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, num_ticks=T, device="cpu")
    step = build_cell_runtime_step(qgrad, engine.runtime, ("trimmed_mean",),
                                   (get_message_attack("random"),), codecs=("int8",))
    with pytest.raises(ValueError, match="CommState"):
        step(engine._group_cells[0], engine.init(init_fn), targets)
    views = torch.zeros(3, M, 4, D)
    assert screening._node_views(views).data_ptr() == views.data_ptr()
    one = torch.zeros(1, 4, D)[:, None].expand(1, M, 4, D)  # a receiver stride of 0
    assert screening._node_views(one).stride(0) == 0
    with pytest.raises(ValueError, match="in place"):
        screening._node_views(torch.zeros(3, 1, 4, D).expand(3, M, 4, D))


def test_sweep_grid_mode_runs_net_scenarios(tmp_path, capsys):
    from repro_torch.launch import sweep
    from repro_torch.sim import existing_tags

    out = str(tmp_path / "store")
    args = ["--mode", "grid", "--out", out, "--device", "cpu", "--grid-nodes", "10",
            "--grid-ticks", "3", "--grid-train", "400", "--grid-test", "100",
            "--attacks", "alie", "--rules", "trimmed_mean", "--scenarios", "ideal,lossy_laggy"]
    res = sweep.main(args)
    assert [r["scenario"] for r in res.cells] == ["ideal", "lossy_laggy"]
    assert all(0.0 <= r["accuracy"] <= 1.0 and "mean_delivered_frac" in r for r in res.cells)
    assert existing_tags(out) == {"trimmed_mean_alie_b1_s0_ideal",
                                  "trimmed_mean_alie_b1_s0_lossy_laggy"}
    assert sweep.main(args) is None
    assert "2 cached" in capsys.readouterr().out


@pytest.mark.parametrize("sparse", [False, True])
def test_message_attack_banks_over_cells_equal_each_cells_call(sparse):
    """`apply_message_attack_bank` (and its sparse and self-view twins) over
    E cells with an attack, a Byzantine mask, a live mask and a key a cell
    equal each cell's one-cell call bit for bit; ``selective_victim``'s
    victims follow each cell's own live edges (churn)."""
    from repro_torch.core import byzantine
    from repro_torch.core.neighbors import NeighborTable
    from repro_torch.net.dynamic import scenario_schedule

    e = 4
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(e, M, D)).astype(np.float32))
    byz = torch.from_numpy(np.stack([rng.permutation(M) < 2 for _ in range(e)]))
    sched = scenario_schedule("churn", topo(), e, seed=0)  # a tick's live edges a cell
    adj = torch.from_numpy(sched)
    keys = np.stack([prng.PRNGKey(7 + i) for i in range(e)])
    bank = tuple(byzantine.get_message_attack(a) for a in ("random", "selective_victim", "alie"))
    idx = (0, 1, 1, 2)
    nbr = NeighborTable.from_schedule(sched, device="cpu") if sparse else None
    live = torch.stack([torch.from_numpy(nbr.live_schedule(sched[i:i + 1])[0])
                        for i in range(e)]) if sparse else adj
    if sparse:
        msgs = byzantine.apply_sparse_message_attack_bank(bank, idx, w, byz, nbr, live, keys, 3)
    else:
        msgs = byzantine.apply_message_attack_bank(bank, idx, w, byz, adj, keys, 3)
    selves = byzantine.apply_self_view_bank(bank, idx, w, byz, keys, 3)
    pair = byzantine.messages_and_self_bank(bank, idx, w, byz, live, keys, 3, nbr)
    for i in range(e):
        a = bank[idx[i]]
        one = (byzantine.apply_sparse_message_attack(a, w[i], byz[i], nbr, live[i], keys[i], 3)
               if sparse else byzantine.apply_message_attack(a, w[i], byz[i], adj[i], keys[i], 3))
        assert torch.equal(msgs[i], one)
        assert torch.equal(selves[i], byzantine.apply_self_view(a, w[i], byz[i], keys[i], 3))
        assert torch.equal(pair[0][i], one) and torch.equal(pair[1][i], selves[i])
    # churn gives the selective_victim cells different in-degrees, so different victims
    assert not torch.equal(adj[1].sum(dim=1), adj[2].sum(dim=1))
