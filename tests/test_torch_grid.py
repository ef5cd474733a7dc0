"""The port's batched experiment grids (`repro_torch.sim`) against the
port's own trainer and against the reference's grid engine, on the CPU.

* every cell of a grid equals its own `BridgeTrainer` run bit for bit
  (params and loss streams), grouped and banked, dense and sparse — the
  reference's anchor (``tests/test_grid.py``), here also for BRIDGE-K /
  BRIDGE-B with per-cell bounds in one group;
* chunked equals unchunked; `set_cells` keeps the engine's steps;
* the result store round-trips and `Cell.tag` is the reference's;
* from a state carried over from the reference's `GridEngine`, the port's
  grid follows it (rtol 1e-5 for T / M; 3 ticks for K / B, whose picks
  turn on the distances' last bits);
* the experiment-axis plain screens equal the per-experiment ones (the
  reference's ``test_grid.py`` batched-kernel check; the kernels against
  them on the card: ``tests/test_torch_kernels.py``, ``cuda``-marked);
* the sweep's grid mode writes the store and resumes from it, and the
  refusals name where their modes belong.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.sim import Cell as JCell
from repro.sim import ExperimentGrid as JGrid
from repro.sim import GridEngine as JEngine
from repro.sim.engine import stack_batches as jstack_batches
from repro_torch import convert, prng
from repro_torch.core import BridgeConfig, BridgeTrainer, complete_graph, erdos_renyi, replicate
from repro_torch.core.neighbors import NeighborTable
from repro_torch.kernels import gather_screen, median, ref, trimmed_mean
from repro_torch.launch import sweep
from repro_torch.obs import TraceSpec
from repro_torch.sim import (Cell, ExperimentGrid, GridEngine, GridResult, cell_of, collect,
                             existing_tags, load_cell_store)

M, D, T = 12, 5, 8


def qgrad(params, batch):
    """The reference test's quadratic loss, per node, over any leading
    axes (``[M, D]`` or ``[E, M, D]`` parameters)."""
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


def sequential(topo, cell, targets, sparse, ticks=T):
    """The cell's own `BridgeTrainer` run."""
    cfg = BridgeConfig(topology=topo, rule=cell.rule, num_byzantine=cell.b, attack=cell.attack,
                       lam=1.0, t0=10.0, byzantine_seed=cell.mask_seed, sparse=sparse)
    tr = BridgeTrainer(cfg, qgrad, device="cpu")
    st = tr.init(init_fn(cell.seed), seed=cell.seed)
    losses = []
    for _ in range(ticks):
        st, m = tr.step(st, targets)
        losses.append(m["loss"])
    return st.params["w"], torch.stack(losses)


GRIDS = {
    # 2 rules x 3 attacks x 2 seeds, as the reference's acceptance grid
    "tm": (lambda: erdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean", "median"),
           ("random", "sign_flip", "alie"), (2,)),
    # the vector rules, per-cell bounds in one group
    "kb": (lambda: complete_graph(M, 2), ("krum", "bulyan"), ("random", "alie"), (1, 2)),
}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_cells_equal_their_trainer_runs(targets, name, group, sparse):
    make, rules, attacks, byz = GRIDS[name]
    topo = make()
    grid = ExperimentGrid(topo, rules, attacks, byz, (0, 1), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, group=group, sparse=sparse, device="cpu")
    final, metrics = engine.run(engine.init(init_fn), torch.stack([targets] * T))
    assert engine.num_steps_built == (len(rules) * len(attacks) if group else 1)
    assert engine.step_calls == engine.num_steps_built * T
    for i, cell in enumerate(engine.cells):
        w_seq, loss_seq = sequential(topo, cell, targets, sparse)
        assert torch.equal(final.params["w"][i], w_seq), f"params diverged for {cell}"
        assert torch.equal(metrics["loss"][i], loss_seq), f"loss diverged for {cell}"
    assert metrics["loss"].shape == (engine.num_cells, T)


def test_chunked_equals_unchunked_and_set_cells_keeps_the_engine(targets):
    topo = erdos_renyi(M, 0.8, 2, seed=1)
    grid = ExperimentGrid(topo, ("trimmed_mean", "krum"), ("random", "alie"), (1, 2),
                          (0, 1, 2), lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, device="cpu")
    batches = torch.stack([targets] * 4)
    whole, mw = engine.run(engine.init(init_fn), batches)
    for chunk in (1, 4, 5):  # ragged tails: groups of 6 cells
        part, mp = engine.run(engine.init(init_fn), batches, chunk=chunk)
        assert torch.equal(part.params["w"], whole.params["w"])
        assert torch.equal(mp["loss"], mw["loss"])
        assert np.array_equal(part.key, whole.key)
    built = engine.num_steps_built
    steps = list(engine._steps)
    moved = [c._replace(seed=c.seed + 5, mask_seed=c.mask_seed + 5) for c in engine.cells]
    engine.set_cells(moved)
    assert engine.num_steps_built == built and engine._steps == steps
    got, _ = engine.run(engine.init(init_fn), batches)
    fresh = GridEngine(grid, qgrad, cells=moved, device="cpu")
    want, _ = fresh.run(fresh.init(init_fn), batches)
    assert torch.equal(got.params["w"], want.params["w"])
    with pytest.raises(ValueError, match="group keys"):
        engine.set_cells(list(reversed(moved)))
    with pytest.raises(ValueError, match="outside"):
        engine.set_cells([c._replace(rule="median") for c in moved])


def test_store_round_trips_and_tags_are_the_reference(tmp_path):
    topo = erdos_renyi(M, 0.8, 2, seed=1)
    grid = ExperimentGrid(topo, ("trimmed_mean", "median"), ("random", "none"), (0, 2), (0, 3))
    jgrid = JGrid(jerdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean", "median"), ("random", "none"),
                  (0, 2), (0, 3))
    cells = grid.cells()
    assert [c.tag for c in cells] == [c.tag for c in jgrid.cells()]
    extra = [Cell("krum", "alie", 1, 2, None, "int8", "none", 7, (0.5, 1.0, 0.0, 0.0))]
    assert extra[0].tag == JCell(*extra[0]).tag
    e = len(cells)
    metrics = {"loss": np.arange(e * 3, dtype=np.float32).reshape(e, 3),
               "consensus_dist": np.ones((e, 3), np.float32)}
    res = collect(cells, metrics, meta={"wall_s": 1.0})
    res.save_cells(str(tmp_path))
    assert existing_tags(str(tmp_path)) == {c.tag for c in cells}
    back = load_cell_store(str(tmp_path))
    assert sorted(cell_of(r) for r in back.cells) == sorted(cells)
    res.save(str(tmp_path / "GridResult.json"))
    again = GridResult.load(str(tmp_path / "GridResult.json"))
    assert again.cells == res.cells and again.meta == res.meta


@pytest.mark.parametrize("rules,b,ticks", [(("trimmed_mean", "median"), 2, 6),
                                           (("krum", "bulyan"), 1, 3)])
def test_grid_follows_the_reference_grid_from_its_state(targets, rules, b, ticks):
    """From the reference grid's state after 2 ticks, the port's grid
    follows it: T / M at rtol 1e-5 (the random attack's normal is within
    5.8e-6 of jax.random's), K / B for 3 ticks, the pick caveat."""
    tgt = jnp.asarray(targets.numpy())
    jtopo = jerdos_renyi(M, 0.8, 2, seed=1)
    jgrid = JGrid(jtopo, rules, ("random", "alie"), (b,), (0, 1), lam=1.0, t0=10.0)
    jengine = JEngine(jgrid, jqgrad)
    jstate, _ = jengine.run(jengine.init(jinit_fn), jstack_batches(lambda i: tgt, 2))
    jfinal, jm = jengine.run(jstate, jstack_batches(lambda i: tgt, ticks))
    grid = ExperimentGrid(erdos_renyi(M, 0.8, 2, seed=1), rules, ("random", "alie"), (b,), (0, 1),
                          lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, device="cpu")
    assert [c.tag for c in engine.cells] == [c.tag for c in jengine.cells]
    assert np.array_equal(engine.byz_masks, jengine.byz_masks)
    state = convert.grid_state_from_jax({"w": np.asarray(jstate.params["w"])},
                                        np.asarray(jstate.t), np.asarray(jstate.key),
                                        device="cpu")
    final, metrics = engine.run(state, torch.stack([targets] * ticks))
    honest = ~engine.byz_masks
    got, want = final.params["w"].numpy(), np.asarray(jfinal.params["w"])
    np.testing.assert_allclose(got[honest], want[honest], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(final.key, np.asarray(jfinal.key))


def experiment_inputs(e, m, d, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(e, m, d)).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = np.nan
    w[rng.random(w.shape) < 0.03] = np.inf
    s = rng.normal(size=(e, m, d)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(s), rng


@pytest.mark.parametrize("per_mask", [False, True])
def test_experiment_axis_plain_screens_equal_per_experiment(per_mask):
    """The plain versions over ``[E, M, d]`` with per-experiment bounds
    (and per-experiment masks: Bulyan's selections) equal E calls of the
    unbatched form, as ``tests/test_grid.py`` holds the TPU kernels."""
    e, m, d = 4, 12, 40
    w, s, rng = experiment_inputs(e, m, d, seed=1)
    adj = rng.random((e, m, m) if per_mask else (m, m)) < 0.6
    adj_t = torch.from_numpy(adj)
    b = torch.tensor([0, 1, 2, 5], dtype=torch.int32)
    at = lambda i: adj_t[i] if per_mask else adj_t
    got = trimmed_mean.trimmed_mean_dense(w, adj_t, s, b)
    want = torch.stack([ref.trimmed_mean_dense(w[i], at(i), s[i], int(b[i])) for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    got = median.median_dense(w, adj_t, s)
    want = torch.stack([ref.median_dense(w[i], at(i), s[i]) for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    tab = NeighborTable.from_adjacency(rng.random((m, m)) < 0.5, device="cpu")
    valid = (torch.from_numpy(rng.random((e, m, tab.k)) < 0.7) & tab.valid_dev) if per_mask \
        else tab.valid_dev
    vt = lambda i: valid[i] if per_mask else valid
    got = gather_screen.gather_screen_trimmed_mean(w, tab.safe_idx, valid, s, b)
    want = torch.stack([ref.gather_trimmed_mean(w[i], tab.safe_idx, vt(i), s[i], int(b[i]))
                        for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    got = gather_screen.gather_screen_median(w, tab.safe_idx, valid, s)
    want = torch.stack([ref.gather_median(w[i], tab.safe_idx, vt(i), s[i]) for i in range(e)])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_banked_dispatch_equals_each_experiments_own_rule():
    """`screen_all_banked`, `screen_gathered_banked` and `screen_views_banked`
    with a rule and a bound an experiment equal each experiment's own
    screen; `min_neighbors_banked` is the reference's per cell."""
    from repro.core import screening as jscreening
    from repro_torch.core import screening

    e, m, d = 5, 12, 16
    w, s, rng = experiment_inputs(e, m, d, seed=7)
    w = torch.nan_to_num(w, nan=0.5, posinf=3.0)
    rules = ("trimmed_mean", "median", "krum", "mean")
    rule_idx = [0, 2, 1, 0, 3]
    b = (1, 2, 0, 2, 1)
    adj_np = rng.random((m, m)) < 0.9
    np.fill_diagonal(adj_np, False)
    adj = torch.from_numpy(adj_np)
    tab = NeighborTable.from_adjacency(adj_np, device="cpu")
    dense = screening.screen_all_banked(w, adj, rules, rule_idx, b, self_vals=s)
    sparse = screening.screen_gathered_banked(w, tab, rules, rule_idx, b, self_vals=s)
    views = ref.gather(w, tab.safe_idx)
    banked_views = screening.screen_views_banked(views, tab.valid_dev, s, rules, rule_idx, b)
    for i in range(e):
        rule = rules[rule_idx[i]]
        assert torch.equal(dense[i], screening.screen_all(w[i], adj, rule=rule, b=b[i],
                                                          self_vals=s[i]))
        assert torch.equal(sparse[i], screening.screen_gathered(w[i], tab, rule=rule, b=b[i],
                                                                self_vals=s[i]))
        assert torch.equal(banked_views[i], screening.screen_views(
            views[i], tab.valid_dev, s[i], rule=rule, b=b[i]))
    want = [int(jscreening.min_neighbors_banked(rules, r, bb)) for r, bb in zip(rule_idx, b)]
    assert screening.min_neighbors_banked(rules, rule_idx, b).tolist() == want


def test_refusals_name_their_roadmap_items(tmp_path):
    """The refusal left names where its mode belongs (the reference's
    dryrun mode: the JAX package; net mode runs since the training CLIs
    are ported); codecs, wire attacks,
    adversaries, a trace (forensics too), the trust layer, the breakdown
    mode, the metric rings and the grid's traced, metered and profiled
    sweep, refused before, now build and run."""
    topo = erdos_renyi(M, 0.8, 2, seed=1)
    grid = ExperimentGrid(topo, ("trimmed_mean",), ("random",), (2,))
    for cell in (Cell("trimmed_mean", "random", 2, 0, "lossy", "int8"),
                 Cell("trimmed_mean", "random", 2, 0, codec="int8"),
                 Cell("trimmed_mean", "scale_abuse", 2, 0),
                 Cell("trimmed_mean", "none", 2, 0, adversary="ipm")):
        GridEngine(grid, qgrad, cells=[cell], num_ticks=3, device="cpu")
    ExperimentGrid(topo, ("trimmed_mean",), ("random",), (2,), adversaries=("ipm",))
    GridEngine(grid, qgrad, trace=TraceSpec(forensics=False), device="cpu")
    # a forensic trace and the trust layer run: each leaves its [E, M, W]
    # state, the forensic trace bit-inert against the untraced grid
    from repro_torch.trust import TrustSpec

    batches = torch.zeros((2, M, D))
    runs = [GridEngine(grid, qgrad, device="cpu", **kw) for kw in
            (dict(), dict(trace=TraceSpec()), dict(trust=TrustSpec()))]
    finals = [eng.run(eng.init(init_fn), batches)[0] for eng in runs]
    assert torch.equal(finals[0].params["w"], finals[1].params["w"])
    assert finals[1].obs.edge_seen.shape == finals[2].trust.suspicion.shape == (1, M, M)
    from repro_torch.obs import MetricSpec

    metered = GridEngine(grid, qgrad, device="cpu", metrics=MetricSpec(capacity=2))
    assert metered.run(metered.init(init_fn), batches)[0].mets.count.tolist() == [2]
    with pytest.raises(ValueError, match="belongs to the JAX package"):
        sweep.main(["--out", str(tmp_path), "--device", "cpu", "--mode", "dryrun"])
    obs_dir = str(tmp_path / "obs")
    sweep.main(["--out", str(tmp_path / "m"), "--device", "cpu", "--rules", "trimmed_mean",
                "--attacks", "alie", "--grid-nodes", "10", "--grid-ticks", "2", "--grid-train",
                "300", "--grid-test", "50", "--trace", obs_dir, "--metrics", obs_dir])
    assert {"metrics.jsonl", "obs_summary.json", "manifest.json",
            "events.jsonl"} <= set(os.listdir(obs_dir))
    # --trust runs the grid with the trust layer, its evicted share reduced
    out = str(tmp_path / "trust")
    sweep.main(["--out", out, "--device", "cpu", "--trust", "--rules", "trimmed_mean",
                "--attacks", "alie", "--grid-nodes", "10", "--grid-ticks", "2",
                "--grid-train", "300", "--grid-test", "50"])
    assert "mean_trust_evicted_frac" in load_cell_store(out).cells[0]


def test_sweep_grid_mode_writes_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "store")
    args = ["--mode", "grid", "--out", out, "--device", "cpu", "--grid-nodes", "10",
            "--grid-ticks", "3", "--grid-train", "400", "--grid-test", "100", "--seeds", "0,1",
            "--attacks", "random"]
    res = sweep.main(args)
    assert len(res.cells) == 4 and all(0.0 <= r["accuracy"] <= 1.0 for r in res.cells)
    assert existing_tags(out) == {c.tag for c in ExperimentGrid(
        erdos_renyi(10, 0.9, 1, seed=0), ("trimmed_mean", "median"), ("random",), (1,),
        (0, 1)).cells()}
    full = GridResult.load(f"{out}/GridResult.json")
    assert full.meta["computed_this_run"] == 4 and len(full.cells) == 4
    assert sweep.main(args) is None
    assert "4 cached" in capsys.readouterr().out
