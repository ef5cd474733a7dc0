"""Breakdown certification, the red-team search and the task's stacked
batches of the port (`repro_torch.adversary.breakdown`,
`repro_torch.adversary.search`, `repro_torch.sim.tasks`,
`repro_torch.data.partition.device_node_batches`, ``sweep --mode
breakdown``), on the CPU against the reference (`repro.adversary`,
`repro.sim.tasks`).

Tolerances, and why:

* batches: bit for bit (a gather copies values; the index draw is the
  reference's);
* certification on the reference's quadratic task (M = 10, D = 4, T = 12):
  b*, the flags, ``first_bad_tick`` and the ledger's keys exactly; final
  losses and scores within rtol 1e-5 (the ``random`` adversary's normal
  draws are within a relative 5.8e-6 of ``jax.random.normal``,
  ``tests/test_torch_prng.py``);
* the search's ledger: thetas exactly (the same numpy generator), fitness
  within rtol 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary.breakdown import BreakdownConfig as JConfig
from repro.adversary.breakdown import BreakdownEngine as JEngine
from repro.adversary.breakdown import feasible_b as jfeasible_b
from repro.adversary.search import SearchConfig as JSearchConfig
from repro.adversary.search import red_team_search as jred_team_search
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.data import partition as jpartition
from repro.obs import EventLog as JEventLog
from repro.sim.engine import stack_batches as jstack_batches
from repro.sim.tasks import linear_task as jlinear_task
from repro_torch import prng
from repro_torch.adversary.breakdown import (BreakdownConfig, BreakdownEngine, breakdown_curve,
                                             feasible_b)
from repro_torch.adversary.search import SearchConfig, red_team_search
from repro_torch.core import erdos_renyi, replicate
from repro_torch.data import partition
from repro_torch.launch import sweep
from repro_torch.obs import EventLog, TraceSpec, read_events
from repro_torch.sim import default_topology
from repro_torch.sim.tasks import dataset, linear_task

M, D, T = 10, 4, 12
RTOL = 1e-5


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


def jqgrad(params, batch):
    w, c = params["w"], batch
    return 0.5 * jnp.sum((w - c) ** 2), {"w": w - c}


def unstable(params, batch):
    # an effective step size ~1e3 >> 2: the iteration overflows float32
    w = params["w"]
    return 0.5e4 * torch.sum((w - batch) ** 2, dim=-1), {"w": 1e4 * (w - batch)}


def junstable(params, batch):
    w, c = params["w"], batch
    return 0.5e4 * jnp.sum((w - c) ** 2), {"w": 1e4 * (w - c)}


def init_fn(seed):
    return replicate({"w": torch.zeros(D)}, M, perturb=0.1, key=prng.PRNGKey(seed))


def jinit_fn(seed):
    return jreplicate({"w": jnp.zeros(D)}, M, perturb=0.1, key=jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def targets():
    return (3.0 * np.random.default_rng(0).normal(size=(M, D))).astype(np.float32)


@pytest.fixture(scope="module")
def batches(targets):
    return torch.from_numpy(targets)[None].expand(T, M, D).contiguous()


@pytest.fixture(scope="module")
def jbatches(targets):
    return jstack_batches(lambda i: jnp.asarray(targets), T)


def topo():
    return erdos_renyi(M, 0.8, 2, seed=1)


def eval_fn(targets):
    """Higher is better: minus the honest nodes' mean distance to the
    targets' mean (the port's params)."""
    centre = targets.mean(axis=0)
    return lambda params, honest: -float(np.mean(np.linalg.norm(
        params["w"].numpy()[np.asarray(honest)] - centre, axis=-1)))


def jeval_fn(targets):
    centre = targets.mean(axis=0)
    return lambda params, honest: -float(np.mean(np.linalg.norm(
        np.asarray(params["w"])[np.asarray(honest)] - centre, axis=-1)))


def close(a, b):
    if a is None or b is None:
        assert a is b
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


def assert_same_result(jres: dict, res: dict) -> None:
    """b*, flags and first bad ticks equal, losses and scores close."""
    for k in ("mode", "seeds", "loss_ratio", "adversaries", "scenario", "trust", "cells_run"):
        assert res["meta"][k] == jres["meta"][k], k
    assert res["rules"].keys() == jres["rules"].keys()
    for rule, jr in jres["rules"].items():
        r = res["rules"][rule]
        assert (r["feasible_b"], r["bstar_worst_adversary"]) == (
            jr["feasible_b"], jr["bstar_worst_adversary"])
        probes = [(r["ref"], jr["ref"])]
        assert r["adversaries"].keys() == jr["adversaries"].keys()
        for adv, ja in jr["adversaries"].items():
            a = r["adversaries"][adv]
            assert (a["bstar"], a["certified_monotone"]) == (ja["bstar"], ja["certified_monotone"])
            assert a["probes"].keys() == ja["probes"].keys()
            probes += [(a["probes"][b], ja["probes"][b]) for b in ja["probes"]]
        for p, jp in probes:
            assert p.keys() == jp.keys()
            for k in ("finite", "survived", "first_bad_tick"):
                assert p.get(k) == jp.get(k), (rule, k)
            for k in ("final_loss", "max_final_loss", "score"):
                if k in jp:
                    close(p[k], jp[k])


# ---------------------------------------------------------------------------
# the batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["iid", "extreme"])
def test_device_batches_equal_stack_node_batches(part):
    """Tick by tick, stacked over 3 ticks and replayed: each batch bit for
    bit `stack_node_batches`' (the reference's loop of draws)."""
    x, y, _, _ = dataset(600, 50, 3)
    split = {"iid": partition.partition_iid, "extreme": partition.partition_extreme_noniid}[part]
    shards = split(x, y, 10, seed=3)
    host = partition.stack_node_batches(shards, 5, seed=3)
    drawer = partition.device_node_batches(shards, 5, seed=3, device="cpu")
    replay = drawer.replay()
    stacked = drawer.stacked(3)
    for t in range(3):
        hx, hy = host(t)
        for bx, by in ((stacked[0][t], stacked[1][t]), replay(t)):
            assert bx.dtype == torch.from_numpy(hx).dtype and by.dtype == torch.from_numpy(hy).dtype
            np.testing.assert_array_equal(bx.numpy(), hx)
            np.testing.assert_array_equal(by.numpy(), hy)
    hx, hy = host(3)  # the drawer's generator moved as the host's did
    bx, by = drawer(3)
    np.testing.assert_array_equal(bx.numpy(), hx)
    np.testing.assert_array_equal(by.numpy(), hy)


@pytest.mark.parametrize("part", ["extreme", "iid"])
def test_linear_task_batches_equal_the_reference(part):
    """``linear_task(M, T).batches`` is the reference's ``task.batches``,
    ``batch_fn`` replays it, and ``ticks=0`` gives None."""
    kw = dict(partition=part, batch=8, num_train=500, num_test=40, seed=0)
    jtask = jlinear_task(10, 3, **kw)
    task = linear_task(10, 3, device="cpu", **kw)
    for mine, ref in zip(task.batches, jtask.batches, strict=True):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    for t in range(3):
        for mine, ref in zip(task.batch_fn(t), jtask.batch_fn(t), strict=True):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert linear_task(10, partition=part, num_train=500, num_test=40, device="cpu").batches is None
    np.testing.assert_array_equal(task.x_test.numpy(), np.asarray(jtask.x_test))


# ---------------------------------------------------------------------------
# certification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum", "bulyan"])
def test_feasible_b_is_the_reference(rule):
    t = default_topology(12, ("trimmed_mean", "median", "krum", "bulyan"), (2,), seed=0)
    from repro.sim.grid import default_topology as jdefault_topology
    jt = jdefault_topology(12, ("trimmed_mean", "median", "krum", "bulyan"), (2,), seed=0)
    for cap in (None, 1, 3):
        assert feasible_b(rule, t, cap) == jfeasible_b(rule, jt, cap)
    assert feasible_b(rule, topo()) == jfeasible_b(rule, jerdos_renyi(M, 0.8, 2, seed=1))


@pytest.fixture(scope="module")
def ladder(targets, batches, jbatches):
    """The reference's quadratic breakdown task (tests/test_adversary.py):
    BRIDGE-T x random, ipm, b_max 2, scored, with its events."""
    cfg = dict(mode="ladder", seeds=(0,), b_max=2, score_drop=0.5)
    jres = JEngine(jerdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean",), ("random", "ipm"),
                   jqgrad, jinit_fn, jbatches, lam=1.0, t0=10.0, config=JConfig(**cfg),
                   eval_fn=jeval_fn(targets)).run()
    eng = BreakdownEngine(topo(), ("trimmed_mean",), ("random", "ipm"), qgrad, init_fn,
                          batches, lam=1.0, t0=10.0, config=BreakdownConfig(**cfg),
                          eval_fn=eval_fn(targets), device="cpu")
    return jres, eng, eng.run()


def test_breakdown_ladder_matches_the_reference(ladder):
    jres, eng, res = ladder
    assert_same_result(jres, res)
    # one round for the references, one for the ladder (two groups)
    assert res["meta"]["compiles"] == sum(e.num_steps_built for e in eng.round_engines) == 3
    assert [len(e.cells) for e in eng.round_engines] == [1, 4]
    rows = breakdown_curve(res)
    assert [r[:3] for r in rows] == [("trimmed_mean", a, b) for a in ("random", "ipm")
                                     for b in (1, 2)]
    assert rows[0][3] == res["rules"]["trimmed_mean"]["adversaries"]["random"]["probes"]["1"][
        "final_loss"]


def test_breakdown_bisect_equals_the_ladder(targets, batches, ladder):
    """Bisect probes fewer cells and certifies the same b*."""
    _, _, want = ladder
    eng = BreakdownEngine(topo(), ("trimmed_mean",), ("random", "ipm"), qgrad, init_fn, batches,
                          lam=1.0, t0=10.0,
                          config=BreakdownConfig(mode="bisect", b_max=2, score_drop=0.5),
                          eval_fn=eval_fn(targets), device="cpu")
    got = eng.run()
    assert got["meta"]["mode"] == "bisect"
    for adv, arec in want["rules"]["trimmed_mean"]["adversaries"].items():
        mine = got["rules"]["trimmed_mean"]["adversaries"][adv]
        assert (mine["bstar"], mine["certified_monotone"]) == (arec["bstar"], True)
        for b, probe in mine["probes"].items():
            assert probe == arec["probes"][b]


def test_breakdown_measure_compile_runs_each_round_twice(batches):
    eng = BreakdownEngine(topo(), ("median",), ("alie",), qgrad, init_fn, batches, lam=1.0,
                          t0=10.0, config=BreakdownConfig(b_max=1, measure_compile=True),
                          trace=None, device="cpu")
    res = eng.run()
    assert res["meta"]["compile_s"] >= 0.0 and res["meta"]["steady_state_s"] > 0.0
    assert all(e.step_calls == 2 * T * e.num_steps_built for e in eng.round_engines)
    assert "first_bad_tick" not in res["rules"]["median"]["ref"]  # trace=None: no sentinel


def test_breakdown_sentinel_dates_the_unstable_quadratic(batches, jbatches, tmp_path):
    """Every probe of the unstable quadratic diverges, dated at the
    reference's first bad tick, and the events file holds the divergences
    and the rounds, as the reference's does."""
    cfg = dict(mode="ladder", seeds=(0,), b_max=2)
    jpath, path = str(tmp_path / "jax.jsonl"), str(tmp_path / "events.jsonl")
    with JEventLog(jpath) as jev:
        jeng = JEngine(jerdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean",), ("random",),
                       junstable, jinit_fn, jbatches, lam=1.0, t0=10.0, config=JConfig(**cfg),
                       events=jev)
        jeng.run()
    with EventLog(path) as ev:
        eng = BreakdownEngine(topo(), ("trimmed_mean",), ("random",), unstable, init_fn,
                              batches, lam=1.0, t0=10.0, config=BreakdownConfig(**cfg),
                              events=ev, device="cpu")
        eng.run()
    assert eng.probes.keys() == jeng.probes.keys()
    for key, rec in eng.probes.items():
        assert not rec["finite"] and 0 <= rec["first_bad_tick"] < T
        assert rec["first_bad_tick"] == jeng.probes[key]["first_bad_tick"]
    tags = [e["tag"] for e in read_events(path)]
    jtags = [e["tag"] for e in read_events(jpath)]
    assert sorted(tags) == sorted(jtags) and "obs.divergence" in tags
    div = [(e["rule"], e["adversary"], e["b"], e["first_bad_tick"])
           for e in read_events(path) if e["tag"] == "obs.divergence"]
    jdiv = [(e["rule"], e["adversary"], e["b"], e["first_bad_tick"])
            for e in read_events(jpath) if e["tag"] == "obs.divergence"]
    assert div == jdiv


def test_breakdown_through_a_net_scenario_matches_the_reference(targets, batches, jbatches):
    """``scenario="lossy"``: the probes run on the net grids."""
    cfg = dict(b_max=2, score_drop=0.5)
    jres = JEngine(jerdos_renyi(M, 0.8, 2, seed=1), ("trimmed_mean",), ("alie_online",),
                   jqgrad, jinit_fn, jbatches, lam=1.0, t0=10.0, config=JConfig(**cfg),
                   eval_fn=jeval_fn(targets), scenario="lossy").run()
    eng = BreakdownEngine(topo(), ("trimmed_mean",), ("alie_online",), qgrad, init_fn, batches,
                          lam=1.0, t0=10.0, config=BreakdownConfig(**cfg),
                          eval_fn=eval_fn(targets), scenario="lossy", device="cpu")
    res = eng.run()
    assert_same_result(jres, res)
    assert all(e.net_mode for e in eng.round_engines)


def test_breakdown_refusals_name_their_roadmap_items(targets, batches, jbatches, ladder):
    """The trust layer and a forensic trace, refused before, now run: a
    forensic trace leaves the certificate the sentinel-only run's (the
    ladder fixture's reference), and a trust run matches the reference's."""
    from repro.trust import TrustSpec as JTrustSpec
    from repro_torch.trust import TrustSpec

    jres = ladder[0]
    eng = BreakdownEngine(topo(), ("trimmed_mean",), ("random", "ipm"), qgrad, init_fn, batches,
                          lam=1.0, t0=10.0,
                          config=BreakdownConfig(mode="ladder", seeds=(0,), b_max=2,
                                                 score_drop=0.5),
                          eval_fn=eval_fn(targets), trace=TraceSpec(), device="cpu")
    assert_same_result(jres, eng.run())
    assert all(e._trace_spec.forensics for e in eng.round_engines)
    cfg = dict(mode="ladder", seeds=(0,), b_max=2)
    jt = JEngine(jerdos_renyi(M, 0.8, 2, seed=1), ("rep_trimmed_mean",), ("ipm",), jqgrad,
                 jinit_fn, jbatches, lam=1.0, t0=10.0, config=JConfig(**cfg),
                 trust=JTrustSpec(warmup=2)).run()
    tt = BreakdownEngine(topo(), ("rep_trimmed_mean",), ("ipm",), qgrad, init_fn, batches,
                         lam=1.0, t0=10.0, config=BreakdownConfig(**cfg),
                         trust=TrustSpec(warmup=2), device="cpu").run()
    assert tt["meta"]["trust"] and jt["meta"]["trust"]
    assert_same_result(jt, tt)
    with pytest.raises(ValueError, match="reference"):
        BreakdownEngine(topo(), ("trimmed_mean",), ("none",), qgrad, init_fn, batches,
                        device="cpu")
    with pytest.raises(ValueError, match="unknown breakdown mode"):
        BreakdownEngine(topo(), ("trimmed_mean",), ("ipm",), qgrad, init_fn, batches,
                        config=BreakdownConfig(mode="nope"), device="cpu").run()


# ---------------------------------------------------------------------------
# the red-team search
# ---------------------------------------------------------------------------


def test_search_ledger_matches_the_reference(batches, jbatches):
    """Population 4, 2 generations: the same proposals, fitness within
    rtol 1e-5, one step built for the whole search."""
    cfg = dict(population=4, generations=2)
    jled = jred_team_search(jerdos_renyi(M, 0.8, 2, seed=1), "trimmed_mean", "ipm", 2, jqgrad,
                            jinit_fn, jbatches, lam=1.0, t0=10.0, config=JSearchConfig(**cfg))
    led = red_team_search(topo(), "trimmed_mean", "ipm", 2, qgrad, init_fn, batches, lam=1.0,
                          t0=10.0, config=SearchConfig(**cfg), device="cpu")
    assert led["trace_count"] == jled["trace_count"] == 1
    assert led["step_calls"] == 2 * T  # one group, every tick of both generations
    for k in ("rule", "adversary", "b", "proposals_evaluated"):
        assert led[k] == jled[k]
    np.testing.assert_allclose(led["best_theta"], jled["best_theta"], rtol=RTOL)
    close(led["best_fitness"], jled["best_fitness"])
    close(led["default_fitness"], jled["default_fitness"])
    assert len(led["generations"]) == len(jled["generations"])
    for g, jg in zip(led["generations"], jled["generations"], strict=True):
        assert g["generation"] == jg["generation"]
        assert g["best_theta"] == jg["best_theta"]
        close(g["best_fitness"], jg["best_fitness"])
        close(g["mean_fitness"], jg["mean_fitness"])
    with pytest.raises(ValueError, match="no searchable theta"):
        red_team_search(topo(), "trimmed_mean", "alie", 2, qgrad, init_fn, batches,
                        device="cpu")


def test_search_cli_runs_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "ledger.json")
    from repro_torch.adversary import search

    led = search.main(["--nodes", "10", "--ticks", "3", "--population", "3", "--generations",
                       "2", "--out", out, "--device", "cpu"])
    assert led["trace_count"] == 1 and led["proposals_evaluated"] == 6
    with open(out) as f:
        assert json.load(f)["rule"] == "trimmed_mean"
    assert "gen 1: best=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# sweep --mode breakdown
# ---------------------------------------------------------------------------


def test_sweep_breakdown_mode_writes_its_json_and_events(tmp_path):
    out, trace = str(tmp_path / "bd"), str(tmp_path / "trace")
    res = sweep.main(["--mode", "breakdown", "--out", out, "--trace", trace, "--device", "cpu",
                      "--rules", "trimmed_mean", "--adversaries", "random,ipm",
                      "--breakdown-b-max", "1", "--grid-nodes", "10", "--grid-ticks", "3",
                      "--grid-train", "300", "--grid-test", "50"])
    with open(os.path.join(out, "BENCH_breakdown.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res, sort_keys=True))
    advs = saved["rules"]["trimmed_mean"]["adversaries"]
    assert set(advs) == {"random", "ipm"} and saved["meta"]["cells_run"] == 3
    assert all(0.0 <= p["score"] <= 1.0 for a in advs.values() for p in a["probes"].values())
    tags = [e["tag"] for e in read_events(os.path.join(trace, "events.jsonl"))]
    assert tags.count("breakdown.round") == 2
    # --trust: the trust layer on the complete graph (the echo's quorums)
    res = sweep.main(["--mode", "breakdown", "--out", out, "--device", "cpu", "--trust",
                      "--rules", "rep_trimmed_mean", "--adversaries", "ipm",
                      "--breakdown-b-max", "1", "--grid-nodes", "10", "--grid-ticks", "3",
                      "--grid-train", "300", "--grid-test", "50"])
    assert res["meta"]["trust"] and res["rules"]["rep_trimmed_mean"]["feasible_b"] == 1
    with pytest.raises(ValueError, match="JAX package"):
        sweep.main(["--mode", "dryrun", "--out", out, "--device", "cpu"])


def test_partition_draw_matches_the_reference_copy():
    """The port's partitioners stay the reference's (the device form draws
    from their shards)."""
    x, y, _, _ = dataset(600, 50, 3)
    for name in ("partition_iid", "partition_extreme_noniid", "partition_moderate_noniid"):
        mine = getattr(partition, name)(x, y, 10, seed=2)
        ref = getattr(jpartition, name)(x, y, 10, seed=2)
        for (a, b), (c, d) in zip(mine, ref, strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
