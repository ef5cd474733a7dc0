"""The port's contract gate (`repro_torch.analysis`) on the CPU, against the
reference's (`repro.analysis`): every pass PASSes on the current tree and
FAILs on a planted defect.

* the registry: the same 16 ``(name, kind)`` contracts, duplicate names and
  unknown kinds refused; `summarize` renders the same text for the same
  results;
* lint: each of the seven checks PASSes on the port's tree and FAILs on the
  reference tests' planted defects mirrored on the port's registries
  (overlap, unassigned, naked key, stale waiver, unknown check SKIPs), and
  on a twin-less dispatcher, a colliding salt, an incomplete side table, a
  multi-homed attack name and a spec holding a tensor;
* prng: the reference tests' six fixtures on the port's `prng`, with the
  counts those tests expect (one flag each for the cross-distribution and
  the in-loop reuse, which the reference's jaxpr pass misses under
  ``jax 0.9.0``); the reference's own count where its pass gives it;
* the canonical programs: each port program from the reference program's
  initial parameters (and batch), 3 ticks, against the reference program's
  3 ticks: bit for bit where no draw is a normal (sparse, net, stream: sign
  flip; the channel's and the codec's uniforms are the reference's bits),
  and where ``random`` draws normals (flat, metrics) the free-run tolerance
  of ``tests/test_torch_bridge.py``, rtol 1e-4, atol 1e-5 on honest rows
  (the port's normal is within a relative 5.8e-6 of XLA's);
* memory: the sparse and stream budgets hold, the sparse program's dense
  twin busts its budget (its plain twin sorts ``[M, M+1, d]`` rows; a CPU
  test only: on the card the dense kernel reads ``w`` in place), a planted
  list of states keeps the first tick's carry alive;
* retrace: `guard`, ``set_cells`` building nothing, a ragged chunking
  building nothing (where the reference retraces), a cache that misses on
  every tick failing the re-run;
* fence: the floor and the apply's bits, the metrics delta of exactly one,
  a planted ``torch.addcmul`` apply failing both, an apply rounded once
  failing the bit check alone;
* the CLI: ``--device cpu`` exits 0 with ``0 failed, 0 skipped``, a planted
  defect exits 1, and without ``--device`` it refuses a machine with no
  card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as JC
from repro.analysis import prng as jprng_pass
from repro.analysis import programs as jprograms
from repro_torch import fence as fence_lib
from repro_torch import prng
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import contracts as C
from repro_torch.analysis import driver, fence, lint, memory, programs, retrace
from repro_torch.analysis import prng as prng_pass
from repro_torch.core import bridge, screening


def _contract(kind, **params):
    return C.Contract(f"test.{kind}.contract", kind, "test fixture",
                      params=tuple(params.items()))


def _governing(name):
    return next(c for c in C.collect() if c.name == name)


# ---------------------------------------------------------------------------
# the registry and the verdict table
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    port = {(c.name, c.kind) for c in C.collect()}
    ref = {(c.name, c.kind) for c in JC.collect()}
    assert port == ref and len(port) == 16
    assert C.KINDS == JC.KINDS


def test_duplicate_contract_name_rejected():
    with pytest.raises(ValueError, match="exactly one home"):
        C.collect(("repro_torch.core.screening", "repro_torch.core.screening"))


def test_contract_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown kind"):
        C.Contract("x.y", "vibes", "not a pass")


@pytest.mark.parametrize("rows", [
    [("b.two", "lint", "FAIL", "boom", ""), ("a.one", "prng", "PASS", "", "flat"),
     ("c.three", "fence", "SKIP", "", "")],
    [("z.z", "retrace", "PASS", "ok", "grid"), ("z.a", "memory", "FAIL", "big", "sparse"),
     ("z.a", "memory", "PASS", "", "stream"), ("q.q", "lint", "PASS", "", "")],
])
def test_summarize_matches_reference(rows):
    port = C.summarize([C.CheckResult(*r) for r in rows])
    assert port == JC.summarize([JC.CheckResult(*r) for r in rows])
    assert port.splitlines()[-1].endswith("skipped")


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

LINT_CONTRACTS = ("screening.stream.partition", "screening.registries.complete",
                  "adversary.tiers.partition", "grid.specs.zero_leaf", "bridge.salts.distinct",
                  "kernels.dispatch.ref_twin", "launch.prng.seed_plumbing")


@pytest.mark.parametrize("name", LINT_CONTRACTS)
def test_lint_check_passes_on_tree(name):
    (res,) = lint.run_lint([_governing(name)], driver.SRC_ROOT)
    assert res.status == "PASS", res.detail


def test_stream_partition_overlap_fails(monkeypatch):
    monkeypatch.setattr(screening, "STREAMABLE_RULES", screening.STREAMABLE_RULES | {"krum"})
    res = lint.check_stream_partition(_contract("lint", check="stream_partition"))
    assert res.status == "FAIL" and "krum" in res.detail


def test_stream_partition_unassigned_fails(monkeypatch):
    monkeypatch.setattr(screening, "STREAM_REJECTED_RULES",
                        screening.STREAM_REJECTED_RULES - {"bulyan"})
    res = lint.check_stream_partition(_contract("lint", check="stream_partition"))
    assert res.status == "FAIL" and "bulyan" in res.detail


def test_registry_completeness_missing_rule_fails(monkeypatch):
    table = dict(screening.RULES_WITH_DECISIONS)
    del table["geomedian"]
    monkeypatch.setattr(screening, "RULES_WITH_DECISIONS", table)
    res = lint.check_registry_completeness(_contract("lint", check="registry_completeness"))
    assert res.status == "FAIL" and "geomedian" in res.detail


def test_adversary_tiers_multi_homed_fails(monkeypatch):
    from repro_torch.adversary import protocols

    tiers = protocols.registry_tiers()
    tiers["wire"] = tiers["wire"] | {"random"}
    monkeypatch.setattr(protocols, "registry_tiers", lambda: tiers)
    res = lint.check_adversary_tiers(_contract("lint", check="adversary_tiers"))
    assert res.status == "FAIL" and "random" in res.detail


@dataclasses.dataclass(frozen=True)
class _TensorSpec:
    scale: torch.Tensor = dataclasses.field(default_factory=lambda: torch.ones(2))


@dataclasses.dataclass
class _LooseSpec:
    capacity: int = 4


@pytest.mark.parametrize("cls,why", [("_TensorSpec", "tensors"), ("_LooseSpec", "frozen")])
def test_zero_leaf_spec_with_array_fails(cls, why):
    res = lint.check_zero_leaf_specs(
        _contract("lint", check="zero_leaf_specs", classes=(f"{__name__}:{cls}",)))
    assert res.status == "FAIL" and why in res.detail


def test_colliding_salt_fails(monkeypatch):
    monkeypatch.setattr(bridge, "COMM_SALT", bridge.NET_SALT)
    res = lint.check_salts_distinct(_governing("bridge.salts.distinct"))
    assert res.status == "FAIL" and "COMM_SALT" in res.detail


def test_twinless_dispatcher_fails(tmp_path, monkeypatch):
    (tmp_path / "twinless_ops.py").write_text(
        "from repro_torch.kernels.median import median_dense\n"
        "from repro_torch.kernels import ref\n\n\n"
        "def median(w, adj, self_vals):\n    return median_dense(w, adj, self_vals)\n\n\n"
        "def plain_only(w, adj, self_vals):\n    return ref.median_dense(w, adj, self_vals)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    res = lint.check_kernel_ref_twins(
        _contract("lint", check="kernel_ref_twins", module="twinless_ops"))
    assert res.status == "FAIL" and "plain_only" in res.detail and "'median'" not in res.detail


def test_seed_plumbing_flags_naked_key(tmp_path):
    pkg = tmp_path / "repro_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "from repro_torch import prng\n\n\ndef init():\n    return prng.PRNGKey(42)\n")
    res = lint.check_seed_plumbing(_contract("lint", check="seed_plumbing"), tmp_path)
    assert res.status == "FAIL"
    assert "bad.py" in res.detail and "init" in res.detail


def test_seed_plumbing_stale_waiver_fails(tmp_path):
    (tmp_path / "repro_torch").mkdir()
    res = lint.check_seed_plumbing(
        _contract("lint", check="seed_plumbing",
                  waivers=(("repro_torch/gone.py", "nobody"),)), tmp_path)
    assert res.status == "FAIL" and "stale" in res.detail


def test_unknown_lint_check_skips():
    out = lint.run_lint([_contract("lint", check="no_such_check")], ".")
    assert out[0].status == "SKIP"


# ---------------------------------------------------------------------------
# prng: the reference tests' fixtures on the port's draws
# ---------------------------------------------------------------------------


def _port_clean_split(key):
    k1, k2 = prng.split(key)
    return prng.normal(k1, (3,), "cpu") + prng.normal(k2, (3,), "cpu")


def _port_reused(key):
    return torch.sum(prng.normal(key, (3,), "cpu")) + torch.sum(prng.normal(key, (5,), "cpu"))


def _port_cross(key):
    return prng.normal(key, (), "cpu") + prng.uniform(key, (), "cpu")


def _port_shared_coin(key):
    return prng.normal(key, (3,), "cpu") + prng.normal(key, (3,), "cpu")


def _port_branches(key, p):
    if p > 0:
        return prng.normal(key, (3,), "cpu")
    return prng.normal(key, (3,), "cpu") * 2.0


def _port_in_loop(key):
    c = 0.0
    for _ in range(3):
        c = c + prng.normal(key, (), "cpu") * prng.uniform(key, (), "cpu")
    return c


def _jax_clean_split(key):
    k1, k2 = jax.random.split(key)
    return jax.random.normal(k1, (3,)) + jax.random.normal(k2, (3,))


def _jax_reused(key):
    return jnp.sum(jax.random.normal(key, (3,))) + jnp.sum(jax.random.normal(key, (5,)))


def _jax_shared_coin(key):
    return jax.random.normal(key, (3,)) + jax.random.normal(key, (3,))


def _jax_branches(key, p):
    return jax.lax.cond(p > 0, lambda k: jax.random.normal(k, (3,)),
                        lambda k: jax.random.normal(k, (3,)) * 2.0, key)


@pytest.mark.parametrize("port_fn,args,flags,jax_case", [
    (_port_clean_split, (), 0, (_jax_clean_split, ())),
    (_port_reused, (), 1, (_jax_reused, ())),
    (_port_cross, (), 1, None),
    (_port_shared_coin, (), 0, (_jax_shared_coin, ())),
    (_port_branches, (0.5,), 0, (_jax_branches, (jnp.float32(0.5),))),
    (_port_in_loop, (), 1, None),
], ids=["clean_split", "reused", "cross_distribution", "shared_coin", "branches", "in_loop"])
def test_prng_fixture_counts(port_fn, args, flags, jax_case):
    reuse = prng_pass.check(port_fn, prng.PRNGKey(0), *args)
    assert len(reuse) == flags
    if flags:
        assert reuse[0].uses == 2
    if jax_case is not None:
        jfn, jargs = jax_case
        assert len(jprng_pass.check(jfn, jax.random.PRNGKey(0), *jargs)) == flags


def test_prng_row_keys_are_keys():
    """A row-key batch's rows are keys: one row reused by an unbatched draw
    of another frame is flagged; each row drawn once is clean."""
    rows = prng.split(prng.PRNGKey(3), 4)

    def clean():
        prng.uniform(rows, (4, 5), "cpu")
        prng.normal(prng.fold_in(prng.PRNGKey(3), 9), (5,), "cpu")

    def reused():
        prng.uniform(torch.as_tensor(rows.astype(np.int64)), (4, 5), "cpu")
        prng.normal(rows[2], (5,), "cpu")

    assert prng_pass.check(clean) == []
    (flag,) = prng_pass.check(reused)
    assert flag.uses == 2


def test_recorder_off_costs_nothing():
    x = torch.arange(6, dtype=torch.float32)
    assert fence_lib.fence(x, "test") is x
    assert prng.RECORDER is None and fence_lib.RECORDER is None
    key = prng.PRNGKey(11)
    with prng_pass.recording():
        on = prng.normal(key, (4, 7), "cpu")
    assert torch.equal(on, prng.normal(key, (4, 7), "cpu"))


# ---------------------------------------------------------------------------
# the canonical programs against the reference's
# ---------------------------------------------------------------------------

TICKS = 3


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("name", programs.PROGRAM_NAMES)
def test_program_matches_reference(name):
    jprog = jprograms.BUILDERS[name]()
    prog = programs.BUILDERS[name]("cpu")
    jstate, jbatch = jprog.state, jprog.batch
    state = prog.state._replace(params={k: torch.from_numpy(np.array(v))
                                        for k, v in _np_tree(jstate.params).items()})
    batch = (torch.from_numpy(np.array(jbatch)) if not isinstance(jbatch, dict)
             else {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    np.testing.assert_array_equal(prog.trainer.byz_mask.numpy(), np.asarray(jprog.trainer.byz_mask))
    for _ in range(TICKS):
        jstate, _ = jprog.trainer.step(jstate, jbatch)
        state, _ = prog.trainer.step(state, batch)
    np.testing.assert_array_equal(np.asarray(state.key), np.asarray(jstate.key))
    honest = ~prog.trainer.byz_mask.numpy()
    for k, want in _np_tree(jstate.params).items():
        got = state.params[k].numpy()
        if name in ("flat", "metrics"):
            np.testing.assert_allclose(got[honest], want[honest], rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


def test_sparse_and_stream_budgets_hold():
    for name, budget in (("sparse", "dense_mmd"), ("stream", "flat_md")):
        prog = programs.BUILDERS[name]("cpu")
        ceiling, label = prog.budgets[budget]
        res = memory.check_budget(_contract("memory", budget=budget), name, prog.memory_record,
                                  ceiling, label)
        assert res.status == "PASS", res.detail


def test_dense_twin_busts_sparse_budget():
    # the canonical sparse graph and model on the DENSE layout: the plain
    # twin sorts each node's [M + 1, d] rows, [M, M+1, d] in all
    prog = programs.build_sparse("cpu")
    cfg = dataclasses.replace(prog.trainer.config, sparse=False)
    trainer = bridge.BridgeTrainer(cfg, programs.quad_grad_fn, device="cpu")
    state = trainer.init(prog.state.params)
    _, rec = memory.measure(lambda: trainer.step(state, prog.batch), torch.device("cpu"))
    ceiling, label = prog.budgets["dense_mmd"]
    res = memory.check_budget(_contract("memory", budget="dense_mmd"), "dense-twin", rec,
                              ceiling, label)
    assert res.status == "FAIL" and "materialized" in res.detail


def test_carry_check_passes_and_fails_on_kept_states():
    c = _governing("bridge.chunk_carry.donated")
    prog = programs.build_flat("cpu")
    assert driver.carry_result(c, prog).status == "PASS"
    kept, inner = [], prog.trainer.step

    def keeping(state, batch):
        new, metrics = inner(state, batch)
        kept.append(new)
        return new, metrics

    prog.trainer.step = keeping
    res = driver.carry_result(c, prog)
    assert res.status == "FAIL" and "still alive" in res.detail
    assert prog.trainer.step is keeping


# ---------------------------------------------------------------------------
# retrace
# ---------------------------------------------------------------------------


def test_guard_raises_on_growth():
    class Engine:
        trace_count = 0

    eng = Engine()
    with pytest.raises(retrace.RetraceError, match="went cold"):
        with retrace.guard(eng, "trace_count", budget=0):
            eng.trace_count += 1


def test_guard_allows_within_budget():
    class Engine:
        trace_count = 0

    eng = Engine()
    with retrace.guard(eng, "trace_count", budget=2):
        eng.trace_count += 2
    count = [0]
    with pytest.raises(retrace.RetraceError):
        with retrace.guard(lambda: count[0], None, budget=1):
            count[0] += 2


def test_set_cells_builds_nothing():
    engine, state_fn, batches = programs.build_grid("cpu")
    res = retrace.check_grid_set_cells(_governing("grid.set_cells.zero_retrace"), engine,
                                       state_fn, batches)
    assert res.status == "PASS", res.detail


def test_ragged_chunks_build_nothing():
    # the reference retraces on chunk lengths 4, 4, 2; the port builds
    # nothing per chunk length
    prog = programs.build_flat("cpu")
    res = retrace.check_run_chunks(_contract("retrace", max_traces=1), prog.trainer,
                                   prog.state, prog.batch_fn, num_steps=10, chunk=4)
    assert res.status == "PASS", res.detail


def test_cache_missing_every_tick_fails():
    from repro_torch.kernels import networks

    prog = programs.build_flat("cpu")
    inner, n = prog.trainer.step, [200]

    def cold(state, batch):
        n[0] += 1
        networks.median_pairs(n[0])  # a plan keyed on the tick
        return inner(state, batch)

    prog.trainer.step = cold
    res = retrace.check_run_chunks(_contract("retrace", max_traces=1), prog.trainer,
                                   prog.state, prog.batch_fn, num_steps=4, chunk=4)
    assert res.status == "FAIL" and "median_pairs" in res.detail


# ---------------------------------------------------------------------------
# fence
# ---------------------------------------------------------------------------


def test_fence_floor_and_metrics_delta():
    flat, met = programs.build_flat("cpu"), programs.build_metrics("cpu")
    res = fence.check_fence_floor(_governing("screening.fence.survives"), "flat",
                                  flat.fence_record)
    assert res.status == "PASS" and flat.fence_record.count(fence.APPLY_SITE) == 1
    res = fence.check_metrics_fence_delta(_governing("screening.metrics.gradnorm_unfused"),
                                          flat.fence_record, met.fence_record)
    assert res.status == "PASS"
    assert met.fence_record.count() == flat.fence_record.count() + 1


def test_addcmul_apply_fails(monkeypatch):
    # the apply contracted into one fused op: no fence site, and its bits
    # differ from y - fence(rho * g)
    def fused(y, rho, g):
        return torch.addcmul(y, g, torch.tensor(rho, dtype=torch.float32), value=-1.0)

    monkeypatch.setattr(bridge, "apply_update", fused)
    prog = programs.build_flat("cpu")
    rec = prog.fence_record
    res = fence.check_fence_floor(_governing("screening.fence.survives"), "flat", rec)
    assert res.status == "FAIL" and "was not passed" in res.detail
    assert rec.apply_mismatches > 0 and "differ" in res.detail
    assert bridge.apply_update is fused


def test_single_rounding_apply_fails(monkeypatch):
    # the apply rounded once, as a contracted fused multiply-add would,
    # still passing its named site: only the bit check can catch it
    def once(y, rho, g):
        rho32 = torch.as_tensor(rho, dtype=torch.float32)
        return fence_lib.fence(y.double() - rho32.double() * g.double(), fence.APPLY_SITE)

    monkeypatch.setattr(bridge, "apply_update", once)
    rec = programs.build_flat("cpu").fence_record
    res = fence.check_fence_floor(_governing("screening.fence.survives"), "flat", rec)
    assert rec.count(fence.APPLY_SITE) == 1 and rec.apply_mismatches > 0
    assert res.status == "FAIL" and "was not passed" not in res.detail and "differ" in res.detail


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_green_on_cpu(capsys):
    assert cli.main(["--device", "cpu", "-q"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    npass = int(out[-1].split()[0])
    assert out[-1].endswith("passed, 0 failed, 0 skipped") and npass > 16
    assert not any(line.startswith(("FAIL", "SKIP")) for line in out)


def test_cli_exits_1_on_planted_defect(monkeypatch, capsys):
    monkeypatch.setattr(screening, "STREAMABLE_RULES", screening.STREAMABLE_RULES | {"krum"})
    assert cli.main(["--device", "cpu", "-q", "--passes", "lint"]) == 1
    out = capsys.readouterr().out
    assert "FAIL lint    screening.stream.partition" in out and "4 skipped" not in out


def test_cli_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-q", "--passes", "lint"])

