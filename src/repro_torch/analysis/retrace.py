"""Retrace guard: the port's build caches stay warm — port of
`repro.analysis.retrace`.

The reference counts compilations: one trace per distinct chunk length in
`run_chunks`, none across a grid's `set_cells`.  The port runs eagerly and
builds nothing per chunk length; what it does build is cached: the kernel
library (`kernels.build.source_hash`, `load`), the sorting networks
(`kernels.networks`), the gather tile kernel's and the distance kernel's
plans (`gather_screen.tile_plan`, `pairwise.split_plan`, `batch_plan`),
each a ``functools.cache`` whose ``cache_info().misses`` counts the entries
built, and the grid engine's steps (``GridEngine.num_steps_built``).  A
"trace" here is one of those misses.

This pass drives the canonical programs through the update patterns the
reference promises (uniform chunks and their identical re-run; cell swaps
at fixed structure) and asserts the counters' growth.  A ragged chunking
costs the port nothing more (where `tests/test_analysis.py` shows the
reference retracing on chunk lengths 4, 4, 2): the port has no program per
length.  `guard` is the reusable context-manager form.
"""
from __future__ import annotations

import contextlib
import importlib

from repro_torch.analysis.contracts import CheckResult

#: the port's build caches: (module, function) of each ``functools.cache``
CACHES: tuple[tuple[str, str], ...] = (
    ("repro_torch.kernels.build", "source_hash"),
    ("repro_torch.kernels.build", "load"),
    ("repro_torch.kernels.networks", "batcher_pairs"),
    ("repro_torch.kernels.networks", "median_pairs"),
    ("repro_torch.kernels.networks", "warp_steps"),
    ("repro_torch.kernels.networks", "warp_schedule"),
    ("repro_torch.kernels.gather_screen", "tile_plan"),
    ("repro_torch.kernels.pairwise", "split_plan"),
    ("repro_torch.kernels.pairwise", "batch_plan"),
)


class RetraceError(AssertionError):
    """A build cache went cold inside a `guard` block."""


def cache_misses() -> dict[str, int]:
    """Each build cache's misses (entries built) so far."""
    out = {}
    for mod, fn in CACHES:
        out[f"{mod.rpartition('.')[2]}.{fn}"] = getattr(importlib.import_module(mod),
                                                        fn).cache_info().misses
    return out


def total_misses() -> int:
    return sum(cache_misses().values())


@contextlib.contextmanager
def guard(obj, attr: str | None = "trace_count", budget: int = 0):
    """Assert a counter grows by at most ``budget`` inside the block: the
    attribute ``attr`` of ``obj``, or ``obj()`` when ``obj`` is a function
    that reads one (``attr`` None).  ``budget=0`` (the default) is the
    zero-build contract."""
    read = obj if attr is None else (lambda: getattr(obj, attr, 0))
    name = getattr(obj, "__name__", None) if attr is None else f"{type(obj).__name__}.{attr}"
    before = read()
    yield
    grew = read() - before
    if grew > budget:
        raise RetraceError(
            f"{name} grew by {grew} (budget {budget}): a build cache went cold — some "
            f"structure (shape, dtype, plan, spec) changed between calls")


def _grown(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def check_run_chunks(contract, trainer, state, batch_fn, *, num_steps: int,
                     chunk: int) -> CheckResult:
    """A uniform-chunk `run_chunks` builds at most the contract's budget
    (default 1) of entries in each cache; an identical re-run builds
    none."""
    budget = int(contract.param("max_traces", 1))
    m0 = cache_misses()
    trainer.run_chunks(state, batch_fn, num_steps, chunk=chunk)
    m1 = cache_misses()
    trainer.run_chunks(state, batch_fn, num_steps, chunk=chunk)
    m2 = cache_misses()
    first, again = _grown(m0, m1), _grown(m1, m2)
    ok = all(v <= budget for v in first.values()) and not again
    return CheckResult(
        contract=contract.name, kind="retrace", program="flat",
        status="PASS" if ok else "FAIL",
        detail=(f"{sum(first.values())} build(s){f' {first}' if first else ''} for {num_steps} "
                f"steps in chunks of {chunk}; re-run added {sum(again.values())}"
                if ok else
                f"first run built {first} (budget {budget} a cache), an identically-shaped "
                f"re-run built {again} — a build cache is going cold"))


def check_grid_set_cells(contract, engine, state_fn, batches) -> CheckResult:
    """A generation update (`set_cells` at fixed structure) builds nothing:
    ``num_steps_built`` and every build cache unchanged across the swapped
    run."""
    engine.run(state_fn(), batches)
    baseline = engine.num_steps_built
    swapped = [c._replace(seed=c.seed + 100) for c in engine.cells]
    engine.set_cells(swapped)
    try:
        with guard(engine, "num_steps_built", budget=0), guard(total_misses, None, budget=0):
            engine.run(state_fn(), batches)
    except RetraceError as e:
        return CheckResult(contract=contract.name, kind="retrace",
                           program="grid", status="FAIL", detail=str(e))
    return CheckResult(
        contract=contract.name, kind="retrace", program="grid",
        status="PASS",
        detail=f"num_steps_built stayed {baseline} and no build cache missed across a "
               f"set_cells generation swap ({engine.num_cells} cells)")
