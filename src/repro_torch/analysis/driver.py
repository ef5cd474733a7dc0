"""Driver: collect every CONTRACTS declaration, build the canonical
programs, route each contract to the pass that can discharge it, and
aggregate verdicts — port of `repro.analysis.driver`, on ``device``.

Routing is by contract ``kind`` plus pass-specific params:

* ``prng``    — `prng.find_reuse` on the keys one recorded tick of every
  program the contract names in its ``("programs", ...)`` param drew;
* ``fence``   — a ``min_fences`` param checks the floor, the apply's site
  and its bits on every selected program; a ``delta`` param compares the
  metrics-on/off twins;
* ``memory``  — a ``budget`` param resolves against the byte ceilings the
  programs declare (`programs.Program.budgets`); ``("check", "donation")``
  watches `run_chunks`'s carry on the flat program;
* ``retrace`` — a ``max_traces`` param drives `run_chunks` on a fresh flat
  program; otherwise the grid `set_cells` zero-build check.  On the card
  the kernel library is loaded first: its one-off build is the process's
  set-up, not a per-chunk build;
* ``lint``    — dispatched wholesale to `lint.run_lint` over the source tree.

A contract whose inputs were deselected (``--programs``/``--passes``)
reports SKIP, never silently disappears — the summary line counts it.
"""
from __future__ import annotations

import pathlib

from repro_torch.analysis import fence as fence_pass
from repro_torch.analysis import lint as lint_pass
from repro_torch.analysis import memory as memory_pass
from repro_torch.analysis import prng as prng_pass
from repro_torch.analysis import programs as programs_lib
from repro_torch.analysis import retrace as retrace_pass
from repro_torch.analysis.contracts import KINDS, CheckResult, collect
from repro_torch.device import resolve_device

#: source root (the directory holding ``repro_torch/``) for the lint pass
SRC_ROOT = pathlib.Path(__file__).resolve().parents[2]

#: ticks of the carry check's chunk, and the retrace check's run
CARRY_TICKS = 4
RETRACE_STEPS, RETRACE_CHUNK = 8, 4


def _skip(c, detail: str, program: str = "") -> CheckResult:
    return CheckResult(contract=c.name, kind=c.kind, status="SKIP",
                       detail=detail, program=program)


def prng_result(c, program: str, rec) -> CheckResult:
    """A prng contract's verdict on one program's `prng.KeyRecord`."""
    reuse = prng_pass.find_reuse(rec)
    return CheckResult(
        contract=c.name, kind="prng", program=program,
        status="PASS" if not reuse else "FAIL",
        detail=(f"every key feeds exactly one draw ({rec.draws} draws under "
                f"{len(rec.uses)} keys)"
                if not reuse else
                f"{len(reuse)} reused key(s): " + " | ".join(str(r) for r in reuse[:3])))


def _run_prng(c, programs) -> list[CheckResult]:
    out = []
    for pname in c.param("programs", tuple(programs)):
        prog = programs.get(pname)
        if prog is None:
            out.append(_skip(c, "program not selected", pname))
            continue
        out.append(prng_result(c, prog.name, prog.key_record))
    return out


def _run_fence(c, programs) -> list[CheckResult]:
    delta = c.param("delta")
    if delta is not None:
        flat, met = programs.get("flat"), programs.get("metrics")
        if flat is None or met is None:
            return [_skip(c, "needs both the flat and metrics programs")]
        return [fence_pass.check_metrics_fence_delta(c, flat.fence_record, met.fence_record,
                                                     delta=int(delta))]
    floor = int(c.param("min_fences", 1))
    return [fence_pass.check_fence_floor(c, p.name, p.fence_record, min_fences=floor)
            for p in programs.values()]


def carry_result(c, prog, num_steps: int = CARRY_TICKS) -> CheckResult:
    rec = memory_pass.carry_run(prog.trainer, prog.state, prog.batch_fn, num_steps=num_steps)
    return memory_pass.check_carry(c, prog.name, rec, num_steps)


def _run_memory(c, programs) -> list[CheckResult]:
    if c.param("check") == "donation":
        prog = programs.get("flat")
        if prog is None:
            return [_skip(c, "needs the flat program")]
        return [carry_result(c, prog)]
    budget_id = c.param("budget")
    out = []
    governed = [p for p in programs.values() if budget_id in p.budgets]
    if not governed:
        return [_skip(c, f"no selected program declares budget {budget_id!r}")]
    for prog in governed:
        byte_ceiling, label = prog.budgets[budget_id]
        out.append(memory_pass.check_budget(c, prog.name, prog.memory_record, byte_ceiling,
                                            label))
    return out


def _run_retrace(c, names, device) -> list[CheckResult]:
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.load()
    if c.param("max_traces") is not None:
        if "flat" not in names:
            return [_skip(c, "needs the flat program")]
        prog = programs_lib.build_flat(device)
        return [retrace_pass.check_run_chunks(
            c, prog.trainer, prog.state, prog.batch_fn, num_steps=RETRACE_STEPS,
            chunk=RETRACE_CHUNK)]
    engine, state_fn, batches = programs_lib.build_grid(device)
    return [retrace_pass.check_grid_set_cells(c, engine, state_fn, batches)]


def run_all(program_names=None, kinds=None, device="cuda", src_root=SRC_ROOT,
            log=None) -> list[CheckResult]:
    """Run the selected passes over the selected canonical programs on
    ``device`` (the card unless ``"cpu"`` is asked for).

    ``program_names``/``kinds`` default to everything; ``log`` (optional
    callable) receives progress lines."""
    say = log or (lambda *_: None)
    dev = resolve_device(device)
    kinds = tuple(kinds) if kinds else KINDS
    names = tuple(program_names) if program_names else programs_lib.PROGRAM_NAMES
    contracts = collect()
    say(f"{len(contracts)} contracts collected from governed modules")

    needs_programs = any(k in kinds for k in ("prng", "fence", "memory"))
    programs = {}
    if needs_programs:
        for n in names:
            say(f"building canonical program: {n} on {dev}")
            programs[n] = programs_lib.BUILDERS[n](dev)

    results: list[CheckResult] = []
    for c in contracts:
        if c.kind not in kinds:
            results.append(_skip(c, f"pass {c.kind!r} not selected"))
            continue
        say(f"checking {c.name} [{c.kind}]")
        if c.kind == "prng":
            results.extend(_run_prng(c, programs))
        elif c.kind == "fence":
            results.extend(_run_fence(c, programs))
        elif c.kind == "memory":
            results.extend(_run_memory(c, programs))
        elif c.kind == "retrace":
            results.extend(_run_retrace(c, names, dev))
    lint_contracts = [c for c in contracts if c.kind == "lint"]
    if "lint" in kinds and lint_contracts:
        results.extend(lint_pass.run_lint(lint_contracts, src_root))
    return results
