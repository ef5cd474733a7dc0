"""Repo-lint pass: the registry contracts, at the registry and AST level —
port of `repro.analysis.lint` over the port's registries and tree.

* **partition** — every screening rule sits in exactly one of
  ``STREAMABLE_RULES`` / ``STREAM_REJECTED_RULES``; every name in the attack
  namespace sits in exactly one of the six `adversary.protocols` tiers;
* **completeness** — ``MIN_NEIGHBORS`` and ``RULES_WITH_DECISIONS`` cover
  exactly ``RULES``, ``WEIGHTED_RULES`` is a subset.  The reference also
  keeps a traceable twin of ``MIN_NEIGHBORS`` (its banked minimum runs
  inside a jitted grid); the port has none: its banked minimum maps
  ``MIN_NEIGHBORS`` on the host (`screening.min_neighbors_banked`), so
  there is no second table to fall out of step;
* **frozen specs** — ``TraceSpec`` / ``MetricSpec`` / ``TrustSpec`` are
  frozen, hashable, and hold no tensor or array: pure structure the grid
  engine never rebuilds per generation (the reference's zero-leaf pytrees);
* **salts** — the stream salts of `repro_torch.core.bridge` are distinct;
* **kernel twins** — every public entry of `repro_torch.kernels.ops`
  reaches a kernel wrapper whose body calls a ``ref.`` twin and whose
  module reaches the built library (``build.load()`` or
  ``screen_wide.launch``);
* **seed plumbing** — no naked ``prng.PRNGKey(...)`` under
  ``src/repro_torch`` outside declared seed-plumbing sites: a site is
  plumbed when its argument mentions a seed (``seed``, ``args.seed``,
  ``c.seed``...) or when it carries a ``(file, function)`` waiver in the
  governing contract; a waiver whose site is gone is stale and fails.

Checks import the live registries and parse source with ``ast`` — nothing
here runs a step.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import pathlib

import numpy as np
import torch

from repro_torch.analysis.contracts import CheckResult, Contract


def _result(contract: Contract, ok: bool, ok_detail: str, bad_detail: str) -> CheckResult:
    return CheckResult(contract=contract.name, kind="lint",
                       status="PASS" if ok else "FAIL",
                       detail=ok_detail if ok else bad_detail)


# ---------------------------------------------------------------------------
# registry partitions / completeness
# ---------------------------------------------------------------------------


def check_stream_partition(contract: Contract) -> CheckResult:
    from repro_torch.core import screening

    rules = set(screening.RULES)
    streamable = set(screening.STREAMABLE_RULES)
    rejected = set(screening.STREAM_REJECTED_RULES)
    overlap = streamable & rejected
    missing = rules - streamable - rejected
    phantom = (streamable | rejected) - rules
    ok = not overlap and not missing and not phantom
    return _result(
        contract, ok,
        f"{len(rules)} rules partitioned: {len(streamable)} streamable, "
        f"{len(rejected)} rejected",
        f"stream partition broken — overlap={sorted(overlap)}, "
        f"unassigned={sorted(missing)}, phantom={sorted(phantom)}")


def check_registry_completeness(contract: Contract) -> CheckResult:
    from repro_torch.core import screening

    rules = set(screening.RULES)
    problems = []
    for label, table in (("MIN_NEIGHBORS", screening.MIN_NEIGHBORS),
                         ("RULES_WITH_DECISIONS", screening.RULES_WITH_DECISIONS)):
        if set(table) != rules:
            problems.append(
                f"{label}: missing={sorted(rules - set(table))}, "
                f"extra={sorted(set(table) - rules)}")
    weighted = set(screening.WEIGHTED_RULES)
    if not weighted <= rules:
        problems.append(f"WEIGHTED_RULES outside RULES: {sorted(weighted - rules)}")
    return _result(
        contract, not problems,
        f"side tables cover all {len(rules)} rules",
        "; ".join(problems))


def check_adversary_tiers(contract: Contract) -> CheckResult:
    from repro_torch.adversary import protocols

    tiers = protocols.registry_tiers()
    names: dict[str, list[str]] = {}
    for tier, members in tiers.items():
        for n in members:
            names.setdefault(n, []).append(tier)
    multi = {n: hs for n, hs in names.items() if len(hs) > 1}
    uncovered = set(protocols.attack_names()) - set(names)
    ok = not multi and not uncovered
    return _result(
        contract, ok,
        f"{len(names)} names across {len(tiers)} tiers, each in exactly one",
        f"tier partition broken — multi-homed={multi}, "
        f"uncovered={sorted(uncovered)}")


def _holds_array(v) -> bool:
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return True
    if isinstance(v, (tuple, list, frozenset, set)):
        return any(_holds_array(x) for x in v)
    if isinstance(v, dict):
        return any(_holds_array(x) for x in v.values())
    return False


def check_zero_leaf_specs(contract: Contract) -> CheckResult:
    bad = []
    classes = contract.param("classes", ())
    for spec_path in classes:
        modname, clsname = spec_path.split(":")
        cls = getattr(importlib.import_module(modname), clsname)
        params = getattr(cls, "__dataclass_params__", None)
        if params is None or not params.frozen:
            bad.append(f"{spec_path} is not a frozen dataclass")
            continue
        inst = cls()
        try:
            hash(inst)
        except TypeError as e:
            bad.append(f"{spec_path} is not hashable ({e})")
        arrays = [f.name for f in dataclasses.fields(inst)
                  if _holds_array(getattr(inst, f.name))]
        if arrays:
            bad.append(f"{spec_path} holds tensors or arrays in {arrays}")
    return _result(
        contract, not bad,
        f"{len(classes)} spec classes are frozen, hashable and array-free (pure structure)",
        "; ".join(bad))


def check_salts_distinct(contract: Contract) -> CheckResult:
    from repro_torch.core import bridge

    names = contract.param("salts", ())
    vals = {n: getattr(bridge, n) for n in names}
    dupes = {v: [n for n, vv in vals.items() if vv == v]
             for v in vals.values()
             if sum(vv == v for vv in vals.values()) > 1}
    return _result(
        contract, not dupes,
        f"{len(names)} stream salts pairwise distinct",
        f"colliding salts (streams would correlate): {dupes}")


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

#: what launching the built library looks like in a wrapper's source
_LIBRARY = ("build.load()", "screen_wide.launch")


def _called_names(fn_node: ast.AST) -> set[str]:
    """Names and ``module.attr`` chains ``fn_node`` calls."""
    out = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            out.add(ast.unparse(node.func))
    return out


def _reaches_library(module, fn_name: str, seen: set) -> bool:
    """Whether the module-level function ``fn_name`` of ``module`` launches
    the built library, itself or through the module's other functions."""
    if (module.__name__, fn_name) in seen:
        return False
    seen.add((module.__name__, fn_name))
    tree = _module_tree(module)
    node = next((n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name),
                None)
    if node is None:
        return False
    src = ast.unparse(node)
    if any(lib in src for lib in _LIBRARY):
        return True
    local = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    # helpers passed as callables count too (``(a if c else b)(...)``)
    names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    if any(_reaches_library(module, n, seen) for n in sorted(names & local)):
        return True
    # a sibling kernel module's launcher (``gather_screen.dispatch(...)``)
    package = module.__name__.rpartition(".")[0]
    for call in sorted(_called_names(node)):
        head, _, attr = call.partition(".")
        sib = getattr(module, head, None)
        if (attr and "." not in attr and inspect.ismodule(sib)
                and sib.__name__.startswith(package + ".")
                and _reaches_library(sib, attr, seen)):
            return True
    return False


_TREES: dict[str, ast.Module] = {}


def _module_tree(module) -> ast.Module:
    if module.__name__ not in _TREES:
        _TREES[module.__name__] = ast.parse(pathlib.Path(module.__file__).read_text())
    return _TREES[module.__name__]


def _kernel_of(ops_mod, node: ast.FunctionDef):
    """The kernel wrappers an ops entry calls: functions of other modules
    of the kernels package, reached through the entry's module namespace."""
    out = []
    for name in sorted(_called_names(node)):
        head, _, attr = name.partition(".")
        obj = getattr(ops_mod, head, None)
        if attr:
            obj = getattr(obj, attr, None) if inspect.ismodule(obj) else None
        if inspect.isfunction(obj) and obj.__module__ != ops_mod.__name__:
            out.append(obj)
    return out


def check_kernel_ref_twins(contract: Contract) -> CheckResult:
    """Every public entry of the kernels' ops module reaches a wrapper whose
    body calls a ``ref.`` twin (the CPU path) and that launches the built
    library (the card's) — the parity surface that lets CPU CI stand in
    for the card."""
    modname = contract.param("module", "repro_torch.kernels.ops")
    mod = importlib.import_module(modname)
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    bad, entries = [], 0
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or node.name.startswith("_"):
            continue
        entries += 1
        ok = False
        for fn in _kernel_of(mod, node):
            kmod = importlib.import_module(fn.__module__)
            knode = next((n for n in _module_tree(kmod).body
                          if isinstance(n, ast.FunctionDef) and n.name == fn.__name__), None)
            if knode is None:
                continue
            twin = any(c.startswith("ref.") for c in _called_names(knode))
            if twin and _reaches_library(kmod, fn.__name__, set()):
                ok = True
                break
        if not ok:
            bad.append(node.name)
    return _result(
        contract, not bad,
        f"every kernel entry ({entries}) reaches a kernel launch and a ref twin",
        f"entries missing a kernel launch or a ref twin: {bad}")


# ---------------------------------------------------------------------------
# naked-PRNGKey scan
# ---------------------------------------------------------------------------


def _prngkey_sites(root: pathlib.Path) -> list[tuple[str, str, int, str]]:
    """Every ``PRNGKey(...)`` call under ``root`` as
    ``(relpath, enclosing_function, lineno, arg_source)``."""
    sites = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).as_posix()
        tree = ast.parse(path.read_text())
        parents: dict[ast.AST, str] = {}

        def visit(node, fname):
            for child in ast.iter_child_nodes(node):
                cf = fname
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cf = child.name
                parents[child] = cf
                visit(child, cf)

        parents[tree] = "<module>"
        visit(tree, "<module>")
        for node, fname in parents.items():
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if name != "PRNGKey":
                continue
            arg_src = ", ".join(ast.unparse(a) for a in node.args)
            sites.append((rel, fname, node.lineno, arg_src))
    return sites


def check_seed_plumbing(contract: Contract, src_root: str | pathlib.Path) -> CheckResult:
    root = pathlib.Path(src_root) / "repro_torch"
    waivers = set(contract.param("waivers", ()))
    sites = _prngkey_sites(root)
    violations = []
    for rel, fname, lineno, arg in sites:
        if "seed" in arg.lower():
            continue  # plumbed: the key IS the seed argument
        if (rel, fname) in waivers:
            continue
        violations.append(f"{rel}:{lineno} in {fname}(PRNGKey({arg}))")
    unused = [w for w in waivers
              if not any((rel, fname) == w for rel, fname, _, _ in sites)]
    ok = not violations and not unused
    return _result(
        contract, ok,
        f"every PRNGKey call ({len(sites)}) is seed plumbing or carries a waiver "
        f"({len(waivers)})",
        ("naked PRNGKey outside seed plumbing: " + "; ".join(violations)
         if violations else "")
        + (f" stale waivers (site moved/removed): {sorted(unused)}" if unused else ""))


#: dispatch by the short check id each lint contract declares
CHECKS = {
    "stream_partition": check_stream_partition,
    "registry_completeness": check_registry_completeness,
    "adversary_tiers": check_adversary_tiers,
    "zero_leaf_specs": check_zero_leaf_specs,
    "salts_distinct": check_salts_distinct,
    "kernel_ref_twins": check_kernel_ref_twins,
}


def run_lint(contracts: list[Contract], src_root) -> list[CheckResult]:
    out = []
    for c in contracts:
        if c.kind != "lint":
            continue
        check_id = c.param("check")
        if check_id == "seed_plumbing":
            out.append(check_seed_plumbing(c, src_root))
        elif check_id in CHECKS:
            out.append(CHECKS[check_id](c))
        else:
            out.append(CheckResult(contract=c.name, kind="lint", status="SKIP",
                                   detail=f"no lint check registered for "
                                          f"{check_id!r}"))
    return out
