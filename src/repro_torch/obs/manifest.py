"""Run manifests — port of `repro.obs.manifest`: every run bracket writes a
self-describing ``manifest.json``.

A run directory that outlives its process (a killed sweep, an archived
artifact, a months-old benchmark) is only as useful as the provenance it
carries.  The manifest records what produced the artifacts next to it: the
exact argv, the config (plus a stable digest for cheap equality checks
across runs), the git commit, the torch and CUDA versions, the backend, the
card's kind, count and power limit, and wall-clock brackets.
`write_manifest` is called at run *start* (so even a killed run is
self-describing) and again at run *end* with ``extra={"ended": ...}`` fields
merged in; `read_manifest` is the monitor/report/perfetto input.  The keys
are the reference's but for the environment's, which name this stack.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any

MANIFEST_NAME = "manifest.json"


def _jsonable_config(config: Any):
    """Config -> JSON-able structure (dataclasses unpacked, everything else
    stringified) — stable enough to digest."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    try:
        json.dumps(config)
        return config
    except TypeError:
        if isinstance(config, dict):
            return {str(k): _jsonable_config(v) for k, v in config.items()}
        if isinstance(config, (list, tuple)):
            return [_jsonable_config(v) for v in config]
        return repr(config)


def config_digest(config: Any) -> str | None:
    """sha256 of the stable-JSON config rendering (None config -> None)."""
    if config is None:
        return None
    blob = json.dumps(_jsonable_config(config), sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _git_sha() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=5,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def _power_limit() -> str | None:
    """The first card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _environment() -> dict:
    env: dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    try:
        import torch

        env["torch"] = torch.__version__
        env["cuda"] = torch.version.cuda
        on_card = torch.cuda.is_available()
        env["backend"] = "cuda" if on_card else "cpu"
        env["device_kind"] = torch.cuda.get_device_name(0) if on_card else None
        env["device_count"] = torch.cuda.device_count() if on_card else 0
    except Exception:
        env["torch"] = None
    env["power_limit"] = _power_limit()
    return env


def write_manifest(run_dir: str, *, kind: str | None = None, config: Any = None,
                   extra: dict | None = None) -> str:
    """Write (or update) ``run_dir/manifest.json``.  Re-writing merges on top
    of an existing manifest, so a run-end bracket extends the run-start one
    instead of erasing it (``kind=None`` keeps the start bracket's kind)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, MANIFEST_NAME)
    manifest = read_manifest(run_dir) or {}
    if kind is not None:
        manifest["kind"] = kind
    else:
        manifest.setdefault("kind", "run")
    manifest.update({
        "argv": list(sys.argv),
        "time": time.time(),
        "time_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "git_sha": _git_sha(),
        "environment": _environment(),
    })
    if config is not None:
        manifest["config"] = _jsonable_config(config)
        manifest["config_digest"] = config_digest(config)
    if extra:
        manifest.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=repr)
    os.replace(tmp, path)  # atomic: a killed run never leaves a torn manifest
    return path


def read_manifest(run_dir: str) -> dict | None:
    """``run_dir/manifest.json`` as a dict, or None when absent/torn."""
    path = os.path.join(run_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
