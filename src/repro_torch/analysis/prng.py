"""PRNG-discipline pass: every random draw has its own key — port of
`repro.analysis.prng`, checked at run time.

BRIDGE's resilience analysis assumes independent randomness per edge, per
block, per tick.  The reference proves it on the jaxpr of a traced step;
the port runs eagerly, so this pass records what a run draws instead:
`repro_torch.prng.RECORDER` sees every outermost public draw (``bits``,
``uniform``, ``normal``, ``randint``, ``truncated_normal``; the calls
nested inside one, ``normal``'s ``uniform``, are the same draw), and a
`KeyRecord` keeps, for each key, the set of *frames* it fed.

* A **key** is the two words of a host key, or each row of a host or
  device row-key batch (row e of a batched draw is the draw of
  ``shape[1:]`` under key e).  Device rows are copied to the host while
  the recorder records, and only then.
* A **frame** is the draw's function with its shape (per row), dtype and
  bounds: ``normal`` and ``uniform`` read the same raw bits from one key
  but are different frames, so that correlated pair is flagged.
* A **violation** is one key feeding two or more distinct frames.  The
  same frame twice is one value, the reference's shared coin, and is not
  flagged.

Where the reference's jaxpr walk loses key identity (a sampler calling
another across a ``pjit`` boundary, a draw inside a ``scan`` body under
``jax 0.9.0``), this pass sees the keys themselves: its counts are the
ones `tests/test_analysis.py` expects of both cases, one flag each.  Only
branches that run are seen, the exclusive-branch merge of the reference
for free.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect

import numpy as np
import torch

from repro_torch import prng as prng_lib


@dataclasses.dataclass(frozen=True)
class KeyReuse:
    """One flagged key: feeds ``uses`` distinct frames."""

    key: str        # the key's two words, hex
    uses: int       # distinct-frame count (>= 2)
    consumers: tuple[str, ...]  # the frames, rendered

    def __str__(self):
        return (f"key {self.key} consumed by {self.uses} distinct draws: "
                + "; ".join(self.consumers))


def _keys(key) -> list[tuple[int, int]]:
    """The keys a draw's ``key`` argument holds, as word pairs."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    k = np.asarray(key).astype(np.uint64).reshape(-1, 2)
    return [(int(a), int(b)) for a, b in k]


def _value(v):
    if isinstance(v, torch.dtype):
        return str(v)
    if isinstance(v, (tuple, list, torch.Size)):
        return tuple(int(x) for x in v)
    return v if isinstance(v, (int, str)) or v is None else float(v)


class KeyRecord:
    """The keys a run's draws took and the frames each fed."""

    def __init__(self):
        self.uses: dict[tuple[int, int], set] = {}
        self.draws = 0
        self._depth = 0

    def draw(self, fn, args, kwargs):
        """Record one call of the public draw ``fn`` (outermost only) and
        run it."""
        if self._depth:
            return fn(*args, **kwargs)
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        params = dict(bound.arguments)
        key, shape = params.pop("key"), tuple(int(s) for s in params.pop("shape"))
        params.pop("device")
        rows = prng_lib.is_rows(key) or prng_lib.is_host_rows(key)
        frame = (fn.__name__, shape[1:] if rows else shape,
                 tuple(sorted((k, _value(v)) for k, v in params.items())))
        for k in _keys(key):
            self.uses.setdefault(k, set()).add(frame)
        self.draws += 1
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1


@contextlib.contextmanager
def recording():
    """Record every draw made inside the block into a fresh `KeyRecord`."""
    if prng_lib.RECORDER is not None:
        raise RuntimeError("a key-use recorder is already on")
    rec = KeyRecord()
    prng_lib.RECORDER = rec
    try:
        yield rec
    finally:
        prng_lib.RECORDER = None


def _render_frame(frame) -> str:
    name, shape, params = frame
    extra = "".join(f", {k}={v}" for k, v in params)
    return f"{name}({list(shape)}{extra})"


def find_reuse(record: KeyRecord) -> list[KeyReuse]:
    """Every key of ``record`` that fed two or more distinct frames.  An
    empty list: the run was PRNG-clean."""
    out = []
    for key, frames in sorted(record.uses.items(), key=lambda kv: -len(kv[1])):
        if len(frames) < 2:
            continue
        out.append(KeyReuse(key=f"{key[0]:08x}:{key[1]:08x}", uses=len(frames),
                            consumers=tuple(sorted(_render_frame(f) for f in frames))))
    return out


def check(fn, *args, **kwargs) -> list[KeyReuse]:
    """Run ``fn(*args, **kwargs)`` under the recorder and report reuse."""
    with recording() as rec:
        fn(*args, **kwargs)
    return find_reuse(rec)
