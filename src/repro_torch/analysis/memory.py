"""Memory-contract pass — the port's counterpart of the memory half of
`repro.analysis.hlo`: byte budgets and the chunked runner's carry.

The reference reads the largest array typed in a step's optimized HLO and
the chunk scan's ``input_output_alias`` table.  The port runs eagerly, so
it measures a tick as it runs:

* **the largest tensor** — a `TorchDispatchMode` sees every op of the tick
  (the kernels' ``torch.empty`` outputs included) and keeps the largest
  *new* floating-point storage one creates (views and in-place ops reuse
  an operand's storage and do not count).  The budgets are float layouts
  (the dense ``[M, M, d]``, the flat ``[M, d]``); an integer tensor, such
  as the index output ``torch.sort`` allocates beside the plain twins'
  sorted values, is not one, and is printed beside the verdict.  It works
  on the CPU and on the card, and must stay strictly under the program's
  budget;
* **the peak on the card** — the caching allocator's peak over the tick
  (its requested bytes, ``requested_bytes.all.peak`` of
  ``torch.cuda.memory_stats``: ``max_memory_allocated`` without the
  rounding of every block up to 512 B, which at the reference's sizes is
  as large as the budgets) less the bytes resident after it: the state it
  was given and the state it returns, the model's own leaves and carries,
  which no layout avoids.  That transient (the gradient and every
  intermediate) must stay under the budget wherever the budget is at
  least `PEAK_FLOOR`: below it, a tick's size-independent
  working set decides, not the layout (at the reference's stream, chunk 64
  of d = 768, the last leaf's gradient, the int8 codec's int64 random
  counters and a block's temporaries hold 109,184 B against a 24,576 B
  budget on the card), and
  the transient is printed, not held.  ``max_memory_allocated`` over the
  bytes before the tick is printed beside it;
* **the carry** (``bridge.chunk_carry.donated``, the port's form of a
  donated scan carry): `run_chunks` keeps no earlier tick's state alive —
  weak references to the first tick's new state tensors are dead by the
  chunk's end, and on the card the requested bytes after the chunk exceed
  those after its first tick by less than one carry.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.contracts import CheckResult


def leaves(x) -> list[torch.Tensor]:
    """The tensors of a state (dicts, tuples, NamedTuples, nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


#: the smallest budget a tick's peak transient is held to: 1 MiB, ten times
#: the fixed working set measured at the reference's sizes
PEAK_FLOOR = 1 << 20


def requested_bytes(device, stat: str = "current") -> int:
    """The caching allocator's requested bytes on ``device`` (``current``
    or ``peak``): what the tensors asked for, before the 512 B rounding."""
    return torch.cuda.memory_stats(device)[f"requested_bytes.all.{stat}"]


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages ``tensors`` hold."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class _Largest(TorchDispatchMode):
    """Keeps the largest floating-point storage any op creates, and the
    largest of any other dtype apart."""

    def __init__(self):
        super().__init__()
        self.bytes = self.other_bytes = 0
        self.what = self.other_what = "none"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = None
        for t in (out,) if isinstance(out, torch.Tensor) else tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            flt = t.is_floating_point()
            if st.nbytes() <= (self.bytes if flt else self.other_bytes):
                continue  # no new record either way: skip the operands' walk
            if ins is None:
                ins = {a.untyped_storage().data_ptr() for a in tree_leaves((args, kwargs))
                       if isinstance(a, torch.Tensor)}
            if st.data_ptr() in ins:
                continue
            what = f"{func} -> {str(t.dtype).replace('torch.', '')}{list(t.shape)}"
            if flt:
                self.bytes, self.what = st.nbytes(), what
            else:
                self.other_bytes, self.other_what = st.nbytes(), what
        return out


@dataclasses.dataclass
class MemoryRecord:
    """One measured tick: the largest new float tensor (bytes and where),
    the largest of another dtype, and on the card the allocator's
    requested bytes (peak, before, after) and ``max_memory_allocated``
    over the bytes allocated before (None on the CPU)."""

    largest: int
    largest_what: str
    other: int = 0
    other_what: str = "none"
    peak: int | None = None
    before: int | None = None
    after: int | None = None
    allocated_over_before: int | None = None

    @property
    def transient(self) -> int | None:
        """The peak less the bytes the tick leaves resident (both states)."""
        if self.peak is None:
            return None
        return self.peak - max(self.before, self.after)


def measure(fn, device: torch.device) -> tuple[object, MemoryRecord]:
    """Run ``fn()`` once under the largest-tensor mode and, on the card,
    between allocator readings; returns its result and the record."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before, allocated = requested_bytes(device), torch.cuda.memory_allocated(device)
    mode = _Largest()
    with mode:
        out = fn()
    rec = MemoryRecord(mode.bytes, mode.what, mode.other_bytes, mode.other_what)
    if cuda:
        torch.cuda.synchronize(device)
        rec.peak, rec.before, rec.after = (requested_bytes(device, "peak"), before,
                                           requested_bytes(device))
        rec.allocated_over_before = torch.cuda.max_memory_allocated(device) - allocated
    return out, rec


def check_budget(contract, program_name: str, record: MemoryRecord, budget_bytes: int,
                 label: str) -> CheckResult:
    """The tick's largest new float tensor, and on the card its peak's
    transient bytes (a budget of at least `PEAK_FLOOR`), strictly under
    ``budget_bytes``."""
    ok = record.largest < budget_bytes
    parts = [f"largest float tensor {record.largest_what} = {record.largest} B",
             f"largest of another dtype {record.other_what} = {record.other} B"]
    if record.peak is None:
        parts.append("peak: the CPU has no allocator reading")
    else:
        held = budget_bytes >= PEAK_FLOOR
        ok = ok and (not held or record.transient < budget_bytes)
        parts.append(f"peak transient {record.transient} B"
                     f"{'' if held else ' (not held: the budget is under the 1 MiB floor)'} "
                     f"(requested peak {record.peak} B less resident "
                     f"{max(record.before, record.after)} B; "
                     f"max_memory_allocated over the bytes before the tick "
                     f"{record.allocated_over_before} B)")
    return CheckResult(
        contract=contract.name, kind="memory", program=program_name,
        status="PASS" if ok else "FAIL",
        detail=("; ".join(parts) + f"; {label} budget {budget_bytes} B"
                + ("" if ok else " — a dense intermediate materialized on a path that "
                                 "promises not to")))


@dataclasses.dataclass
class CarryRecord:
    """What `carry_run` saw: the first tick's new state tensors still alive
    at the chunk's end, one carry's bytes, and on the card the allocated
    requested bytes' growth from the first tick to the chunk's end."""

    alive: int
    tracked: int
    carry_bytes: int
    grew: int | None


def carry_run(trainer, state, batch_fn, *, num_steps: int = 4) -> CarryRecord:
    """`run_chunks` over ``num_steps`` ticks in one chunk, watching its
    first tick's new state tensors through weak references (the trainer's
    ``step`` wrapped for the call, whatever it is bound to)."""
    dev = trainer.device
    cuda = dev.type == "cuda"
    had = "step" in vars(trainer)
    inner = trainer.step
    first: dict = {}

    def step(st, batch):
        new, metrics = inner(st, batch)
        if not first:
            old = {id(t) for t in leaves(st)}
            fresh = [t for t in leaves(new) if id(t) not in old]
            first["refs"] = [weakref.ref(t) for t in fresh]
            first["bytes"] = storage_bytes(fresh)
            del fresh
            if cuda:
                torch.cuda.synchronize(dev)
            first["alloc"] = requested_bytes(dev) if cuda else None
        return new, metrics

    trainer.step = step
    try:
        final = trainer.run_chunks(state, batch_fn, num_steps, chunk=num_steps)[0]
    finally:
        if had:
            trainer.step = inner
        else:
            del trainer.step
    grew = None
    if cuda:
        torch.cuda.synchronize(dev)
        grew = requested_bytes(dev) - first["alloc"]
    del final
    alive = sum(r() is not None for r in first["refs"])
    return CarryRecord(alive, len(first["refs"]), first["bytes"], grew)


def check_carry(contract, program_name: str, record: CarryRecord, num_steps: int) -> CheckResult:
    """No earlier tick's carry alive at the chunk's end."""
    ok = record.alive == 0 and record.tracked > 0
    grew = ""
    if record.grew is not None:
        ok = ok and record.grew < record.carry_bytes
        grew = (f"; requested bytes grew {record.grew} B over the chunk (a carry "
                f"{record.carry_bytes} B)")
    return CheckResult(
        contract=contract.name, kind="memory", program=program_name,
        status="PASS" if ok else "FAIL",
        detail=(f"the first tick's {record.tracked} state tensor(s) freed by the end of a "
                f"{num_steps}-tick chunk{grew}"
                if ok else
                f"{record.alive} of the first tick's {record.tracked} state tensor(s) still alive "
                f"after a {num_steps}-tick chunk{grew} — run_chunks keeps earlier carries, "
                f"multiplying peak state memory"))
