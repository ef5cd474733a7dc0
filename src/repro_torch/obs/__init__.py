"""repro_torch.obs — the observability layer's forensics-free half (port of
`repro.obs`): the trace's sentinel, loss trace and reservoir
(`repro_torch.obs.trace`) and the async JSONL event log
(`repro_torch.obs.events`).  Tracing is off by default (``trace=None``)
and bit-inert when on.  The forensics half (per-edge trim counters,
survival rates, histograms), the metric rings and the manifests wait for
the screening rules' decision twins: ROADMAP Queue 1 open item 5.
"""
from repro_torch.obs.events import EventLog, read_events
from repro_torch.obs.trace import TraceSpec, TraceState, init_state, summarize, update

__all__ = ["EventLog", "read_events", "TraceSpec", "TraceState", "init_state", "summarize",
           "update"]
