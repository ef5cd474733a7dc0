"""repro_torch.obs — the observability layer (port of `repro.obs`): the
trace's forensics (per-edge trim counters from the screening rules'
decision twins, survival rates, histograms), its sentinel, loss trace and
reservoir (`repro_torch.obs.trace`) and the async JSONL event log
(`repro_torch.obs.events`).  Tracing is off by default (``trace=None``)
and bit-inert when on.  The metric rings and the manifests are ROADMAP
Queue 1 open item 5's next slice.
"""
from repro_torch.obs.events import EventLog, read_events
from repro_torch.obs.trace import (TraceSpec, TraceState, init_state, ranking_auc, sender_grid,
                                   summarize, update)

__all__ = ["EventLog", "read_events", "TraceSpec", "TraceState", "init_state", "ranking_auc",
           "sender_grid", "summarize", "update"]
