"""repro_torch.obs — the observability layer (port of `repro.obs`): the
trace's forensics, sentinel, loss trace and reservoir
(`repro_torch.obs.trace`), the async JSONL event log
(`repro_torch.obs.events`), the live per-tick metric rings and threshold
alerting (`repro_torch.obs.metrics`), run manifests
(`repro_torch.obs.manifest`), the Perfetto/Chrome-trace exporter
(``python -m repro_torch.obs.perfetto``), the live run monitor (``python -m
repro_torch.obs.monitor``) and the report renderer (``python -m
repro_torch.obs.report``).  Tracing and metrics are off by default
(``trace=None``, ``metrics=None``) and bit-inert when on.
"""
from repro_torch.obs.events import EventLog, read_events
from repro_torch.obs.manifest import read_manifest, write_manifest
from repro_torch.obs.metrics import (AlertEngine, AlertRules, MetricSpec, MetricState,
                                     MetricWriter, read_metrics)
from repro_torch.obs.trace import (TraceSpec, TraceState, init_state, ranking_auc, sender_grid,
                                   staleness_of, summarize, update)

__all__ = ["EventLog", "read_events", "AlertEngine", "AlertRules", "MetricSpec", "MetricState",
           "MetricWriter", "read_metrics", "read_manifest", "write_manifest", "TraceSpec",
           "TraceState", "init_state", "ranking_auc", "sender_grid", "staleness_of", "summarize",
           "update"]
