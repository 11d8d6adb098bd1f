"""disco_tpu_torch.obs — structured run telemetry (the port's copy of the
core of ``disco_tpu/obs``).

* :mod:`~disco_tpu_torch.obs.events` — the append-only JSONL event log
  with a process-global recorder (a strict no-op while disabled), size
  rotation and the run manifest;
* :mod:`~disco_tpu_torch.obs.metrics` — the counters / gauges /
  histograms registry, :class:`StageTimer` and :func:`trace_to`;
* :mod:`~disco_tpu_torch.obs.accounting` — fence and batched-readback
  counters;
* :mod:`~disco_tpu_torch.obs.trace` — causal spans from a client block to
  its delivery;
* :mod:`~disco_tpu_torch.obs.flight` — the bounded ring of recent events,
  dumped atomically on a trigger.

The log schema, the span chains and the flight dumps are the JAX
package's, so either package's readers read the other's files.  Every
entry point is safe to call from hot paths: disabled, it returns after one
attribute check, and no obs failure breaks the pipeline it observes.
"""
from disco_tpu_torch.obs.events import (
    Event,
    Recorder,
    disable,
    enable,
    enabled,
    read_events,
    record,
    recorder,
    recording,
    stage,
    validate_event,
    write_manifest,
)
from disco_tpu_torch.obs import flight, trace
from disco_tpu_torch.obs.metrics import REGISTRY, StageTimer, trace_to
from disco_tpu_torch.obs.accounting import (
    device_get_count,
    device_get_tick,
    fence_count,
    fence_tick,
)

__all__ = [
    "Event",
    "Recorder",
    "REGISTRY",
    "StageTimer",
    "device_get_count",
    "device_get_tick",
    "disable",
    "enable",
    "enabled",
    "fence_count",
    "fence_tick",
    "flight",
    "read_events",
    "record",
    "recorder",
    "recording",
    "stage",
    "trace",
    "trace_to",
    "validate_event",
    "write_manifest",
]
