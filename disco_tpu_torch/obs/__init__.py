"""disco_tpu_torch.obs — structured run telemetry (the port's copy of the
core of ``disco_tpu/obs``).

* :mod:`~disco_tpu_torch.obs.events` — the append-only JSONL event log
  with a process-global recorder (a strict no-op while disabled), size
  rotation and the run manifest;
* :mod:`~disco_tpu_torch.obs.metrics` — the counters / gauges /
  histograms registry, :class:`StageTimer` and :func:`trace_to`;
* :mod:`~disco_tpu_torch.obs.accounting` — fence and batched-readback
  counters, and :func:`counted_jit`, the signature counter of the entry
  points the JAX package jits (``jit_recompiles``);
* :mod:`~disco_tpu_torch.obs.sentinels` — opt-in numerics watchdogs
  (:func:`check_finite`) at the corpus driver's stage boundaries;
* :mod:`~disco_tpu_torch.obs.trace` — causal spans from a client block to
  its delivery;
* :mod:`~disco_tpu_torch.obs.flight` — the bounded ring of recent events,
  dumped atomically on a trigger;
* :mod:`~disco_tpu_torch.obs.scope` — the scope gate: complete causal
  chains for every delivered serve frame, a byte-stable flight dump on an
  injected fault, a ``status`` frame equal to the registry (imports
  serving, so it is not imported here).

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
    counted_jit,
    device_get_count,
    device_get_tick,
    fence_count,
    fence_tick,
    recompile_count,
)
from disco_tpu_torch.obs.sentinels import check_finite

__all__ = [
    "Event",
    "Recorder",
    "REGISTRY",
    "StageTimer",
    "check_finite",
    "counted_jit",
    "device_get_count",
    "device_get_tick",
    "disable",
    "enable",
    "enabled",
    "fence_count",
    "fence_tick",
    "flight",
    "read_events",
    "recompile_count",
    "record",
    "recorder",
    "recording",
    "stage",
    "trace",
    "trace_to",
    "validate_event",
    "write_manifest",
]
