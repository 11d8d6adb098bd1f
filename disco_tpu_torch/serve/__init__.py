"""disco_tpu_torch.serve — online enhancement: continuous batching of
concurrent streaming sessions on one device (the port's counterpart of
``disco_tpu/serve``).

* :mod:`~disco_tpu_torch.serve.protocol`  — length-prefixed msgpack frames
  over a unix/TCP socket, byte for byte the JAX package's wire.
* :mod:`~disco_tpu_torch.serve.session`   — per-stream state: config,
  streaming carry, fault availability, queues; checkpoint/resume via
  atomic msgpack (the JAX package's file).
* :mod:`~disco_tpu_torch.serve.scheduler` — the continuous-batching tick:
  ready blocks across sessions queued on the device through the offline
  streaming entry points (bit-exact parity), ONE batched readback a tick.
* :mod:`~disco_tpu_torch.serve.server`    — asyncio I/O + one dispatch
  thread (the only thread that touches the device), graceful drain, chaos
  seams.
* :mod:`~disco_tpu_torch.serve.client`    — blocking numpy client.
* :mod:`~disco_tpu_torch.serve.ladder`, :mod:`~disco_tpu_torch.serve.status`
  — the overload controller and the live status payload.
* :mod:`~disco_tpu_torch.serve.check`     — the serving contract's legs as
  functions of a device.

The server runs on ``"cuda"`` unless it is given ``device="cpu"``.  It
takes the flywheel's corpus tap (``tap=``), a promotion controller
(``promote=``, which serves ``masks="model"`` sessions) and a co-resident
trainer (``resident=``): :mod:`disco_tpu_torch.flywheel` and
:mod:`disco_tpu_torch.promote`.
"""
from disco_tpu_torch.serve.client import ServeClient, ServeError
from disco_tpu_torch.serve.ladder import RUNGS, DegradationLadder
from disco_tpu_torch.serve.scheduler import (
    AdmissionError,
    QueueFull,
    Scheduler,
    set_dispatch_fault_injector,
)
from disco_tpu_torch.serve.server import EnhanceServer
from disco_tpu_torch.serve.status import (
    DEFAULT_SLO,
    STATUS_SECTIONS,
    evaluate_slo,
    fetch_status,
    status_payload,
    status_section,
)
from disco_tpu_torch.serve.session import (
    Session,
    SessionConfig,
    SessionStateError,
    load_session_state,
    probe_session_state,
    save_session_state,
)

__all__ = [
    "AdmissionError",
    "DEFAULT_SLO",
    "DegradationLadder",
    "EnhanceServer",
    "QueueFull",
    "RUNGS",
    "STATUS_SECTIONS",
    "Scheduler",
    "ServeClient",
    "ServeError",
    "Session",
    "SessionConfig",
    "SessionStateError",
    "evaluate_slo",
    "fetch_status",
    "load_session_state",
    "probe_session_state",
    "save_session_state",
    "set_dispatch_fault_injector",
    "status_payload",
    "status_section",
]
