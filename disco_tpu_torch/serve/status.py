"""Live serve introspection: the ``status`` frame payload and SLO verdicts
(the port's copy of ``disco_tpu/serve/status.py``).

Any client (no open session required) sends a ``status`` frame and
receives one ``status_ok`` frame built by :func:`status_payload`: session
states, scheduler tick and drain state, the degradation-ladder rung, the
full counters/gauges registry snapshot (its counters equal
``obs.REGISTRY.snapshot()["counters"]``), latency-histogram percentiles and
the causal tracer's in-flight spans.  :func:`evaluate_slo` turns one
payload into a verdict over declared SLO targets.

Everything here is host-only reads under the owning locks: building a
status payload never touches the device, so the I/O thread serves it while
the dispatch thread owns the card.
"""
from __future__ import annotations

from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry

#: The closed set of status-payload sections.
STATUS_SECTIONS = (
    "sessions",    # per-session states: id/status/blocks/queue/inflight
    "scheduler",   # tick number, draining flag, capacity knobs
    "ladder",      # degradation-ladder rung + mode (None when ladder off)
    "counters",    # the full counters registry (MUST match REGISTRY.snapshot)
    "gauges",      # the full gauges registry
    "latency",     # serve histogram summaries (p50/p95/p99 ...)
    "inflight",    # the causal tracer's in-flight span table
)

#: Latency histograms surfaced in the ``latency`` section.
_LATENCY_HISTOGRAMS = ("serve_block_latency_ms", "serve_queue_wait_ms",
                       "serve_dispatch_ms", "serve_tick_ms")

#: Default SLO targets (a caller overrides each).  Chosen for
#: the loopback CPU gate sizes; production declares its own.
DEFAULT_SLO = {
    "serve_p95_ms": 1000.0,       # delivered-block latency p95
    "queue_wait_p95_ms": 500.0,   # enqueue→dispatch wait p95
    "max_drop_rate": 0.01,        # tap drops / tap offers
    "max_evict_rate": 0.05,       # evictions / finished sessions
}


def status_payload(scheduler, *, ladder=None, tracer=None) -> dict:
    """Build the ``status_ok`` payload from a live scheduler (I/O thread;
    host-only reads, no device call).  ``ladder``/``tracer`` default to the
    scheduler's ladder and the process-global tracer.
    """
    ladder = ladder if ladder is not None else scheduler.ladder
    tracer = tracer if tracer is not None else obs_trace.tracer()
    sessions = []
    for s in scheduler.sessions() + scheduler.parked_sessions():
        entry = {
            "id": s.id,
            "status": s.status,
            "blocks_in": s.blocks_in,
            "blocks_done": s.blocks_done,
            "queue_depth": s.queue_depth(),
            "inflight": s.inflight,
            "priority": bool(s.priority),
            "quarantine_count": s.quarantine_count,
        }
        if getattr(s, "generation", None) is not None:
            # only a model session has the key: a promote-less payload is
            # unchanged
            entry["generation"] = s.generation
        sessions.append(entry)
    snap = obs_registry.snapshot()
    sched_section = {
        "tick_no": scheduler.tick_no,
        "ticks_with_work": scheduler.ticks_with_work,
        "draining": scheduler.draining,
        "max_sessions": scheduler.max_sessions,
        "max_blocks_per_tick": scheduler.max_blocks_per_tick,
        "blocks_per_super_tick": scheduler.blocks_per_super_tick,
        "pending_blocks": scheduler.pending_blocks(),
    }
    promote = getattr(scheduler, "promote", None)
    if promote is not None:
        sched_section["active_generation"] = promote.store.active()
    return {
        "sessions": sessions,
        "scheduler": sched_section,
        "ladder": (None if ladder is None else {
            "rung": ladder.rung,
            "mode": _rung_name(ladder.rung),
            "transitions": len(ladder.transitions),
        }),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "latency": {name: snap["histograms"][name]
                    for name in _LATENCY_HISTOGRAMS
                    if name in snap["histograms"]},
        "inflight": (tracer.inflight_snapshot() if tracer.enabled
                     else {"count": 0, "oldest_s": None, "spans": [],
                           "tracing": False}),
    }


def _rung_name(rung: int) -> str:
    from disco_tpu_torch.serve.ladder import RUNGS

    return RUNGS[rung] if 0 <= rung < len(RUNGS) else f"rung{rung}"


def status_section(payload: dict, name: str):
    """One section of a status payload (the section name must come from
    :data:`STATUS_SECTIONS`).  Raises
    :class:`KeyError` on an unknown section — a reader asking for a
    section this server never built must fail loudly, not render blanks.
    """
    if name not in STATUS_SECTIONS:
        raise KeyError(
            f"unknown status section {name!r} (registered: {STATUS_SECTIONS})"
        )
    return payload[name]


def fetch_status(address, timeout_s: float = 10.0) -> dict:
    """Dial a serve server, send one ``status`` frame, return the
    ``status_ok`` payload (numpy and stdlib; no device call).

    ``address``: ``(host, port)`` tuple or unix-socket path.
    """
    import socket

    from disco_tpu_torch.serve import protocol

    family = (socket.AF_UNIX if isinstance(address, (str, bytes))
              else socket.AF_INET)
    target = address if isinstance(address, (str, bytes)) else tuple(address)
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.settimeout(timeout_s)
    try:
        sock.connect(target)
        protocol.send_frame(sock, {"type": "status"})
        frame = protocol.recv_frame(sock)
    finally:
        sock.close()
    if frame is None or frame.get("type") != "status_ok":
        raise RuntimeError(
            f"status request got {frame.get('type') if frame else 'EOF'!r}, "
            "expected status_ok"
        )
    return frame


def evaluate_slo(payload: dict, targets: dict | None = None) -> dict:
    """Judge one status payload against declared SLO targets.

    Returns ``{"verdict": "OK"|"VIOLATED", "checks": [...]}`` where each
    check carries ``name``/``value``/``target``/``ok`` — an unmeasured
    value (no traffic yet) passes with ``value: None`` rather than
    flagging an idle server.  Rates: ``drop_rate`` is tap drops over tap
    offers; ``evict_rate`` is evictions over finished sessions (evicted +
    closed) — both 0 when the denominator is 0.
    """
    targets = {**DEFAULT_SLO, **(targets or {})}
    counters = status_section(payload, "counters")
    latency = status_section(payload, "latency")
    checks = []

    def check(name, value, target, lower_is_better=True):
        ok = True if value is None else (
            value <= target if lower_is_better else value >= target)
        checks.append({"name": name, "value": value, "target": target,
                       "ok": ok})

    lat = latency.get("serve_block_latency_ms") or {}
    check("serve_p95_ms", lat.get("p95"), targets["serve_p95_ms"])
    wait = latency.get("serve_queue_wait_ms") or {}
    check("queue_wait_p95_ms", wait.get("p95"), targets["queue_wait_p95_ms"])

    offered = counters.get("tap_blocks", 0) + counters.get("tap_dropped", 0)
    drop_rate = counters.get("tap_dropped", 0) / offered if offered else 0.0
    check("drop_rate", round(drop_rate, 6), targets["max_drop_rate"])

    finished = counters.get("session_evicted", 0) + counters.get("session_closed", 0)
    evict_rate = (counters.get("session_evicted", 0) / finished
                  if finished else 0.0)
    check("evict_rate", round(evict_rate, 6), targets["max_evict_rate"])

    return {
        "verdict": "OK" if all(c["ok"] for c in checks) else "VIOLATED",
        "checks": checks,
    }
