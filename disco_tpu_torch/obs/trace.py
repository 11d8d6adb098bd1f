"""Causal tracing: end-to-end spans from a client block to its delivery
(the port's copy of ``disco_tpu/obs/trace.py``; stdlib only).

A ``trace_id``/``span_id``/``parent_id`` triple is minted at client block
submission (:func:`root`), carried in the ``block`` protocol frame
(``frame["trace"]``; absent for untraced clients, which are served
unchanged), and advanced one hop at a time (:func:`span`) through

    client_block -> enqueue -> dispatch -> readback -> deliver

Each hop is one ``span`` obs event whose ``stage`` names the hop (the
closed set :data:`SPAN_STAGES`) and whose attrs carry
``trace``/``span``/``parent`` plus the hop's attribution (queue wait at
dispatch, readback duration, delivery latency).  :func:`chain` rebuilds a
trace from an event log and :func:`verify_chain` checks it; both read logs
of either package, since the spans and the event schema are the JAX
package's.

The process-global :class:`Tracer` is a strict no-op while disabled: every
entry point returns after one attribute check.  When enabled, spans flow
to the JSONL event log (if recording is on) and to the flight recorder ring
(if armed).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid

from disco_tpu_torch.obs import events as _events

#: The closed set of span stages (hop names), the JAX package's: a typo'd
#: hop would break every chain reconstruction that expects the canonical
#: names.
SPAN_STAGES = frozenset(
    {
        "client_block",  # root: one input block submitted by a serve client
        "enqueue",       # scheduler accepted the block into a session queue
        "dispatch",      # the block's device program was queued (per super-tick group)
        "readback",      # the tick's ONE batched readback brought it host-side
        "deliver",       # the enhanced block was handed to the connection writer
        "tap",           # the corpus tap spooled the delivered tuple
        "train_batch",   # a ShardDataset read the tapped record into training windows
        "promote_stage",   # root of a promotion rollout: candidate staged
        "promote_canary",  # canary sessions assigned onto the candidate
        "promote_gate",    # the SDR/SLO gate verdict was computed
        "promote_swap",    # the rollout's terminal swap (promote or rollback)
    }
)

#: Canonical hop order for waterfall rendering and chain validation (the
#: serve chain; ``train_batch`` happens in a later process and is ordered
#: last when present).
STAGE_ORDER = ("client_block", "enqueue", "dispatch", "readback", "deliver",
               "tap", "train_batch",
               # the promotion-rollout chain is its own waterfall (a rollout,
               # not a block, is the traced unit — promote/controller.py)
               "promote_stage", "promote_canary", "promote_gate",
               "promote_swap")

#: Bound on tracked in-flight spans (the ``status`` frame's inflight
#: section); beyond it new entries are dropped, never an error.
MAX_INFLIGHT = 4096


@dataclasses.dataclass(frozen=True)
class SpanCtx:
    """One trace's moving head: the trace id plus the id of the most recent
    hop (the parent of the next hop).  Immutable — every hop returns an
    advanced copy, so a failed dispatch's retry re-advances from the same
    parent instead of chaining onto the failed attempt."""

    trace: str
    span: str

    def to_wire(self) -> dict:
        """The protocol-frame / shard-record representation."""
        return {"trace": self.trace, "span": self.span}


def new_id() -> str:
    """A fresh 64-bit hex span/trace id (uuid4-derived — unique across the
    client and server processes that share one trace)."""
    return uuid.uuid4().hex[:16]


def from_wire(d) -> SpanCtx | None:
    """Validate a wire-decoded ``frame["trace"]`` dict into a
    :class:`SpanCtx`; None for absent/malformed headers (a pre-span client
    MUST be served unchanged, so a bad header degrades to untraced, never
    raises)."""
    if not isinstance(d, dict):
        return None
    trace, span = d.get("trace"), d.get("span")
    if not isinstance(trace, str) or not isinstance(span, str):
        return None
    if not trace or not span or len(trace) > 64 or len(span) > 64:
        return None
    return SpanCtx(trace=trace, span=span)


class Tracer:
    """Process-global span sink (the :class:`~disco_tpu_torch.obs.events.Recorder`
    contract): strict no-op while disabled, one attribute check per call.

    When enabled, each hop records a ``span`` event through the obs
    recorder (sideband JSONL when recording is on, flight ring when the
    flight recorder is armed — :mod:`disco_tpu_torch.obs.events` fans out) and
    maintains the bounded in-flight table the serve ``status`` frame
    reports.
    """

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        #: {key: {"trace", "stage", "session", "seq", "t"}} — blocks whose
        #: chain has started but not reached ``deliver`` yet
        self._inflight: dict = {}
        self.spans_recorded = 0

    def enable(self) -> None:
        with self._lock:
            self._inflight.clear()
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._inflight.clear()

    # -- span recording ------------------------------------------------------
    def root(self, stage: str = "client_block", **attrs) -> SpanCtx | None:
        """Mint a new trace and record its root span (parent null).  None
        while disabled — callers thread the None through and every later
        hop no-ops."""
        if not self.enabled:
            return None
        ctx = SpanCtx(trace=new_id(), span=new_id())
        self._record(stage, ctx, parent=None, **attrs)
        return ctx

    def span(self, stage: str, ctx: SpanCtx | None, **attrs) -> SpanCtx | None:
        """Record one hop: mints a child span id under ``ctx`` and returns
        the advanced context.  No-op (returns ``ctx`` unchanged) while
        disabled or when ``ctx`` is None (an untraced block)."""
        if not self.enabled or ctx is None:
            return ctx
        child = SpanCtx(trace=ctx.trace, span=new_id())
        self._record(stage, child, parent=ctx.span, **attrs)
        return child

    def record_span(self, stage: str, ctx: SpanCtx | None, *,
                    parent: str | None, **attrs) -> None:
        """Record a hop for an ALREADY-minted context (mint-then-commit:
        the corpus tap mints its span id into the shard record first and
        records the event only once the spool accepted the block — a
        dropped block must never log a hop it did not take)."""
        if not self.enabled or ctx is None:
            return
        self._record(stage, ctx, parent=parent, **attrs)

    def _record(self, stage: str, ctx: SpanCtx, parent: str | None, **attrs):
        with self._lock:
            # spans flow in from the I/O thread (client block arrival), the
            # dispatch thread (enqueue/dispatch/readback hops) and main —
            # += alone drops counts exactly like the metrics Counter would
            self.spans_recorded += 1
        _events.record("span", stage=stage, trace=ctx.trace, span=ctx.span,
                       parent=parent, **attrs)

    # -- in-flight table (the status frame's live view) ----------------------
    def inflight_begin(self, key, ctx: SpanCtx | None, stage: str,
                       **info) -> None:
        """Track one block's chain as in flight (bounded; overflow drops)."""
        if not self.enabled or ctx is None:
            return
        with self._lock:
            if len(self._inflight) >= MAX_INFLIGHT and key not in self._inflight:
                return
            self._inflight[key] = {"trace": ctx.trace, "stage": stage,
                                   "t": time.time(), **info}

    def inflight_update(self, key, stage: str) -> None:
        """Advance an in-flight block's current stage."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._inflight.get(key)
            if entry is not None:
                entry["stage"] = stage

    def inflight_end(self, key) -> None:
        """The block reached delivery: drop it from the live table."""
        if not self.enabled:
            return
        with self._lock:
            self._inflight.pop(key, None)

    def inflight_snapshot(self, limit: int = 32) -> dict:
        """{"count", "oldest_s", "spans": [...]} — the ``status`` frame's
        inflight section (``spans`` capped at ``limit`` oldest-first)."""
        now = time.time()
        with self._lock:
            entries = sorted(self._inflight.items(), key=lambda kv: kv[1]["t"])
        spans = [
            {"key": list(k) if isinstance(k, tuple) else k,
             "age_s": round(now - v["t"], 6),
             **{kk: vv for kk, vv in v.items() if kk != "t"}}
            for k, v in entries[:limit]
        ]
        return {
            "count": len(entries),
            "oldest_s": round(now - entries[0][1]["t"], 6) if entries else None,
            "spans": spans,
        }


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global :class:`Tracer`."""
    return _TRACER


def enabled() -> bool:
    """True while causal tracing is on."""
    return _TRACER.enabled


def enable() -> None:
    """Turn on causal tracing process-wide (``disco-serve --trace``,
    the scope-check gate)."""
    _TRACER.enable()


def disable() -> None:
    """Turn causal tracing off (back to the strict no-op contract)."""
    _TRACER.disable()


def root(stage: str = "client_block", **attrs) -> SpanCtx | None:
    """Module-level :meth:`Tracer.root` on the process-global tracer."""
    return _TRACER.root(stage, **attrs)


def span(stage: str, ctx: SpanCtx | None, **attrs) -> SpanCtx | None:
    """Module-level :meth:`Tracer.span` on the process-global tracer."""
    return _TRACER.span(stage, ctx, **attrs)


def record_span(stage: str, ctx: SpanCtx | None, *, parent: str | None,
                **attrs) -> None:
    """Module-level :meth:`Tracer.record_span` on the process-global
    tracer (the mint-then-commit form)."""
    _TRACER.record_span(stage, ctx, parent=parent, **attrs)


# -- reconstruction (the reader side) -----------------------------------------
def spans_of(events: list, trace_id: str) -> list:
    """Every ``span`` event of one trace, in record order."""
    return [e for e in events
            if e.get("kind") == "span" and e["attrs"].get("trace") == trace_id]


def trace_ids(events: list) -> list:
    """Distinct trace ids in first-appearance order (the ``disco-obs trace
    <log>`` listing)."""
    seen: dict = {}
    for e in events:
        if e.get("kind") == "span":
            seen.setdefault(e["attrs"].get("trace"), None)
    return [t for t in seen if t]


def chain(events: list, trace_id: str, *, end_stage: str | None = None) -> list:
    """Reconstruct one trace's causal chain by walking ``parent`` links
    backward from its terminal span; returns the spans root-first.

    ``end_stage`` picks the terminal hop explicitly (e.g. ``"deliver"`` for
    the serve chain, ``"tap"`` when the corpus tap ran); default: the last
    recorded span of the trace.  Spans off the main path — a failed
    dispatch attempt whose retry re-chained from the same parent — are
    left out by construction: the walk only follows the surviving links.
    Raises :class:`ValueError` when a parent link is dangling (a broken
    chain must fail loudly — scope-check turns this into a gate failure).
    """
    spans = spans_of(events, trace_id)
    if not spans:
        raise ValueError(f"trace {trace_id!r}: no span events")
    by_id = {e["attrs"]["span"]: e for e in spans}
    if end_stage is not None:
        tails = [e for e in spans if e["stage"] == end_stage]
        if not tails:
            raise ValueError(
                f"trace {trace_id!r}: no {end_stage!r} span — the chain "
                f"never reached its terminal hop "
                f"(stages seen: {sorted({e['stage'] for e in spans})})"
            )
        tail = tails[-1]
    else:
        tail = spans[-1]
    path = [tail]
    seen = {tail["attrs"]["span"]}
    while path[-1]["attrs"].get("parent") is not None:
        parent = path[-1]["attrs"]["parent"]
        if parent not in by_id:
            if path[-1]["stage"] in ("enqueue", "train_batch"):
                # legitimate cross-process chain heads: an enqueue span's
                # parent is the client's root (it lives in the CLIENT
                # process's log), and a train_batch span's parent is the
                # tap span (it lives in the SERVER process's log) — a
                # single-process log starts its view of the trace here
                break
            raise ValueError(
                f"trace {trace_id!r}: span {path[-1]['attrs']['span']} names "
                f"parent {parent} but no such span was recorded — broken chain"
            )
        if parent in seen:
            raise ValueError(f"trace {trace_id!r}: parent cycle at {parent}")
        seen.add(parent)
        path.append(by_id[parent])
    return list(reversed(path))


def verify_chain(events: list, trace_id: str, *, require: tuple,
                 end_stage: str | None = None) -> list:
    """:func:`chain` plus a stage-coverage assertion: the reconstructed
    path must visit every stage in ``require`` (order-checked against
    :data:`STAGE_ORDER`).  Returns the chain; raises :class:`ValueError`
    with the missing/misordered hops named — the scope-check failure shape.
    """
    path = chain(events, trace_id, end_stage=end_stage or (require[-1] if require else None))
    stages = [e["stage"] for e in path]
    missing = [s for s in require if s not in stages]
    if missing:
        raise ValueError(
            f"trace {trace_id!r}: chain missing hop(s) {missing} "
            f"(got {stages})"
        )
    order = [STAGE_ORDER.index(s) for s in stages if s in STAGE_ORDER]
    if order != sorted(order):
        raise ValueError(
            f"trace {trace_id!r}: hops out of causal order: {stages}"
        )
    return path


def render_waterfall(events: list, trace_id: str, width: int = 40) -> str:
    """The ``disco-obs trace`` waterfall: one line per hop with its offset
    from the root span, per-hop attribution (queue wait / readback duration
    / delivery latency) and a proportional bar.
    """
    path = chain(events, trace_id)
    t0 = path[0]["t"]
    t_end = max(e["t"] for e in path)
    total = max(t_end - t0, 1e-9)
    lines = [f"trace {trace_id}  ({len(path)} hops, "
             f"{total * 1e3:.2f} ms client-to-tail)"]
    lines.append(f"{'hop':<14}{'+ms':>10}  {'attribution':<28} waterfall")
    for e in path:
        off = e["t"] - t0
        a = e["attrs"]
        attribution = ""
        for key, label in (("wait_ms", "queue-wait"), ("readback_ms", "readback"),
                           ("latency_ms", "latency"), ("dur_ms", "dur")):
            if a.get(key) is not None:
                attribution += f"{label}={a[key]:.2f}ms "
        if a.get("failed"):
            attribution += f"FAILED: {a.get('error', '?')} "
        if a.get("tick") is not None:
            attribution += f"tick={a['tick']} "
        pos = int(off / total * (width - 1))
        bar = "." * pos + "#"
        lines.append(f"{e['stage']:<14}{off * 1e3:>10.2f}  {attribution:<28} {bar}")
    sess = next((e["attrs"].get("session") for e in path
                 if e["attrs"].get("session") is not None), None)
    seq = next((e["attrs"].get("seq") for e in path
                if e["attrs"].get("seq") is not None), None)
    if sess is not None:
        lines.append(f"session={sess}  seq={seq}")
    return "\n".join(lines)
