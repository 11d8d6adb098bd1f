"""Append-only JSONL event log (the port's copy of
``disco_tpu/obs/events.py``).

Every event is one JSON object per line::

    {"t": <unix wall time>, "kind": <str>, "stage": <str|null>, "attrs": {...}}

``kind`` is one of :data:`EVENT_KINDS`; ``stage`` names the pipeline stage
the event describes (null for run-scoped events like the manifest).  The
schema, the closed kind set, the rotation and the reader are the JAX
package's, so each package reads the other's logs.  The log is a sideband:
nothing here writes to stdout, and the process-global :class:`Recorder` is
a strict no-op while disabled (one attribute check and return).

The run manifest names the port's stack: the ``torch``, ``numpy`` and
``scipy`` versions, and the CUDA device (``platform="gpu"``, the device
count and ``torch.cuda.get_device_name()``) where the JAX package records
JAX's backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

#: The closed set of event kinds, the JAX package's: a log either package
#: writes passes the other's :func:`validate_event`.
EVENT_KINDS = frozenset(
    {
        "manifest",     # run header: git SHA, backend, devices, config, versions
        "stage_end",    # a timed pipeline stage finished (attrs: dur_s, fences, ...)
        "clip",         # one clip/RIR fully enhanced + persisted
        "epoch",        # one training epoch (attrs: train_loss, val_loss, steps)
        "jit_trace",    # a counted_jit entry point (re)compiled
        "sentinel",     # numerics watchdog tripped (attrs: tensor stats)
        "counters",     # metrics-registry snapshot (usually last event of a run)
        "watchdog",     # bench watchdog fired (no-progress diagnostic)
        "bench_result", # the full bench record, mirrored off stdout
        "fault",        # an injected or detected fault (attrs: fault, node, ...)
        "recovery",     # a retried operation succeeded (utils.resilience)
        "degraded",     # the pipeline entered degraded mode (excluded streams)
        "run_start",    # a crash-safe run began (attrs: preflight, ledger, ...)
        "run_resume",   # a run resumed from its ledger (attrs: done/requeued counts)
        "session",      # serve session lifecycle (attrs: action=open/close/evict/drain)
        "tap",          # flywheel corpus-tap lifecycle (attrs: action=shard/close)
        "interrupted",  # graceful stop requested (SIGTERM/SIGINT; runs.interrupt)
        "warning",      # degraded input / requeued unit — visible, non-fatal
        "span",         # one causal-trace hop (obs.trace; attrs: trace/span/parent)
        "flight",       # a flight-recorder dump landed (obs.flight; attrs: trigger/path)
        "promotion",    # a weight generation staged/adopted/promoted (promote/)
        "canary",       # canary window lifecycle (attrs: action=assign/score/window)
        "rollback",     # a demoted candidate rolled back (attrs: reason, failing metric)
        "generation",   # resident trainer published a generation (flywheel/resident)
        "train_throttled",  # ladder rung paused/resumed resident training
        "scene",        # one simulated scene batch (scenes/; attrs: epoch, index, n_scenes)
        "note",         # freeform annotation
    }
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One telemetry event (the in-memory twin of a JSONL line)."""

    kind: str
    stage: str | None
    t_wall: float
    attrs: dict

    def to_json(self) -> str:
        return json.dumps(
            {"t": self.t_wall, "kind": self.kind, "stage": self.stage, "attrs": self.attrs},
            default=_jsonable,
        )


def _jsonable(x):
    """Last-resort JSON coercion: numpy scalars -> python, else repr.  An
    unserializable attr must degrade to a string, never raise — recording can
    be called from exception handlers and watchdog threads."""
    if hasattr(x, "item"):
        try:
            return x.item()
        except Exception:
            pass
    return repr(x)


class Recorder:
    """Process-global JSONL event sink.

    Strict no-op while inactive: :meth:`record` returns after a single
    attribute check (``_active`` folds the JSONL sink and the flight-ring
    sink into one flag — see :func:`refresh_sinks`).  When enabled, lines
    are appended and flushed per event (the watchdog path calls
    ``os._exit`` right after recording), behind a lock (the batched driver
    scores on a thread pool; serving records from its I/O and dispatch
    threads).

    **Rotation**: ``enable(path, max_bytes=N)`` bounds the live file — once
    an append pushes it past ``N`` bytes the file is atomically renamed to
    the next numbered segment (``events.jsonl`` → ``events.1.jsonl``,
    ``events.2.jsonl``, ...; ``os.replace``, so a crash never leaves a
    half-rotated log) and a fresh live file is opened.  :func:`read_events`
    transparently spans the rotated segments in order, tolerating a torn
    final line at each rotation seam (a crash mid-append before the next
    process rotated) — long soak/serve runs no longer grow one file
    without bound.
    """

    def __init__(self):
        self.enabled = False
        self.path: Path | None = None
        self.max_bytes: int | None = None
        self.rotations = 0
        self._fh = None
        self._lock = threading.Lock()
        #: the armed FlightRecorder (obs.flight), or None — events fan out
        #: to its ring even when the JSONL sink is off
        self._flight = None
        self._active = False

    def _refresh_active(self) -> None:
        fl = self._flight
        self._active = self.enabled or (fl is not None and fl.enabled)

    def enable(self, path, max_bytes: int | None = None) -> None:
        if max_bytes is not None and int(max_bytes) < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self.path = Path(path)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
            self.max_bytes = int(max_bytes) if max_bytes is not None else None
            self.rotations = 0
            self.enabled = True
            self._refresh_active()

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self.path = None
            self.max_bytes = None
            self._refresh_active()

    def record(self, kind: str, stage: str | None = None, **attrs) -> Event | None:
        if not self._active:
            return None
        ev = Event(kind=kind, stage=stage, t_wall=time.time(), attrs=attrs)
        fl = self._flight
        if fl is not None:
            fl.add(stage or kind, kind, attrs, ev.t_wall)
        if not self.enabled:
            return ev
        with self._lock:
            if self._fh is None:  # disabled between the check and the lock
                return None
            self._fh.write(ev.to_json() + "\n")
            self._fh.flush()
            if self.max_bytes is not None and self._fh.tell() >= self.max_bytes:
                self._rotate_locked()
        return ev

    def _rotate_locked(self) -> None:
        """Roll the live file over to the next numbered segment (caller
        holds the lock).  The rename is atomic; the live path is reopened
        fresh, so every line lives in exactly one segment."""
        self._fh.close()
        n = self.rotations + 1
        while True:  # a re-enabled path may already have older segments
            target = _segment_path(self.path, n)
            if not target.exists():
                break
            n += 1
        os.replace(self.path, target)
        self.rotations = n
        self._fh = open(self.path, "a")


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process-global :class:`Recorder`."""
    return _RECORDER


def enabled() -> bool:
    """True while the process-global recorder is recording."""
    return _RECORDER.enabled


def active() -> bool:
    """True while ANY event sink is live: the JSONL recorder OR the
    flight-recorder ring (the flag :meth:`Recorder.record` gates on).
    Opt-in instrumentation that should run in post-mortem-only mode — the
    numerics sentinels under ``--flight-dir`` without ``--obs-log`` —
    gates on this, not :func:`enabled`."""
    return _RECORDER._active


def enable(path, max_bytes: int | None = None) -> None:
    """Start recording to ``path`` (JSONL, append).  ``max_bytes`` arms
    size-bounded rotation (see :class:`Recorder`)."""
    _RECORDER.enable(path, max_bytes=max_bytes)


def refresh_sinks() -> None:
    """Re-derive the recorder's one-check activity flag from its sinks
    (called by ``obs.flight`` enable/disable — the flight ring receives
    events even while the JSONL sink is off, without adding a second check
    to the disabled hot path)."""
    from disco_tpu_torch.obs import flight as _flight_mod

    fl = _flight_mod.flight()
    _RECORDER._flight = fl if fl.enabled else None
    _RECORDER._refresh_active()


def disable() -> None:
    """Stop recording on the process-global recorder and close the log."""
    _RECORDER.disable()


def record(kind: str, stage: str | None = None, **attrs) -> Event | None:
    """Record one event on the process-global recorder (no-op when disabled)."""
    return _RECORDER.record(kind, stage=stage, **attrs)


@contextlib.contextmanager
def recording(path, max_bytes: int | None = None):
    """Scoped recording: enable for the block, disable after (test helper and
    the CLI wiring — guarantees the file handle is released)."""
    enable(path, max_bytes=max_bytes)
    try:
        yield _RECORDER
    finally:
        disable()


@contextlib.contextmanager
def stage(name: str, **attrs):
    """Time a pipeline stage and record a ``stage_end`` event with its
    duration and the fence-count delta across the block.

    Disabled fast path: plain ``yield`` — no clock read, no dict build.
    The fence delta is this thread's host readbacks inside the block
    (``obs.accounting``): the stage that waited on the device pays them.
    """
    if not _RECORDER._active:
        yield
        return
    from disco_tpu_torch.obs import accounting

    # Per-thread fence delta: the batched driver runs stages concurrently on
    # scoring workers; the process-wide count would cross-attribute fences.
    f0 = accounting.fence_count_thread()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        # measured keys win over caller attrs (never crash on a collision)
        record(
            "stage_end",
            stage=name,
            **{**attrs,
               "dur_s": round(dur, 6),
               "fences": accounting.fence_count_thread() - f0},
        )


def _git_sha() -> str | None:
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=Path(__file__).resolve().parents[2],
            capture_output=True,
            text=True,
            timeout=10,
        )
        return out.stdout.strip() or None
    except Exception:
        return None


def _versions() -> dict:
    from importlib import metadata

    vers = {"python": sys.version.split()[0]}
    for pkg in ("torch", "numpy", "scipy"):
        try:
            vers[pkg] = metadata.version(pkg)
        except Exception:
            vers[pkg] = None
    return vers


def _device_fields() -> tuple:
    """(platform, device count, device kind) of the CUDA device, or
    ("cpu", 0, None) without one; nulls if torch cannot say."""
    try:
        import torch

        if not torch.cuda.is_available():
            return "cpu", 0, None
        return "gpu", torch.cuda.device_count(), torch.cuda.get_device_name()
    except Exception:
        return None, None, None


def write_manifest(config: dict | None = None, **extra) -> Event | None:
    """Record the run manifest: git SHA, the device (platform, count and
    kind), the run's config dict, and package versions.

    Called once at startup (after ``enable``).  Every field is guarded: a
    broken git checkout or a device that cannot be queried degrades to
    nulls, never breaks the run being observed.
    """
    if not _RECORDER.enabled:
        return None
    platform, device_count, device_kind = _device_fields()
    return record(
        "manifest",
        git_sha=_git_sha(),
        platform=platform,
        device_count=device_count,
        device_kind=device_kind,
        argv=list(sys.argv),
        cwd=os.getcwd(),
        config=config or {},
        versions=_versions(),
        **extra,
    )


def validate_event(d: dict) -> None:
    """Raise ``ValueError`` if ``d`` is not a schema-conforming event dict.
    The JAX package's schema: its reader and this one accept the same
    lines."""
    for key in ("t", "kind", "stage", "attrs"):
        if key not in d:
            raise ValueError(f"event missing key {key!r}: {d}")
    if not isinstance(d["t"], (int, float)):
        raise ValueError(f"event 't' must be a number, got {d['t']!r}")
    if d["kind"] not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {d['kind']!r} (known: {sorted(EVENT_KINDS)})")
    if d["stage"] is not None and not isinstance(d["stage"], str):
        raise ValueError(f"event 'stage' must be a string or null, got {d['stage']!r}")
    if not isinstance(d["attrs"], dict):
        raise ValueError(f"event 'attrs' must be an object, got {d['attrs']!r}")


def _segment_path(path: Path, n: int) -> Path:
    """Rotated-segment path ``n`` of a live log (``events.jsonl`` →
    ``events.1.jsonl``)."""
    return path.with_name(f"{path.stem}.{n}{path.suffix}")


def rotated_segments(path) -> list[Path]:
    """The live log's rotated segments, oldest first (``events.1.jsonl``
    before ``events.2.jsonl``).  Pure discovery — missing segments are
    simply absent (a cleaned-up tail is legal)."""
    path = Path(path)
    prefix, suffix = path.stem + ".", path.suffix
    found = []
    for p in path.parent.glob(f"{path.stem}.*{path.suffix}"):
        mid = p.name[len(prefix):len(p.name) - len(suffix)] if suffix else \
            p.name[len(prefix):]
        if mid.isdigit():
            found.append((int(mid), p))
    return [p for _n, p in sorted(found)]


def _read_one(path, validate: bool, tolerate_torn_tail: bool) -> list[dict]:
    """One file's events.  ``tolerate_torn_tail`` skips a final line that is
    not valid JSON — the rotation-seam tear (a crash mid-append whose file
    was later rotated); a bad line anywhere ELSE still raises, and schema
    violations always raise."""
    with open(path) as fh:
        raw = [(i, ln.strip()) for i, ln in enumerate(fh, 1)]
    raw = [(i, ln) for i, ln in raw if ln]
    events = []
    for pos, (lineno, line) in enumerate(raw):
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            if tolerate_torn_tail and pos == len(raw) - 1:
                break  # the torn final line of a rotated segment
            raise ValueError(f"{path}:{lineno}: not valid JSON: {e}") from None
        if validate:
            try:
                validate_event(d)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
        events.append(d)
    return events


def read_events(path, validate: bool = True) -> list[dict]:
    """Load a JSONL event log (the ``cli/obs.py report`` input), spanning
    any rotated segments (``events.1.jsonl``, ``events.2.jsonl``, ...,
    oldest first, then the live file).  A torn final line at a rotation
    seam is skipped — the crash-mid-append shape rotation can strand —
    while any other malformed line still raises."""
    segments = rotated_segments(path)
    events = []
    for seg in segments:
        events.extend(_read_one(seg, validate, tolerate_torn_tail=True))
    events.extend(_read_one(path, validate, tolerate_torn_tail=False))
    return events
