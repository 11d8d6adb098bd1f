"""Counters, gauges and histograms, and the stage timer (the port's copy
of ``disco_tpu/obs/metrics.py``).

Named :class:`Counter` (monotonic), :class:`Gauge` (last value) and
:class:`Histogram` (count/total/min/max plus p50/p95/p99 from a bounded,
seeded reservoir) instruments, a process-global :data:`REGISTRY` with a
``snapshot()`` dict and a pretty-printer, and the profiling tools
:class:`StageTimer` and :func:`trace_to`.  The instruments and the
snapshot are the JAX package's, number for number: the same samples give
the same percentiles and the same snapshot.  Where the JAX package waits
for device work (``jax.block_until_ready``) and traces (``jax.profiler``),
the port calls ``torch.cuda.synchronize`` and ``torch.profiler``; torch is
imported only inside those two, so reading an event log never imports it.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time


class Counter:
    """Monotonic named count (fences, readbacks, clips, serve blocks).
    Locked: the batched driver increments from scoring worker threads while
    the main thread ticks fences — ``+=`` alone can drop increments."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self.value += n
            return self.value


class Gauge:
    """Last-value instrument (current loss, current RTF)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = float(v)


#: Retained-sample cap per histogram.  Percentiles (``p50``/``p95``/``p99``
#: in :meth:`Histogram.summary`) come from this bounded reservoir, so a
#: long-lived process (the online enhancement server's request-latency
#: histograms) cannot grow host memory without bound.  Below the cap the
#: percentiles are exact over every observation; past it, classic reservoir
#: sampling keeps a uniform subsample (deterministically seeded — the same
#: observation stream always yields the same report).
RESERVOIR_SIZE = 2048


class Histogram:
    """Streaming count/total/min/max summary plus p50/p95/p99 from a bounded
    sample reservoir (per-clip durations, per-request serve latencies)."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples", "_rng", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list[float] = []
        self._rng = random.Random(0xD15C0)
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) < RESERVOIR_SIZE:
                self._samples.append(v)
            else:  # reservoir: keep each of the count observations w.p. R/count
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_SIZE:
                    self._samples[j] = v

    @staticmethod
    def _percentile(ordered: list[float], q: float):
        """Linear-interpolated percentile over a sorted sample list (the
        numpy default definition, so tests can pin against np.percentile)."""
        if not ordered:
            return None
        pos = (q / 100.0) * (len(ordered) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ordered) - 1)
        return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)

    def percentile(self, q: float):
        """The q-th percentile of the retained samples (exact while count <=
        RESERVOIR_SIZE; a uniform-subsample estimate beyond)."""
        with self._lock:
            ordered = sorted(self._samples)
        return self._percentile(ordered, q)

    def reset(self) -> None:
        """Zero in place (a caller resets the latency histograms between
        a warm-up and a timed run, so p95 measures serving, not the first
        call's kernel build)."""
        with self._lock:
            self.count, self.total, self.min, self.max = 0, 0.0, None, None
            self._samples.clear()

    def summary(self) -> dict:
        with self._lock:
            ordered = sorted(self._samples)
            count, total = self.count, self.total
            vmin, vmax = self.min, self.max
        return {
            "count": count,
            "total": total,
            "mean": total / count if count else None,
            "min": vmin,
            "max": vmax,
            "p50": self._percentile(ordered, 50.0),
            "p95": self._percentile(ordered, 95.0),
            "p99": self._percentile(ordered, 99.0),
        }


class Registry:
    """Named instruments, get-or-create.  ``reset()`` zeroes values in place
    so module-level bindings (e.g. the fence counter in ``obs.accounting``)
    stay live across test resets."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def peek_counter(self, name: str) -> int:
        """A counter's value WITHOUT creating it (0 when absent).  Readers
        (``accounting.recompile_count``) must not materialize zero-valued
        instruments as a side effect — every counter created here appears
        in ``snapshot()`` and therefore in every later report."""
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else 0

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name)
            return self._histograms[name]

    def snapshot(self) -> dict:
        """{'counters': {name: int}, 'gauges': {...}, 'histograms': {...}} —
        plain JSON-ready values, the payload of a ``counters`` event."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary() for k, h in self._histograms.items()},
            }

    def pretty(self) -> str:
        snap = self.snapshot()
        lines = []
        for name, v in sorted(snap["counters"].items()):
            lines.append(f"counter    {name:28s} {v}")
        for name, v in sorted(snap["gauges"].items()):
            lines.append(f"gauge      {name:28s} {v if v is None else f'{v:g}'}")
        for name, s in sorted(snap["histograms"].items()):
            fmt = lambda v: f"{v:g}" if v is not None else "-"
            lines.append(
                f"histogram  {name:28s} n={s['count']} total={fmt(s['total'])} "
                f"mean={fmt(s['mean'])} p50={fmt(s.get('p50'))} "
                f"p95={fmt(s.get('p95'))} p99={fmt(s.get('p99'))}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = None
            for h in self._histograms.values():
                h.reset()


#: Process-global registry — the single place run counters accumulate.
REGISTRY = Registry()


class StageTimer:
    """Accumulate named wall-clock stage timings.

    ``stage(name, block_on=x)`` waits for the device work queued so far
    (``torch.cuda.synchronize()`` on ``x``'s CUDA device) before it stops
    the clock, so the stage's time includes that work; nothing is waited
    for when ``x`` is not a CUDA tensor (or a list, tuple or dict holding
    one) or ``sync=False``.

    >>> t = StageTimer()
    >>> with t.stage("stft"):
    ...     pass
    >>> "stft" in t.report()
    True
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and self.sync:
                dev = _cuda_device_of(block_on)
                if dev is not None:
                    import torch

                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        """{stage: {'total_s', 'calls', 'mean_s'}} sorted by total time."""
        out = {
            k: {"total_s": v, "calls": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.times.items()
        }
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_s"]))

    def pretty(self) -> str:
        lines = [f"{k:24s} {v['total_s']:9.4f}s  x{v['calls']:<5d} {v['mean_s']*1e3:9.3f} ms/call"
                 for k, v in self.report().items()]
        return "\n".join(lines)


def _cuda_device_of(tree):
    """The device of the first CUDA tensor in ``tree`` (a tensor, or a
    list, tuple or dict of them), else None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _cuda_device_of(v)
            if dev is not None:
                return dev
        return None
    dev = getattr(tree, "device", None)
    return dev if getattr(dev, "type", None) == "cuda" else None


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where CUDA is
    available, CUDA activities) and export a Chrome trace to
    ``<logdir>/trace.json`` (open it in ``chrome://tracing`` or Perfetto).
    The JAX package writes a ``jax.profiler`` trace here.  No-op (with a
    note) if the profiler cannot start: tracing must never break the
    pipeline it observes."""
    from pathlib import Path

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - backend-specific
        print(f"[profiling] trace unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            out = Path(logdir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
