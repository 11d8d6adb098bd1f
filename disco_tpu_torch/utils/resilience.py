"""Bounded retry and backoff around the device seams, the dispatch
watchdog and the preflight probe (the port's copy of
``disco_tpu/utils/resilience.py``).

Recovery is in-process: a failed call is retried with bounded exponential
backoff under an overall deadline, and when the budget runs out the error
is raised and the caller unwinds cleanly.  Every retry is telemetry: each
failed attempt records a ``fault`` event (``transient_error``) and ticks
``retries``; a success after a failure records a ``recovery`` event and
ticks ``retry_recoveries``; an exhausted budget ticks ``retry_giveups``.

**What counts as transient** (:data:`TRANSPORT_ERRORS`).  The JAX package
retries ``ConnectionError``, ``TimeoutError``, ``OSError`` and JAX's
runtime error, the form a dropped device round-trip takes there.  The port
retries the first three and ``torch.OutOfMemoryError``: an allocation that
fails while other work holds the card's memory can pass once that work
frees it.  It retries neither a bare ``RuntimeError`` nor
``torch.AcceleratorError``: a device-side fault (an illegal address, a
failed launch) leaves the CUDA context unusable, so a retry can only burn
the budget, and a deterministic error must raise at once.

The seams: :func:`resilient_fence` (a device synchronize plus a
one-element readback), :func:`resilient_to_host` and
:func:`resilient_to_device` (the batched copies of ``device.to_host`` and
``device.as_device_tensors``), :class:`DispatchDeadline` (a host-only
watchdog of one dispatch window) and :func:`preflight_probe`.
"""
from __future__ import annotations

import functools
import random
import threading
import time

import torch

from disco_tpu_torch.obs import accounting as _accounting
from disco_tpu_torch.obs import events as _events
from disco_tpu_torch.obs.metrics import REGISTRY as _REGISTRY

_RETRIES = _REGISTRY.counter("retries")
_RECOVERIES = _REGISTRY.counter("retry_recoveries")
_GIVEUPS = _REGISTRY.counter("retry_giveups")
_DEADLINE_HITS = _REGISTRY.counter("dispatch_deadline_hits")

#: Transport-layer exception types (module docstring): what a retry may
#: cure.  TypeError, ValueError and device-side faults raise at once.
TRANSPORT_ERRORS: tuple = (ConnectionError, TimeoutError, OSError, torch.OutOfMemoryError)


class DeadlineExceeded(TimeoutError):
    """The retry budget's wall-clock deadline ran out before a success."""


def call_with_retries(
    fn,
    *args,
    retries: int = 3,
    base_delay_s: float = 0.1,
    backoff: float = 2.0,
    max_delay_s: float = 2.0,
    deadline_s: float | None = None,
    retry_on: type | tuple = Exception,
    label: str | None = None,
    jitter: float = 0.0,
    jitter_seed: int = 0,
    sleep=time.sleep,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying transient failures.

    Args:
      retries: maximum number of RE-tries (so at most ``retries + 1``
        calls).
      base_delay_s / backoff / max_delay_s: exponential backoff
        ``min(base * backoff**i, max)`` between attempts — deterministic by
        default (``jitter=0``), so a seeded run's retry schedule is
        reproducible.
      jitter / jitter_seed: fraction of each backoff delay to SUBTRACT at
        random (``delay * (1 - jitter * u)``, ``u`` drawn from a
        ``random.Random(jitter_seed)`` stream, one draw per sleep, in
        ``[0, 1)``).  Desynchronizes the thundering herd of K parked
        clients all reconnecting after the same outage, while staying
        fully deterministic given the seed (same seed, same failure
        pattern → same schedule) and never exceeding the un-jittered
        delay — deadline accounting stays conservative.  ``jitter`` must
        be in ``[0, 1]``.
      deadline_s: overall wall budget from the first call; if the next
        backoff sleep would cross it, :class:`DeadlineExceeded` is raised
        (chained to the last error) instead of sleeping.
      retry_on: exception type(s) considered transient.  ``KeyboardInterrupt``
        and ``SystemExit`` are never caught (they do not inherit from
        ``Exception``): an operator abort unwinds immediately.
      label: telemetry name for the wrapped operation (events/``obs
        report``); defaults to the function's ``__name__``.
      sleep: injection point for tests.

    Returns ``fn``'s value; raises the last error once the budget is spent.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if not 0.0 <= jitter <= 1.0:
        raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    name = label or getattr(fn, "__name__", "call")
    rng = random.Random(jitter_seed) if jitter else None
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            out = fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            _RETRIES.inc()
            _events.record(
                "fault", stage=name, fault="transient_error",
                attempt=attempt, error=repr(e),
            )
            if attempt > retries:
                _GIVEUPS.inc()
                raise
            delay = min(base_delay_s * backoff ** (attempt - 1), max_delay_s)
            if rng is not None:
                delay *= 1.0 - jitter * rng.random()
            if deadline_s is not None and (time.monotonic() - t0) + delay > deadline_s:
                _GIVEUPS.inc()
                raise DeadlineExceeded(
                    f"{name}: retry deadline of {deadline_s}s exhausted after "
                    f"{attempt} failed attempt(s); last error: {e!r}"
                ) from e
            sleep(delay)
        else:
            if attempt:
                _RECOVERIES.inc()
                _events.record("recovery", stage=name, attempts=attempt + 1)
            return out


def retrying(**retry_opts):
    """Decorator form of :func:`call_with_retries`::

        @retrying(retries=5, deadline_s=30.0, label="fetch_chunk")
        def fetch_chunk(i): ...

    The wrapped function's kwargs are passed through a closure, NOT merged
    into :func:`call_with_retries`'s namespace — so a decorated function may
    freely take kwargs named ``retries``/``label``/``sleep``/... without
    colliding with the retry options fixed at decoration time.
    """

    def deco(fn):
        opts = dict(retry_opts)
        opts.setdefault("label", getattr(fn, "__name__", "call"))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retries(lambda: fn(*args, **kwargs), **opts)

        return wrapper

    return deco


def _fence_readback(x) -> float:
    """Wait for the device work queued before ``x`` and read one element
    of it back (``torch.cuda.synchronize()`` on a CUDA tensor, then
    ``.item()``); counts one fence.  The un-retried attempt the retrying
    seams wrap."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    val = float(x.reshape(-1)[0].item())
    _accounting.fence_tick()
    return val


def resilient_fence(x, **retry_opts) -> float:
    """:func:`_fence_readback` of ``x`` under caller-chosen retry budgets;
    each attempt counts its own fence."""
    retry_opts.setdefault("label", "fence")
    retry_opts.setdefault("retry_on", TRANSPORT_ERRORS)
    return call_with_retries(_fence_readback, x, **retry_opts)


def resilient_to_host(tensors, **retry_opts) -> list:
    """``device.to_host`` (float32 and complex64 tensors to host arrays in
    one copy) under bounded retry of :data:`TRANSPORT_ERRORS`; a dtype or
    shape error raises straight through."""
    from disco_tpu_torch.device import to_host

    retry_opts.setdefault("label", "to_host")
    retry_opts.setdefault("retry_on", TRANSPORT_ERRORS)
    return call_with_retries(to_host, tensors, **retry_opts)


def resilient_to_device(arrays, device=None, **retry_opts) -> list:
    """``device.as_device_tensors`` (arrays to float32 tensors on one
    device) under bounded retry of :data:`TRANSPORT_ERRORS`."""
    from disco_tpu_torch.device import as_device_tensors

    retry_opts.setdefault("label", "to_device")
    retry_opts.setdefault("retry_on", TRANSPORT_ERRORS)
    return call_with_retries(as_device_tensors, arrays, device, **retry_opts)


class DispatchDeadline:
    """Host-only wall-clock watchdog for one dispatch window.

    The watchdog never interrupts anything: it is a pure
    ``threading.Timer`` (no CUDA call, safe on any thread) that, when
    the deadline passes with the guarded block still running, marks the
    window **suspect**: flips :attr:`expired`, ticks the
    ``dispatch_deadline_hits`` counter, records a ``fault`` obs event (kind
    ``dispatch_deadline``) and calls the optional ``on_expire`` callback
    (host-only by contract).  The guarded code observes :attr:`expired`
    AFTER its (late) completion and decides what to do — the serve
    scheduler fences via :func:`preflight_probe` and then lets the
    degradation ladder choose retry vs. degrade.

    Usage::

        with DispatchDeadline(2.0, label="serve_tick") as dd:
            ...dispatch + readback...
        if dd.expired:
            ...probe, then degrade...
    """

    def __init__(self, deadline_s: float, *, label: str = "dispatch",
                 on_expire=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.label = label
        self.on_expire = on_expire
        self.expired = False
        self.t0: float | None = None
        self._timer: threading.Timer | None = None

    def _fire(self) -> None:
        # timer thread: host-only telemetry, never touches the device; a
        # one-way handoff: the timer only stores True, __enter__ resets it
        # before arming and __exit__ cancels before the next window
        self.expired = True
        _DEADLINE_HITS.inc()
        _events.record(
            "fault", stage=self.label, fault="dispatch_deadline",
            deadline_s=self.deadline_s,
        )
        if self.on_expire is not None:
            try:
                self.on_expire()
            except Exception:
                pass  # a watchdog must never crash the run it watches

    def __enter__(self) -> "DispatchDeadline":
        self.expired = False
        self.t0 = time.monotonic()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def elapsed_s(self) -> float:
        """Seconds since the guarded window opened (0 before ``__enter__``)."""
        return 0.0 if self.t0 is None else time.monotonic() - self.t0


class PreflightFailed(RuntimeError):
    """The preflight device health probe could not complete a fenced
    round-trip inside its deadline."""


def preflight_probe(deadline_s: float = 60.0, retries: int = 2, device=None) -> dict:
    """Bounded-deadline device health probe for long runs.

    One tiny fenced dispatch up front (``torch.ones(1) + 1`` on the device,
    read back through :func:`resilient_fence`), so a device that cannot
    complete a round-trip fails in seconds with a clean error instead of
    after a run has loaded its data.  ``device``: ``"cuda"`` when None
    (``device.resolve_device``).

    Returns ``{"ok": True, "dur_s", "platform", "device_count",
    "device_kind"}`` on success; raises :class:`PreflightFailed` (chaining
    the underlying error) when the round-trip cannot complete or reads back
    anything but 2.0.
    """
    t0 = time.monotonic()
    try:
        from disco_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        val = resilient_fence(torch.ones(1, device=dev) + 1,
                              retries=retries, deadline_s=deadline_s)
        if val != 2.0:
            raise PreflightFailed(
                f"preflight readback returned {val!r}, expected 2.0 — the "
                f"device is returning garbage; do not start the run"
            )
        cuda = dev.type == "cuda"
        return {
            "ok": True,
            "dur_s": round(time.monotonic() - t0, 6),
            "platform": "gpu" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        }
    except PreflightFailed:
        raise
    except Exception as e:
        raise PreflightFailed(
            f"preflight fenced dispatch failed within {deadline_s}s: {e!r} — "
            f"the device is not healthy; refusing to start the long run"
        ) from e
