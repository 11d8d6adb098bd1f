"""Fence and readback accounting (the port's copy of the counters of
``disco_tpu/obs/accounting.py``).

A host readback waits for the device work queued before it, so the number
of readbacks, not wall-clock, is what host-device traffic costs a stream
of launches: each one ends the overlap of host and device work.  This
module counts them:

* :func:`fence_tick` — one execution fence (a host readback that waits on
  the device), process-wide and per thread;
* :func:`device_get_tick` — one batched readback of many tensors in ONE
  copy (``device.to_host``), the ``device_get_batches`` counter the serve
  scheduler's one-readback-per-tick contract is checked by.

Counting stays on when event recording is off (one locked increment per
readback).  The JAX package's ``counted_jit``/``recompile_count`` count
jit retraces; the port has no jit, so they are not here.
"""
from __future__ import annotations

import threading

from disco_tpu_torch.obs import metrics as _metrics

_FENCES = _metrics.REGISTRY.counter("fences")
_DEVICE_GETS = _metrics.REGISTRY.counter("device_get_batches")
_TLS = threading.local()  # per-thread fence count for stage attribution


def fence_tick(n: int = 1) -> None:
    """Count ``n`` execution fences (host readbacks that wait on the
    device)."""
    _FENCES.inc(n)
    _TLS.count = getattr(_TLS, "count", 0) + n


def fence_count() -> int:
    """Process-wide fence count (monotonic)."""
    return _FENCES.value


def fence_count_thread() -> int:
    """Fences ticked by THIS thread.  ``events.stage`` diffs this, not the
    process-wide count: a stage on one thread must not be charged another
    thread's readbacks."""
    return getattr(_TLS, "count", 0)


def device_get_tick() -> None:
    """Count one BATCHED host readback (``device.to_host``): many tensors
    crossing in one copy are one fence, however many they are."""
    fence_tick(1)
    _DEVICE_GETS.inc()


def device_get_count() -> int:
    """Process-wide batched-readback count (``device.to_host`` calls)."""
    return _DEVICE_GETS.value
