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
  scheduler's one-readback-per-tick contract is checked by;
* :func:`counted_jit` — the signature counter of the entry points the JAX
  package jits (see its docstring for what the port counts).

Counting stays on when event recording is off (one locked increment per
readback); events go through the recorder, a no-op while disabled.
"""
from __future__ import annotations

import functools
import inspect
import threading

import numpy as np

from disco_tpu_torch.obs import events as _events
from disco_tpu_torch.obs import metrics as _metrics

_FENCES = _metrics.REGISTRY.counter("fences")
_RECOMPILES = _metrics.REGISTRY.counter("jit_recompiles")
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


def recompile_label(label: str) -> str:
    """Counter name of one label's signature count (``jit_recompiles{label}``,
    the JAX package's flattened labeled-series name)."""
    return f"jit_recompiles{{{label}}}"


def recompile_count(label: str | None = None) -> int:
    """:func:`counted_jit` count — process-wide, or one label's.  Peeks
    without creating the per-label counter, so a label that never counted
    adds no zero-valued counter to later snapshots."""
    if label is None:
        return _RECOMPILES.value
    return _metrics.REGISTRY.peek_counter(recompile_label(label))


def _signature(x):
    """The part of one argument that makes JAX trace a new program: shape,
    dtype and device of a tensor (a numpy array is a host array of its
    shape and dtype), the type of a Python scalar (JAX traces it as a
    weak-typed scalar, whatever its value), the structure of a tuple, list
    or dict, and the type of anything else."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        dev = getattr(x, "device", None)
        return ("array", tuple(x.shape), str(x.dtype).removeprefix("torch."),
                "cpu" if dev is None or isinstance(dev, str) else str(dev))
    if x is None or isinstance(x, (bool, int, float, complex)):
        return type(x).__name__
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_signature(e) for e in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _signature(x[k])) for k in sorted(x, key=str)))
    return type(x).__qualname__


def _static_key(v):
    """A static argument's value as a hashable key (arrays by their bytes)."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_static_key(e) for e in v))
    if isinstance(v, dict):
        return ("dict", tuple((k, _static_key(v[k])) for k in sorted(v, key=str)))
    try:
        hash(v)
    except TypeError:
        return repr(v)
    return v


#: guards every :func:`counted_jit` wrapper's seen-signature set (one lock
#: for all wrappers: the critical section is a set lookup and insert)
_SEEN_LOCK = threading.Lock()


def counted_jit(fun=None, *, label: str | None = None, static_argnames=()):
    """Count the call signatures of an entry point the JAX package jits.

    The port compiles no program per call signature (its one build, the
    kernel library, happens once a cache root), so there is no compile to
    count.
    What this wrapper counts is what makes the JAX package trace a new
    program: a call whose signature the wrapper has not seen before.  The
    signature is the shape, dtype and device of each tensor or array
    argument, the type of each Python scalar and the structure of each
    tuple, list or dict (:func:`_signature`), plus the VALUES of the
    arguments named in ``static_argnames`` — the label's
    ``static_argnames`` in the JAX decorator.  Arguments are bound to the
    function's signature with their defaults applied, and an argument named
    ``device`` is left out (the tensors carry their device).

    Each new signature ticks ``jit_recompiles`` and
    ``jit_recompiles{label}`` and records a ``jit_trace`` event, the JAX
    package's names, so ``fit``'s epoch event and the scene gate's dispatch
    budget read the same counts in either package.  Like a jitted function
    the wrapper keeps its seen set for its own lifetime: a module-level
    entry point counts once per signature per process, a runner built per
    call counts afresh.

    Usable bare or as ``@counted_jit(label=..., static_argnames=(...))``;
    the wrapper returns what ``fun`` returns, and ``__wrapped__`` is
    ``fun``.  ``clear_cache()`` forgets the signatures seen, as
    ``clear_cache`` empties a jitted function's cache (the retrace-budget
    workload of ``analysis.trace.budgets`` starts from it).
    """
    if fun is None:
        return functools.partial(counted_jit, label=label, static_argnames=static_argnames)
    name = label or getattr(fun, "__name__", "<jit>")
    statics = frozenset(static_argnames)
    sig = inspect.signature(fun)
    seen: set = set()

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key = tuple((k, _static_key(v) if k in statics else _signature(v))
                    for k, v in bound.arguments.items() if k != "device")
        with _SEEN_LOCK:
            new = key not in seen
            if new:
                seen.add(key)
                n = len(seen)
        if new:
            _RECOMPILES.inc()
            _metrics.REGISTRY.counter(recompile_label(name)).inc()
            _events.record("jit_trace", stage=name, n_new_programs=1, cache_size=n)
        return fun(*args, **kwargs)

    def clear_cache() -> None:
        with _SEEN_LOCK:
            seen.clear()

    wrapper.clear_cache = clear_cache
    return wrapper
