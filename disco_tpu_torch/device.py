"""Device resolution for the port's entry points.

Counterpart of ``disco_tpu/utils/backend.py::is_tpu``: the JAX package
routes by the backend's device kind; the port routes by the device of the
tensors it is given, and its entry points resolve that device here.
"""
from __future__ import annotations

import collections
import queue as queue_mod
import threading

import numpy as np
import torch

from disco_tpu_torch.obs.accounting import device_get_tick


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` when ``device`` is
    None, else the requested device.

    Raises RuntimeError when CUDA is requested (explicitly or by default)
    and no CUDA device exists — the port never falls back to the CPU on its
    own; callers that want the plain versions on the host pass
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "disco_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the host"
        )
    return dev


def as_device_tensors(arrays, device=None) -> list:
    """``arrays`` (tensors, numpy arrays or numbers) as float32 tensors on
    one device: that of the first tensor among them, else
    ``resolve_device(device)`` — the rule of the functions that take either
    (``sim.ism``, ``scenes``)."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
    dev = resolve_device(device) if dev is None else dev
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def is_hopper() -> bool:
    """True when the current CUDA device is a Hopper card (compute
    capability 9.0), the only target the kernels in ``csrc/`` are built
    for."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)


def to_host(tensors) -> list:
    """Copy float32 and complex64 tensors of one device to host numpy
    arrays in ONE transfer (counterpart of the JAX package's batched
    ``device_get_tree``): each is flattened into one float32 payload
    (complex64 as its (re, im) pairs), the payload crosses with one
    ``.cpu()``, and the host arrays are views of it in the tensors'
    shapes and dtypes.  Each call counts one batched readback
    (``obs.accounting.device_get_tick``: the ``device_get_batches``
    counter)."""
    tensors = list(tensors)
    for t in tensors:
        if t.dtype not in (torch.float32, torch.complex64):
            raise TypeError(f"to_host: float32 or complex64 tensors only, got {t.dtype}")
    flat = [(torch.view_as_real(t) if t.is_complex() else t).reshape(-1) for t in tensors]
    payload = torch.cat(flat).cpu().numpy()
    device_get_tick()
    out, start = [], 0
    for t, f in zip(tensors, flat):
        a = payload[start:start + f.numel()]
        start += f.numel()
        out.append((a.view(np.complex64) if t.is_complex() else a).reshape(tuple(t.shape)))
    return out


def check_module_device(module: torch.nn.Module, dev: torch.device) -> None:
    """Raise ValueError unless every parameter and buffer of ``module`` lies
    on ``dev`` — a model is never moved to the caller's device silently."""
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"the model's {name} lies on {t.device}, the call runs on {dev}; move the model "
                f"with model.to({str(dev)!r}) first"
            )


def _map_batch(fn, item):
    """``fn`` over the arrays of a batch: an array, or a tuple, list or dict
    of batches."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map_batch(fn, e) for e in item)
    if isinstance(item, dict):
        return {k: _map_batch(fn, v) for k, v in item.items()}
    return fn(item)


def prefetch_to_device(iterator, device, size: int = 2):
    """Batches of ``iterator`` (numpy arrays, or tuples, lists or dicts of
    them) as tensors on ``device``, with host work, copies and compute
    overlapped (counterpart of ``disco_tpu/utils/transfer.py::
    prefetch_to_device``; the loader-parallel layer that the reference
    gets from DataLoader workers, train.py:104-105).

    A feeder thread drains ``iterator`` into a queue of ``size`` host
    batches, so the host work inside ``next()`` (file reads, windowing)
    runs beside the consumer.  On a CUDA device one batch is kept ahead on
    the card: its arrays are copied into pinned host memory and sent with
    ``non_blocking`` copies on a side stream while the consumer's step
    runs.  Before a batch is handed out the consumer's stream waits for
    that batch's copy (an event recorded on the copy stream), and each
    tensor is marked as used on the consumer's stream (``record_stream``),
    so the caching allocator does not hand its memory to a later copy
    while the step still reads it.  A pinned source buffer goes back to
    torch's pinned-memory cache once its batch is handed out; the cache
    reuses it only after the copy that read it has completed.  On the CPU
    the batches are handed out as tensors sharing the arrays' memory.

    Exceptions of ``iterator`` are raised at the consumer.  Closing the
    generator (an early stop) stops the feeder thread.
    """
    if size < 1:
        raise ValueError("prefetch_to_device needs size >= 1")
    dev = torch.device(device)
    hostq: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                hostq.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def feeder():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # raised at the consumer
            put(e)

    thread = threading.Thread(target=feeder, name="disco-prefetch-to-device", daemon=True)
    thread.start()

    def next_host():
        item = hostq.get()
        if isinstance(item, BaseException):
            raise item
        return item

    try:
        if dev.type != "cuda":
            while (item := next_host()) is not end:
                yield _map_batch(lambda a: torch.as_tensor(a, device=dev), item)
            return
        copy_stream = torch.cuda.Stream(dev)
        lookahead: collections.deque = collections.deque()

        def send(item):
            pinned = _map_batch(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(),
                                item)
            with torch.cuda.stream(copy_stream):
                on_dev = _map_batch(lambda t: t.to(dev, non_blocking=True), pinned)
                done = torch.cuda.Event()
                done.record(copy_stream)
            lookahead.append((on_dev, pinned, done))

        item = next_host()
        more = item is not end
        if more:
            send(item)
        while lookahead:
            on_dev, pinned, done = lookahead.popleft()
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            _map_batch(lambda t: t.record_stream(compute), on_dev)
            del pinned
            if more:  # the next batch's copy runs behind this batch's step
                item = next_host()
                more = item is not end
                if more:
                    send(item)
            yield on_dev
    finally:
        stop.set()
