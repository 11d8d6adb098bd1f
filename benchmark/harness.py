"""One run of one cell: set-up, the measured window, the traced stretch, and
the check of what the window produced.

Set-up makes the pool of input batches and the pipeline's weights from the
seed on the device, builds the pipeline and runs it until every shape of the
cell is warm.  The window is a closed loop with ``in_flight`` batches queued:
batch i + 1 is enqueued before batch i's enhanced signals are copied to the
host with ``disco_tpu_torch.device.to_host``, the program's product.  A
batch's latency runs from the start of its enqueue to its output in host
memory.  With ``trace``, a stretch of whole batches after the window runs
under ``torch.profiler`` with the benchmark's spans, and the per-layer
readers read it.  Last, with the program's state released, the reference
recomputes a sample of the window's batches, drawn from the seed, and the
numbers compared are set beside their limits.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import os
import random
import statistics
import sys
import tempfile
import time
import types

import torch

from benchmark import check, costs, scenes, spec, trace as trace_mod

_tracing = contextvars.ContextVar("bench_tracing", default=False)


def span(name: str):
    """The benchmark's span ``name``: a profiler range while a trace is
    recorded, nothing otherwise."""
    if _tracing.get():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _module_spans(pairs):
    """A ``name`` span around every forward of each (name, module)."""
    handles, open_spans = [], []

    def pre(name):
        def hook(_mod, _inp):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_spans.append(rf)
        return hook

    def post(_mod, _inp, _out):
        open_spans.pop().__exit__(None, None, None)

    for name, mod in pairs:
        handles.append(mod.register_forward_pre_hook(pre(name)))
        handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop: ``depth`` batches queued, the oldest copied to the
    host when a new one has been enqueued."""

    def __init__(self, run, pool, depth: int):
        from disco_tpu_torch.device import to_host

        self.run, self.pool, self.depth, self.to_host = run, pool, depth, to_host
        self.i = 0                                       # batches enqueued
        self.queue = collections.deque()                 # (index, start, output)

    def enqueue(self) -> float:
        """Enqueue the next batch; returns its dispatch seconds."""
        t = time.perf_counter()
        with span("bench.batch"):
            out = self.run(self.pool[self.i % len(self.pool)])
        d = time.perf_counter() - t
        self.queue.append((self.i, t, out))
        self.i += 1
        return d

    def complete(self):
        """(index, start, done, host array) of the oldest queued batch."""
        i, t, out = self.queue.popleft()
        with span("bench.readback"):
            host = self.to_host([out])[0]
        return i, t, time.perf_counter(), host

    def drain(self) -> None:
        while self.queue:
            self.complete()


def warm_up(run, pool, depth: int, device) -> None:
    """Every pool batch through the loop, and the queue filled and drained:
    each shape, the allocator's pools and cuDNN's choices made."""
    loop = Loop(run, pool, depth)
    for _ in range(max(len(pool), depth + 1)):
        loop.enqueue()
        if len(loop.queue) >= depth:
            loop.complete()
    loop.drain()
    _sync(device)


def window(run, pool, depth: int, seconds: float, keep) -> dict:
    """The measured window: batches complete until ``seconds`` have passed;
    ``keep(index, host)`` sees each completed batch's output."""
    loop = Loop(run, pool, depth)
    t0 = time.perf_counter()
    disp, lat = [], []
    done = t0
    while True:
        while len(loop.queue) < depth:
            disp.append(loop.enqueue())
        i, start, done, host = loop.complete()
        lat.append(done - start)
        keep(i, host)
        if done - t0 >= seconds:
            break
    n = len(lat)
    loop.drain()                                           # the batches still queued
    return {"batches": n, "seconds": done - t0, "latency_s": lat, "dispatch_s": disp[:n]}


def traced(run, pool, depth: int, n_batches: int, hooks, device) -> trace_mod.Trace:
    """``n_batches`` whole batches through the loop under the profiler, the
    queue drained before and after."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    _sync(device)
    prof = profile(activities=acts, record_shapes=True)
    token = _tracing.set(True)
    try:
        with _module_spans(hooks):
            prof.start()
            loop = Loop(run, pool, depth)
            for _ in range(n_batches):
                loop.enqueue()
                if len(loop.queue) >= depth:
                    loop.complete()
            loop.drain()
            _sync(device)
            prof.stop()
    finally:
        _tracing.reset(token)
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.parse(path)
    finally:
        os.remove(path)


class Sampler:
    """Reservoir sample, drawn from the seed, of ``size`` completed batches."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept, self.seen = size, random.Random(seed), {}, 0

    def __call__(self, i: int, host) -> None:
        if self.seen < self.size:
            self.kept[self.seen] = (i, host)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (i, host)
        self.seen += 1

    def batches(self) -> list:
        return sorted(self.kept.values(), key=lambda p: p[0])


def _p95(values) -> float:
    """The 95th percentile, linear between order statistics."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: float | None = None, variant=None, log=sys.stderr,
             marks=None) -> dict:
    """One run of ``cell``: the result object of the run's last line.

    ``variant``, for the readings and the tests: a function of the pipeline
    that returns what runs in the program's place (the control, a planted
    fault); None runs the program.  ``marks``: (phase, wall time at its end)
    of the set-up before this call, for the set-up's breakdown on ``log``.
    """
    t_begin = time.time() if t_process is None else t_process
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = list(marks or []) + [("imports", time.time())]

    def mark(phase: str) -> None:
        _sync(dev)
        marks.append((phase, time.time()))

    cfg, mix = cell.cfg, cell.mix
    B, K, C, L = scenes.batch_shape(cfg, mix)
    gen = scenes.generator(seed, dev)
    torch.empty(1, device=dev)
    mark("context")
    pool = scenes.make_pool(cfg, mix, gen, dev)
    mark("pool")
    pipe = spec.pipeline(mix).Pipeline(cfg, mix, dev, gen)
    run = pipe.run if variant is None else variant(pipe)
    mark("pipeline")
    depth = mix["in_flight"]
    warm_up(run, pool, depth, dev)
    mark("warm-up")
    peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_begin
    print("set-up: " + ", ".join(f"{p} {t - t0:.3f}" for (p, t), (_, t0)
                                 in zip(marks, [("start", t_begin)] + marks)) + " s",
          file=log, flush=True)
    sampler = Sampler(mix["check_batches"], seed)
    win = window(run, pool, depth, seconds, sampler)
    peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    print(f"window: {win['batches']} batches of {B} clips in {win['seconds']:.3f} s; set-up "
          f"{setup_s:.3f} s", file=log, flush=True)
    tr = None
    if trace:
        tr = traced(run, pool, depth, mix["trace_batches"], pipe.span_hooks(), dev)
    peak = max(peak_setup, peak_window,
               torch.cuda.max_memory_allocated(dev) if on_card else 0)
    flops, nbytes = pipe.need(B, K, C, L)
    pipe.release()
    run = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(pipe, pool, sampler.batches(), cell.limits)
    print(f"check: {len(sampler.batches())} batches against the reference in "
          f"{time.perf_counter() - t_check:.3f} s", file=log, flush=True)
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    failed = 0 if correct else len(sampler.batches()) * B       # the clips judged

    e2e_values = {
        "clip_audio_s_per_s": win["batches"] * B * mix["clip_s"] / win["seconds"],
        "batch_ms_p95": 1e3 * _p95(win["latency_s"]),
        "peak_mem_gib": peak_window / 2 ** 30,
        "setup_s": setup_s,
    }
    result = {"correct": correct, "attempted": win["batches"] * B, "failed": failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if not trace:
        result["metrics"] = {m["name"]: {"value": e2e_values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = types.SimpleNamespace(
            trace=tr, n_traced=mix["trace_batches"], window=win, need=(flops, nbytes),
            costs=costs, cfg=cfg, mix=mix, batch=(B, K, C, L))
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown
    result["device"] = device_info
    result["checks"] = numbers
    return result
