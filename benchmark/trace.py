"""The reduction of a profiler trace to what the per-layer readers read.

``torch.profiler`` records the host's ops and the benchmark's spans
(``record_function``) and, through CUPTI, every kernel, copy and fill on the
card.  Its Chrome trace links each kernel to the host call that launched it
by a correlation id.  From the launch's time and thread this module finds the
port's named kernel op around it (``disco_torch::*``) and the benchmark's
spans around it (``bench.*``), so a reader can sum device time by op or by
span.  The window is the traced stretch from the first device operation to
the last; busy time is the union of all device operations in it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json

NAMED_OP_PREFIX = "disco_torch::"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Kernel:
    name: str
    ts: float            # us
    dur: float           # us
    cat: str             # kernel | gpu_memcpy | gpu_memset
    op: dict | None      # the named kernel op whose call launched it
    spans: frozenset     # the benchmark spans around its launch


@dataclasses.dataclass
class Trace:
    device: list         # every device operation, sorted by start
    ops: list            # the named kernel op calls: {name, args, kernels: [Kernel]}
    busy_s: float
    window_s: float
    breakdown: dict


class _Intervals:
    """Intervals of one thread, for 'which of them holds time t'."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def holding(self, t: float):
        """The innermost interval holding ``t`` (latest start), or None."""
        held = self.all_holding(t)
        return held[0] if held else None

    def all_holding(self, t: float, limit: int = 400):
        """Every interval holding ``t``, the latest start first, among the
        ``limit`` that start last before it."""
        i = bisect.bisect_right(self.starts, t) - 1
        out = []
        stop = max(-1, i - limit)
        while i > stop:
            e = self.ev[i]
            if e["ts"] <= t <= e["ts"] + e.get("dur", 0.0):
                out.append(e)
            i -= 1
        return out


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def parse(path: str, top: int = 10) -> Trace:
    """Read a Chrome trace that ``torch.profiler`` exported."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, by_ext = {}, {}
    named, spans, ops_by_tid = collections.defaultdict(list), collections.defaultdict(list), \
        collections.defaultdict(list)
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = e
        elif cat == "cpu_op":
            ops_by_tid[e["tid"]].append(e)
            if "External id" in args:
                by_ext[args["External id"]] = e
            if e["name"].startswith(NAMED_OP_PREFIX):
                named[e["tid"]].append(e)
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans[e["tid"]].append(e)
    named_iv = {t: _Intervals(v) for t, v in named.items()}
    span_iv = {t: _Intervals(v) for t, v in spans.items()}
    op_calls = {}
    device = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        args = e.get("args") or {}
        launch = launches.get(args.get("correlation"))
        if launch is None and args.get("External id") in by_ext:
            launch = by_ext[args["External id"]]
        op, held = None, frozenset()
        if launch is not None:
            t, tid = launch["ts"], launch["tid"]
            if tid in named_iv:
                op = named_iv[tid].holding(t)
            if tid in span_iv:
                held = frozenset(s["name"] for s in span_iv[tid].all_holding(t))
        k = Kernel(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"], op, held)
        device.append(k)
        if op is not None and k.cat == "kernel":
            call = op_calls.setdefault(id(op), {"name": op["name"], "args": op.get("args") or {},
                                                "kernels": []})
            call["kernels"].append(k)
    if not device:
        return Trace([], [], 0.0, 0.0, {"device_ops": [], "idle_gaps": []})
    busy = _merged((k.ts, k.ts + k.dur) for k in device)
    lo, hi = busy[0][0], busy[-1][1]
    busy_us = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for k in device:
        by_name[k.name[:120]] += k.dur / 1e6
    gaps = collections.Counter()
    main = max(span_iv, key=lambda t: len(span_iv[t].ev)) if span_iv else None
    host_ops = _Intervals(ops_by_tid.get(main, [])) if main is not None else None
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        t = 0.5 * (e0 + s1)
        label = "no benchmark span"
        if main is not None:
            sp = span_iv[main].holding(t)
            op = host_ops.holding(t)
            label = f"{sp['name'] if sp else 'outside spans'} / {op['name'] if op else 'python'}"
        gaps[label] += (s1 - e0) / 1e6
    breakdown = {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                 "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
    return Trace(device, list(op_calls.values()), busy_us / 1e6, (hi - lo) / 1e6, breakdown)
