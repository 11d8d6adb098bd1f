"""The roofline join: measured stage times × modeled stage costs
(counterpart of ``disco_tpu/obs/roofline.py``).

``disco-torch-obs roofline`` merges a record's measured ``stage_ms`` with
the costs of :mod:`disco_tpu_torch.analysis.meter.stages` at the record's
workload and renders, per stage, the achieved FLOP/s and bytes/s, their
fractions of the card's peaks, and a verdict:

* **compute-bound** — the binding fraction is the operations';
* **bandwidth-bound** — the binding fraction is the memory's;
* **dispatch-bound** — below :data:`DISPATCH_FRAC` of peak on the binding
  dimension: neither roof explains the time, launches and the host do.

The peaks are the card's, from the H100 SXM data sheet, and hold at its
full power limit: a card set below 700 W runs slower under load, so a
record names its card and limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``) beside its numbers.  The costs are traced for the
card on fake tensors, so a roofline of a card's record renders on a host
with no card.
"""
from __future__ import annotations

#: the card the peaks are of, and the power limit they hold at
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
#: FP32 outside the tensor cores, dense bf16 on the tensor cores, HBM3
#: bandwidth (H100 SXM data sheet)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
#: the verdict's default peaks (TFLOP/s, GB/s): float32 work and HBM
PEAK_TFLOPS = PEAK_FP32 / 1e12
PEAK_GBPS = PEAK_BYTES / 1e9

#: below this fraction of peak on the BINDING dimension a stage is called
#: dispatch-bound
DISPATCH_FRAC = 0.01


def workload_of_record(record: dict):
    """The record's workload (its ``workload`` field, else the headline
    defaults) as a meter :class:`Workload` + an ``assumed`` flag."""
    from disco_tpu_torch.analysis.meter.stages import HEADLINE, Workload

    w = record.get("workload")
    if not isinstance(w, dict):
        return HEADLINE, True
    return Workload(
        batch=int(w.get("batch", HEADLINE.batch)),
        dur_s=float(w.get("dur_s", HEADLINE.dur_s)),
        fs=int(w.get("fs", HEADLINE.fs)),
        n_nodes=int(w.get("n_nodes", HEADLINE.n_nodes)),
        mics_per_node=int(w.get("mics_per_node", HEADLINE.mics_per_node)),
    ), False


def verdict(flops: float, traffic: float, ms: float, peak_tflops: float = PEAK_TFLOPS,
            peak_gbps: float = PEAK_GBPS) -> dict:
    """One stage's roofline row from its modeled work and measured time."""
    secs = ms / 1e3
    achieved_f, achieved_b = flops / secs, traffic / secs
    frac_c = achieved_f / (peak_tflops * 1e12)
    frac_b = achieved_b / (peak_gbps * 1e9)
    binding = "compute" if frac_c >= frac_b else "bandwidth"
    frac_peak = max(frac_c, frac_b)
    return {
        "ms": ms,
        "gflops": round(flops / 1e9, 3),
        "gbytes": round(traffic / 1e9, 3),
        "arithmetic_intensity": round(flops / traffic, 6) if traffic else None,
        "gflops_per_s": round(achieved_f / 1e9, 2),
        "gb_per_s": round(achieved_b / 1e9, 2),
        "frac_compute": round(frac_c, 6),
        "frac_bandwidth": round(frac_b, 6),
        "fraction_of_peak": round(frac_peak, 6),
        "verdict": "dispatch-bound" if frac_peak < DISPATCH_FRAC else f"{binding}-bound",
    }


def stage_verdicts(record: dict, peak_tflops: float = PEAK_TFLOPS, peak_gbps: float = PEAK_GBPS,
                   costs: dict | None = None) -> dict:
    """The per-stage roofline table of one record: ``{rows, workload,
    workload_assumed, peaks, cost_model_version}``.  Stages without a
    measured time or a modeled cost are skipped.  ``costs`` (stage ->
    cost) skips the tracing when the caller has them."""
    from disco_tpu_torch.analysis.meter import costmodel
    from disco_tpu_torch.analysis.meter.stages import STAGE_KEYS, offline_stage_costs

    workload, assumed = workload_of_record(record)
    costs = costs if costs is not None else offline_stage_costs(workload)
    stage_ms = record.get("stage_ms") or {}
    rows = []
    for stage in STAGE_KEYS:
        ms, cost = stage_ms.get(stage), costs.get(stage)
        if not ms or not cost:
            continue
        rows.append({"stage": stage, **verdict(cost["flops"], cost["traffic_bytes"], ms,
                                               peak_tflops, peak_gbps)})
    return {
        "rows": rows,
        "workload": {"batch": workload.batch, "dur_s": workload.dur_s, "fs": workload.fs,
                     "n_nodes": workload.n_nodes, "mics_per_node": workload.mics_per_node},
        "workload_assumed": assumed,
        "peaks": {"tflops": peak_tflops, "gbps": peak_gbps, "card": CARD,
                  "power_limit_w": POWER_LIMIT_W},
        "cost_model_version": costmodel.VERSION,
    }


def render(result: dict) -> str:
    """The ``disco-torch-obs roofline`` text table."""
    w = result["workload"]
    src = "assumed (the record has no workload field)" if result["workload_assumed"] \
        else "from record"
    p = result["peaks"]
    lines = [
        f"workload: batch={w['batch']} dur_s={w['dur_s']:g} K={w['n_nodes']} "
        f"C={w['mics_per_node']} fs={w['fs']} — {src}",
        f"peaks: {p['tflops']:g} TFLOP/s, {p['gbps']:g} GB/s ({p.get('card', CARD)} at "
        f"{p.get('power_limit_w', POWER_LIMIT_W):g} W; cost model v{result['cost_model_version']})",
        f"{'stage':<20}{'ms':>10}{'GFLOP':>10}{'GB':>9}{'AI':>8}"
        f"{'GFLOP/s':>10}{'GB/s':>9}{'%peak':>8}  verdict",
    ]
    for r in result["rows"]:
        lines.append(
            f"{r['stage']:<20}{r['ms']:>10.2f}{r['gflops']:>10.2f}{r['gbytes']:>9.2f}"
            f"{r['arithmetic_intensity'] or 0:>8.3f}{r['gflops_per_s']:>10.1f}"
            f"{r['gb_per_s']:>9.1f}{r['fraction_of_peak']:>8.2%}  {r['verdict']}")
    if not result["rows"]:
        lines.append("(no stage_ms lanes in this record)")
    return "\n".join(lines)
