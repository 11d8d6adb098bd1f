"""Telemetry reader CLI (the port's ``disco-obs``; the counterpart of
``disco_tpu/cli/obs.py``): render an event log, reconstruct causal traces,
and introspect a live server.  The logs, span chains and status frames are
the JAX package's, so each package's reader reads the other's files.

Subcommands:

* ``report LOG.jsonl`` — aggregate a JSONL event log (``disco_tpu_torch.obs``
  schema) into a manifest summary, a per-stage time/call/fence table with
  the run's fence count, recompile and sentinel listings, the
  fault-tolerance story (injected faults, retry recoveries, degraded-mode
  entries), a histogram table with p50/p95/p99 percentiles, an
  online-serving section (session lifecycle, admission/eviction counters,
  request-latency percentiles), the flywheel and scene-factory sections,
  and the final counter snapshot.  The JAX report's estimated tunnel-RPC
  overhead (fences x a TPU attachment's per-fence cost) is left out: it is
  a TPU figure.
* ``trace LOG.jsonl [TRACE_ID]`` — causal-trace reconstruction
  (``disco_tpu_torch.obs.trace``): without an id, list the log's trace ids;
  with one, render the per-hop waterfall (client block → enqueue →
  dispatch → readback → deliver → tap → train batch).
* ``top ADDRESS`` — live serve introspection over the read-only ``status``
  protocol frame (no session): session states, ladder rung,
  counters/gauges, latency percentiles, in-flight spans.  ``--watch N``
  refreshes every N seconds until interrupted.
* ``slo ADDRESS|STATUS.json`` — verdict over declared SLO targets
  (``--serve-p95-ms``, ``--queue-wait-p95-ms``, ``--max-drop-rate``,
  ``--max-evict-rate``); exits nonzero on violation.

``roofline`` joins a record's measured ``stage_ms`` with the port's cost
model (``analysis.meter``, traced for the card on fake tensors) against
the card's peaks (``obs.roofline``).  ``compare`` parses as in the JAX
package and exits naming what it waits for: it diffs the records of a
benchmark, which the port does not have yet.  No subcommand touches a
device; ``--device`` is checked as in every port CLI.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from disco_tpu_torch.cli.common import add_device_arg
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.obs.events import read_events


def build_parser():
    """Build the ``disco-obs`` argument parser."""
    p = argparse.ArgumentParser(description="Render disco_tpu_torch telemetry")
    sub = p.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="render a JSONL event log")
    rep.add_argument("log", help="event log written via --obs-log")
    add_device_arg(rep)

    cmp_ = sub.add_parser("compare", help="diff two bench records (old new)")
    cmp_.add_argument("old", help="baseline bench JSON (BENCH_r*.json / raw line / obs log)")
    cmp_.add_argument("new", help="candidate bench JSON")
    cmp_.add_argument("--threshold", type=float, default=0.05,
                      help="relative RTF drop that counts as a regression "
                           "(default 0.05)")
    add_device_arg(cmp_)

    roof = sub.add_parser(
        "roofline",
        help="per-stage roofline verdict of one bench record "
             "(measured stage_ms x modeled stage costs)")
    roof.add_argument("record", help="bench JSON (BENCH_r*.json / raw line "
                                     "/ obs log with a bench_result)")
    roof.add_argument("--peak-tflops", type=float, default=None,
                      help="dense f32 peak to judge against "
                           "(default: the device's)")
    roof.add_argument("--peak-gbps", type=float, default=None,
                      help="HBM bandwidth peak to judge against "
                           "(default: the device's)")
    roof.add_argument("--format", choices=("text", "json"), default="text",
                      help="report format")
    add_device_arg(roof)

    trc = sub.add_parser("trace", help="list / render causal traces from an event log")
    trc.add_argument("log", help="event log written via --obs-log (span events)")
    trc.add_argument("trace_id", nargs="?", default=None,
                     help="trace id to render as a waterfall; omit to list ids")
    trc.add_argument("--limit", type=int, default=20,
                     help="max trace ids to list (newest-first; default 20)")
    add_device_arg(trc)

    top = sub.add_parser("top", help="live serve introspection (status frame)")
    top.add_argument("address", help="server address: HOST:PORT or a unix socket path")
    top.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                     help="refresh every N seconds until interrupted "
                          "(default: one snapshot)")
    add_device_arg(top)

    slo = sub.add_parser("slo", help="SLO verdict over a live server or a saved status")
    slo.add_argument("target", help="HOST:PORT, unix socket path, or a status JSON file")
    slo.add_argument("--serve-p95-ms", type=float, default=None,
                     help="delivered-block latency p95 target (ms)")
    slo.add_argument("--queue-wait-p95-ms", type=float, default=None,
                     help="enqueue-to-dispatch wait p95 target (ms)")
    slo.add_argument("--max-drop-rate", type=float, default=None,
                     help="tap drops / tap offers ceiling")
    slo.add_argument("--max-evict-rate", type=float, default=None,
                     help="evictions / finished sessions ceiling")
    add_device_arg(slo)
    return p


# -- report -----------------------------------------------------------------
def summarize(events: list[dict]) -> dict:
    """Aggregate an event list into the report structure (pure function —
    the testable core of ``report``)."""
    # LAST manifest wins (the log is append-mode: a re-used --obs-log path
    # holds one manifest per run, and the stage/counter tail being rendered
    # belongs to the newest one — same rule as the counters snapshot below)
    manifest = next((e for e in reversed(events) if e["kind"] == "manifest"), None)
    stages: dict[str, dict] = {}
    for e in events:
        if e["kind"] != "stage_end":
            continue
        s = stages.setdefault(
            e["stage"], {"calls": 0, "total_s": 0.0, "fences": 0}
        )
        s["calls"] += 1
        s["total_s"] += float(e["attrs"].get("dur_s") or 0.0)
        s["fences"] += int(e["attrs"].get("fences") or 0)
    for s in stages.values():
        s["mean_s"] = s["total_s"] / s["calls"]
    counters = next(
        (e["attrs"] for e in reversed(events) if e["kind"] == "counters"), None
    )
    n_fences = sum(s["fences"] for s in stages.values())
    if counters and "counters" in counters:
        n_fences = max(n_fences, int(counters["counters"].get("fences", 0)))
    histograms = (counters or {}).get("histograms") or {}

    # -- serve section: the online service's lifecycle + request telemetry
    session_events = [e for e in events if e["kind"] == "session"]
    cvals = (counters or {}).get("counters") or {}
    gvals = (counters or {}).get("gauges") or {}
    serve = None
    if session_events or any(k.startswith("serve") for k in cvals):
        actions: dict[str, int] = {}
        for e in session_events:
            a = e["attrs"].get("action", "?")
            actions[a] = actions.get(a, 0) + 1
        serve = {
            "sessions": actions,
            "admission_reject": int(cvals.get("admission_reject", 0)),
            "session_evicted": int(cvals.get("session_evicted", 0)),
            "serve_ticks": int(cvals.get("serve_ticks", 0)),
            "serve_blocks": int(cvals.get("serve_blocks", 0)),
            "sessions_active": gvals.get("sessions_active"),
            "queue_depth": gvals.get("queue_depth"),
            "batch_occupancy": gvals.get("batch_occupancy"),
            "latency_ms": histograms.get("serve_block_latency_ms"),
        }
    # -- flywheel section: corpus-tap spool + shard-training telemetry,
    # plus the resident trainer's generation/throttle lifecycle
    tap_events = [e for e in events if e["kind"] == "tap"]
    gen_events = [e for e in events if e["kind"] == "generation"]
    throttle_events = [e for e in events if e["kind"] == "train_throttled"]
    flywheel = None
    if (tap_events or gen_events or throttle_events
            or any(k.startswith(("tap_", "shards_")) for k in cvals)):
        flywheel = {
            "tap_blocks": int(cvals.get("tap_blocks", 0)),
            "tap_dropped": int(cvals.get("tap_dropped", 0)),
            "tap_shards_written": int(cvals.get("tap_shards_written", 0)),
            "tap_errors": int(cvals.get("tap_errors", 0)),
            "shards_skipped": int(cvals.get("shards_skipped", 0)),
            "train_steps": int(cvals.get("train_steps", 0)),
            "rotations": sum(1 for e in tap_events
                             if e["attrs"].get("action") == "shard"),
            "generations_published": sum(
                1 for e in gen_events
                if e["attrs"].get("action") == "published"),
            "generations_refused": sum(
                1 for e in gen_events
                if e["attrs"].get("action") == "refused"),
            "last_generation": next(
                (e["attrs"] for e in reversed(gen_events)
                 if e["attrs"].get("action") == "published"), None),
            "throttle_pauses": sum(
                1 for e in throttle_events
                if e["attrs"].get("action") == "paused"),
            "throttled_ticks": int(cvals.get("train_throttled_ticks", 0)),
        }
    # -- per-label recompile table: the log's own jit_trace events are the
    # run's truth (per-log scope); the jit_recompiles{label} counter series
    # (obs.accounting.recompile_label) from the final snapshot only fills
    # in labels with no events — the snapshot is PROCESS-cumulative, so for
    # a log opened mid-process it over-counts labels the run retraced.
    by_label: dict[str, int] = {}
    for e in events:
        if e["kind"] == "jit_trace":
            by_label[e["stage"]] = by_label.get(
                e["stage"], 0
            ) + int(e["attrs"].get("n_new_programs", 1))
    for name, v in (cvals or {}).items():
        # zero-valued series carry no recompile to report (defensive: a
        # stray created-but-never-incremented counter must not render)
        if (name.startswith("jit_recompiles{") and name.endswith("}")
                and int(v) > 0):
            by_label.setdefault(name[len("jit_recompiles{"):-1], int(v))
    # -- scenario-factory section: batched scene-simulation telemetry
    # (scenes/stream.py feed batches + datagen/disco.py batched chunks)
    scene_events = [e for e in events if e["kind"] == "scene"]
    scenes = None
    if scene_events or any(k in ("scene_batches", "scenes_simulated")
                           for k in cvals):
        scenes = {
            "scene_batches": int(cvals.get("scene_batches", 0)),
            "scenes_simulated": int(cvals.get("scenes_simulated", 0)),
            "stream_batches": sum(1 for e in scene_events
                                  if e.get("stage") == "scenes"),
            "datagen_batches": sum(1 for e in scene_events
                                   if e.get("stage") == "datagen"),
            "last_scene": scene_events[-1]["attrs"] if scene_events else None,
        }
    # -- causal tracing + flight dumps (the scope layer)
    span_events = [e for e in events if e["kind"] == "span"]
    traces: dict[str, int] = {}
    for e in span_events:
        t = e["attrs"].get("trace")
        traces[t] = traces.get(t, 0) + 1
    return {
        "manifest": manifest["attrs"] if manifest else None,
        "spans": len(span_events),
        "n_traces": len(traces),
        "flights": [e for e in events if e["kind"] == "flight"],
        "stages": dict(sorted(stages.items(), key=lambda kv: -kv[1]["total_s"])),
        "counters": counters,
        "recompiles": [e for e in events if e["kind"] == "jit_trace"],
        "recompiles_by_label": dict(sorted(by_label.items())),
        "sentinels": [e for e in events if e["kind"] == "sentinel"],
        "epochs": [e for e in events if e["kind"] == "epoch"],
        "clips": sum(1 for e in events if e["kind"] == "clip"),
        "watchdogs": [e for e in events if e["kind"] == "watchdog"],
        "faults": [e for e in events if e["kind"] == "fault"],
        "recoveries": [e for e in events if e["kind"] == "recovery"],
        "degraded": [e for e in events if e["kind"] == "degraded"],
        "runs": [e for e in events if e["kind"] in ("run_start", "run_resume")],
        "interrupts": [e for e in events if e["kind"] == "interrupted"],
        "warnings": [e for e in events if e["kind"] == "warning"],
        "histograms": histograms,
        "serve": serve,
        "flywheel": flywheel,
        "scenes": scenes,
        "n_events": len(events),
        "n_fences": n_fences,
    }


def render_report(summary: dict) -> str:
    """Render the ``disco-obs report`` tables from a parsed event list."""
    lines = []
    man = summary["manifest"]
    if man:
        sha = (man.get("git_sha") or "?")[:12]
        lines.append(
            f"run: git {sha}  platform={man.get('platform')} "
            f"x{man.get('device_count')} ({man.get('device_kind')})"
        )
        vers = man.get("versions") or {}
        lines.append(
            "versions: " + " ".join(f"{k}={v}" for k, v in vers.items() if v)
        )
        if man.get("config"):
            lines.append(f"config: {json.dumps(man['config'], sort_keys=True)}")
    else:
        lines.append("run: (no manifest event)")
    lines.append("")
    lines.append(f"{'stage':<22}{'calls':>7}{'total_s':>12}{'mean_ms':>12}{'fences':>8}")
    for name, s in summary["stages"].items():
        lines.append(
            f"{name:<22}{s['calls']:>7}{s['total_s']:>12.4f}"
            f"{s['mean_s'] * 1e3:>12.3f}{s['fences']:>8}"
        )
    if not summary["stages"]:
        lines.append("(no stage events)")
    lines.append(f"fences: {summary['n_fences']}")
    if summary["clips"]:
        lines.append(f"clips enhanced: {summary['clips']}")

    def fmtg(v):
        return "-" if v is None else f"{v:g}"

    if summary.get("histograms"):
        lines.append("")
        lines.append(
            f"{'histogram':<28}{'count':>7}{'mean':>10}{'p50':>10}"
            f"{'p95':>10}{'p99':>10}{'max':>10}"
        )
        for name, h in sorted(summary["histograms"].items()):
            lines.append(
                f"{name:<28}{h.get('count', 0):>7}{fmtg(h.get('mean')):>10}"
                f"{fmtg(h.get('p50')):>10}{fmtg(h.get('p95')):>10}"
                f"{fmtg(h.get('p99')):>10}{fmtg(h.get('max')):>10}"
            )
    sv = summary.get("serve")
    if sv:
        lines.append("")
        sess = "  ".join(f"{k}×{v}" for k, v in sorted(sv["sessions"].items()))
        lines.append(f"serve sessions: {sess or '(none recorded)'}")
        lines.append(
            f"serve: {sv['serve_blocks']} blocks over {sv['serve_ticks']} "
            f"ticks  admission rejects={sv['admission_reject']}  "
            f"evictions={sv['session_evicted']}"
        )
        lines.append(
            f"serve gauges: sessions_active={fmtg(sv['sessions_active'])}  "
            f"queue_depth={fmtg(sv['queue_depth'])}  "
            f"batch_occupancy={fmtg(sv['batch_occupancy'])}"
        )
        lat = sv.get("latency_ms") or {}
        if lat.get("count"):
            lines.append(
                f"serve request latency (ms): p50={fmtg(lat.get('p50'))}  "
                f"p95={fmtg(lat.get('p95'))}  p99={fmtg(lat.get('p99'))}  "
                f"max={fmtg(lat.get('max'))} over {lat['count']} blocks"
            )
    fw = summary.get("flywheel")
    if fw:
        lines.append("")
        lines.append(
            f"flywheel tap: {fw['tap_blocks']} blocks spooled  "
            f"dropped={fw['tap_dropped']}  shards={fw['tap_shards_written']}"
            + (f"  errors={fw['tap_errors']}" if fw["tap_errors"] else "")
        )
        lines.append(
            f"flywheel train: {fw['train_steps']} steps  "
            f"corrupt shards skipped={fw['shards_skipped']}"
        )
        if fw.get("generations_published") or fw.get("generations_refused"):
            last = fw.get("last_generation") or {}
            tail = (f"  last={last.get('gen')} (serial {last.get('serial')}, "
                    f"epoch {last.get('epoch')})" if last else "")
            lines.append(
                f"flywheel generations: published="
                f"{fw['generations_published']}  "
                f"refused={fw['generations_refused']}{tail}"
            )
        if fw.get("throttle_pauses") or fw.get("throttled_ticks"):
            lines.append(
                f"flywheel throttle: pauses={fw['throttle_pauses']}  "
                f"throttled ticks={fw['throttled_ticks']} "
                "(ladder rung >= trainer threshold)"
            )
    sc = summary.get("scenes")
    if sc:
        lines.append("")
        lines.append(
            f"scene factory: {sc['scenes_simulated']} scenes over "
            f"{sc['scene_batches']} batched dispatches  "
            f"(stream batches={sc['stream_batches']}  "
            f"datagen chunks={sc['datagen_batches']})"
        )
        last = sc.get("last_scene") or {}
        if last:
            lines.append(
                f"scene factory last batch: n_scenes={last.get('n_scenes')}  "
                f"scenario={last.get('scenario')}  "
                f"rir_len={last.get('rir_len')}  "
                f"max_order={last.get('max_order')}"
            )
    if summary.get("spans"):
        lines.append(
            f"causal spans: {summary['spans']} over {summary['n_traces']} "
            f"trace(s) — render one with `disco-obs trace <log> <trace_id>`"
        )
    for e in summary.get("flights") or []:
        a = e["attrs"]
        lines.append(
            f"FLIGHT DUMP ({a.get('trigger')}): {a.get('path')} "
            f"[{a.get('n_entries')} entries]"
            + (f" — {a.get('reason')}" if a.get("reason") else "")
        )
    by_label = summary.get("recompiles_by_label") or {}
    if by_label:
        # per-label table (the jit_recompiles{label} counter series): which
        # entry point traced how many programs — the first thing to read
        # when `make trace-check`'s budget gate names a label
        lines.append("")
        lines.append(f"{'recompiled programs':<28}{'programs':>9}")
        for label, n in sorted(by_label.items()):
            lines.append(f"{label:<28}{n:>9}")
    def fmt6(v):
        # the schema admits any attrs dict; the reader must render partial
        # epoch events, not crash on a missing loss
        return f"{v:.6f}" if isinstance(v, (int, float)) else "-"

    for e in summary["epochs"]:
        a = e["attrs"]
        lines.append(
            f"epoch {a.get('epoch')}: train {fmt6(a.get('train_loss'))} "
            f"val {fmt6(a.get('val_loss'))} ({a.get('steps')} steps)"
        )
    for e in summary["sentinels"]:
        a = e["attrs"]
        lines.append(
            f"SENTINEL non-finite at stage {e['stage']!r}: {a.get('name')} "
            f"{a.get('n_nonfinite')}/{a.get('shape')} bad "
            f"(nan={a.get('n_nan')}, inf={a.get('n_inf')})"
        )
    for e in summary["watchdogs"]:
        lines.append(f"WATCHDOG fired: {e['attrs'].get('suspected_cause')}")
    if summary["faults"]:
        # injected faults grouped by kind; transient_error retries listed
        # individually would drown the report, so they are counted per label
        by_kind: dict[str, int] = {}
        for e in summary["faults"]:
            key = e["attrs"].get("fault", "?")
            if key == "transient_error":
                key = f"transient_error@{e['stage']}"
            by_kind[key] = by_kind.get(key, 0) + 1
        lines.append(
            "faults: " + "  ".join(f"{k}×{v}" for k, v in sorted(by_kind.items()))
        )
        for e in summary["faults"]:
            a = e["attrs"]
            if a.get("fault") == "transient_error":
                continue
            detail = "  ".join(
                f"{k}={v}" for k, v in a.items() if k not in ("fault", "blocks")
            )
            lines.append(f"  FAULT {a.get('fault')}: {detail}")
    if summary["recoveries"]:
        by_stage: dict[str, int] = {}
        for e in summary["recoveries"]:
            by_stage[e["stage"] or "?"] = by_stage.get(e["stage"] or "?", 0) + 1
        lines.append(
            "recoveries: "
            + "  ".join(f"{k}×{v}" for k, v in sorted(by_stage.items()))
        )
    for e in summary["degraded"]:
        a = e["attrs"]
        lines.append(
            f"DEGRADED mode at stage {e['stage']!r}: "
            + "  ".join(f"{k}={v}" for k, v in a.items())
        )
    for e in summary["runs"]:
        a = e["attrs"]
        if e["kind"] == "run_resume":
            lines.append(
                f"run resumed (stage {e['stage']}): {a.get('n_done')} done "
                f"verified, {a.get('n_requeued')} requeued"
                + (f" ({a.get('requeued')})" if a.get("requeued") else "")
            )
        else:
            pf = a.get("preflight")
            lines.append(
                f"run started (tool {a.get('tool')})"
                + (f"  preflight ok in {pf.get('dur_s')}s on "
                   f"{pf.get('platform')} x{pf.get('device_count')}"
                   if isinstance(pf, dict) else "")
            )
    for e in summary["interrupts"]:
        lines.append(
            f"INTERRUPTED: {e['attrs'].get('reason')} — run wound down "
            f"gracefully (resumable)"
        )
    if summary["warnings"]:
        by_stage: dict[str, int] = {}
        for e in summary["warnings"]:
            by_stage[e["stage"] or "?"] = by_stage.get(e["stage"] or "?", 0) + 1
        lines.append(
            "warnings: "
            + "  ".join(f"{k}×{v}" for k, v in sorted(by_stage.items()))
        )
        for e in summary["warnings"]:
            a = e["attrs"]
            lines.append(
                f"  WARNING at {e['stage']!r}: {a.get('reason')}"
                + (f" ({a.get('unit')})" if a.get("unit") else "")
                + (f" [{a.get('path')}]" if a.get("path") else "")
            )
    return "\n".join(lines)


# -- trace / top / slo -------------------------------------------------------
def parse_address(target: str):
    """``HOST:PORT`` -> (host, port) tuple; anything else is a unix-socket
    path (the two shapes ``disco-serve`` binds)."""
    host, sep, port = target.rpartition(":")
    if sep and port.isdigit():
        return (host or "127.0.0.1", int(port))
    return target


def cmd_trace(args):
    """``disco-obs trace``: list trace ids, or render one waterfall."""
    from disco_tpu_torch.obs import trace as obs_trace

    events = read_events(args.log)
    if args.trace_id is None:
        ids = obs_trace.trace_ids(events)
        if not ids:
            print("(no span events in this log — run with tracing enabled: "
                  "disco-serve --trace, or obs.trace.enable())")
            return ids
        print(f"{len(ids)} trace(s); newest {min(args.limit, len(ids))}:")
        for tid in ids[-args.limit:][::-1]:
            spans = obs_trace.spans_of(events, tid)
            stages = [e["stage"] for e in spans]
            sess = next((e["attrs"].get("session") for e in spans
                         if e["attrs"].get("session") is not None), "?")
            seq = next((e["attrs"].get("seq") for e in spans
                        if e["attrs"].get("seq") is not None), "?")
            print(f"  {tid}  session={sess} seq={seq} hops={len(stages)} "
                  f"({stages[0]}→{stages[-1]})")
        return ids
    print(obs_trace.render_waterfall(events, args.trace_id))
    return obs_trace.chain(events, args.trace_id)


def render_status(payload: dict) -> str:
    """Render one ``status_ok`` payload (the ``disco-obs top`` screen)."""
    from disco_tpu_torch.serve.status import status_section

    lines = []
    sch = status_section(payload, "scheduler")
    lines.append(
        f"tick {sch['tick_no']} ({sch['ticks_with_work']} with work)  "
        f"pending={sch['pending_blocks']}  "
        f"super-tick={sch['blocks_per_super_tick']}  "
        + ("DRAINING" if sch["draining"] else "serving")
    )
    lad = status_section(payload, "ladder")
    if lad:
        lines.append(f"ladder: rung {lad['rung']} ({lad['mode']}), "
                     f"{lad['transitions']} transition(s)")
    sessions = status_section(payload, "sessions")
    lines.append(f"{'session':<14}{'status':<13}{'in':>6}{'done':>6}"
                 f"{'queue':>7}{'inflight':>9}")
    for s in sessions:
        lines.append(
            f"{s['id']:<14}{s['status']:<13}{s['blocks_in']:>6}"
            f"{s['blocks_done']:>6}{s['queue_depth']:>7}{s['inflight']:>9}"
            + ("  priority" if s.get("priority") else "")
        )
    if not sessions:
        lines.append("(no live sessions)")
    fmt = lambda v: "-" if v is None else f"{v:g}"
    counters = status_section(payload, "counters")
    keys = ("serve_blocks", "serve_ticks", "admission_reject",
            "session_evicted", "session_closed", "session_quarantined",
            "sessions_shed", "tap_blocks", "tap_dropped")
    lines.append("counters: " + "  ".join(
        f"{k}={counters[k]}" for k in keys if k in counters))
    gauges = status_section(payload, "gauges")
    gkeys = ("sessions_active", "sessions_parked", "queue_depth",
             "batch_occupancy", "queue_wait_p95_ms", "ladder_rung")
    lines.append("gauges:   " + "  ".join(
        f"{k}={fmt(gauges[k])}" for k in gkeys if k in gauges))
    for name, h in sorted(status_section(payload, "latency").items()):
        if h.get("count"):
            lines.append(
                f"{name}: n={h['count']} p50={fmt(h.get('p50'))} "
                f"p95={fmt(h.get('p95'))} p99={fmt(h.get('p99'))} "
                f"max={fmt(h.get('max'))}"
            )
    inflight = status_section(payload, "inflight")
    if inflight.get("count"):
        lines.append(f"in-flight spans: {inflight['count']} "
                     f"(oldest {fmt(inflight.get('oldest_s'))}s)")
        for sp in inflight.get("spans") or []:
            lines.append(f"  {sp.get('trace')}  stage={sp.get('stage')} "
                         f"session={sp.get('session')} seq={sp.get('seq')} "
                         f"age={fmt(sp.get('age_s'))}s")
    return "\n".join(lines)


def cmd_top(args):
    """``disco-obs top``: one status snapshot, or a --watch loop."""
    import time as time_mod

    from disco_tpu_torch.serve.status import fetch_status

    address = parse_address(args.address)
    while True:
        payload = fetch_status(address)
        print(render_status(payload))
        if args.watch is None:
            return payload
        print("-" * 72)
        time_mod.sleep(args.watch)


def cmd_slo(args):
    """``disco-obs slo``: judge a live server (or saved status JSON)
    against the declared targets; exit 1 on violation."""
    from disco_tpu_torch.serve.status import evaluate_slo, fetch_status

    if Path(args.target).is_file():
        payload = json.loads(Path(args.target).read_text())
    else:
        payload = fetch_status(parse_address(args.target))
    targets = {}
    for flag, name in (("serve_p95_ms", "serve_p95_ms"),
                       ("queue_wait_p95_ms", "queue_wait_p95_ms"),
                       ("max_drop_rate", "max_drop_rate"),
                       ("max_evict_rate", "max_evict_rate")):
        v = getattr(args, flag)
        if v is not None:
            targets[name] = v
    verdict = evaluate_slo(payload, targets)
    fmt = lambda v: "-" if v is None else f"{v:g}"
    for c in verdict["checks"]:
        mark = "ok " if c["ok"] else "VIOLATED"
        print(f"{c['name']:<22}{fmt(c['value']):>12}  target {fmt(c['target']):>10}  {mark}")
    print(f"SLO VERDICT: {verdict['verdict']}")
    if verdict["verdict"] != "OK":
        raise SystemExit(1)
    return verdict


#: what ``compare`` waits for
NOT_PORTED = {
    "compare": "diffs the records of a benchmark, and the port has no benchmark yet",
}


def load_bench_record(path) -> dict:
    """A record from any of its on-disk shapes: a wrapper with a ``parsed``
    field, a raw one-line JSON record, or an event log whose
    ``bench_result`` event carries it (the JAX CLI's loader)."""
    path = Path(path)
    text = path.read_text()
    try:
        d = json.loads(text)
        if isinstance(d, dict) and "kind" in d and "attrs" in d:
            d = None  # a single-line event log parses as JSON too
    except json.JSONDecodeError:
        d = None
    if d is None:
        for e in reversed(read_events(path, validate=False)):
            if e.get("kind") == "bench_result":
                return e["attrs"]
        raise SystemExit(f"{path}: neither a bench JSON nor an event log with a bench_result")
    if isinstance(d, dict) and "parsed" in d:
        d = d["parsed"]
    if not isinstance(d, dict) or "metric" not in d:
        raise SystemExit(f"{path}: not a bench record (no 'metric' field)")
    return d


def cmd_roofline(args):
    """``disco-torch-obs roofline``: the per-stage roofline table of one
    record, its stages costed at the record's workload (traced for the
    card on fake tensors; nothing runs on a device)."""
    from disco_tpu_torch.obs import roofline

    record = load_bench_record(args.record)
    result = roofline.stage_verdicts(
        record,
        peak_tflops=args.peak_tflops if args.peak_tflops is not None else roofline.PEAK_TFLOPS,
        peak_gbps=args.peak_gbps if args.peak_gbps is not None else roofline.PEAK_GBPS,
    )
    print(json.dumps(result, indent=2) if args.format == "json" else roofline.render(result))
    return result


def main(argv=None):
    """``disco-obs`` console entry point."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.cmd == "report":
        summary = summarize(read_events(args.log))
        print(render_report(summary))
        return summary
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "top":
        return cmd_top(args)
    if args.cmd == "slo":
        return cmd_slo(args)
    if args.cmd == "roofline":
        return cmd_roofline(args)
    raise SystemExit(f"disco-obs {args.cmd} {NOT_PORTED[args.cmd]} "
                     "(ROADMAP Queue 1); run it with the JAX package's disco-obs")


if __name__ == "__main__":
    main()
