"""The causal-tracing / flight-recorder / live-status gate (the port's
counterpart of ``disco_tpu/obs/scope.py``).

Runs the enhancement server in-process on loopback with tracing, the flight
recorder and the corpus tap armed, and asserts:

1. **Chain completeness**: every delivered frame of every traced client
   reconstructs a COMPLETE causal chain from client seq to tap shard —
   ``client_block → enqueue → dispatch → readback → deliver → tap`` — with
   intact parent links and causal hop order
   (:func:`disco_tpu_torch.obs.trace.verify_chain`), while every session's
   output stays bit-identical to the offline ``streaming_tango`` of its
   clip (tracing observes, never perturbs).
2. **Back-compat**: a client with ``trace=False`` (no ``trace`` header on
   the wire) is served bit-exact and leaves ZERO span events naming its
   session.
3. **Status/registry agreement**: the read-only ``status`` frame answers
   without a session, its ``counters`` section equals
   ``REGISTRY.snapshot()["counters"]`` exactly, and the SLO evaluator
   renders a verdict over it.
4. **Fault leg**: an injected transport fault (the scheduler's dispatch
   hook) exhausts the retry budget and quarantines the session; the flight
   recorder's quarantine dump names the failing ``dispatch`` span (``failed:
   true`` with the fault's error text) and is byte-stable; the wounded
   session still finishes bit-exact.

Each leg is a function of a device and of the session shape: the CPU tests
call them on ``device="cpu"`` at the JAX gate's size (4 nodes × 2 mics,
8-frame blocks, refresh every 4 frames), ``chip_smoke.py`` on the card at
the north-star width.  ``python -m disco_tpu_torch.obs.scope`` runs the
gate on ``cuda`` (``--device cpu`` for the host).  References are computed
before a server starts: while it runs, only its dispatch thread touches the
device.

No reference counterpart: the reference has no serving layer and no
telemetry.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

#: the JAX gate's size: nodes, mics, refresh length, block frames, samples
K, C, U = 4, 2, 4
BLOCK = 2 * U
LENGTH = 6000

#: the serve chain every delivered frame must reconstruct (tap included:
#: the gate runs with the corpus tap armed)
CHAIN = ("client_block", "enqueue", "dispatch", "readback", "deliver", "tap")

#: the JAX gate's clients: (seed, config kwargs, traced?) — three traced
#: sessions and one that sends no trace header
SPECS = ((71, {}, True), (72, {"mu": 1.2}, True), (73, {"lambda_cor": 0.97}, True),
         (74, {}, False))


def _shape(kw: dict) -> dict:
    return {"n_nodes": kw.get("n_nodes", K), "n_mics": kw.get("n_mics", C),
            "block": kw.get("block", BLOCK), "update_every": kw.get("update_every", U),
            "length": kw.get("length", LENGTH)}


def _inputs(seed: int, cfg: dict, sh: dict, device):
    """(Y, m, offline reference, SessionConfig kwargs) of one client."""
    from disco_tpu_torch.serve.check import offline_stream, scene

    Y, m = scene(seed, length=sh["length"], n_nodes=sh["n_nodes"], n_mics=sh["n_mics"],
                 device=device)
    ref = offline_stream(Y, m, device=device, update_every=sh["update_every"], policy="local",
                         **cfg)
    return Y, m, ref


def _config(F: int, sh: dict, **kw):
    from disco_tpu_torch.serve.check import session_config

    return session_config(F, n_nodes=sh["n_nodes"], n_mics=sh["n_mics"],
                          block_frames=sh["block"], update_every=sh["update_every"], **kw)


def check_chains_and_status(failures: list, tmp, *, device=None, specs=SPECS,
                            timeout_s: float = 300.0, **shape) -> dict:
    """Legs 1-3's serving half: the clients of ``specs`` through a tap-armed
    loopback server, their outputs against the offline references, and the
    status frame against the registry.  ``shape``: ``n_nodes``, ``n_mics``,
    ``block``, ``update_every``, ``length`` (the JAX gate's by default)."""
    from disco_tpu_torch.flywheel import CorpusTap
    from disco_tpu_torch.obs.metrics import REGISTRY
    from disco_tpu_torch.serve import EnhanceServer, ServeClient
    from disco_tpu_torch.serve.check import _differs, _run_clients
    from disco_tpu_torch.serve.status import evaluate_slo, status_section

    sh = _shape(shape)
    tmp = Path(tmp)
    inputs = [_inputs(seed, cfg, sh, device) for seed, cfg, _tr in specs]
    F = inputs[0][0].shape[-2]
    results: list = [None] * len(specs)
    session_ids: list = [None] * len(specs)

    tap = CorpusTap(tmp / "tap", records_per_shard=8)
    srv = EnhanceServer(max_sessions=8, tap=tap, device=device)
    addr = srv.start()
    try:
        def work(i):
            seed, cfg, traced = specs[i]
            Y, m, _ref = inputs[i]
            cl = ServeClient(addr, trace=bool(traced))
            try:
                session_ids[i] = cl.open(_config(F, sh, **cfg), session_id=f"scope{i}")
                results[i] = cl.enhance_clip(Y, m, m)
                cl.close()
            finally:
                cl.shutdown()

        failures.extend(_run_clients(len(specs), work, timeout_s))
        # quiesce the tap before the exact counters comparison: its writer
        # thread bumps tap counters asynchronously
        tap_stats = tap.close()
        if tap_stats["blocks_dropped"]:
            failures.append(f"tap dropped {tap_stats['blocks_dropped']} blocks at gate load")
        status_client = ServeClient(addr)
        try:
            status = status_client.status(timeout_s=30)
        finally:
            status_client.shutdown()
        counters_now = REGISTRY.snapshot()["counters"]
        served = status_section(status, "counters")
        if served != counters_now:
            drift = {k: (served.get(k), counters_now.get(k))
                     for k in set(served) | set(counters_now)
                     if served.get(k) != counters_now.get(k)}
            failures.append(f"status counters disagree with the registry: {drift}")
        for name in ("sessions", "scheduler", "latency", "inflight", "gauges"):
            if name not in status:
                failures.append(f"status frame missing the {name!r} section")
        slo = evaluate_slo(status, {"serve_p95_ms": 60000.0, "queue_wait_p95_ms": 60000.0})
        if slo["verdict"] != "OK" or len(slo["checks"]) != 4:
            failures.append(f"SLO evaluator returned {slo} on a healthy idle server")
    finally:
        srv.stop()

    for i, (_Y, _m, ref) in enumerate(inputs):
        kind = "traced" if specs[i][2] else "untraced"
        err = _differs(f"session {i} ({kind})", results[i], ref)
        if err:
            failures.append(err + " — tracing perturbed the pipeline")
    traced = [i for i, s in enumerate(specs) if s[2]]
    return {
        "n_clients": len(specs),
        "n_blocks": sum(-(-inputs[i][2].shape[-1] // sh["block"]) for i in traced),
        "untraced_sessions": [session_ids[i] for i, s in enumerate(specs) if not s[2]],
        "session_ids": [session_ids[i] for i in traced],
        "tap_shards": tap_stats["shards_written"],
    }


def verify_chains(failures: list, events: list, info: dict) -> int:
    """Leg 1's log half: every delivered (session, seq) of every traced
    client has a complete verified chain; leg 2's: an untraced session
    appears in ZERO span events.  Returns the chains verified."""
    from disco_tpu_torch.obs import trace as obs_trace

    spans = [e for e in events if e["kind"] == "span"]
    for sid in info["untraced_sessions"]:
        untraced = [e for e in spans if e["attrs"].get("session") == sid]
        if untraced:
            failures.append(f"back-compat broken: {len(untraced)} span event(s) name the "
                            f"untraced client's session {sid!r}")
    delivered: dict = {}
    for e in spans:
        if e["stage"] == "deliver":
            delivered[(e["attrs"].get("session"), e["attrs"].get("seq"))] = e["attrs"]["trace"]
    expect_per_session = info["n_blocks"] // len(info["session_ids"])
    n_verified = 0
    for sid in info["session_ids"]:
        seqs = sorted(seq for (s, seq) in delivered if s == sid)
        if seqs != list(range(expect_per_session)):
            failures.append(f"session {sid}: deliver spans cover seqs {seqs}, expected "
                            f"0..{expect_per_session - 1} — not every delivered frame is traced")
            continue
        for seq in seqs:
            try:
                obs_trace.verify_chain(events, delivered[(sid, seq)], require=CHAIN)
                n_verified += 1
            except ValueError as e:
                failures.append(f"chain verification failed: {e}")
    return n_verified


def check_fault_dump(failures: list, tmp, dump_dir, *, device=None, seed: int = 81,
                     solver: str | None = None, **shape) -> dict:
    """Leg 4: an injected transport fault quarantines the session; the
    quarantine dump under ``dump_dir`` (the armed flight recorder's) names
    the failing span and is byte-stable; the stream finishes bit-exact."""
    from disco_tpu_torch.obs import flight as obs_flight
    from disco_tpu_torch.serve import EnhanceServer, ServeClient
    from disco_tpu_torch.serve.check import _differs
    from disco_tpu_torch.serve.scheduler import set_dispatch_fault_injector

    sh = _shape(shape)
    tmp, dump_dir = Path(tmp), Path(dump_dir)
    cfg = {} if solver is None else {"solver": solver}
    Y, m, ref = _inputs(seed, cfg, sh, device)
    state = {"failures": 0}

    def injector(session_id, seqs):
        if session_id == "wounded" and state["failures"] < 3:
            state["failures"] += 1
            raise OSError("scope-check: injected transport fault")

    # a short quarantine, so the wounded stream finishes inside the gate
    srv = EnhanceServer(max_sessions=4, quarantine_ticks=3, tick_interval_s=0.001,
                        dispatch_retries=2, device=device)
    addr = srv.start()
    set_dispatch_fault_injector(injector)
    try:
        cl = ServeClient(addr, trace=True)
        try:
            cl.open(_config(Y.shape[-2], sh, **cfg), session_id="wounded")
            got = cl.enhance_clip(Y, m, m)
            cl.close()
        finally:
            cl.shutdown()
    finally:
        set_dispatch_fault_injector(None)
        srv.stop()
    if state["failures"] < 3:
        failures.append(f"fault injector only fired {state['failures']}/3 times — the retry "
                        "budget was never exhausted, nothing was quarantined")
    err = _differs("wounded session (post-quarantine)", got, ref)
    if err:
        failures.append(err)
    dumps = sorted(dump_dir.glob("flight-*-quarantine.json"))
    if not dumps:
        failures.append(f"no quarantine flight dump under {dump_dir} "
                        f"(present: {[p.name for p in dump_dir.glob('*')]})")
        return {"dumps": 0, "injected_failures": state["failures"]}
    payload = json.loads(dumps[0].read_text())
    # a ring per subsystem: a span's ring is its hop ("dispatch")
    failing = [(hop, e) for hop, ring in payload["subsystems"].items() for e in ring
               if e["kind"] == "span" and e["attrs"].get("failed")]
    if not failing:
        failures.append("quarantine dump does not name the failing span "
                        "(no span entry with failed=true)")
    elif failing[0][0] != "dispatch" or \
            "injected transport fault" not in failing[0][1]["attrs"].get("error", ""):
        failures.append(f"failing span is not the faulted dispatch: {failing[0]}")
    # byte stability: the ring is quiet now (server stopped) — two dumps of
    # the unchanged state must be byte-identical
    a = obs_flight.flight().dump(tmp / "stable_a.json", trigger="manual",
                                 reason="byte-stability probe")
    b = obs_flight.flight().dump(tmp / "stable_b.json", trigger="manual",
                                 reason="byte-stability probe")
    if Path(a).read_bytes() != Path(b).read_bytes():
        failures.append("flight dump is not byte-stable: two dumps of the unchanged ring "
                        "differ")
    return {"dumps": len(dumps), "failing_spans": len(failing),
            "injected_failures": state["failures"]}


def run_scope(failures: list, tmp, *, device=None, specs=SPECS, solver: str | None = None,
              **shape) -> dict:
    """The whole gate under ``tmp``: tracing, the flight recorder (dumping
    to ``tmp/flight``) and the recorder armed for legs 1-4, then the log
    legs.  ``solver``: the sessions' solver (their ``SessionConfig``
    default when None)."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.obs import flight as obs_flight
    from disco_tpu_torch.obs import trace as obs_trace

    tmp = Path(tmp)
    if solver is not None:
        specs = tuple((seed, {**cfg, "solver": solver}, tr) for seed, cfg, tr in specs)
    obs_log = tmp / "scope_check.jsonl"
    obs_trace.enable()
    obs_flight.enable(dump_dir=tmp / "flight")
    try:
        with obs.recording(obs_log):
            obs.write_manifest(tool="scope-check")
            info = check_chains_and_status(failures, tmp, device=device, specs=specs, **shape)
            fault = check_fault_dump(failures, tmp, tmp / "flight", device=device,
                                     solver=solver, **shape)
            obs.record("counters", **obs.REGISTRY.snapshot())
        events = obs.read_events(obs_log)  # schema-validating read
        n_verified = verify_chains(failures, events, info)
        if not any(e["kind"] == "flight" for e in events):
            failures.append("event log carries no flight events (dump notices missing)")
    finally:
        obs_trace.disable()
        obs_flight.disable()
    return {"clients": info["n_clients"], "chains_verified": n_verified,
            "tap_shards": info["tap_shards"], "flight_dumps": fault["dumps"],
            "failing_spans": fault.get("failing_spans", 0),
            "injected_failures": fault["injected_failures"]}


def main(argv=None) -> int:
    """Run the scope gate; exit 1 on failure.  Runs on ``cuda`` unless
    ``--device cpu`` (RuntimeError without a CUDA device)."""
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.obs.scope")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        out = run_scope(failures, tmp, device=device)
    if failures:
        for f in failures:
            print(f"scope-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"scope_check": "ok", **out, "sigkills_issued": 0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
