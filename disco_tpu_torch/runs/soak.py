"""The chaos-soak gate of the serving survival layer (the port's
counterpart of ``disco_tpu/runs/soak.py``).

Composes the existing fault primitives — the chaos seams
(:mod:`disco_tpu_torch.runs.chaos`), protocol truncation, hard connection
drops, slow clients and injected ``TRANSPORT_ERRORS`` through the
scheduler's dispatch hook
(:func:`disco_tpu_torch.serve.scheduler.set_dispatch_fault_injector`) —
into seeded randomized multi-fault campaigns against a loopback server,
and asserts the survival invariants after every run:

1. **no torn artifact or shard** — every session checkpoint passes
   ``probe_session_state``, every tap shard ``probe_shard``;
2. **no delivered frame lost or duplicated** — each client's log of
   received ``enhanced`` seqs is exactly ``0..n_blocks-1``, once each;
3. **bit-exact reattach** — every session's stitched output equals the
   offline ``streaming_tango`` of its clip, byte for byte;
4. **bounded recovery** — after the campaign the server drains within
   :func:`recovery_tick_bound` ticks (a load-scaled budget), and the
   degradation ladder never steps up (its thresholds in block times:
   :func:`_ladder`);
5. **byte-stable ledger** — the per-seed summary (the plan plus
   deterministic survival facts from the event log) is byte-identical
   across runs of the same seed.

The crash leg (:func:`crash_leg`, the final seed's schedule): a parked
session's checkpoint survives a ``ChaosCrash`` server death and resumes
bit-exact on a fresh server through its resume token.  :func:`plan_campaign`
is the JAX package's, draw for draw.

Each leg is a function of a device: the CPU tests run one seed twice (the
byte-stability leg) and the crash leg on ``device="cpu"``, ``chip_smoke.py``
the same on the card; ``python -m disco_tpu_torch.runs.soak`` runs the full
roster of :data:`SEEDS` on ``cuda`` (``--device cpu`` for the host).
Loopback sockets only; nothing is signalled or killed.

No reference counterpart: the reference has no serving layer to soak.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

#: the seeded campaign roster (the JAX package's)
SEEDS = (201, 202, 203, 204, 205)

#: the recovery bound: scheduler ticks between the campaign's end and full
#: drain, load-scaled (a base plus a per-block slack): a wedged server blows
#: it by orders of magnitude
RECOVERY_TICK_BOUND_BASE = 3000
RECOVERY_TICKS_PER_BLOCK = 50


def recovery_tick_bound(total_blocks: int) -> int:
    """Ticks allowed between the campaign's end and full drain for a
    campaign carrying ``total_blocks`` client blocks."""
    return RECOVERY_TICK_BOUND_BASE + RECOVERY_TICKS_PER_BLOCK * total_blocks


#: the JAX gate's size: nodes, mics, refresh length, block frames, samples
K, C, U = 4, 2, 4
BLOCK = 2 * U
LENGTH = 16000


def _scene(seed: int, device):
    """(Y, m) of the JAX gate's recipe on ``device``, trimmed to whole blocks
    (a ragged final block would be a new program shape mid-campaign in the
    JAX package)."""
    from disco_tpu_torch.serve.check import scene

    Y, m = scene(seed, length=LENGTH, n_nodes=K, n_mics=C, device=device)
    T = Y.shape[-1] - Y.shape[-1] % BLOCK
    return Y[..., :T], m[..., :T]


def _offline(Y, m, device) -> np.ndarray:
    from disco_tpu_torch.serve.check import offline_stream

    return offline_stream(Y, m, device=device, update_every=U, policy="local")


def _config(F: int):
    from disco_tpu_torch.serve.check import session_config

    return session_config(F, n_nodes=K, n_mics=C, block_frames=BLOCK, update_every=U)


def _warm(F: int, n_super: int, device) -> float:
    """Run the serve-shaped calls through the production scheduler path
    (one super-tick group and one per-block dispatch on a throwaway
    scheduler), twice: the first pass pays start-up cost (on the card, the
    kernels' build and first launches), which is not a fault — unwarmed it
    would dominate the campaign's queue waits and the first run of a seed
    would not match the second.  Returns the second pass's milliseconds a
    block, the device's warm dispatch time at the soak's shape."""
    from disco_tpu_torch.serve import Scheduler

    cap = max(2 * n_super, 2)
    sched = Scheduler(max_sessions=1, max_queue_blocks=cap, max_blocks_per_tick=cap,
                      blocks_per_super_tick=n_super, device=device)
    s = sched.open_session(_config(F), session_id="warm")
    Y = np.zeros((K, C, F, BLOCK), np.complex64)
    m = np.ones((K, F, BLOCK), np.float32)
    seq = 0

    def one_pass() -> int:
        nonlocal seq
        for _ in range(n_super):
            sched.push_block(s, seq, Y, m, m)
            seq += 1
        sched.tick()                  # the (super-tick or per-block) call
        if n_super > 1:
            sched.push_block(s, seq, Y, m, m)
            seq += 1
            sched.tick()              # the per-block tail
        sched.tick()                  # flush the overlap buffer (a readback)
        return n_super + (n_super > 1)

    one_pass()
    t0 = time.perf_counter()
    n = one_pass()
    return (time.perf_counter() - t0) * 1e3 / n


#: the ladder's default thresholds (queue-wait p95 500 ms up, 100 ms down)
#: hold the soak's light load while one block's warm dispatch takes at most
#: this long: a campaign keeps up to 3 sessions x 4 blocks in flight, so a
#: queue wait reaches about 12 block times, and a block served beside the
#: client threads costs up to twice its warm time (a host CPU's plain
#: versions: ~65 against ~38 ms) — 12 x 2 x 10 ms leaves the 500 ms twice
LADDER_BLOCK_MS = 10.0


def _ladder(block_ms: float):
    """The campaign server's degradation ladder: the default thresholds,
    scaled by how far the device's warm block time exceeds
    :data:`LADDER_BLOCK_MS` (1 on the card at the gate's size; the plain
    versions on a host CPU take longer a block), so "light load" means the
    same number of block times on any device."""
    from disco_tpu_torch.serve.ladder import DegradationLadder

    scale = max(1.0, block_ms / LADDER_BLOCK_MS)
    return DegradationLadder(p95_high_ms=500.0 * scale, p95_low_ms=100.0 * scale)


def plan_campaign(seed: int) -> dict:
    """Expand one seed into a deterministic multi-fault schedule.

    Per session: one connection fault (``drop`` — hard socket kill after a
    drawn delivery, ``truncate`` — a partial frame then EOF mid-stream, or
    ``none``) plus an optional slow-reader delay; per run: a seeded set of
    dispatch-attempt indices that raise an injected transport error (single
    indices retry in place; a consecutive triple exhausts the retry budget
    and exercises quarantine).  Same seed, same plan, same summary —
    ``plan_faults``'s determinism contract applied to the serving layer.

    No reference counterpart (module docstring)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_sessions = int(2 + rng.integers(0, 2))          # 2-3 clients
    kinds = ["drop", "truncate", "none"]
    faults = [kinds[int(rng.integers(0, len(kinds)))] for _ in range(n_sessions)]
    if all(f == "none" for f in faults):
        faults[0] = "drop"                            # every run multi-faults
    plan = {
        "seed": seed,
        "super_tick": 2 if seed % 2 == 0 else 1,
        "sessions": [
            {
                "sid": f"soak{seed}-{i}",
                "scene_seed": seed * 100 + i,
                "fault": faults[i],
                "drop_after": int(rng.integers(1, 4)),  # deliveries before it
                "slow_ms": int(rng.integers(0, 2)) * 5,  # 0 or 5 ms per block
            }
            for i in range(n_sessions)
        ],
        "crash_leg": seed == SEEDS[-1],
    }
    # transport bursts only on per-block schedules (attempt indices map 1:1
    # to blocks there, so consumption is deterministic); one lone transient
    # plus one exhausting triple
    if plan["super_tick"] == 1 and not plan["crash_leg"]:
        lone = int(rng.integers(2, 6))
        burst = int(rng.integers(8, 11))
        plan["transport_attempts"] = sorted({lone, burst, burst + 1, burst + 2})
    else:
        plan["transport_attempts"] = []
    return plan


def _logging_client(*args, **kwargs):
    """A ServeClient that logs every received ``enhanced`` seq (loss and
    duplicate detection across reattaches)."""
    from disco_tpu_torch.serve import ServeClient

    class LoggingClient(ServeClient):
        def __init__(self, *a, **k):
            self.seq_log: list[int] = []
            super().__init__(*a, **k)

        def _fold(self, frame):
            if frame.get("type") == "enhanced":
                self.seq_log.append(int(frame["seq"]))
            super()._fold(frame)

    return LoggingClient(*args, **kwargs)


def _make_injector(attempt_indices):
    """The transport-fault injector: raises ``TimeoutError`` (a
    ``TRANSPORT_ERRORS`` member) on the planned dispatch-attempt indices,
    counting every attempt, retries included — so a consecutive index
    triple hits one block's whole retry chain and exhausts it."""
    planned = set(attempt_indices)
    state = {"n": 0, "injected": 0}

    def injector(_sid, _seqs):
        state["n"] += 1
        if state["n"] - 1 in planned:
            state["injected"] += 1
            raise TimeoutError(f"soak: injected transport fault at dispatch attempt "
                               f"{state['n'] - 1}")

    return injector, state


def _client_worker(plan_s, addr, Y, m, results, errors, i):
    """One streaming client thread executing its session's fault script."""
    cl = _logging_client(addr, timeout_s=120.0, reattach_timeout_s=10.0,
                         retry_seed=plan_s["scene_seed"])
    try:
        cl.open(_config(Y.shape[-2]), session_id=plan_s["sid"])
        fired = [False]

        def on_block(seq, _yf):
            if plan_s["slow_ms"]:
                time.sleep(plan_s["slow_ms"] / 1e3)
            if fired[0] or seq + 1 != plan_s["drop_after"]:
                return
            fired[0] = True
            if plan_s["fault"] == "drop":
                # a hard network drop: both directions die mid-stream
                cl._sock.shutdown(socket.SHUT_RDWR)
            elif plan_s["fault"] == "truncate":
                # a partial frame then EOF: the server must park the session
                from disco_tpu_torch.serve import protocol

                frame = protocol.pack_frame({"type": "close"})
                cl._sock.sendall(frame[: max(1, len(frame) // 2)])
                cl._sock.shutdown(socket.SHUT_WR)

        yf = cl.enhance_clip(Y, m, m, on_block=on_block)
        cl.close()
        results[i] = (yf, list(cl.seq_log), cl.reattaches)
    except Exception as e:  # reported as the campaign's failure
        errors.append(f"client {plan_s['sid']}: {type(e).__name__}: {e}")
    finally:
        cl.shutdown()


def run_soak(seed: int, tmp, failures: list, *, device=None) -> dict:
    """One seeded soak campaign under ``tmp``; returns its canonical
    summary (deterministic: the byte-stability invariant compares its
    JSON)."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.flywheel import CorpusTap, list_shards, probe_shard
    from disco_tpu_torch.serve import EnhanceServer, set_dispatch_fault_injector
    from disco_tpu_torch.serve.session import probe_session_state

    plan = plan_campaign(seed)
    scenes = [_scene(s["scene_seed"], device) for s in plan["sessions"]]
    refs = [_offline(Y, m, device) for (Y, m) in scenes]
    n_blocks = [-(-Y.shape[-1] // BLOCK) for (Y, _m) in scenes]
    block_ms = _warm(scenes[0][0].shape[-2], plan["super_tick"], device)

    run_dir = Path(tmp) / f"seed{seed}"
    run_dir.mkdir(parents=True, exist_ok=True)
    obs_log = run_dir / "events.jsonl"
    tap = CorpusTap(run_dir / "tap", records_per_shard=8)
    injector, inj_state = _make_injector(plan["transport_attempts"])

    summary: dict = {"seed": seed, "plan": plan}
    with obs.recording(obs_log):
        srv = EnhanceServer(
            max_sessions=8, state_dir=run_dir / "state", tap=tap,
            blocks_per_super_tick=plan["super_tick"], park_ttl_s=60.0, quarantine_ticks=5,
            tick_deadline_s=10.0, dispatch_retries=2, retry_seed=seed,
            ladder=_ladder(block_ms), device=device,
        )
        srv.scheduler.dispatch_retry_base_s = 0.002
        set_dispatch_fault_injector(injector)
        try:
            addr = srv.start()
            results: list = [None] * len(scenes)
            errors: list = []
            threads = [threading.Thread(
                target=_client_worker,
                args=(plan["sessions"][i], addr, scenes[i][0], scenes[i][1], results, errors,
                      i)) for i in range(len(scenes))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            recovery_start_tick = srv.scheduler.tick_no
            failures.extend(f"seed {seed}: {e}" for e in errors)
            srv.stop(timeout_s=120)
            if plan["crash_leg"]:
                # with the campaign server fully stopped: the chaos seam is
                # process-global, and exactly ONE server must tick when it fires
                summary["crash_leg"] = crash_leg(seed, run_dir, failures, device=device)
        finally:
            set_dispatch_fault_injector(None)
            tap_stats = tap.close()

        # invariants 2 + 3: loss/duplication and bit-exactness per session
        for i, s in enumerate(plan["sessions"]):
            if results[i] is None:
                failures.append(f"seed {seed}: session {s['sid']} returned nothing")
                continue
            yf, seq_log, _reattaches = results[i]
            if sorted(seq_log) != list(range(n_blocks[i])):
                dup = sorted({q for q in seq_log if seq_log.count(q) > 1})
                missing = sorted(set(range(n_blocks[i])) - set(seq_log))
                failures.append(f"seed {seed}: session {s['sid']} delivered frames "
                                f"lost={missing} duplicated={dup}")
            if not np.array_equal(yf, refs[i]):
                failures.append(f"seed {seed}: session {s['sid']} stitched output is not "
                                f"bit-exact vs offline streaming_tango (max abs diff "
                                f"{np.abs(yf - refs[i]).max():g})")
        # invariant 4: bounded recovery
        ticks_total = srv.scheduler.tick_no
        tick_bound = recovery_tick_bound(sum(n_blocks))
        if ticks_total - recovery_start_tick > tick_bound:
            failures.append(f"seed {seed}: drain took {ticks_total - recovery_start_tick} "
                            f"ticks after the campaign (> {tick_bound} for {sum(n_blocks)} "
                            "blocks)")
        # invariant 1: no torn artifact or shard
        state_dir = run_dir / "state"
        for p in sorted(state_dir.glob("*.msgpack")) if state_dir.is_dir() else []:
            if not probe_session_state(p):
                failures.append(f"seed {seed}: torn session checkpoint {p}")
        for p in list_shards(run_dir / "tap"):
            if not probe_shard(p):
                failures.append(f"seed {seed}: torn tap shard {p}")
        if tap_stats["blocks_dropped"]:
            failures.append(f"seed {seed}: tap dropped {tap_stats['blocks_dropped']} blocks "
                            "at soak load")

    # invariant 5: the plan plus deterministic survival facts from the
    # validated event log; race-dependent counts are asserted, summarized
    # as booleans, and wall times and ticks never enter the summary
    events = obs.read_events(obs_log)
    campaign_ids = {s["sid"] for s in plan["sessions"]}
    acts = [e["attrs"].get("action") for e in events
            if e["kind"] == "session" and e["attrs"].get("session") in campaign_ids]
    n_faults = sum(1 for s in plan["sessions"] if s["fault"] != "none")
    parks, reatt = acts.count("park"), acts.count("reattach")
    spurious_degrades = sum(1 for e in events if e["kind"] == "degraded"
                            and e["attrs"].get("controller") == "ladder")
    summary.update({
        "sessions": len(plan["sessions"]),
        "blocks": n_blocks,
        "connection_faults": n_faults,
        "transport_faults_planned": len(plan["transport_attempts"]),
        "transport_faults_injected": inj_state["injected"],
        "quarantines": acts.count("quarantine"),
        "evictions": acts.count("evict"),
        "all_parks_reattached": parks == reatt and parks >= n_faults,
        "spurious_ladder_degrades": spurious_degrades,
        "torn_artifacts": 0,   # any torn probe above is a failure
    })
    if summary["transport_faults_injected"] != len(plan["transport_attempts"]):
        failures.append(f"seed {seed}: injected {summary['transport_faults_injected']} "
                        f"transport faults, planned {len(plan['transport_attempts'])}")
    if not summary["all_parks_reattached"]:
        failures.append(f"seed {seed}: {n_faults} connection fault(s), {parks} park(s), "
                        f"{reatt} reattach(es) — a park never reattached (or a fault evicted "
                        "instead of parking)")
    if summary["evictions"]:
        failures.append(f"seed {seed}: {summary['evictions']} eviction(s) during the soak — "
                        "every faulted session must park and reattach")
    if spurious_degrades:
        failures.append(f"seed {seed}: the ladder degraded {spurious_degrades}x during a "
                        f"light-load soak (warm block {block_ms:.1f} ms)")
    return summary


def check_byte_stable(failures: list, tmp, seed: int = SEEDS[0], *, device=None) -> dict:
    """Invariant 5 asserted literally: ``seed`` run twice in fresh
    directories, the two summaries compared byte for byte."""
    first = run_soak(seed, Path(tmp) / "a", failures, device=device)
    again = run_soak(seed, Path(tmp) / "b", failures, device=device)
    a = json.dumps(first, sort_keys=True).encode()
    b = json.dumps(again, sort_keys=True).encode()
    if a != b:
        failures.append(f"seed {seed}: event summary is not byte-stable across runs:\n  "
                        f"{a.decode()}\n  {b.decode()}")
    return first


def crash_leg(seed: int, run_dir, failures: list, *, device=None) -> dict:
    """A parked session's checkpoint survives a ChaosCrash server death and
    resumes bit-exact on a fresh server through its resume token."""
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.serve import EnhanceServer, ServeClient
    from disco_tpu_torch.serve.session import probe_session_state

    Y, m = _scene(seed * 100 + 77, device)
    F, T = Y.shape[-2:]
    ref = _offline(Y, m, device)
    n_blocks = -(-T // BLOCK)
    half = max(1, n_blocks // 2)
    state_dir = Path(run_dir) / "crash_state"

    srv = EnhanceServer(max_sessions=4, state_dir=state_dir, park_ttl_s=60.0, device=device)
    addr = srv.start()
    cl = ServeClient(addr, reattach_retries=0)
    cl.open(_config(F), session_id="crashee")
    outs = {}
    for i in range(half):
        lo, hi = i * BLOCK, (i + 1) * BLOCK
        cl.send_block(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi])
        outs[i] = cl.recv_enhanced(i, timeout_s=60)
    cl.shutdown()           # a deliberate disconnect: the session PARKS
    ckpt = state_dir / "session_crashee.state.msgpack"
    deadline = time.monotonic() + 30.0
    while not ckpt.is_file() and time.monotonic() < deadline:
        time.sleep(0.01)    # the park checkpoint lands on the next tick
    if not ckpt.is_file():
        failures.append(f"seed {seed}: park checkpoint never written")
    # the server dies mid-tick: arm the seam and WAIT for the dispatch loop
    # to hit it (stop() here would win the race)
    chaos.configure("serve_tick", after=3)
    crashed = False
    try:
        deadline = time.monotonic() + 30.0
        while srv.crashed is None and time.monotonic() < deadline:
            time.sleep(0.005)
        try:
            srv.wait(timeout_s=30)
        except chaos.ChaosCrash:
            crashed = True
    finally:
        chaos.disable()
    if not crashed:
        failures.append(f"seed {seed}: chaos serve_tick crash never fired")
    if not probe_session_state(ckpt):
        failures.append(f"seed {seed}: park checkpoint torn by the crash")

    # a FRESH server: the resume token reattaches through the checkpoint
    srv2 = EnhanceServer(max_sessions=4, state_dir=state_dir, device=device)
    addr2 = srv2.start()
    rest = None
    try:
        cl2 = ServeClient(addr2)
        try:
            cl2.open(_config(F), resume="crashee")
            if cl2.blocks_done != half:
                failures.append(f"seed {seed}: crash-resume started at {cl2.blocks_done}, "
                                f"expected {half}")
            rest = cl2.enhance_clip(Y, m, m)
            cl2.close()
        finally:
            cl2.shutdown()
    finally:
        srv2.stop(timeout_s=120)
    if rest is not None:
        full = np.concatenate([np.concatenate([outs[i] for i in range(half)], axis=-1), rest],
                              axis=-1)
        if not np.array_equal(full, ref):
            failures.append(f"seed {seed}: crash-resume stitch is not bit-exact (max abs diff "
                            f"{np.abs(full - ref).max():g})")
    return {"blocks_before_park": half, "blocks_total": n_blocks, "crash_injected": crashed}


def main(argv=None) -> int:
    """Run the chaos-soak gate (every seed of :data:`SEEDS`, the first one
    twice); exit 1 on failure.  Runs on ``cuda`` unless ``--device cpu``
    (RuntimeError without a CUDA device)."""
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.runs.soak")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        summaries = [check_byte_stable(failures, Path(tmp) / "stable", SEEDS[0],
                                       device=device)]
        summaries += [run_soak(seed, Path(tmp) / "a", failures, device=device)
                      for seed in SEEDS[1:]]
    if failures:
        for f in failures:
            print(f"soak-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({
        "soak_check": "ok",
        "schedules": len(SEEDS),
        "connection_faults": sum(s["connection_faults"] for s in summaries),
        "transport_faults": sum(s["transport_faults_injected"] for s in summaries),
        "all_parks_reattached": all(s["all_parks_reattached"] for s in summaries),
        "quarantines": sum(s["quarantines"] for s in summaries),
        "crash_legs": sum(1 for s in summaries if "crash_leg" in s),
        "byte_stable_seeds": 1,
        "recovery_tick_bound_base": RECOVERY_TICK_BOUND_BASE,
        "recovery_ticks_per_block": RECOVERY_TICKS_PER_BLOCK,
        "sigkills_issued": 0,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
