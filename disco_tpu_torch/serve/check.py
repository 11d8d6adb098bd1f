"""The serving contract's legs, as functions of a device (the port's
counterpart of ``disco_tpu/serve/check.py``).

Each leg runs an in-process :class:`~disco_tpu_torch.serve.EnhanceServer`
on loopback with numpy :class:`~disco_tpu_torch.serve.ServeClient`
clients on host threads, appends what it finds wrong to ``failures`` and
returns its numbers.  The CPU tests call them on ``device="cpu"`` at a small
size, and
``chip_smoke.py`` phase 3h on the card at the north-star width, so the
contract is written once:

1. :func:`check_parity` — concurrent sessions, each delivered stream
   bit-identical to its offline reference (the whole-clip
   ``streaming_tango`` of the same clip), and exactly one batched readback
   (``device_get_batches``) per tick with work; in either tick mode (the
   caller passes ``blocks_per_super_tick``).
2. :func:`check_drain_resume` — a graceful stop (``runs.interrupt``) with a
   half-fed session drains, checkpoints and closes; no frame lost; the
   stream resumed on a fresh server stitches bit-identical.
3. :func:`check_chaos` — a ``serve_tick`` crash mid-stream leaves every
   frame received before it complete and bit-correct; a ``mid_write`` crash
   during the drain checkpoint leaves no truncated checkpoint at a final
   path.
4. :func:`check_overload` — flooding past the per-tick block budget and
   admission past capacity: clean ``capacity`` errors, a stepwise ladder
   that degrades and recovers, every flooded session still bit-exact.
5. :func:`check_chained` — a time-domain session equals
   ``streaming_clip_fused`` driven window by window with the state
   carried.

All references are computed by the caller BEFORE the server starts (while a
server runs, only its dispatch thread touches the device), through
:func:`offline_stream`, :func:`per_block_stream` and
:func:`chained_windows`.

6. :func:`check_tap` — the parity cycle with a
   :class:`~disco_tpu_torch.flywheel.CorpusTap` on: no block dropped, one
   record a delivered block, every shard passing ``probe_shard`` and the
   manifest's verified replay, and serving bit-identical with the tap on.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np

#: the small size of the CPU checks: nodes, mics, refresh length, block
K, C, U = 4, 2, 4
BLOCK = 2 * U


# -- inputs and references (main thread, before any server starts) ---------
def scene(seed: int, length: int = 8000, n_nodes: int = K, n_mics: int = C, device=None):
    """(Y (K, C, F, T) complex64, m (K, F, T) float32) host arrays: white
    noise through the port's STFT on ``device`` and uniform soft masks,
    both from ``seed``."""
    import torch

    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.device import resolve_device, to_host

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_nodes, n_mics, length)).astype(np.float32)
    (Y,) = to_host([stft(torch.from_numpy(x).to(resolve_device(device)))])
    F, T = Y.shape[-2:]
    m = rng.uniform(0.05, 0.95, size=(n_nodes, F, T)).astype(np.float32)
    return Y, m


def offline_stream(Y, m, *, device=None, update_every: int = U, **kw) -> np.ndarray:
    """The whole-clip ``streaming_tango`` of (Y, m) on ``device`` (both
    steps on ``m``), as a host array."""
    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.enhance.streaming import streaming_tango

    return to_host([streaming_tango(Y, m, m, update_every=update_every, device=device,
                                    **kw)["yf"]])[0]


def per_block_stream(Y, m, *, block: int, device=None, update_every: int = U,
                     z_avail=None, **kw) -> np.ndarray:
    """``streaming_tango`` block by block over the whole clip (the last
    block ragged), the state carried and the availability columns given as
    the scheduler gives them: the offline calls a served stream makes."""
    import torch

    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.enhance.streaming import streaming_tango

    K_, T = Y.shape[0], Y.shape[-1]
    za = None if z_avail is None else np.asarray(z_avail, np.float32)
    state, outs = None, []
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        n_ref = -(-(hi - lo) // update_every)
        avail = (np.ones((K_, n_ref), np.float32) if za is None
                 else np.broadcast_to(za[:, None], (K_, n_ref)))
        o = streaming_tango(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi],
                            update_every=update_every, state=state, z_avail=avail.copy(),
                            device=device, **kw)
        state = o["state"]
        outs.append(o["yf"])
    return to_host([torch.cat(outs, dim=-1)])[0]


def chained_windows(wins, masks, *, device=None, update_every: int = U, **kw) -> list:
    """``streaming_clip_fused`` window by window with the state carried:
    the (K, samples) outputs as host arrays."""
    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.enhance.fused import streaming_clip_fused

    refs, state = [], None
    for y, mw in zip(wins, masks):
        out = streaming_clip_fused(y, masks_z=mw, mask_w=mw, update_every=update_every,
                                   state=state, device=device, **kw)
        refs.append(out["yf"])
        state = out["state"]
    return to_host(refs)


def session_config(n_freq: int, *, n_nodes: int = K, n_mics: int = C,
                   block_frames: int = BLOCK, update_every: int = U, **kw):
    """A :class:`SessionConfig` at the gate's widths (counterpart of the
    JAX gate's session configs in ``disco_tpu/serve/check.py``)."""
    from disco_tpu_torch.serve import SessionConfig

    return SessionConfig(n_nodes=n_nodes, mics_per_node=n_mics, n_freq=n_freq,
                         block_frames=block_frames, update_every=update_every, **kw)


def _run_clients(n: int, work, timeout_s: float) -> list:
    """Run ``work(i)`` on ``n`` host threads; returns the errors (a client
    thread still alive after ``timeout_s`` is one)."""
    errors: list = []

    def run(i):
        try:
            work(i)
        except Exception as e:  # surfaced by the caller, with the index
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,), name=f"serve-check-client-{i}",
                                daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    t_end = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(t_end - time.monotonic(), 0.0))
    errors += [f"client {i}: still running after {timeout_s} s"
               for i, t in enumerate(threads) if t.is_alive()]
    return errors


def _differs(label: str, got, ref) -> str | None:
    if got is None:
        return f"{label}: returned nothing"
    if got.shape != ref.shape or not np.array_equal(got, ref):
        diff = (f"max abs diff {np.abs(got - ref).max():g}" if got.shape == ref.shape
                else f"shape {got.shape} vs {ref.shape}")
        return f"{label}: differs from its offline reference ({diff})"
    return None


# -- the legs ----------------------------------------------------------------
def check_parity(failures: list, specs: list, *, device=None, server_kw: dict | None = None,
                 label: str = "parity", timeout_s: float = 300.0) -> dict:
    """Concurrent sessions, bit-parity and readback accounting.

    ``specs``: one dict a session — ``Y`` (K, C, F, T), ``m`` (K, F, T),
    ``config`` (a :class:`SessionConfig`), ``ref`` (its offline output) and
    optionally ``z_mask``.  A ``domain="time"`` session gives ``windows``
    and ``masks`` (lists of (K, C, samples) windows and their (K, F, T)
    masks) in place of ``Y``/``m``, each window one block, and its ``ref``
    is the windows' outputs joined along time.  Returns the ticks,
    readbacks, blocks and the served streams (``outputs``)."""
    from disco_tpu_torch.obs.accounting import device_get_count
    from disco_tpu_torch.serve import EnhanceServer, ServeClient

    srv = EnhanceServer(max_sessions=max(8, len(specs)), device=device, **(server_kw or {}))
    addr = srv.start()
    results: list = [None] * len(specs)
    try:
        gets0 = device_get_count()
        t0 = time.perf_counter()

        def work(i):
            sp = specs[i]
            cl = ServeClient(addr)
            try:
                cl.open(sp["config"], z_mask=sp.get("z_mask"))
                if sp["config"].domain == "time":
                    got = []
                    for j, (y, mw) in enumerate(zip(sp["windows"], sp["masks"])):
                        cl.send_block(y, mw, mw)
                        got.append(cl.recv_enhanced(j, timeout_s=timeout_s))
                    results[i] = np.concatenate(got, axis=-1)
                else:
                    results[i] = cl.enhance_clip(sp["Y"], sp["m"], sp["m"])
                cl.close()
            finally:
                cl.shutdown()

        failures.extend(f"{label}: {e}" for e in _run_clients(len(specs), work, timeout_s))
        seconds = time.perf_counter() - t0
        gets = device_get_count() - gets0
        ticks = srv.scheduler.ticks_with_work
    finally:
        srv.stop()
    for i, sp in enumerate(specs):
        bad = _differs(f"{label}: session {i}", results[i], sp["ref"])
        if bad:
            failures.append(bad)
    if gets != ticks:
        failures.append(
            f"{label}: {gets} batched readbacks for {ticks} scheduler ticks — "
            "the one-readback-per-tick contract is broken")
    blocks = sum(len(sp["windows"]) if sp["config"].domain == "time"
                 else -(-sp["ref"].shape[-1] // sp["config"].block_frames) for sp in specs)
    return {"sessions": len(specs), "ticks": ticks, "batched_readbacks": gets,
            "blocks_total": blocks, "seconds": seconds, "outputs": results}


def check_drain_resume(failures: list, state_dir, Y, m, ref, config, *, device=None,
                       server_kw: dict | None = None, session_id: str = "drainee",
                       timeout_s: float = 120.0) -> dict:
    """A graceful stop with a half-fed session drains, checkpoints and
    closes with no frame lost; the stream resumed on a fresh server
    stitches bit-identical to ``ref``."""
    from disco_tpu_torch.runs.interrupt import GracefulInterrupt, request_stop
    from disco_tpu_torch.serve import EnhanceServer, ServeClient
    from disco_tpu_torch.serve.session import probe_session_state

    bf = config.block_frames
    T = Y.shape[-1]
    n_blocks = -(-T // bf)
    half = max(1, n_blocks // 2)
    outs: dict = {}
    with GracefulInterrupt():  # the dispatch loop polls runs.interrupt
        srv = EnhanceServer(max_sessions=4, state_dir=state_dir, device=device,
                            **(server_kw or {}))
        addr = srv.start()
        cl = ServeClient(addr)
        try:
            cl.open(config, session_id=session_id)
            for i in range(half):
                lo, hi = i * bf, (i + 1) * bf
                cl.send_block(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi])
                outs[i] = cl.recv_enhanced(i, timeout_s=timeout_s)
            request_stop("serve check: drain")   # the in-process SIGINT
            info = cl.wait_closed(timeout_s=timeout_s)
        finally:
            try:
                srv.wait(timeout_s=timeout_s)
            finally:
                cl.shutdown()
    if not cl.draining:
        failures.append("drain: client never saw the 'draining' notice")
    if info.get("blocks_done") != half:
        failures.append(f"drain: closed at blocks_done={info.get('blocks_done')}, "
                        f"expected {half} (lost frames)")
    if len(outs) != half:
        failures.append(f"drain: {len(outs)}/{half} enhanced blocks delivered")
    state_path = info.get("state_path")
    if not state_path or not probe_session_state(state_path):
        failures.append(f"drain: checkpoint missing or fails its probe: {state_path}")
        return {"blocks_before_drain": half, "blocks_total": n_blocks}

    srv2 = EnhanceServer(max_sessions=4, state_dir=state_dir, device=device,
                         **(server_kw or {}))
    addr2 = srv2.start()
    rest = None
    try:
        cl2 = ServeClient(addr2)
        try:
            cl2.open(config, resume=session_id)
            if cl2.blocks_done != half:
                failures.append(f"resume: server resumed at {cl2.blocks_done}, expected {half}")
            rest = cl2.enhance_clip(Y, m, m)
            cl2.close()
        finally:
            cl2.shutdown()
    finally:
        srv2.stop()
    full = np.concatenate([outs[i] for i in range(half)] + [rest], axis=-1)
    bad = _differs("resume: the stitched drain + resume stream", full, ref)
    if bad:
        failures.append(bad)
    return {"blocks_before_drain": half, "blocks_total": n_blocks,
            "state_path": state_path}


def check_chaos(failures: list, state_dir, Y, m, ref, config, *, device=None,
                server_kw: dict | None = None, crash_after: int = 3,
                mid_write: bool = True, timeout_s: float = 120.0) -> dict:
    """(a) A ``serve_tick`` crash after ``crash_after`` ticks: every frame
    received before it is complete and bit-correct.  (b) With
    ``mid_write``, a crash inside the drain checkpoint's write: no
    truncated checkpoint at the final path and no temp litter."""
    from disco_tpu_torch.io.atomic import TMP_SUFFIX
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, ServeError
    from disco_tpu_torch.serve.session import probe_session_state

    bf = config.block_frames
    T = Y.shape[-1]
    n_blocks = -(-T // bf)
    n_crashes = 0
    received: dict = {}
    srv = EnhanceServer(max_sessions=4, device=device, **(server_kw or {}))
    addr = srv.start()
    cl = ServeClient(addr, reattach_retries=0)
    try:
        cl.open(config)
        # arm AFTER block 0 is delivered: the dispatch loop ticks even when
        # idle, so arming first would race the first send against idle ticks
        cl.send_block(Y[..., :bf], m[..., :bf], m[..., :bf])
        received[0] = cl.recv_enhanced(0, timeout_s=timeout_s)
        chaos.configure("serve_tick", after=crash_after)
        try:
            for i in range(1, n_blocks):
                lo, hi = i * bf, min((i + 1) * bf, T)
                cl.send_block(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi])
                received[i] = cl.recv_enhanced(i, timeout_s=timeout_s)
            failures.append("chaos: serve_tick crash never fired")
        except ServeError:
            pass  # the connection died with the server — the expected shape
        finally:
            chaos.disable()
        try:
            srv.wait(timeout_s=timeout_s)
            failures.append("chaos: dispatch thread survived the injected crash")
        except chaos.ChaosCrash:
            n_crashes += 1
    finally:
        cl.shutdown()
    if not received:
        failures.append("chaos: no blocks delivered before the injected crash")
    for i, yf in received.items():
        lo, hi = i * bf, min((i + 1) * bf, T)
        if not np.array_equal(yf, ref[..., lo:hi]):
            failures.append(f"chaos: block {i} delivered before the crash is not bit-correct")

    if mid_write:
        srv = EnhanceServer(max_sessions=4, state_dir=state_dir, device=device,
                            **(server_kw or {}))
        addr = srv.start()
        cl = ServeClient(addr, reattach_retries=0)
        try:
            cl.open(config, session_id="chaotic")
            cl.send_block(Y[..., :bf], m[..., :bf], m[..., :bf])
            cl.recv_enhanced(0, timeout_s=timeout_s)
            chaos.configure("mid_write", after=1)
            try:
                srv.stop(timeout_s=timeout_s)
                failures.append("chaos: mid_write crash never fired during checkpoint")
            except chaos.ChaosCrash:
                n_crashes += 1
            finally:
                chaos.disable()
        finally:
            cl.shutdown()
        state_dir = Path(state_dir)
        final = state_dir / "session_chaotic.state.msgpack"
        if final.exists():
            failures.append(
                "chaos: a checkpoint reached its final path through a mid-write crash"
                if not probe_session_state(final)
                else "chaos: mid_write crash fired after the rename")
        litter = [str(p) for p in state_dir.rglob(f"*{TMP_SUFFIX}.*")]
        if litter:
            failures.append(f"chaos: checkpoint temp litter left on unwind: {litter}")
    return {"crashes_injected": n_crashes, "blocks_before_crash": len(received)}


def check_overload(failures: list, specs: list, *, device=None,
                   timeout_s: float = 300.0) -> dict:
    """The overload drill: 4 clients flood an 8-block tick budget under a
    ladder capped at rung 2 while 3 more opens are refused for capacity;
    the ladder steps stepwise, every flooded session stays bit-exact, and
    with the load gone the ladder walks back to rung 0 within a tick
    budget, after which a fresh session is bit-exact again.  ``specs``:
    the :func:`check_parity` dicts of 4 sessions."""
    from disco_tpu_torch.serve import DegradationLadder, EnhanceServer, ServeClient, ServeError

    ladder = DegradationLadder(p95_high_ms=4.0, p95_low_ms=2.5, recover_ticks=10, max_rung=2)
    srv = EnhanceServer(max_sessions=len(specs), max_queue_blocks=8, max_blocks_per_tick=8,
                        blocks_per_super_tick=2, tick_interval_s=0.001, ladder=ladder,
                        device=device)
    addr = srv.start()
    results: list = [None] * len(specs)
    rejects = 0
    try:
        def work(i):
            if i >= len(specs):  # the opens past capacity
                nonlocal rejects
                time.sleep(0.3)   # let the flood establish itself
                for _ in range(3):
                    extra = ServeClient(addr)
                    try:
                        extra.open(specs[0]["config"])
                        extra.close()
                    except ServeError as e:
                        rejects += e.code == "capacity"
                    finally:
                        extra.shutdown()
                return
            sp = specs[i]
            cl = ServeClient(addr)
            try:
                cl.open(sp["config"])
                results[i] = cl.enhance_clip(sp["Y"], sp["m"], sp["m"], window=8)
                cl.close()
            finally:
                cl.shutdown()

        failures.extend(f"overload: {e}" for e in _run_clients(len(specs) + 1, work, timeout_s))
        peak = max((to for (_t, _f, to, _r) in ladder.transitions), default=0)
        if peak < 1:
            failures.append("overload: the ladder never degraded under a flooded tick budget")
        if rejects < 1:
            failures.append("overload: no admission attempt was rejected past capacity")
        for (tick, frm, to, _r) in ladder.transitions:
            if abs(to - frm) != 1:
                failures.append(f"overload: non-stepwise ladder transition {frm}->{to} "
                                f"at tick {tick}")
        for i, sp in enumerate(specs):
            bad = _differs(f"overload: session {i}", results[i], sp["ref"])
            if bad:
                failures.append(bad)
        # the load drops to zero: recovery is driven by tick counts (idle
        # ticks fold an empty window, p95 = 0), with a hang guard only
        sched = srv.scheduler
        budget = 4 * (sched.wait_window_ticks + ladder.max_rung * ladder.recover_ticks) + 100
        tick_end = sched.tick_no + budget
        last_tick, last_progress = sched.tick_no, time.monotonic()
        while ladder.rung > 0 and sched.tick_no < tick_end:
            if sched.tick_no != last_tick:
                last_tick, last_progress = sched.tick_no, time.monotonic()
            elif time.monotonic() - last_progress > 10.0:
                failures.append(f"overload: tick counter stalled at {last_tick} during recovery")
                break
            time.sleep(0.005)
        if ladder.rung != 0:
            failures.append(f"overload: ladder stuck at rung {ladder.rung} after "
                            f"{budget} idle ticks")
        downs = sum(1 for (_t, frm, to, _r) in ladder.transitions if to < frm)
        if not downs:
            failures.append("overload: no recovery transitions recorded")
        sp = specs[0]
        cl = ServeClient(addr)
        try:
            cl.open(sp["config"])
            after = cl.enhance_clip(sp["Y"], sp["m"], sp["m"], window=8)
            cl.close()
        finally:
            cl.shutdown()
        bad = _differs("overload: post-recovery session", after, sp["ref"])
        if bad:
            failures.append(bad)
    finally:
        srv.stop(timeout_s=timeout_s)
    return {"peak_rung": peak, "capacity_rejects": rejects,
            "transitions": list(ladder.transitions), "recoveries": downs}


def check_chained(failures: list, wins, masks, refs, config, *, device=None,
                  timeout_s: float = 120.0) -> dict:
    """A ``domain="time"`` session: each (K, C, samples) window sent as one
    block comes back as the (K, samples) float window ``refs[i]``
    (:func:`chained_windows`), bit for bit."""
    from disco_tpu_torch.serve import EnhanceServer, ServeClient

    srv = EnhanceServer(max_sessions=2, device=device)
    addr = srv.start()
    got = []
    try:
        cl = ServeClient(addr)
        try:
            cl.open(config)
            for i, (y, mw) in enumerate(zip(wins, masks)):
                cl.send_block(y, mw, mw)
                got.append(cl.recv_enhanced(i, timeout_s=timeout_s))
            cl.close()
        finally:
            cl.shutdown()
    finally:
        srv.stop()
    for i, (g, r) in enumerate(zip(got, refs)):
        if g.dtype.kind != "f":
            failures.append(f"chained: window {i} came back {g.dtype}, expected float")
        bad = _differs(f"chained: window {i}", g, r)
        if bad:
            failures.append(bad)
    return {"windows": len(got), "outputs": got}


def check_tap(failures: list, specs: list, tap_dir, *, device=None,
              server_kw: dict | None = None, records_per_shard: int = 8,
              label: str = "tap") -> dict:
    """:func:`check_parity` with a corpus tap on the server: every delivered
    STFT block spooled, nothing dropped, every shard intact, and each
    stream still bit-identical to its reference (the tap is transparent to
    serving).  Time-domain sessions are served but never tapped."""
    from disco_tpu_torch.flywheel import MANIFEST_NAME, CorpusTap, list_shards, probe_shard, read_shard
    from disco_tpu_torch.runs.ledger import RunLedger

    tap = CorpusTap(tap_dir, records_per_shard=records_per_shard)
    try:
        parity = check_parity(failures, specs, device=device, label=label,
                              server_kw={**(server_kw or {}), "tap": tap})
    finally:
        stats = tap.close()
    expected = sum(-(-sp["ref"].shape[-1] // sp["config"].block_frames)
                   for sp in specs if sp["config"].domain != "time")
    if stats["blocks_dropped"]:
        failures.append(f"{label}: {stats['blocks_dropped']} blocks dropped — the "
                        "spool bound is undersized for the load")
    if stats["blocks_accepted"] != expected:
        failures.append(f"{label}: spooled {stats['blocks_accepted']} blocks, expected "
                        f"{expected} (one a delivered STFT block)")
    shards = list_shards(tap_dir)
    if expected and not shards:
        failures.append(f"{label}: no shard files written")
    n_records = 0
    for sp in shards:
        if not probe_shard(sp):
            failures.append(f"{label}: shard fails its integrity probe: {sp}")
        else:
            n_records += len(read_shard(sp)[1])
    if n_records != stats["blocks_accepted"]:
        failures.append(f"{label}: shards hold {n_records} records, the tap accepted "
                        f"{stats['blocks_accepted']}")
    led = RunLedger(Path(tap_dir) / MANIFEST_NAME)
    done, requeued = led.verified_done(requeue=False)
    led.close()
    if len(done) != len(shards) or requeued:
        failures.append(f"{label}: the manifest verifies {len(done)}/{len(shards)} shards "
                        f"({len(requeued)} requeued)")
    return {**parity, "shards": len(shards), "records": n_records, **stats}
