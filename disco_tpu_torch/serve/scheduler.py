"""Continuous-batching scheduler: many concurrent sessions, one device (the
port's counterpart of ``disco_tpu/serve/scheduler.py``).

Each tick gathers the ready blocks across all live sessions and queues
every block's :func:`~disco_tpu_torch.enhance.streaming.streaming_tango`
step on the device — eager CUDA launches are asynchronous, so nothing
waits between sessions — and the tick's outputs cross to the host in ONE
``device.to_host`` copy.  ``device_get_batches``
(``obs.accounting``) therefore advances exactly once per tick with work.

Each block goes through the very entry point offline streaming uses, with
the session's carry: ``streaming_tango`` for a block of STFT frames,
``streaming_tango_scan`` for a super-tick of N blocks, and
``enhance.fused.streaming_clip_fused`` for a time-domain (chained-lane)
window.  A stream served block by block is therefore bit-identical to the
offline whole-clip stream inside the port (``serve.check``), as it is in
the JAX package.  The JAX package resolves each step to its jitted
program, donates the carry off the CPU, and passes ``lambda_cor``/``mu``
only when they differ from the defaults so that a default keeps one
traced program; the port has no jit, and ``streaming`` computes every power
of ``lambda_cor`` in float64 on the host, so both are always passed.

Super-ticks (``blocks_per_super_tick`` = N > 1): every run of N
consecutive full queued blocks a session contributes to a tick rides one
``streaming_tango_scan`` call (the per-block function N times, the state
carried: bit-identical), and with ``overlap_readback`` tick T+1's
launches are queued before tick T's batch is read back.  Sub-N remainders
and ragged final blocks go per block.

Admission control, the survival layer and the telemetry are the JAX
package's: a bounded session count, a bounded per-session input queue
(backpressure errors), transport-aware dispatch under
``utils.resilience.call_with_retries`` (an exhausted transport budget
re-queues the undispatched blocks and quarantines the session, any other
error evicts it with a clean error frame), a host-only dispatch deadline,
session parking with a bounded replay buffer, and the degradation ladder.

The flywheel's seams are the JAX package's: a corpus tap (``tap=``,
:class:`~disco_tpu_torch.flywheel.CorpusTap`) is offered every delivered
STFT block at the post-readback seam; a promotion controller
(``promote=``, :class:`~disco_tpu_torch.promote.PromotionController`)
serves ``masks="model"`` sessions, whose blocks get their masks at dispatch
from the session's weight generation (:mod:`disco_tpu_torch.promote.lane`),
with the controller's swaps applied on the dispatch thread at block
boundaries; a co-resident trainer (``resident=``,
:class:`~disco_tpu_torch.flywheel.ResidentTrainer`) takes its slice of
train steps at the tail of every tick.  A model session's masks stay on
the device, and the tap's copy of them rides the tick's one readback.
Without a promotion store, ``masks="model"`` sessions are refused at
admission with the JAX package's message.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs import flight as obs_flight
from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.serve.session import (
    CLOSED,
    DRAINING,
    EVICTED,
    OPEN,
    PARKED,
    QUARANTINED,
    Session,
    SessionConfig,
    SessionStateError,
    load_session_state,
)

#: Default bound on blocks enhanced per tick across all sessions — keeps
#: one tick's device queue (and its single readback payload) bounded, so a
#: bursty client cannot starve the others for a whole tick.
DEFAULT_MAX_BLOCKS_PER_TICK = 64

#: Refresh-block horizon of a per-session fault plan drawn from a server
#: fault spec (``plan_faults`` needs a concrete width; blocks past the
#: horizon are treated as delivered).
FAULT_PLAN_BLOCKS = 4096



class AdmissionError(RuntimeError):
    """Session rejected at the door (capacity, draining, bad config)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class QueueFull(RuntimeError):
    """Per-session input queue bound hit — backpressure, not a crash."""


#: The fakeable dispatch seam: when set, called as ``injector(session_id,
#: seqs)`` at the top of every dispatch attempt (inside the retry wrapper,
#: so each retry re-consults it) and may raise a transport error — how the
#: tests drive the retry/quarantine machinery without a failing device.
_DISPATCH_FAULT_INJECTOR = None


def set_dispatch_fault_injector(fn) -> None:
    """Install (or clear, with ``None``) the dispatch fault injector above."""
    global _DISPATCH_FAULT_INJECTOR
    _DISPATCH_FAULT_INJECTOR = fn


class Scheduler:
    """Session registry + the per-tick continuous-batching loop body.

    Thread model: ``open_session`` / ``push_block`` / ``request_close`` are
    called from the server's I/O thread and touch host arrays only;
    :meth:`tick` runs on the single dispatch thread, the only thread that
    launches device work or reads it back.  The registry lock is never
    held across device work.

    ``device``: where the sessions' steps run — ``"cuda"`` when None
    (``RuntimeError`` at construction without a CUDA device), ``"cpu"``
    for the plain versions on the host.
    """

    def __init__(self, *, max_sessions: int = 16, max_queue_blocks: int = 8,
                 max_blocks_per_tick: int = DEFAULT_MAX_BLOCKS_PER_TICK,
                 blocks_per_super_tick: int = 1,
                 overlap_readback: bool | None = None,
                 allow_chained: bool = True,
                 fault_spec=None, tap=None,
                 dispatch_retries: int = 2,
                 dispatch_retry_base_s: float = 0.05,
                 retry_seed: int = 0,
                 tick_deadline_s: float | None = None,
                 park_ttl_s: float = 60.0,
                 replay_blocks: int = 64,
                 quarantine_ticks: int = 20,
                 max_quarantines: int = 2,
                 shed_retry_after_s: float = 1.0,
                 wait_window_ticks: int = 50,
                 ladder=None, state_dir=None, promote=None, resident=None,
                 device=None):
        if max_sessions < 1 or max_queue_blocks < 1 or max_blocks_per_tick < 1:
            raise ValueError("scheduler bounds must be >= 1")
        if blocks_per_super_tick < 1:
            raise ValueError("blocks_per_super_tick must be >= 1")
        if blocks_per_super_tick > max_blocks_per_tick:
            raise ValueError(
                f"blocks_per_super_tick={blocks_per_super_tick} exceeds "
                f"max_blocks_per_tick={max_blocks_per_tick}: no super-tick "
                "could ever form"
            )
        if dispatch_retries < 0 or park_ttl_s <= 0 or replay_blocks < 1:
            raise ValueError("survival knobs out of range (dispatch_retries "
                             ">= 0, park_ttl_s > 0, replay_blocks >= 1)")
        if quarantine_ticks < 1 or max_quarantines < 0 or wait_window_ticks < 1:
            raise ValueError("quarantine/window knobs out of range")
        #: the device every dispatch of this scheduler runs on
        self.device = resolve_device(device)
        self.max_sessions = max_sessions
        self.max_queue_blocks = max_queue_blocks
        self.max_blocks_per_tick = max_blocks_per_tick
        #: N: every run of N consecutive full queued blocks of a session is
        #: dispatched as ONE streaming_tango_scan call; the sub-N remainder
        #: (and a ragged final block) goes per block, so the last partial
        #: window never waits for more input.
        self.blocks_per_super_tick = blocks_per_super_tick
        #: Double-buffered tick state: when on, tick T queues its launches
        #: FIRST and then reads back tick T-1's batch, so the device computes
        #: tick T while the host takes tick T-1's outputs.  Deliveries lag
        #: one tick; an idle tick flushes the buffer.  Default: on exactly
        #: when super-ticks are on.
        self.overlap_readback = (blocks_per_super_tick > 1
                                 if overlap_readback is None else overlap_readback)
        #: admit ``domain="time"`` (chained-lane) sessions?
        self.allow_chained = allow_chained
        self.fault_spec = fault_spec
        #: optional flywheel corpus tap (flywheel.CorpusTap), offered every
        #: delivered STFT block's host arrays (noisy Y, masks, enhanced yf)
        #: at the post-readback seam.  Its offer() never blocks and never
        #: raises, so serving cannot backpressure or crash on its tap.
        self.tap = tap
        #: transport-retry budget per dispatch/readback call (retries past
        #: the first attempt; an exhausted budget quarantines)
        self.dispatch_retries = dispatch_retries
        self.dispatch_retry_base_s = dispatch_retry_base_s
        #: base seed of the per-dispatch jittered backoff draws (each call
        #: derives seed + dispatch counter — deterministic, desynchronized)
        self.retry_seed = retry_seed
        #: per-tick wall deadline for dispatch+readback (None = watchdog
        #: off); on expiry the tick is marked suspect, the device is fenced
        #: by preflight_probe and the hit feeds the degradation ladder
        self.tick_deadline_s = tick_deadline_s
        #: how long a parked session waits for its client to reattach
        #: before the slot is reclaimed (EVICTED, ``park_expired`` counter)
        self.park_ttl_s = park_ttl_s
        #: per-session replay-buffer depth (bit-exact reattach window)
        self.replay_blocks = replay_blocks
        self.quarantine_ticks = quarantine_ticks
        self.max_quarantines = max_quarantines
        #: reattach back-off hint carried in the shed/park error frame
        self.shed_retry_after_s = shed_retry_after_s
        #: queue-wait samples older than this many ticks age out of the
        #: ladder's p95 window (recovery after load drops)
        self.wait_window_ticks = wait_window_ticks
        #: optional DegradationLadder (serve/ladder.py); None = ladder off
        self.ladder = ladder
        #: park-checkpoint directory (the server's state dir); parked
        #: sessions are checkpointed here on the next tick so a reattach
        #: survives even a server death in between
        self.state_dir = state_dir
        #: optional PromotionController.  The controller only requests
        #: generation swaps; this scheduler's dispatch thread executes them
        #: at block boundaries (:meth:`_apply_generation_swaps`), so every
        #: block runs under exactly one generation.
        self.promote = promote
        #: {gen_id: model on this scheduler's device}, dispatch thread only
        self._gen_models: dict = {}
        if promote is not None:
            promote.bind(self)
        #: optional co-resident trainer (flywheel.ResidentTrainer), stepped
        #: at the end of every tick with the ladder's rung, on this
        #: dispatch thread: all its device work happens inside that call.
        self.resident = resident
        self.draining = False
        self._lock = threading.Lock()
        self._sessions: dict[str, Session] = {}
        self._parked: dict[str, Session] = {}
        self._session_seq = 0
        self._rotate = 0
        self.ticks_with_work = 0
        #: monotonically increasing tick number (quarantine release + the
        #: ladder's deterministic clock)
        self.tick_no = 0
        self._dispatch_seq = 0
        self._to_checkpoint: list = []
        #: (session, reason, retry_after_s) park notices the server posts
        #: as ``parked`` error frames (shed happens on the dispatch thread,
        #: frames go out on the I/O thread)
        self._park_notices: list = []
        #: (tick_no, wait_ms) samples feeding the ladder's p95 window
        self._wait_samples: list = []
        #: the ladder's rung >= 2 switches the tap off
        self._tap_suspended = False
        #: dispatched-but-not-read-back units of the previous tick
        #: (overlap_readback): [(session, [seq, ...], yf on the device,
        #: t_dispatch, raw)] where raw keeps the input (seq, Y, mz, mw)
        #: tuples for the tap (None when no tap)
        self._inflight: list = []

    # -- registry (I/O thread) ----------------------------------------------
    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions.values())

    def get(self, session_id: str) -> Session | None:
        with self._lock:
            return self._sessions.get(session_id)

    def model_session_ids(self) -> list:
        """Ids of the OPEN model-mask sessions — the promotion controller's
        canary-eligible set (any thread)."""
        with self._lock:
            return [s.id for s in self._sessions.values()
                    if s.status == OPEN and s.config.masks == "model"]

    def _reject(self, code: str, message: str) -> AdmissionError:
        obs_registry.counter("admission_reject").inc()
        return AdmissionError(code, message)

    def open_session(self, config, *, session_id: str | None = None,
                     z_mask=None, resume_from=None,
                     priority: bool = False) -> Session:
        """Admit one session (or resume a checkpointed one).

        Parked sessions count toward ``max_sessions`` — a park holds its
        slot for the TTL (so a reattach can never be rejected for
        capacity), and the TTL bounds how long an absent client can do so.

        Raises :class:`AdmissionError` on capacity / draining / config
        problems — the server turns those into clean ``error`` frames.
        """
        if self.draining:
            raise self._reject("draining", "server is draining; not admitting sessions")
        if not isinstance(config, SessionConfig):
            try:
                config = SessionConfig.from_dict(config)
            except ValueError as e:
                raise self._reject("bad_config", str(e)) from None
        if config.masks == "model" and self.promote is None:
            raise self._reject(
                "bad_config",
                'masks="model" needs a promotion store; start the server '
                "with --promote-dir",
            )
        if config.domain == "time" and not self.allow_chained:
            raise self._reject(
                "bad_config",
                'domain="time" (chained-lane) sessions are disabled on this '
                "server (--no-chained-sessions)",
            )

        with self._lock:
            if len(self._sessions) + len(self._parked) >= self.max_sessions:
                raise self._reject(
                    "capacity",
                    f"server at max_sessions={self.max_sessions}; retry later",
                )
            self._session_seq += 1
            seq = self._session_seq

        if resume_from is not None:
            session = load_session_state(resume_from)
            if session.config != config:
                raise self._reject(
                    "config_mismatch",
                    f"checkpoint {resume_from} was made with a different "
                    f"session config; resume with the original one",
                )
            if session_id is not None:
                session.id = session_id
            session.priority = bool(priority)
            session.replay = type(session.replay)(maxlen=self.replay_blocks)
        else:
            from disco_tpu_torch.enhance.streaming import initial_stream_state

            sid = session_id or f"s{seq:06d}"
            z_avail = self._session_fault_plan(config, seq, z_mask)
            session = Session(
                sid, config,
                z_avail=z_avail,
                priority=priority,
                replay_blocks=self.replay_blocks,
                state=initial_stream_state(
                    config.n_nodes, config.mics_per_node, config.n_freq,
                    update_every=config.update_every, ref_mic=config.ref_mic,
                ),
            )
        session.open_seq = seq
        if config.masks == "model":
            # every open (fresh or resumed) adopts the store's ACTIVE
            # pointer: generations are not kept in session checkpoints, so
            # a crash mid-rollout lands every resumed session back on the
            # committed generation
            try:
                gen = self.promote.active_generation()
            except RuntimeError as e:
                raise self._reject("bad_config", str(e)) from None
            session.set_generation(gen, at_seq=session.blocks_done)
        with self._lock:
            if session.id in self._sessions or session.id in self._parked:
                raise self._reject(
                    "duplicate", f"session id {session.id!r} already live"
                )
            self._sessions[session.id] = session
        obs_events.record(
            "session", stage="serve", action="open", session=session.id,
            resumed_blocks=session.blocks_done,
            faulted=session.z_avail is not None,
        )
        self._set_gauges()
        return session

    def _session_fault_plan(self, config: SessionConfig, seq: int, z_mask):
        """Per-session z availability: an explicit client mask wins; else a
        server fault spec is expanded per session (seeded off the admission
        sequence number, so every session draws its own deterministic
        realization)."""
        if z_mask is not None:
            mask = np.asarray(z_mask, np.float32)
            if mask.shape not in ((config.n_nodes,),) and (
                mask.ndim != 2 or mask.shape[0] != config.n_nodes
            ):
                raise self._reject(
                    "bad_config",
                    f"z_mask shape {mask.shape} does not match n_nodes={config.n_nodes}",
                )
            return mask
        if self.fault_spec is None or not self.fault_spec.any_fault():
            return None
        import dataclasses

        from disco_tpu_torch.fault.inject import plan_faults

        spec = dataclasses.replace(self.fault_spec, seed=self.fault_spec.seed + seq)
        plan = plan_faults(spec, config.n_nodes, n_blocks=FAULT_PLAN_BLOCKS)
        if not plan.any_fault():
            return None
        return np.asarray(plan.avail_streaming, np.float32)

    def push_block(self, session: Session, seq: int, Y, mask_z, mask_w,
                   trace=None) -> None:
        """Accept one input block (I/O thread).  Validates shape/order and
        enforces the queue bound (:class:`QueueFull` = backpressure).

        ``trace``: the block frame's causal-trace header (a wire dict with
        ``trace``/``span`` ids — ``obs.trace``), or None for an untraced
        client.  With tracing enabled, acceptance records the ``enqueue``
        hop and threads the advanced context through the session."""
        cfg = session.config
        if session.status not in (OPEN, DRAINING):
            raise QueueFull(f"session {session.id} is {session.status}")
        if seq != session.blocks_in:
            raise QueueFull(
                f"out-of-order block seq {seq} (expected {session.blocks_in}); "
                "blocks must arrive in order"
            )
        Y = np.asarray(Y)
        if not np.issubdtype(Y.dtype, np.number):
            # the wire codec round-trips ANY declared dtype; a non-numeric
            # block dies here as a bad_block, not inside the dispatch thread
            raise ValueError(f"block Y dtype {Y.dtype} is not numeric")
        exp = cfg.block_shape
        if Y.shape[:-1] != exp[:-1] or Y.shape[-1] > exp[-1] or Y.shape[-1] < 1:
            raise QueueFull(
                f"block shape {Y.shape} does not fit session shape {exp} "
                "(only the final block may be shorter)"
            )
        if cfg.domain == "time":
            # the chained lane: each block is one float time window whose
            # STFT frame count must stay refresh-aligned
            if np.iscomplexobj(Y):
                raise QueueFull(
                    f"session {session.id} has domain='time'; blocks must "
                    "be float time windows, not complex STFT frames"
                )
            t_frames = cfg.frames_of(Y.shape[-1])
            if t_frames % cfg.update_every:
                raise QueueFull(
                    f"time window of {Y.shape[-1]} samples has {t_frames} "
                    f"STFT frames — not a multiple of update_every="
                    f"{cfg.update_every} (chunk-exact streaming needs "
                    "refresh-aligned windows)"
                )
        else:
            t_frames = Y.shape[-1]
        if cfg.masks == "model":
            # the model-mask lane: blocks arrive maskless and the dispatch
            # thread fills both masks from the session's generation
            if mask_z is not None or mask_w is not None:
                raise QueueFull(
                    f'session {session.id} has masks="model"; blocks must '
                    "not carry mask_z/mask_w"
                )
        else:
            for name, m in (("mask_z", mask_z), ("mask_w", mask_w)):
                m = np.asarray(m)  # disco-torch-lint: disable=DL002 -- wire-decoded host arrays on the I/O thread; no device tensor can reach push_block
                if not np.issubdtype(m.dtype, np.number):
                    raise ValueError(f"{name} dtype {m.dtype} is not numeric")
                if m.shape != (cfg.n_nodes, cfg.n_freq, t_frames):
                    raise QueueFull(f"{name} shape {m.shape} does not match block {Y.shape}")
            mask_z, mask_w = np.asarray(mask_z), np.asarray(mask_w)
        if session.queue_depth() >= self.max_queue_blocks:
            raise QueueFull(
                f"session {session.id} input queue at max_queue_blocks="
                f"{self.max_queue_blocks}; wait for enhanced blocks"
            )
        ctx = None
        if obs_trace.enabled() and trace is not None:
            ctx = obs_trace.from_wire(trace)
            ctx = obs_trace.span(
                "enqueue", ctx, session=session.id, seq=int(seq),
                depth=session.queue_depth(),
            )
            obs_trace.tracer().inflight_begin(
                (session.id, int(seq)), ctx, "enqueue",
                session=session.id, seq=int(seq),
            )
        session.push_block(seq, Y, mask_z, mask_w, time.time(), trace_ctx=ctx)
        self._set_gauges()

    def request_close(self, session: Session) -> None:
        session.close_requested = True

    def evict(self, session: Session, reason: str) -> None:
        """Drop a session that is not keeping up (unread output backlog,
        exhausted quarantine budget, a failed dispatch).  The server sends
        the clean ``error`` frame; this records the decision and frees the
        slot."""
        with self._lock:
            self._sessions.pop(session.id, None)
            self._parked.pop(session.id, None)
        session.status = EVICTED
        session.error = reason
        self._drop_traces(session)
        obs_registry.counter("session_evicted").inc()
        obs_events.record("session", stage="serve", action="evict",
                          session=session.id, reason=reason)
        self._set_gauges()

    # -- parking / reattach (I/O + dispatch threads) -------------------------
    def parked_sessions(self) -> list:
        """Snapshot of the parked registry (drain checkpoints these too)."""
        with self._lock:
            return list(self._parked.values())

    def park(self, session: Session, reason: str, *, notice: bool = False,
             retry_after_s: float = 0.0) -> bool:
        """Park a live session instead of evicting it: keep carry + queue +
        replay buffer, hold the admission slot, and wait ``park_ttl_s`` for
        the client to reattach.  ``notice=True`` queues a ``parked`` error
        frame (resume token + back-off hint) for the server to post — the
        shed path, where the connection is still up.  Returns False when
        the session already left the live registry (close/evict race).

        Called from the I/O thread (connection drop, protocol truncation)
        and the dispatch thread (ladder shedding); the checkpoint itself is
        deferred to the next tick, on the dispatch thread."""
        with self._lock:
            live = self._sessions.pop(session.id, None)
            if live is None:
                return False
            self._parked[session.id] = session
            session.status = PARKED
            session.parked_at = time.monotonic()
            session.outage_tick = self.tick_no
            self._to_checkpoint.append(session)
            if notice:
                self._park_notices.append((session, reason, retry_after_s))
        obs_registry.counter("sessions_parked_total").inc()
        obs_events.record("session", stage="serve", action="park",
                          session=session.id, reason=reason,
                          blocks_done=session.blocks_done)
        obs_flight.auto_dump("park", reason=f"session {session.id}: {reason}")
        self._set_gauges()
        return True

    def reattach(self, session_id: str, config, have: int | None):
        """Reattach a parked session in place (I/O thread): validate the
        config and the replay coverage, move the session back to the live
        registry, and return ``(session, resume_seq)`` — the output seq the
        server's posting cursor restarts from (the frame re-sends happen on
        the dispatch loop, the one thread that posts ``enhanced`` frames).
        ``have`` is the next output seq the client still needs; ``None``
        means a fresh client resuming with just the token: resume semantics
        from ``blocks_done``, nothing replayed.  Returns ``None`` when
        ``session_id`` is not parked here (the server then falls back to
        the checkpoint-resume path)."""
        with self._lock:
            session = self._parked.get(session_id)
        if session is None:
            return None
        if config is not None and not isinstance(config, SessionConfig):
            try:
                config = SessionConfig.from_dict(config)
            except ValueError as e:
                raise self._reject("bad_config", str(e)) from None
        if config is not None and session.config != config:
            raise self._reject(
                "config_mismatch",
                f"session {session_id} was parked with a different config; "
                "reattach with the original one",
            )
        if have is None:
            resume_seq = session.blocks_done
        else:
            resume_seq = int(have)
            try:
                session.replay_from(resume_seq)   # coverage validation only
            except SessionStateError as e:
                raise self._reject("resume_gap", str(e)) from None
        with self._lock:
            if self._parked.pop(session_id, None) is None:
                return None   # TTL expiry raced us; treat as not parked
            self._sessions[session_id] = session
            session.status = OPEN
            session.parked_at = None
            session.outage_tick = self.tick_no
        if (self.promote is not None and session.config.masks == "model"
                and session.generation is not None):
            # a rollout can end while a session is parked (its swap request
            # was voided): a generation that is neither ACTIVE nor the live
            # candidate is stale, and the session adopts ACTIVE
            active = self.promote.active_generation()
            if session.generation not in (active, self.promote.current_candidate()):
                session.set_generation(active, at_seq=session.blocks_done)
        obs_registry.counter("session_reattached").inc()
        obs_events.record("session", stage="serve", action="reattach",
                          session=session.id, resume_seq=resume_seq,
                          blocks_done=session.blocks_done)
        self._set_gauges()
        return session, resume_seq

    def drain_park_notices(self) -> list:
        """Take the pending ``parked`` notices (dispatch loop → server,
        which posts the error frames on the I/O thread)."""
        with self._lock:
            notices, self._park_notices = self._park_notices, []
        return notices

    def _expire_parks(self) -> None:
        """Reclaim parked slots whose TTL ran out (dispatch thread)."""
        now = time.monotonic()
        with self._lock:
            expired = [s for s in self._parked.values()
                       if s.parked_at is not None
                       and now - s.parked_at > self.park_ttl_s]
            for s in expired:
                self._parked.pop(s.id, None)
        for s in expired:
            s.status = EVICTED
            s.error = f"parked session expired after {self.park_ttl_s:g}s TTL"
            self._drop_traces(s)
            obs_registry.counter("park_expired").inc()
            obs_events.record("session", stage="serve", action="park_expire",
                              session=s.id, blocks_done=s.blocks_done)
        if expired:
            self._set_gauges()

    def _checkpoint_parked(self) -> None:
        """Checkpoint freshly parked sessions (dispatch thread — the one
        place the device carry may be read back).  An IO failure demotes to
        a ``warning`` event: the in-memory park still works, only the
        crash-survival copy is missing.  A ChaosCrash (BaseException) from
        the mid_write seam still unwinds like a process death."""
        with self._lock:
            batch, self._to_checkpoint = self._to_checkpoint, []
        if self.state_dir is None or not batch:
            return
        from pathlib import Path

        from disco_tpu_torch.serve.session import save_session_state

        state_dir = Path(self.state_dir)
        state_dir.mkdir(parents=True, exist_ok=True)
        for s in batch:
            if s.status != PARKED:
                continue   # reattached (or expired) before we got here
            try:
                save_session_state(
                    state_dir / f"session_{s.id}.state.msgpack", s)
            except Exception as e:
                obs_events.record(
                    "warning", stage="serve",
                    reason=f"park checkpoint failed for {s.id}: "
                           f"{type(e).__name__}: {e}",
                )

    # -- promotion (dispatch thread) -----------------------------------------
    def _apply_generation_swaps(self) -> None:
        """Execute the promotion controller's requested generation swaps —
        here, on the dispatch thread, and only for sessions at a block
        boundary (``inflight == 0``): every block a session dispatches runs
        under exactly one generation, which makes the per-generation replay
        bit-exact.  Sessions not at a boundary are retried next tick;
        sessions that left the live registry are reported void.

        The ``pre_swap`` chaos seam fires here, after the rollout intent is
        durable in the ledger and before the session moves.  With a state
        dir, the session is checkpointed at the boundary first
        (``save_session_state``): the carry a resume would adopt was
        produced entirely under the old generation."""
        swaps = self.promote.pending_swaps()
        if not swaps:
            return
        from disco_tpu_torch.runs import chaos

        for sid, gen, kind in swaps:
            with self._lock:
                session = self._sessions.get(sid)
            if session is None or session.status not in (OPEN, DRAINING):
                self.promote.note_swap_void(sid)
                continue
            if session.inflight != 0:
                continue   # mid-flight: not at a boundary, next tick
            chaos.tick("pre_swap", session=sid, gen=gen, swap=kind)
            boundary = session.blocks_done
            if self.state_dir is not None:
                from pathlib import Path

                from disco_tpu_torch.serve.session import save_session_state

                state_dir = Path(self.state_dir)
                state_dir.mkdir(parents=True, exist_ok=True)
                try:
                    save_session_state(state_dir / f"session_{sid}.state.msgpack", session)
                except Exception as e:
                    obs_events.record(
                        "warning", stage="serve",
                        reason=f"swap checkpoint failed for {sid}: "
                               f"{type(e).__name__}: {e}",
                    )
            session.set_generation(gen, at_seq=boundary)
            ev_kind, ev_action = {"canary": ("canary", "swap"),
                                  "promote": ("promotion", "adopt"),
                                  "rollback": ("rollback", "swap")}[kind]
            obs_events.record(ev_kind, stage="serve", action=ev_action,
                              session=sid, gen=gen, seq=boundary)
            self.promote.note_swapped(sid, gen, boundary)
        # drop the device weights no live or parked session references (a
        # rolled-back candidate must not pin its weights on the device)
        refs = {s.generation for s in self.sessions()}
        refs |= {s.generation for s in self.parked_sessions()}
        for g in [g for g in self._gen_models if g not in refs]:
            del self._gen_models[g]

    def _gen_model(self, gen_id: str):
        """The CRNN of one generation on this scheduler's device: a cache
        miss loads it through the controller (digest-verified) and moves
        its weights to the device once (dispatch thread only)."""
        model = self._gen_models.get(gen_id)
        if model is None:
            model, _variables = self.promote.model_for(gen_id, device=self.device)
            self._gen_models[gen_id] = model
        return model

    def _fill_model_masks(self, session: Session, blocks: list) -> None:
        """Fill a model-mask session's popped blocks in place with masks of
        its current generation (:func:`~disco_tpu_torch.promote.lane.
        block_masks`, tensors on the device) before grouping, so the scan
        path, the tap and a transport-retry requeue all see the same masks
        (a retried block is never recomputed under a later generation)."""
        from disco_tpu_torch.promote.lane import block_masks

        model = self._gen_model(session.generation)
        for i, (seq, Y, mz, mw) in enumerate(blocks):
            if mz is not None:
                continue   # already filled (requeued after a retry)
            m = block_masks(Y, model, ref_mic=session.config.ref_mic)
            blocks[i] = (seq, Y, m, m)

    # -- quarantine (dispatch thread) ----------------------------------------
    def _quarantine(self, session: Session, error: BaseException) -> None:
        """Transport budget exhausted for one session: cool it off instead
        of letting it poison every tick with a fresh retry storm.  The
        ``max_quarantines``-th offense evicts."""
        session.quarantine_count += 1
        if session.quarantine_count > self.max_quarantines:
            self.evict(
                session,
                f"transport failures exhausted the quarantine budget "
                f"({self.max_quarantines}): {type(error).__name__}: {error}",
            )
            return
        session.status = QUARANTINED
        session.quarantine_until_tick = self.tick_no + self.quarantine_ticks
        session.outage_tick = self.tick_no
        obs_registry.counter("session_quarantined").inc()
        obs_events.record(
            "session", stage="serve", action="quarantine",
            session=session.id, strike=session.quarantine_count,
            until_tick=session.quarantine_until_tick,
            error=f"{type(error).__name__}: {error}",
        )
        obs_flight.auto_dump(
            "quarantine",
            reason=f"session {session.id} strike {session.quarantine_count}: "
                   f"{type(error).__name__}: {error}",
        )
        self._set_gauges()

    def _release_quarantined(self) -> None:
        """Re-open quarantined sessions whose cool-off elapsed."""
        for s in self.sessions():
            if s.status == QUARANTINED and self.tick_no >= s.quarantine_until_tick:
                s.status = OPEN
                s.outage_tick = self.tick_no
                obs_events.record("session", stage="serve",
                                  action="unquarantine", session=s.id)
                self._set_gauges()

    def _drop_traces(self, session: Session) -> None:
        """Terminal-state trace cleanup: a session that will never deliver
        its pending blocks leaves no ghost entries in the tracer's bounded
        in-flight table."""
        for seq in session.drain_traces():
            obs_trace.tracer().inflight_end((session.id, seq))

    def _finish(self, session: Session) -> None:
        with self._lock:
            self._sessions.pop(session.id, None)
        session.status = CLOSED
        self._drop_traces(session)
        obs_registry.counter("session_closed").inc()
        obs_events.record("session", stage="serve", action="close",
                          session=session.id, blocks=session.blocks_done)
        self._set_gauges()

    # -- dispatch (scheduler thread) ----------------------------------------
    def tick(self) -> list:
        """One continuous-batching step.

        Returns ``[(session, seq, yf, latency_s), ...]`` host-side
        deliveries (``yf`` numpy: complex64 (K, F, T) for an STFT session,
        float32 (K, samples) for a time-domain one), and finishes sessions
        whose close was requested and whose queues and in-flight dispatches
        drained.  Exactly one batched readback per tick that reads work
        back; none on an idle tick.  With super-ticks on, each session's
        popped blocks ride scanned dispatches in groups of N (the sub-N
        remainder goes per block), and with ``overlap_readback`` the
        previous tick's batch is read back after this tick's launches are
        queued.
        """
        from disco_tpu_torch.runs import chaos
        from disco_tpu_torch.utils.resilience import DispatchDeadline, TRANSPORT_ERRORS

        chaos.tick("serve_tick")
        self.tick_no += 1
        self._release_quarantined()
        self._expire_parks()
        self._checkpoint_parked()
        if self.promote is not None:
            self._apply_generation_swaps()
        sessions = self.sessions()
        if sessions:
            # rotate the starting session each tick: under sustained overload
            # the per-tick block budget runs out, and a fixed registry order
            # would starve the sessions at the tail indefinitely
            k = self._rotate % len(sessions)
            self._rotate += 1
            sessions = sessions[k:] + sessions[:k]
        units: list = []  # (session, [seq, ...], yf on the device, t_dispatch, raw)
        keep_raw = self.tap is not None and not self._tap_suspended
        budget = self.max_blocks_per_tick
        # ladder rung >= 1: fall back to the per-block path
        n_super = (1 if self.ladder is not None and self.ladder.rung >= 1
                   else self.blocks_per_super_tick)
        n_busy = 0
        t0 = time.perf_counter()
        deadline = (DispatchDeadline(self.tick_deadline_s, label="serve_tick")
                    if self.tick_deadline_s else contextlib.nullcontext())
        with deadline:
            for session in sessions:
                if session.status not in (OPEN, DRAINING) or budget <= 0:
                    continue
                if n_super > 1:
                    # align the pop to a multiple of N: blocks left queued
                    # join the next tick's scan group instead of going per
                    # block; a sub-N queue (stream tail) still pops in full
                    # below and rides the per-block path.  When the budget
                    # remainder is < N, skip: the per-tick rotation hands
                    # this session a full-width slot next tick.
                    cap = budget // n_super * n_super
                    if cap == 0:
                        continue
                else:
                    cap = budget
                blocks = session.pop_blocks(cap)
                if not blocks:
                    continue
                n_busy += 1
                budget -= len(blocks)
                # progress rides a mutable cell, NOT the return value: when
                # a dispatch raises mid-pop, the blocks dispatched before it
                # are already in `units` with the carry advanced
                progress = [0]
                try:
                    self._dispatch_blocks(session, blocks, n_super, units, keep_raw,
                                          progress)
                except TRANSPORT_ERRORS as e:
                    # transport budget exhausted after the per-call retries:
                    # the carry never advanced for the blocks past
                    # `progress`, so they re-queue in order (a bit-identical
                    # later retry) and the session cools off in quarantine
                    self._trace_dispatch_failed(session, blocks[progress[0]:], e)
                    session.requeue_front(blocks[progress[0]:])
                    self._quarantine(session, e)
                except Exception as e:
                    # per-session isolation: a NON-transport error is
                    # deterministic, so evict the offender and keep serving
                    # the others.  ChaosCrash is a BaseException and still
                    # dies here.
                    self.evict(
                        session, f"dispatch failed: {type(e).__name__}: {e}"
                    )

            if self.overlap_readback:
                # double buffer: read back the PREVIOUS tick's batch while this
                # tick's launches compute; an idle tick flushes the buffer
                to_read, self._inflight = self._inflight, units
            else:
                to_read = units
            deliveries = self._readback(to_read) if to_read else []
        deadline_hits = 0
        if isinstance(deadline, DispatchDeadline) and deadline.expired:
            # the tick is suspect: fence the device through the bounded
            # preflight probe before deciding anything
            deadline_hits = 1
            self._probe_after_deadline(deadline)
        if to_read:
            obs_registry.histogram("serve_tick_ms").observe(
                (time.perf_counter() - t0) * 1e3
            )
        obs_registry.gauge("batch_occupancy").set(
            n_busy / self.max_sessions if self.max_sessions else 0.0
        )

        for session in sessions:
            if (session.close_requested and session.status in (OPEN, DRAINING)
                    and session.queue_depth() == 0 and session.inflight == 0):
                self._finish(session)
        self._step_ladder(deadline_hits)
        if self.resident is not None and not self.draining:
            # the co-resident trainer's slice rides the tail of the tick:
            # this tick's serving work is dispatched and read back, and the
            # ladder has folded this tick's distress — a rung at or above
            # the trainer's throttle threshold trains nothing
            self.resident.step(tick_no=self.tick_no,
                               rung=self.ladder.rung if self.ladder is not None else 0)
        self._set_gauges()
        return deliveries

    def _dispatch_blocks(self, session: Session, blocks: list, n_super: int,
                         units: list, keep_raw: bool, progress: list) -> int:
        """Dispatch one session's popped blocks (scan groups + per-block
        tail); every dispatch goes through the transport-retry wrapper.
        ``progress`` (a 1-cell list) advances after every successful
        dispatch, so the caller knows exactly which blocks to re-queue when
        this raises mid-pop.  A time-domain session's window always goes
        alone: the window STFT pads each window by reflection, so two
        windows joined are another transform.  A model session's masks are
        filled first (:meth:`_fill_model_masks`).  With ``keep_raw`` each
        unit keeps its input tuples for the tap; a time-domain window is
        never tapped (the shard records are STFT tuples)."""
        bf = session.config.block_frames
        if self.promote is not None and session.config.masks == "model":
            self._fill_model_masks(session, blocks)
        chained = session.config.domain == "time"
        if chained:
            keep_raw = False
        done = 0
        for g in range(0, len(blocks), n_super):
            group = blocks[g:g + n_super]
            if (not chained and n_super > 1 and len(group) == n_super
                    and all(b[1].shape[-1] == bf for b in group)):
                yf = self._dispatch_resilient(self._dispatch_scan, session, group)
                units.append((session, [b[0] for b in group], yf, time.time(),
                              group if keep_raw else None))
                session.inflight += len(group)
                done += len(group)
                progress[0] = done
                self._trace_dispatch(session, [b[0] for b in group], len(group))
            else:
                for seq, Y, mz, mw in group:
                    yf = self._dispatch_resilient(
                        self._dispatch_chained if chained else self._dispatch,
                        session, seq, Y, mz, mw)
                    units.append((session, [seq], yf, time.time(),
                                  [(seq, Y, mz, mw)] if keep_raw else None))
                    session.inflight += 1
                    done += 1
                    progress[0] = done
                    self._trace_dispatch(session, [seq], 1)
        return done

    def _trace_dispatch(self, session: Session, seqs: list, n_group: int) -> None:
        """Record the ``dispatch`` hop for each just-dispatched block and
        advance its stored trace head (dispatch thread).  ``wait_ms`` is
        the enqueue→dispatch queue wait."""
        if not obs_trace.enabled():
            return
        now = time.time()
        for seq in seqs:
            ctx = session.get_trace(seq)
            if ctx is None:
                continue
            t_in = session.enqueued_at.get(seq)
            ctx = obs_trace.span(
                "dispatch", ctx, session=session.id, seq=int(seq),
                tick=self.tick_no, group=n_group,
                wait_ms=(round(max(now - t_in, 0.0) * 1e3, 3)
                         if t_in is not None else None),
            )
            session.set_trace(seq, ctx)
            obs_trace.tracer().inflight_update((session.id, int(seq)), "dispatch")

    def _trace_dispatch_failed(self, session: Session, blocks: list,
                               error: BaseException) -> None:
        """Record a FAILED ``dispatch`` span for the first undispatched
        block of a transport-exhausted pop.  The stored trace head is not
        advanced: the retry re-chains its own ``dispatch`` hop from the
        same ``enqueue`` parent."""
        if not obs_trace.enabled() or not blocks:
            return
        seq = blocks[0][0]
        ctx = session.get_trace(seq)
        if ctx is None:
            return
        obs_trace.span(
            "dispatch", ctx, session=session.id, seq=int(seq),
            tick=self.tick_no, failed=True,
            error=f"{type(error).__name__}: {error}",
        )

    def _retry_opts(self, label: str) -> dict:
        """The transport-retry budget of one dispatch or readback, its
        jitter seeded by (retry_seed, dispatch counter)."""
        from disco_tpu_torch.utils.resilience import TRANSPORT_ERRORS

        self._dispatch_seq += 1
        return {"retries": self.dispatch_retries,
                "base_delay_s": self.dispatch_retry_base_s,
                "max_delay_s": 0.5, "retry_on": TRANSPORT_ERRORS, "jitter": 0.5,
                "jitter_seed": self.retry_seed + self._dispatch_seq, "label": label}

    def _dispatch_resilient(self, fn, session: Session, *args):
        """One dispatch under the transport-retry contract: transient
        ``TRANSPORT_ERRORS`` retry with seeded-jitter backoff; any other
        exception raises straight through to the evict path.  The carry
        only advances on success, so a retried attempt is bit-identical to
        a first try."""
        from disco_tpu_torch.utils.resilience import call_with_retries

        return call_with_retries(fn, session, *args, **self._retry_opts("serve_dispatch"))

    def _probe_after_deadline(self, deadline) -> None:
        """A tick blew its wall deadline: fence the device via the bounded
        preflight probe.  Success means the device answers again (the
        suspect tick merely finished late — the ladder handles the rest);
        ``PreflightFailed`` propagates and unwinds the dispatch thread
        cleanly (parked/checkpointed sessions resume on the next server)."""
        from disco_tpu_torch.utils.resilience import preflight_probe

        probe = preflight_probe(deadline_s=max(self.tick_deadline_s, 5.0),
                                retries=1, device=self.device)
        obs_events.record(
            "warning", stage="serve",
            reason=f"tick {self.tick_no} exceeded its "
                   f"{self.tick_deadline_s:g}s dispatch deadline "
                   f"(finished in {deadline.elapsed_s():.3f}s); device "
                   f"probe ok in {probe['dur_s']}s",
        )
        obs_flight.auto_dump(
            "watchdog",
            reason=f"tick {self.tick_no} blew its "
                   f"{self.tick_deadline_s:g}s dispatch deadline",
        )

    def _step_ladder(self, deadline_hits: int) -> None:
        """Feed the degradation ladder this tick's metrics and apply the
        rung's effects (super-tick shrink is read by the next tick; the tap
        gate and shedding apply here)."""
        if self.ladder is None:
            return
        cutoff = self.tick_no - self.wait_window_ticks
        self._wait_samples = [s for s in self._wait_samples if s[0] > cutoff]
        window = [ms for (_t, ms) in self._wait_samples]
        p95 = float(np.percentile(window, 95)) if window else 0.0
        obs_registry.gauge("queue_wait_p95_ms").set(p95)
        rung = self.ladder.observe(queue_wait_p95_ms=p95,
                                   deadline_hits=deadline_hits,
                                   tick=self.tick_no)
        self._tap_suspended = rung >= 2
        if rung >= 3:
            self._shed_one()

    def _shed_one(self) -> None:
        """Shed rung: park the NEWEST non-priority open session (resume
        token + back-off hint ride the ``parked`` error frame), one per
        tick while the rung holds."""
        candidates = [s for s in self.sessions()
                      if s.status == OPEN and not s.priority]
        if not candidates:
            return
        victim = max(candidates, key=lambda s: s.open_seq)
        obs_registry.counter("sessions_shed").inc()
        self.park(victim, "shed: overload (degradation ladder)",
                  notice=True, retry_after_s=self.shed_retry_after_s)

    def _readback(self, units: list) -> list:
        """ONE batched readback (``device.to_host``) over ``units`` and the
        per-block delivery bookkeeping.  A super-tick unit's (K, F,
        N*block_frames) output is split back into its N per-seq blocks on
        the host.

        ``serve_block_latency_ms`` is split into ``serve_queue_wait_ms``
        (enqueue → dispatch) and ``serve_dispatch_ms`` (dispatch → host
        delivery: device time plus the readback share and, with
        ``overlap_readback``, the one-tick buffering lag).

        The tap's copies of a model session's masks (tensors on the device)
        cross in the same ``to_host``, after the outputs."""
        import torch

        from disco_tpu_torch.device import to_host
        from disco_tpu_torch.utils.resilience import call_with_retries

        n_blocks = sum(len(seqs) for (_, seqs, _, _, _) in units)
        n_sessions = len({s.id for (s, _, _, _, _) in units})
        tap_on = self.tap is not None and not self._tap_suspended
        dev_masks = [mz for (_, _, _, _, raw) in units if tap_on and raw
                     for (_, _, mz, _) in raw if isinstance(mz, torch.Tensor)]
        with obs_events.stage("serve_tick", n_blocks=n_blocks, n_sessions=n_sessions):
            # an EXHAUSTED budget raises: the carries already advanced on
            # the device, so there is no bit-exact way to replay this tick;
            # the server unwinds and checkpointed sessions resume elsewhere
            t_rb0 = time.perf_counter()
            host = call_with_retries(to_host, [yf for (_, _, yf, _, _) in units] + dev_masks,
                                     **self._retry_opts("serve_readback"))
        host_masks = dict(zip(map(id, dev_masks), host[len(units):]))
        host = host[:len(units)]
        readback_ms = round((time.perf_counter() - t_rb0) * 1e3, 3)
        now = time.time()
        lat_hist = obs_registry.histogram("serve_block_latency_ms")
        wait_hist = obs_registry.histogram("serve_queue_wait_ms")
        disp_hist = obs_registry.histogram("serve_dispatch_ms")
        deliveries = []
        tracing = obs_trace.enabled()
        delivered_ctx: dict = {}
        for (session, seqs, _, t_disp, raw), yf in zip(units, host):
            bf = session.config.block_frames
            for j, seq in enumerate(seqs):
                blk = yf if len(seqs) == 1 else yf[..., j * bf:(j + 1) * bf]
                t_in = session.enqueued_at.pop(seq, None)
                lat_s = (now - t_in) if t_in is not None else 0.0
                lat_hist.observe(lat_s * 1e3)
                if tracing:
                    ctx = session.pop_trace(seq)
                    if ctx is not None:
                        ctx = obs_trace.span(
                            "readback", ctx, session=session.id, seq=int(seq),
                            tick=self.tick_no, readback_ms=readback_ms,
                            n_blocks=n_blocks,
                        )
                        ctx = obs_trace.span(
                            "deliver", ctx, session=session.id, seq=int(seq),
                            latency_ms=round(lat_s * 1e3, 3),
                        )
                        delivered_ctx[(session.id, int(seq))] = ctx
                        obs_trace.tracer().inflight_end((session.id, int(seq)))
                if t_in is not None:
                    wait_ms = max(t_disp - t_in, 0.0) * 1e3
                    wait_hist.observe(wait_ms)
                    if (self.ladder is not None
                            and self.tick_no - session.outage_tick
                            > self.wait_window_ticks):
                        # a post-outage backlog flush measures the outage,
                        # not the load: keep it out of the ladder's p95
                        self._wait_samples.append((self.tick_no, wait_ms))
                disp_hist.observe(max(now - t_disp, 0.0) * 1e3)
                session.blocks_done = max(session.blocks_done, seq + 1)
                session.inflight = max(session.inflight - 1, 0)
                # the reattach replay buffer (super-tick slices are copied so
                # a parked stream never pins the whole readback payload)
                session.record_delivery(
                    seq, blk if len(seqs) == 1 else np.ascontiguousarray(blk))
                deliveries.append((session, seq, blk, lat_s))
                if self.promote is not None and session.generation is not None:
                    # advances the canary window, attributed to the
                    # generation the block ran under
                    self.promote.note_delivery(session.id, seq, session.gen_for(seq))
            if tap_on and raw:
                # the corpus-tap seam: the block's training tuple is on the
                # host here (inputs kept at dispatch, yf and a model
                # session's masks just read back).  offer() never blocks and
                # never raises.  Super-tick slices are copied, so a queued
                # record never pins the whole readback buffer.
                for j, (seq, Y, mz, mw) in enumerate(raw):
                    blk = (yf if len(seqs) == 1
                           else np.ascontiguousarray(yf[..., j * bf:(j + 1) * bf]))
                    mz = host_masks.get(id(mz), mz)
                    mw = host_masks.get(id(mw), mw)
                    self.tap.offer(session.id, seq, Y, mz, mw, blk,
                                   trace=delivered_ctx.get((session.id, int(seq))))
        self.ticks_with_work += 1
        obs_registry.counter("serve_ticks").inc()
        obs_registry.counter("serve_blocks").inc(n_blocks)
        if any(len(seqs) > 1 for (_, seqs, _, _, _) in units):
            obs_registry.counter("serve_super_ticks").inc()
        return deliveries

    def _step_kwargs(self, session: Session, first_seq: int, n_refresh: int) -> dict:
        """The keyword arguments every step of a session takes: its config,
        its carry (moved to the device at its first dispatch), the
        availability columns of its refresh blocks, and the device."""
        from disco_tpu_torch.enhance.streaming import state_from_numpy

        cfg = session.config
        state = session.state
        if isinstance(state, dict) and isinstance(state["step1"][0], np.ndarray):
            state = state_from_numpy(state, self.device)
        return {"lambda_cor": cfg.lambda_cor, "update_every": cfg.update_every,
                "mu": cfg.mu, "ref_mic": cfg.ref_mic, "policy": cfg.policy,
                "state": state, "solver": cfg.solver,
                "z_avail": session.block_z_avail(first_seq, n_refresh),
                "device": self.device}

    def _dispatch(self, session: Session, seq: int, Y, mz, mw):
        """Queue one block's streaming step on the device (no readback):
        the offline entry point with the session's carry."""
        if _DISPATCH_FAULT_INJECTOR is not None:
            _DISPATCH_FAULT_INJECTOR(session.id, [seq])
        from disco_tpu_torch.enhance.streaming import streaming_tango

        n_refresh = -(-Y.shape[-1] // session.config.update_every)  # ragged final block
        out = streaming_tango(Y, mz, mw, **self._step_kwargs(session, seq, n_refresh))
        session.state = out["state"]
        return out["yf"]

    def _dispatch_chained(self, session: Session, seq: int, y, mz, mw):
        """Queue one time-domain session's window on the device (no
        readback): :func:`~disco_tpu_torch.enhance.fused.streaming_clip_fused`
        (window STFT, the masks, the two-step streaming pipeline and the
        ISTFT).  The carry is the STFT lane's streaming state, so a window
        boundary is a block boundary for checkpoints and replay."""
        if _DISPATCH_FAULT_INJECTOR is not None:
            _DISPATCH_FAULT_INJECTOR(session.id, [seq])
        from disco_tpu_torch.enhance.fused import streaming_clip_fused

        cfg = session.config
        n_refresh = cfg.frames_of(y.shape[-1]) // cfg.update_every
        out = streaming_clip_fused(y, masks_z=mz, mask_w=mw,
                                   **self._step_kwargs(session, seq, n_refresh))
        session.state = out["state"]
        return out["yf"]

    def _dispatch_scan(self, session: Session, blocks: list):
        """Queue one super-tick on the device: N contiguous full blocks
        through ``streaming_tango_scan`` (no readback), with the calling
        convention of :meth:`_dispatch` — bit-identical to N per-block
        dispatches."""
        if _DISPATCH_FAULT_INJECTOR is not None:
            _DISPATCH_FAULT_INJECTOR(session.id, [b[0] for b in blocks])
        from disco_tpu_torch.enhance.streaming import streaming_tango_scan

        import torch

        def join(arrays):  # a model session's masks are device tensors
            if isinstance(arrays[0], torch.Tensor):
                return torch.cat(arrays, dim=-1)
            return np.concatenate(arrays, axis=-1)

        Y = np.concatenate([b[1] for b in blocks], axis=-1)
        mz, mw = join([b[2] for b in blocks]), join([b[3] for b in blocks])
        n_refresh = Y.shape[-1] // session.config.update_every  # grouped blocks are full
        out = streaming_tango_scan(Y, mz, mw, blocks_per_dispatch=len(blocks),
                                   **self._step_kwargs(session, blocks[0][0], n_refresh))
        session.state = out["state"]
        return out["yf"]

    def pending_blocks(self) -> int:
        """Blocks not yet delivered: queued plus dispatched in flight (the
        drain gate waits for the overlap buffer to flush before the final
        checkpoint, so checkpoints land on delivered-block boundaries)."""
        return sum(s.queue_depth() + s.inflight for s in self.sessions())

    def _set_gauges(self) -> None:
        with self._lock:
            n = len(self._sessions)
            n_parked = len(self._parked)
            n_quar = sum(1 for s in self._sessions.values()
                         if s.status == QUARANTINED)
            depth = sum(s.queue_depth() for s in self._sessions.values())
        obs_registry.gauge("sessions_active").set(n)
        obs_registry.gauge("sessions_parked").set(n_parked)
        obs_registry.gauge("sessions_quarantined").set(n_quar)
        obs_registry.gauge("queue_depth").set(depth)

    # -- drain / checkpoint (dispatch thread) --------------------------------
    def checkpoint_sessions(self, state_dir) -> dict:
        """Checkpoint every live and parked session's carry under
        ``state_dir`` — the carries fetched in ONE batched readback, files
        placed atomically (:func:`~disco_tpu_torch.serve.session.
        save_session_state`).  Returns {session_id: path}."""
        from pathlib import Path

        from disco_tpu_torch.serve.session import fetch_state_host, save_session_state

        state_dir = Path(state_dir)
        sessions = [s for s in self.sessions()
                    if s.status in (OPEN, DRAINING, QUARANTINED)]
        # parked sessions checkpoint too: their client may reattach to the
        # NEXT server with the resume token
        sessions += self.parked_sessions()
        if not sessions:
            return {}
        host_states = fetch_state_host({s.id: s.state for s in sessions})
        paths = {}
        for s in sessions:
            path = state_dir / f"session_{s.id}.state.msgpack"
            save_session_state(path, s, state_host=host_states[s.id])
            paths[s.id] = str(path)
        return paths

    def start_drain(self) -> None:
        """Stop admitting; mark every live session draining (their queued
        blocks still run to completion on subsequent ticks)."""
        self.draining = True
        for s in self.sessions():
            if s.status == OPEN:
                s.status = DRAINING
