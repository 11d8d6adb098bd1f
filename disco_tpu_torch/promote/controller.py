"""The promotion controller: canary -> gate -> promote or roll back (the
port's counterpart of ``disco_tpu/promote/controller.py``: the same phases,
ledger units, states and reasons, so a rollout ledger written by either
package resolves the same way when the other replays it).

One background thread (``disco-promote-controller``) turns staged weight
generations (:mod:`disco_tpu_torch.promote.store`) into a survivable
rollout:

1. **stage** — watch a checkpoint directory (or accept direct
   ``GenerationStore`` stages from a live trainer) and stage candidates as
   digest-addressed generations; a mid-epoch-interrupted run is refused at
   this seam (:class:`~disco_tpu_torch.promote.store.PublishRefused`).
2. **canary** — request that ``canary_frac`` of the live model-mask
   sessions swap onto the candidate.  The controller only *requests*: every
   swap is executed by the scheduler's dispatch thread at a block boundary
   (``Scheduler._apply_generation_swaps``), so each session sees exactly
   one generation a block.  The controller thread never touches the card:
   weights reach it only on the dispatch thread, through :meth:`model_for`.
3. **gate** — over a bounded canary window, judge canary SDR within
   ``sdr_gate_db`` of the incumbent (scores arrive through
   :meth:`PromotionController.offer_score`) plus the serve SLO targets
   (``serve.status.evaluate_slo``).
4. **promote or roll back** — promotion flips the store's ``ACTIVE``
   pointer atomically after every model session adopted the candidate;
   demotion dumps the flight recorder (``obs/flight.py``, trigger
   ``demotion``, the reason naming the failing metric) and moves the canary
   sessions back onto the incumbent at the same boundary.

Every transition is recorded in the store's rollout ledger before it takes
effect, so a crash at any chaos seam (``pre_swap`` on the dispatch thread,
``mid_canary``/``post_gate`` here) resumes deterministically: on restart,
:meth:`PromotionController.start` replays the ledger — an interrupted
``promoting`` phase whose ``ACTIVE`` already points at the candidate is
completed, anything else is rolled back, and every session adopts
``ACTIVE``.
"""
from __future__ import annotations

import collections
import threading
import time
from pathlib import Path

from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs import flight as obs_flight
from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.promote.store import GenerationStore, PublishRefused
from disco_tpu_torch.runs import chaos

#: Rollout phases, carried in the ledger's ``phase`` attr (the ledger
#: *state* stays the closed LEDGER_STATES set: ``in_flight`` while any
#: phase is live, ``done``/``failed`` terminal).
PHASES = ("idle", "canary", "gating", "promoting", "rolling_back")


def rollout_unit(gen_id: str) -> str:
    """Ledger unit id of one promotion rollout."""
    return f"rollout:{gen_id}"


class PromotionController:
    """Drives the canary/gate/rollback ladder against one
    :class:`~disco_tpu_torch.promote.store.GenerationStore` and one scheduler.

    Threading contract: the controller thread never touches the card — it
    *requests* swaps into ``_pending`` and the dispatch thread
    executes them (:meth:`pending_swaps` / :meth:`note_swapped`).
    ``_lock`` guards the rollout state machine and is never held across a
    store read, a scheduler call or any I/O.

    Args:
      store: the generation store (or a promote-dir path).
      canary_frac: fraction of live model-mask sessions canaried onto a
        candidate (at least one when any exist).
      sdr_gate_db: demote when mean canary SDR falls more than this many
        dB below the incumbent's; None skips the SDR leg (scoreless
        deployments gate on SLO + window completion alone).
      slo_gate: also judge the serve SLO targets
        (``slo_targets`` overrides :data:`~disco_tpu_torch.serve.status.DEFAULT_SLO`).
      window_blocks: canary window size — delivered candidate blocks
        needed before the gate fires.
      min_scores: minimum canary SDR samples for the SDR leg to count as
        measured.
      gate_timeout_s: wall bound on the whole rollout; a window still
        starved at the bound demotes with the window named as the failing
        metric (no evidence → no promotion).
      watch_dir: optional checkpoint directory to poll for candidates
        (``*.msgpack``; a sibling ``<stem>.ledger.jsonl`` or
        ``ledger.jsonl`` is consulted for the mid-epoch refusal).
      poll_s: controller step period.
      gc_keep_last: arm bounded generation retention — after every
        successful promotion, :meth:`~disco_tpu_torch.promote.store.
        GenerationStore.collect` keeps ACTIVE, the just-replaced
        incumbent, every generation a live/parked session still
        references or an in-flight rollout names, and the last N staged;
        None (default) = the store grows without bound.
    """

    def __init__(self, store, *, canary_frac: float = 0.25,
                 sdr_gate_db: float | None = None, slo_gate: bool = True,
                 slo_targets: dict | None = None, window_blocks: int = 32,
                 min_scores: int = 2, gate_timeout_s: float = 120.0,
                 watch_dir=None, poll_s: float = 0.05,
                 gc_keep_last: int | None = None):
        if not 0.0 <= float(canary_frac) <= 1.0:
            raise ValueError(f"canary_frac must be in [0, 1], got {canary_frac}")
        if int(window_blocks) < 1:
            raise ValueError(f"window_blocks must be >= 1, got {window_blocks}")
        if gc_keep_last is not None and int(gc_keep_last) < 0:
            raise ValueError(f"gc_keep_last must be >= 0, got {gc_keep_last}")
        self.store = store if isinstance(store, GenerationStore) else GenerationStore(store)
        self.canary_frac = float(canary_frac)
        self.sdr_gate_db = None if sdr_gate_db is None else float(sdr_gate_db)
        self.slo_gate = bool(slo_gate)
        self.slo_targets = dict(slo_targets) if slo_targets else None
        self.window_blocks = int(window_blocks)
        self.min_scores = int(min_scores)
        self.gate_timeout_s = float(gate_timeout_s)
        self.watch_dir = Path(watch_dir) if watch_dir is not None else None
        self.poll_s = float(poll_s)
        self.gc_keep_last = None if gc_keep_last is None else int(gc_keep_last)

        self.scheduler = None
        self.crashed: BaseException | None = None
        self._ledger = self.store.rollout_ledger()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seen_ckpts: dict = {}

        self._lock = threading.Lock()
        self._phase = "idle"
        self._candidate = None          # Generation under rollout
        self._incumbent: str | None = None
        self._pending: dict = {}        # sid -> (gen_id, kind) swap requests
        self._swapped: set = set()      # sids currently on the candidate
        self._canary_ids: set = set()
        self._scores = {"canary": collections.deque(maxlen=self.window_blocks),
                        "incumbent": collections.deque(maxlen=self.window_blocks)}
        self._canary_blocks = 0
        self._window_t0: float | None = None
        self._rollout_t0: float | None = None
        self._fail_reason: str | None = None
        self._trace = None              # rollout SpanCtx (promote_* chain)

    # -- wiring ----------------------------------------------------------------
    def bind(self, scheduler) -> None:
        """Attach the scheduler this controller steers (called by
        ``Scheduler.__init__(promote=...)``)."""
        self.scheduler = scheduler

    def start(self) -> None:
        """Resume any interrupted rollout from the ledger, then start the
        controller thread."""
        self._resume()
        self._thread = threading.Thread(
            target=self._run, name="disco-promote-controller", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Request controller shutdown (idempotent)."""
        self._stop.set()

    def wait(self, timeout_s: float | None = 10.0) -> None:
        """Join the controller thread; inspect :attr:`crashed` afterwards
        (a ChaosCrash in the controller is surfaced there, like
        ``EnhanceServer.crashed``)."""
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    # -- dispatch-thread interface (scheduler side) ----------------------------
    def active_generation(self) -> str:
        """gen_id every newly-opened model-mask session adopts (the store's
        ``ACTIVE`` pointer — crash truth, not controller memory)."""
        gen = self.store.active()
        if gen is None:
            raise RuntimeError(
                f"promote store {self.store.root} has no ACTIVE generation — "
                f"stage and activate an incumbent before serving model masks")
        return gen

    def pending_swaps(self) -> list:
        """Snapshot of requested swaps: ``[(session_id, gen_id, kind)]``
        with kind in ``canary``/``promote``/``rollback``.  The dispatch
        thread applies what it can at block boundaries and reports back
        through :meth:`note_swapped` / :meth:`note_swap_void`."""
        with self._lock:
            return [(sid, gen, kind) for sid, (gen, kind) in self._pending.items()]

    def note_swapped(self, session_id: str, gen_id: str, seq: int) -> None:
        """Dispatch-thread report: ``session_id`` now serves ``gen_id``
        from block ``seq`` on."""
        with self._lock:
            self._pending.pop(session_id, None)
            if self._candidate is not None and gen_id == self._candidate.gen_id:
                self._swapped.add(session_id)
            else:
                self._swapped.discard(session_id)

    def note_swap_void(self, session_id: str) -> None:
        """Dispatch-thread report: the session a swap was requested for is
        gone (closed/evicted/parked) — stop waiting on it."""
        with self._lock:
            self._pending.pop(session_id, None)
            self._swapped.discard(session_id)
            self._canary_ids.discard(session_id)

    def current_candidate(self) -> str | None:
        """gen_id of the generation under rollout, or None when idle (the
        scheduler's reattach staleness check)."""
        with self._lock:
            return None if self._candidate is None else self._candidate.gen_id

    def note_delivery(self, session_id: str, seq: int, gen_id: str) -> None:
        """Dispatch-thread report: one block was delivered under
        ``gen_id`` — advances the canary window while the gate is open."""
        with self._lock:
            if (self._phase == "gating" and self._candidate is not None
                    and gen_id == self._candidate.gen_id):
                self._canary_blocks += 1

    def model_for(self, gen_id: str, device=None):
        """(model on ``device``, host variables) for a generation — the
        scheduler's device-cache miss path, called on the dispatch thread
        (the store digest-verifies the weight file)."""
        return self.store.load(gen_id, device=device)

    # -- scorer interface ------------------------------------------------------
    def offer_score(self, session_id: str, seq: int, sdr_db: float, *,
                    gen: str | None = None) -> None:
        """Feed one delivered block's SDR (any thread; the check harness
        and external scorers).  ``gen`` attributes the sample to the
        candidate or incumbent side explicitly (the delivered frame's
        generation tag); without it the session's current side is used."""
        with self._lock:
            if self._phase not in ("canary", "gating") or self._candidate is None:
                return
            if gen is not None:
                side = "canary" if gen == self._candidate.gen_id else "incumbent"
            else:
                side = "canary" if session_id in self._swapped else "incumbent"
            self._scores[side].append(float(sdr_db))

    # -- the controller thread -------------------------------------------------
    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._step()
                self._stop.wait(self.poll_s)
        except BaseException as e:  # noqa: BLE001 — deliberate last-resort
            # stash: a ChaosCrash here simulates the controller's process
            # death; the server keeps serving on its current generations,
            # and the caller observes the death through `crashed`, like
            # EnhanceServer's dispatch-loop stash.
            self.crashed = e
            obs_events.record("rollback", stage="controller", action="crashed",
                              error=f"{type(e).__name__}: {e}")

    def _step(self) -> None:
        self._scan_watch_dir()
        with self._lock:
            phase = self._phase
        if phase == "idle":
            self._maybe_begin_rollout()
        elif phase == "canary":
            self._step_canary()
        elif phase == "gating":
            self._step_gating()
        elif phase == "promoting":
            self._step_promoting()
        elif phase == "rolling_back":
            self._step_rolling_back()

    # -- staging (watch dir) ---------------------------------------------------
    def _scan_watch_dir(self) -> None:
        if self.watch_dir is None or not self.watch_dir.is_dir():
            return
        active = self.store.active()
        for path in sorted(self.watch_dir.glob("*.msgpack")):
            try:
                st = path.stat()
            except OSError:
                continue
            key = (st.st_mtime_ns, st.st_size)
            if self._seen_ckpts.get(str(path)) == key:
                continue
            self._seen_ckpts[str(path)] = key
            if active is None:
                obs_events.record(
                    "promotion", stage="stage", action="refused",
                    path=path.name,
                    reason="no ACTIVE generation to take the architecture from")
                continue
            arch = self.store.get(active).arch
            ledger = None
            for cand in (path.with_suffix(".ledger.jsonl"),
                         path.parent / "ledger.jsonl"):
                if cand.is_file():
                    ledger = cand
                    break
            try:
                gen = self.store.stage_checkpoint(
                    path, arch=arch, ledger=ledger, source=str(path))
            except PublishRefused as e:
                obs_events.record("promotion", stage="stage", action="refused",
                                  path=path.name, unit=e.unit, reason=str(e))
                continue
            with self._lock:
                queued = self._phase != "idle"
            # a candidate landing mid-rollout is QUEUED, not dropped: it is
            # staged now and picked up by _maybe_begin_rollout at the next
            # idle step (newest-wins — see the superseded marking there)
            obs_events.record("promotion", stage="stage", action="staged",
                              gen=gen.gen_id, serial=gen.serial,
                              path=path.name, queued=queued)

    # -- phase steps -----------------------------------------------------------
    def _maybe_begin_rollout(self) -> None:
        active = self.store.active()
        if active is None:
            return
        latest = self._ledger.replay()
        active_serial = self.store.get(active).serial
        eligible = []
        for gen_id in self.store.list_ids():       # staging (serial) order
            if gen_id == active:
                continue
            if self.store.get(gen_id).serial < active_serial:
                continue   # staged before the live generation: a promotion
                           # must never resurrect a superseded candidate
            rec = latest.get(rollout_unit(gen_id))
            if rec is not None and rec["state"] in ("done", "failed"):
                continue                            # already decided — never retried
            eligible.append(self.store.get(gen_id))
        if not eligible:
            return
        candidate = eligible[-1]                    # newest wins
        for stale in eligible[:-1]:
            # decide the older queued candidates DURABLY: without a
            # terminal record a failed rollout of the newest would let an
            # already-obsolete generation roll out on the next idle step
            self._ledger.mark_failed(
                rollout_unit(stale.gen_id),
                error=f"superseded by {candidate.gen_id}",
                phase="superseded", superseded_by=candidate.gen_id)
            obs_registry.counter("candidates_superseded").inc()
            obs_events.record("promotion", stage="rollout", action="superseded",
                              gen=stale.gen_id, serial=stale.serial,
                              by=candidate.gen_id)
        unit = rollout_unit(candidate.gen_id)
        self._ledger.record(unit, "in_flight", phase="canary",
                            candidate=candidate.gen_id, incumbent=active,
                            canary_frac=self.canary_frac)
        ctx = obs_trace.root("promote_stage", gen=candidate.gen_id,
                            serial=candidate.serial)
        obs_events.record("promotion", stage="rollout", action="begin",
                          gen=candidate.gen_id, serial=candidate.serial,
                          incumbent=active)
        with self._lock:
            self._phase = "canary"
            self._candidate = candidate
            self._incumbent = active
            self._pending = {}
            self._swapped = set()
            self._canary_ids = set()
            self._scores = {
                "canary": collections.deque(maxlen=self.window_blocks),
                "incumbent": collections.deque(maxlen=self.window_blocks)}
            self._canary_blocks = 0
            self._rollout_t0 = time.monotonic()
            self._window_t0 = None
            self._fail_reason = None
            self._trace = ctx

    def _model_session_ids(self) -> list:
        sched = self.scheduler
        return [] if sched is None else sched.model_session_ids()

    def _step_canary(self) -> None:
        with self._lock:
            cand = self._candidate
            have_canaries = bool(self._canary_ids)
            pending = bool(self._pending)
            t0 = self._rollout_t0
        if not have_canaries:
            eligible = sorted(self._model_session_ids())
            if not eligible:
                if time.monotonic() - t0 > self.gate_timeout_s:
                    self._decide([{"name": "canary_sessions", "value": 0,
                                   "target": 1, "ok": False}])
                return
            n = max(1, int(round(self.canary_frac * len(eligible))))
            chosen = eligible[:n]
            with self._lock:
                self._canary_ids = set(chosen)
                for sid in chosen:
                    self._pending[sid] = (cand.gen_id, "canary")
            self._trace = obs_trace.span("promote_canary", self._trace,
                                         gen=cand.gen_id, n=len(chosen))
            obs_events.record("canary", stage="assign", action="assign",
                              gen=cand.gen_id, sessions=chosen,
                              frac=self.canary_frac)
            return
        if not pending:
            with self._lock:
                if not self._swapped:      # every chosen canary vanished
                    self._canary_ids = set()
                    return
                self._phase = "gating"
                self._window_t0 = time.monotonic()
                n_live = len(self._swapped)
            obs_events.record("canary", stage="window", action="window",
                              gen=cand.gen_id, n=n_live,
                              window_blocks=self.window_blocks)

    def _step_gating(self) -> None:
        with self._lock:
            cand = self._candidate
            blocks = self._canary_blocks
            t0 = self._window_t0
        chaos.tick("mid_canary", gen=cand.gen_id, blocks=blocks)
        starved = time.monotonic() - t0 > self.gate_timeout_s
        if blocks < self.window_blocks and not starved:
            return
        if starved and blocks < self.window_blocks:
            checks = [{"name": "canary_window_blocks", "value": blocks,
                       "target": self.window_blocks, "ok": False}]
        else:
            checks = self._gate_checks()
        self._decide(checks)

    def _gate_checks(self) -> list:
        with self._lock:
            canary = list(self._scores["canary"])
            incumbent = list(self._scores["incumbent"])
        checks = []
        if self.sdr_gate_db is not None:
            mean_c = (sum(canary) / len(canary)
                      if len(canary) >= self.min_scores else None)
            mean_i = (sum(incumbent) / len(incumbent)) if incumbent else None
            if mean_c is None:
                # the operator asked for SDR gating: an unmeasured canary
                # side is a FAIL here (unlike evaluate_slo's idle-server
                # pass) — no evidence must never promote
                checks.append({"name": "canary_sdr_db", "value": None,
                               "target": None, "ok": False})
            elif mean_i is None:
                checks.append({"name": "canary_sdr_db",
                               "value": round(mean_c, 4), "target": None,
                               "ok": True})     # no incumbent baseline to defend
            else:
                target = mean_i - self.sdr_gate_db
                checks.append({"name": "canary_sdr_db",
                               "value": round(mean_c, 4),
                               "target": round(target, 4),
                               "ok": mean_c >= target})
        if self.slo_gate and self.scheduler is not None:
            from disco_tpu_torch.serve.status import evaluate_slo, status_payload

            slo = evaluate_slo(status_payload(self.scheduler), self.slo_targets)
            checks.extend(slo["checks"])
        return checks

    def _decide(self, checks: list) -> None:
        with self._lock:
            cand = self._candidate
        ok = all(c["ok"] for c in checks)
        chaos.tick("post_gate", gen=cand.gen_id,
                   verdict="promote" if ok else "demote")
        self._trace = obs_trace.span(
            "promote_gate", self._trace, gen=cand.gen_id,
            verdict="promote" if ok else "demote",
            checks=[c["name"] for c in checks if not c["ok"]])
        if ok:
            self._begin_promote(checks)
        else:
            self._begin_rollback(checks)

    def _begin_promote(self, checks: list) -> None:
        with self._lock:
            cand = self._candidate
        self._ledger.record(rollout_unit(cand.gen_id), "in_flight",
                            phase="promoting", checks=checks)
        obs_events.record("promotion", stage="gate", action="pass",
                          gen=cand.gen_id, checks=checks)
        with self._lock:
            self._phase = "promoting"
        self._step_promoting()

    def _step_promoting(self) -> None:
        sids = set(self._model_session_ids())
        with self._lock:
            cand = self._candidate
            for sid in sids - self._swapped - set(self._pending):
                self._pending[sid] = (cand.gen_id, "promote")
            done = not self._pending and sids <= self._swapped
        if done:
            self._finish_promote()

    def _finish_promote(self) -> None:
        with self._lock:
            cand = self._candidate
        self.store.set_active(cand.gen_id)
        latency_ms = max(0.0, (time.time() - float(
            cand.meta.get("staged_t", time.time()))) * 1e3)
        self._ledger.mark_done(rollout_unit(cand.gen_id),
                               artifact_paths=(cand.weights_path,),
                               phase="done", latency_ms=round(latency_ms, 3))
        obs_registry.counter("model_promotions").inc()
        obs_registry.gauge("weight_generation").set(cand.serial)
        obs_registry.histogram("tap_to_promotion_ms").observe(latency_ms)
        obs_events.record("promotion", stage="rollout", action="promoted",
                          gen=cand.gen_id, serial=cand.serial,
                          latency_ms=round(latency_ms, 3))
        self._trace = obs_trace.span("promote_swap", self._trace,
                                     gen=cand.gen_id, action="promote")
        self._collect_generations()
        self._reset_to_idle()

    def _collect_generations(self) -> None:
        """Bounded-retention sweep after a successful promotion (only when
        ``gc_keep_last`` is set).  Pins the just-replaced incumbent plus
        every generation a live or parked session still references — the
        dispatch thread may deliver from them until the park boundary;
        :meth:`~disco_tpu_torch.promote.store.GenerationStore.collect` itself
        pins ACTIVE and any in-flight rollout's sides.  A GC failure must
        never break the rollout path: it is demoted to a warning event."""
        if self.gc_keep_last is None:
            return
        with self._lock:
            pins = {self._incumbent}
        sched = self.scheduler
        if sched is not None:
            pins |= {s.generation for s in sched.sessions()}
            pins |= {s.generation for s in sched.parked_sessions()}
        pins.discard(None)
        try:
            self.store.collect(keep_last=self.gc_keep_last, pinned=pins)
        except Exception as e:  # noqa: BLE001 — GC is best-effort
            obs_events.record("warning", stage="promote", action="gc_failed",
                              error=f"{type(e).__name__}: {e}")

    def _begin_rollback(self, checks: list) -> None:
        failing = next(c for c in checks if not c["ok"])
        reason = (f"{failing['name']}={failing['value']}"
                  f" vs target {failing['target']}")
        with self._lock:
            cand = self._candidate
            incumbent = self._incumbent
            self._fail_reason = reason
        # the flight dump FIRST (names the failing metric), then the
        # durable intent, then the swap requests — a crash between any two
        # resumes as a rollback (the post_gate drill)
        obs_flight.auto_dump("demotion", reason=reason)
        self._ledger.record(rollout_unit(cand.gen_id), "in_flight",
                            phase="rolling_back", reason=reason,
                            metric=failing["name"], checks=checks)
        obs_events.record("rollback", stage="gate", action="begin",
                          gen=cand.gen_id, incumbent=incumbent,
                          metric=failing["name"], reason=reason)
        with self._lock:
            self._phase = "rolling_back"
            for sid in set(self._swapped) | set(self._canary_ids):
                self._pending[sid] = (incumbent, "rollback")
        self._step_rolling_back()

    def _step_rolling_back(self) -> None:
        with self._lock:
            done = not self._pending and not self._swapped
        if done:
            self._finish_rollback()

    def _finish_rollback(self) -> None:
        with self._lock:
            cand = self._candidate
            incumbent = self._incumbent
            reason = self._fail_reason
        self._ledger.mark_failed(rollout_unit(cand.gen_id),
                                 error=reason or "demoted",
                                 phase="rolled_back", incumbent=incumbent)
        obs_events.record("rollback", stage="rollout", action="done",
                          gen=cand.gen_id, incumbent=incumbent, reason=reason)
        self._trace = obs_trace.span("promote_swap", self._trace,
                                     gen=cand.gen_id, action="rollback")
        self._reset_to_idle()

    def _reset_to_idle(self) -> None:
        with self._lock:
            self._phase = "idle"
            self._candidate = None
            self._pending = {}
            self._swapped = set()
            self._canary_ids = set()
            self._canary_blocks = 0
            self._fail_reason = None
            self._trace = None

    # -- crash resume ----------------------------------------------------------
    def _resume(self) -> None:
        """Replay the rollout ledger: complete or roll back any rollout
        interrupted mid-flight.  ``ACTIVE`` is the arbiter — a crash after
        the pointer flip completes the promotion, a crash before it rolls
        back; either way every restarted session adopts ``ACTIVE`` and
        lands on exactly one intact generation (the chaos-leg contract)."""
        active = self.store.active()
        for unit, rec in sorted(self._ledger.replay().items()):
            if not unit.startswith("rollout:") or rec["state"] != "in_flight":
                continue
            gen_id = unit.split(":", 1)[1]
            phase = (rec.get("attrs") or {}).get("phase")
            if phase == "promoting" and active == gen_id:
                self._ledger.mark_done(unit, phase="done", resumed=True)
                obs_registry.counter("model_promotions").inc()
                obs_events.record("promotion", stage="rollout",
                                  action="promoted", gen=gen_id, resumed=True)
            else:
                self._ledger.mark_failed(
                    unit, error=f"crash during {phase!r}; rolled back",
                    phase="rolled_back", resumed=True, incumbent=active)
                obs_events.record("rollback", stage="rollout", action="resume",
                                  gen=gen_id, incumbent=active,
                                  reason=f"crash during {phase!r}")
        if active is not None:
            obs_registry.gauge("weight_generation").set(
                self.store.get(active).serial)
