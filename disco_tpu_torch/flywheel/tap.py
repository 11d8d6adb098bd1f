"""The corpus tap: serve traffic -> training shards, without touching
serving (the port's counterpart of ``disco_tpu/flywheel/tap.py``).

The scheduler's post-readback seam sees, for every delivered block, the
tuple the CRNN mask estimator learns from — the noisy mixture STFT block
``Y``, the enhanced output ``yf`` and the step-1/2 masks, all host numpy
arrays by then (the outputs and a model session's masks crossed in the
tick's one ``device.to_host``).  :class:`CorpusTap` spools those tuples
onto a bounded queue drained by a background writer thread that rotates
shard files (:mod:`disco_tpu_torch.flywheel.shards`) and records each
finished shard in a manifest ledger (:class:`disco_tpu_torch.runs.RunLedger`
— digested ``done`` records, so a resume verifies shards before trusting
them).

Discipline:

* the writer thread never touches torch: numpy, the msgpack codec and
  ``io.atomic`` only.  The dispatch thread owns the card, and a second
  thread launching CUDA work would race it;
* :meth:`CorpusTap.offer` never blocks and never raises: a full queue
  drops the block and ticks ``tap_dropped`` — serving never backpressures
  on its own tap, and a tap bug never evicts a session;
* a :class:`~disco_tpu_torch.runs.chaos.ChaosCrash` on the writer thread
  (the ``mid_write`` seam inside the atomic shard write) is stashed and
  raised again at :meth:`close`: a simulated process death is never
  swallowed.

Counters: ``tap_blocks`` (accepted), ``tap_dropped`` (overflow),
``tap_shards_written``, ``tap_errors``; shard rotations record a ``tap``
obs event.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from pathlib import Path

import numpy as np

from disco_tpu_torch.flywheel.shards import SHARD_SUFFIX, unit_shard, write_shard
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.runs.ledger import RunLedger

#: manifest ledger file name inside a tap directory
MANIFEST_NAME = "manifest.jsonl"

_CLOSE = object()


class CorpusTap:
    """Bounded, never-blocking spool from the serve post-readback seam to
    rotated training shards under ``tap_dir``.

    Args:
      tap_dir: shard + manifest directory (created if missing).
      max_queue_blocks: bound on spooled-but-unwritten blocks; offers past
        it drop and count (``tap_dropped``) instead of blocking serving.
      records_per_shard: rotation threshold — a shard is finalized (atomic
        write + manifest ``done`` record with digest) every this many
        accepted blocks, and once more at :meth:`close` for the remainder.
      start: start the writer thread now (the default).  ``False`` lets a
        test fill the queue deterministically, then call :meth:`start`.
    """

    def __init__(self, tap_dir, *, max_queue_blocks: int = 256,
                 records_per_shard: int = 64, start: bool = True):
        if max_queue_blocks < 1 or records_per_shard < 1:
            raise ValueError("tap bounds must be >= 1")
        self.tap_dir = Path(tap_dir)
        self.tap_dir.mkdir(parents=True, exist_ok=True)
        self.records_per_shard = records_per_shard
        self.ledger = RunLedger(self.tap_dir / MANIFEST_NAME)
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue_blocks)
        self._buf: list[dict] = []
        # resume numbering after the shards already on disk: a restarted
        # server over the same tap dir appends, never overwrites shard 1
        # (which would also void the manifest's recorded digest)
        self._shard_seq = max(
            (int(p.name[len("tap-"):len("tap-") + 6])
             for p in self.tap_dir.glob(f"tap-??????{SHARD_SUFFIX}")),
            default=0)
        self._closing = False
        self._crashed: BaseException | None = None
        self._lock = threading.Lock()
        #: this tap's accounting (the registry counters are process-wide)
        self.accepted = 0
        self.dropped = 0
        self.shards_written = 0
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # -- producer side (the scheduler's dispatch thread) ---------------------
    def offer(self, session_id: str, seq: int, Y, mask_z, mask_w, yf,
              trace=None) -> bool:
        """Spool one delivered block (host numpy arrays); True when accepted.

        Non-blocking and exception-free: a full queue (or a closing tap)
        drops the block, ticks ``tap_dropped`` and returns False.

        ``trace``: the delivered block's causal-trace context
        (``obs.trace.SpanCtx``) — the ``tap`` hop is recorded as the block
        enters the spool and the advanced ids ride in the shard record, so
        a training batch traces back to the client block it came from.
        """
        if self._closing:
            self.dropped += 1
            obs_registry.counter("tap_dropped").inc()
            return False
        record = {
            "session": str(session_id),
            "seq": int(seq),
            "t": time.time(),
            "Y": np.asarray(Y),
            "yf": np.asarray(yf),
            "mask_z": np.asarray(mask_z),
            "mask_w": np.asarray(mask_w),
        }
        tap_ctx = None
        if trace is not None and obs_trace.enabled():
            # mint, then commit: the span id lives in the record, but the
            # event is recorded only if the spool accepts the block
            tap_ctx = obs_trace.SpanCtx(trace=trace.trace, span=obs_trace.new_id())
            record["trace"] = tap_ctx.to_wire()
        try:
            self._q.put_nowait(record)
        except queue_mod.Full:
            self.dropped += 1
            obs_registry.counter("tap_dropped").inc()
            return False
        if tap_ctx is not None:
            obs_trace.record_span("tap", tap_ctx, parent=trace.span,
                                  session=str(session_id), seq=int(seq))
        self.accepted += 1
        obs_registry.counter("tap_blocks").inc()
        return True

    # -- writer side (the tap thread) ----------------------------------------
    def start(self) -> None:
        """Start the background writer thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="disco-flywheel-tap", daemon=True)
            self._thread.start()

    def _run(self):
        try:
            while True:
                try:
                    item = self._q.get(timeout=0.05)
                except queue_mod.Empty:
                    if self._closing:
                        break
                    continue
                if item is _CLOSE:
                    break
                self._buf.append(item)
                if len(self._buf) >= self.records_per_shard:
                    self._rotate()
            if self._buf:
                self._rotate()
        except Exception as e:
            # a tap bug is telemetry, not an outage: count it, say it, stop
            # writing — serving continues untouched
            obs_registry.counter("tap_errors").inc()
            obs_events.record("warning", stage="flywheel",
                              reason=f"tap writer died: {type(e).__name__}: {e}")
        except BaseException as e:  # ChaosCrash: raised again at close()
            with self._lock:
                self._crashed = e

    def _rotate(self):
        """Finalize the buffered records as one shard: atomic write, then
        the manifest ``done`` record carrying the shard's digest."""
        self._shard_seq += 1
        name = f"tap-{self._shard_seq:06d}{SHARD_SUFFIX}"
        path = self.tap_dir / name
        records, self._buf = self._buf, []
        sessions = sorted({r["session"] for r in records})
        write_shard(path, records, meta={
            "created_t": time.time(),
            "sessions": sessions,
            "source": "serve-tap",
        })
        self.ledger.mark_done(unit_shard(name), artifact_paths=[path],
                              n_records=len(records))
        self.shards_written += 1
        obs_registry.counter("tap_shards_written").inc()
        obs_events.record("tap", stage="flywheel", action="shard",
                          shard=name, n_records=len(records),
                          sessions=len(sessions))

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout_s: float = 30.0) -> dict:
        """Flush and stop: drain the queue, finalize the remainder shard,
        join the writer, close the manifest.  Raises a stashed
        :class:`~disco_tpu_torch.runs.chaos.ChaosCrash` of the writer
        thread.  Returns :meth:`stats`.  Idempotent."""
        self._closing = True
        if self._thread is None and not self._q.empty():
            # a never-started tap with spooled blocks: run the writer now
            # so close() still flushes them
            self.start()
        thread = self._thread
        if thread is not None:
            try:  # unblock a writer parked on an empty queue
                self._q.put_nowait(_CLOSE)
            except queue_mod.Full:
                pass
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                obs_registry.counter("tap_errors").inc()
                obs_events.record(
                    "warning", stage="flywheel",
                    reason=f"tap writer still flushing after close({timeout_s:g}s)")
        self.ledger.close()
        obs_events.record("tap", stage="flywheel", action="close", **self.stats())
        with self._lock:
            crash, self._crashed = self._crashed, None
        if crash is not None:
            raise crash
        return self.stats()

    def stats(self) -> dict:
        """This tap's accounting: accepted and dropped blocks, shards written."""
        return {
            "tap_dir": str(self.tap_dir),
            "blocks_accepted": self.accepted,
            "blocks_dropped": self.dropped,
            "shards_written": self.shards_written,
        }
