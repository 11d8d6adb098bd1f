"""Append-only run ledger: per-work-unit state with verified resume (the
port's copy of ``disco_tpu/runs/ledger.py``: the same JSONL, so each package
replays the other's ledger).

The long-haul jobs — corpus enhancement (thousands of RIRs), dataset
generation, multi-hour CRNN training — need a restart story stronger than
"does the output file exist".  The ledger is an append-only JSONL record of
per-unit state transitions::

    {"t": <unix>, "unit": "rir:11001:ssn", "state": "in_flight", "attrs": {...}}
    {"t": <unix>, "unit": "rir:11001:ssn", "state": "done",
     "artifacts": {"results/.../results_mwf_11001_ssn.p": "sha256:..."},
     "attrs": {...}}

States: ``pending`` → ``in_flight`` → ``done`` | ``failed``; a ``requeued``
record (appended by verification) voids an earlier ``done``.  Appends are
single ``write`` calls of one line, flushed and fsynced per transition —
crash-durable, and a torn final line (the one crash artifact an append-only
log can have) is detected and skipped on replay.

**Verified resume** is the point: :meth:`RunLedger.verified_done` replays
the log and re-checks every done unit against its recorded artifacts —
digest match (:func:`disco_tpu_torch.io.atomic.file_digest`) when recorded,
integrity probe otherwise.  A unit whose artifacts are missing or corrupt
is *requeued* (a ``requeued`` line is appended, the ``units_requeued``
counter ticks, a ``warning`` obs event fires) and reported as not-done, so
the driver re-runs it.  Truncated files are never trusted.

No reference counterpart: the reference's restartability is existence
checks per output file (SURVEY.md §5.3).
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

from disco_tpu_torch.io.atomic import file_digest, probe_artifact, verify_digest

#: Legal ledger states, in lifecycle order.
LEDGER_STATES = ("pending", "in_flight", "done", "failed", "requeued")


def unit_rir(rir, noise: str) -> str:
    """Work-unit id of one enhanced RIR (``enhance_rir(s_batched)``)."""
    return f"rir:{rir}:{noise}"


def unit_scene(rir_id) -> str:
    """Work-unit id of one generated datagen scene
    (``datagen.disco.generate_disco_rirs(_batched)``)."""
    return f"scene:{rir_id}"


def unit_epoch(epoch) -> str:
    """Work-unit id of one training epoch (``nn.training.fit``)."""
    return f"epoch:{epoch}"


def digest_artifacts(paths) -> dict:
    """{str(path): sha256 digest} over finished artifact files — the
    payload of a ``done`` record.

    Paths that do not exist are OMITTED rather than raised on: the ledger
    catch-up path records clips whose completion markers are intact but
    whose secondary artifacts may have been cleaned up (a pre-ledger corpus
    where only the OIM pickles feed aggregation is a normal sight), and a
    done record must certify what is there, not crash the resume that is
    trying to recover.  Files present at record time remain fully verified
    on every later resume."""
    return {str(p): file_digest(p) for p in paths if Path(p).is_file()}


class RunLedger:
    """Append-only JSONL state ledger for one run directory.

    Thread-safe (the batched driver marks units done from scoring worker
    threads).  The file handle opens lazily in append mode, so constructing
    a ledger for a path never truncates an existing log — resume appends to
    the same history.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None
        self._lock = threading.Lock()

    # -- append side --------------------------------------------------------
    def record(self, unit: str, state: str, artifacts: dict | None = None, **attrs):
        """Append one state transition, flushed + fsynced (a transition that
        was reported must survive the very next crash)."""
        if state not in LEDGER_STATES:
            raise ValueError(f"unknown ledger state {state!r} (known: {LEDGER_STATES})")
        line = json.dumps(
            {"t": time.time(), "unit": unit, "state": state,
             "artifacts": artifacts, "attrs": attrs},
            default=str,
        )
        with self._lock:
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def mark_in_flight(self, unit: str, **attrs):
        self.record(unit, "in_flight", **attrs)

    def mark_done(self, unit: str, artifact_paths=(), **attrs):
        """Record completion WITH the artifact digests that make the claim
        verifiable on resume."""
        self.record(unit, "done", artifacts=digest_artifacts(artifact_paths), **attrs)

    def mark_failed(self, unit: str, error: str = "", **attrs):
        self.record(unit, "failed", error=error, **attrs)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- replay side --------------------------------------------------------
    def replay(self) -> dict:
        """{unit: latest record dict} from the log.  A torn final line
        (crash mid-append) is skipped; a torn line anywhere else is treated
        the same — every line is independent, so one bad line never poisons
        the rest of the history."""
        state: dict[str, dict] = {}
        if not self.path.exists():
            return state
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn append — the crash artifact replay expects
                if not isinstance(rec, dict) or "unit" not in rec or "state" not in rec:
                    continue
                state[rec["unit"]] = rec
        return state

    def verified_done(self, requeue: bool = True) -> tuple[set, dict]:
        """Replay and VERIFY: returns ``(done_units, requeued)``.

        A unit counts as done only if its latest state is ``done`` AND every
        recorded artifact checks out — digest match when the record carries
        one, format probe (:func:`probe_artifact`) when it does not.  Units
        that fail verification are returned in ``requeued`` ({unit: reason})
        and, when ``requeue`` is true, get a ``requeued`` line appended (so
        the next replay doesn't re-hash them), a ``units_requeued`` counter
        tick and a ``warning`` obs event — corrupt partials are never
        silently trusted.
        """
        from disco_tpu_torch.obs import events as _events
        from disco_tpu_torch.obs.metrics import REGISTRY as _REGISTRY

        done: set = set()
        requeued: dict[str, str] = {}
        for unit, rec in self.replay().items():
            if rec["state"] != "done":
                continue
            reason = None
            for pathstr, digest in (rec.get("artifacts") or {}).items():
                if digest:
                    if not verify_digest(pathstr, digest):
                        reason = (f"artifact {pathstr} "
                                  + ("missing" if not Path(pathstr).exists() else "digest mismatch"))
                        break
                elif not probe_artifact(pathstr):
                    reason = f"artifact {pathstr} missing or failed its integrity probe"
                    break
            if reason is None:
                done.add(unit)
            else:
                requeued[unit] = reason
                if requeue:
                    self.record(unit, "requeued", reason=reason)
                _REGISTRY.counter("units_requeued").inc()
                _events.record("warning", stage="resume", unit=unit, reason=reason)
        return done, requeued
