"""The named-lock registry: every lock in the port, by declaration (the
port's copy of ``disco_tpu/analysis/race/registries.py``; the JAX
package's locks that have no port module — the compile cache, the
native loaders' dlopen locks, the jitted step caches — are gone, and the
port's own ``_Conn`` frame count and ``counted_jit`` seen-set locks are in).

Lock-order analysis needs stable lock *identities*: a deadlock cycle is a
statement about specific locks, so every ``threading.Lock``/``RLock``/
``Condition`` must be a named module- or instance-level attribute
registered here.  The id format is

* ``module::name``        — module-level lock
  (``disco_tpu_torch.runs.interrupt::_lock``)
* ``module:Class::attr``  — instance lock assigned ``self.attr = Lock()``
  (``disco_tpu_torch.flywheel.tap:CorpusTap::_lock``)

The value is the one-line statement of WHAT the lock guards — the
sentence a change adding a lock must state, exactly like the obs
``EVENT_KINDS`` / chaos ``SEAMS`` registries.  A ``Lock()`` created
outside this table is a DR005 finding (and DL015 at lint time): an
anonymous lock cannot participate in the order analysis, so it is an
unreviewed deadlock surface.

Per-instance locks (one lock object per Counter/Session instance) are
registered once by their attribute id: the order analysis is about the
*classes* of locks code acquires, not object identity — two instances of
the same attr id never nest in the repo's designs, and if a design ever
needs that, the registry comment is where it gets said.

No reference counterpart: the reference repo has no locks at all.
"""
from __future__ import annotations

#: lock id -> what it guards (the reviewed contract line)
LOCKS = {
    "disco_tpu_torch.utils.compile_cache::_lock":
        "the kernel build cache's process-wide resolution (root, scratch "
        "root, note flag); no event is recorded under it",
    "disco_tpu_torch.enhance.driver::_FIG_LOCK":
        "matplotlib's non-thread-safe figure state across scoring workers",
    "disco_tpu_torch.runs.interrupt::_lock":
        "the active GracefulInterrupt scope stack",
    "disco_tpu_torch.runs.chaos:_Plan::lock":
        "a chaos plan's hit counter (ticked from any seam's thread)",
    "disco_tpu_torch.runs.ledger:RunLedger::_lock":
        "ledger append + in-memory state (dispatch loop vs tap writer)",
    "disco_tpu_torch.flywheel.tap:CorpusTap::_lock":
        "tap writer-thread lifecycle (start-once) and the ChaosCrash "
        "stash handoff between the writer and close()",
    "disco_tpu_torch.serve.session:Session::_lock":
        "one session's queue/state (I/O thread pushes, dispatch pops)",
    "disco_tpu_torch.serve.scheduler:Scheduler::_lock":
        "the session registry; NEVER held across device work "
        "(Scheduler docstring)",
    "disco_tpu_torch.serve.server:EnhanceServer::_conns_lock":
        "the live-connection set (asyncio thread vs drain)",
    "disco_tpu_torch.serve.server:_Conn::_count_lock":
        "one connection's posted-but-unwritten frame count and its "
        "writer-done flag (dispatch thread posts, the I/O writer drains)",
    "disco_tpu_torch.obs.accounting::_SEEN_LOCK":
        "every counted_jit wrapper's seen-signature set (dispatch thread "
        "vs main: a set lookup and insert, nothing else under it)",
    "disco_tpu_torch.obs.events:Recorder::_lock":
        "the JSONL sink file handle + rotation state",
    "disco_tpu_torch.obs.trace:Tracer::_lock":
        "the in-flight span table",
    "disco_tpu_torch.obs.flight:FlightRecorder::_lock":
        "the per-subsystem rings + dump bookkeeping",
    "disco_tpu_torch.obs.metrics:Counter::_lock":
        "one counter's value (scoring workers vs main)",
    "disco_tpu_torch.obs.metrics:Histogram::_lock":
        "one histogram's reservoir",
    "disco_tpu_torch.obs.metrics:Registry::_lock":
        "the instrument name tables (get-or-create)",
    "disco_tpu_torch.promote.controller:PromotionController::_lock":
        "the rollout state machine (phase/candidate/pending/swapped/"
        "scores: controller thread steps it, dispatch thread reports "
        "swaps, I/O thread offers scores); NEVER held across store I/O "
        "or a model load",
}


#: Functions that ASSUME a lock is already held by their caller (the
#: ``_locked`` suffix convention) — the analyzer seeds their held set so
#: writes inside them are judged as lock-guarded.  Each entry is a
#: reviewed contract: "every caller of this function holds that lock".
ASSUMED_LOCKS = {
    "disco_tpu_torch.obs.events:Recorder._rotate_locked": (
        "disco_tpu_torch.obs.events:Recorder::_lock",
    ),
}


def lock_id(module: str, cls, attr: str) -> str:
    """The registry id for a lock assigned at ``module`` level (``cls``
    None) or as ``self.attr`` inside ``cls`` — the ONE id-construction
    rule shared by DL015 (rules/threads.py) and this registry's readers."""
    return f"{module}:{cls}::{attr}" if cls else f"{module}::{attr}"


def is_registered(lid: str) -> bool:
    """Whether a lock id is in the registry (the DL015-side membership
    check; the race engine consults its injectable ``Index.locks`` copy)."""
    return lid in LOCKS
