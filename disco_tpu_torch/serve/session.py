"""Per-stream session state of the online enhancement service (the port's
copy of ``disco_tpu/serve/session.py``).

A session is one client's audio stream: open -> blocks in -> enhanced
blocks out -> close.  It wraps the state the streaming pipeline defines —
the :func:`~disco_tpu_torch.enhance.streaming.streaming_tango` continuation
carry (the per-block covariance recursion and the last-good-z hold) and
the per-session fault availability plan — and adds what a scheduler needs:
input and output queues, block accounting and lifecycle status.

The carry is an explicit pytree from block 0
(:func:`~disco_tpu_torch.enhance.streaming.initial_stream_state`), so a live
session can be checkpointed at any block boundary
(:func:`save_session_state`: atomic msgpack with a digest, the JAX
package's file) and resumed by a later server of either package
(:func:`load_session_state`) with a bit-identical continuation.

Nothing here calls ``torch.cuda``: a client constructs :class:`SessionConfig`
without touching a device.  :func:`fetch_state_host` brings a device carry
back in one ``device.to_host`` copy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import deque
from pathlib import Path

import numpy as np

from disco_tpu_torch.nn.serialization import packb, unpackb

#: Session lifecycle states.  ``OPEN``/``DRAINING`` sessions are dispatched
#: by the scheduler tick; ``PARKED`` (connection lost, awaiting reattach
#: within the park TTL) and ``QUARANTINED`` (repeated transport-failed
#: dispatches, cooling off) sessions keep their carry + queue but are
#: skipped by the tick loop; ``CLOSED``/``EVICTED`` are terminal.
OPEN, DRAINING, CLOSED, EVICTED = "open", "draining", "closed", "evicted"
PARKED, QUARANTINED = "parked", "quarantined"

_STATE_VERSION = 1

#: mask-for-z policies the streaming pipeline supports (the oracle policies
#: are offline-only — enhance/streaming._stream_stats).
SERVE_POLICIES = ("local", "distant", "none")

#: Where a session's masks come from.  ``"client"`` (default): every block
#: frame carries ``mask_z``/``mask_w``.  ``"model"``: blocks arrive
#: maskless and the scheduler fills both masks from the session's weight
#: generation; that needs a promotion store, which the port does not have
#: yet, so the port's scheduler refuses such sessions at admission.
MASK_SOURCES = ("client", "model")

#: Wire domain of a session's blocks.  ``"stft"`` (default): blocks are
#: (K, C, F, T) complex STFT frames, outputs (K, F, T) complex — the client
#: owns the transforms.  ``"time"`` (the chained lane): each block is one
#: (K, C, samples) float window, dispatched whole through
#: :func:`disco_tpu_torch.enhance.fused.streaming_clip_fused` (window STFT,
#: masks, the two-step streaming pipeline and ISTFT), and the delivered
#: output is the (K, samples) enhanced float window.  Masks still ride the
#: wire in the STFT grid (K, F, T_frames).
DOMAINS = ("stft", "time")


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Static per-session configuration (the JAX package's fields and
    validation).  ``block_frames`` is fixed per session: every block but
    the last carries exactly that many STFT frames.
    """

    n_nodes: int
    mics_per_node: int
    n_freq: int
    block_frames: int
    update_every: int = 4
    lambda_cor: float = 0.99
    mu: float = 1.0
    ref_mic: int = 0
    policy: str = "local"
    solver: str = "eigh"
    masks: str = "client"
    domain: str = "stft"

    def __post_init__(self):
        # coerce wire-decoded numbers: a msgpack/JSON integer mu=1 is the
        # float 1.0, and configs compare equal across the wire
        for f in ("lambda_cor", "mu"):
            v = getattr(self, f)
            if not isinstance(v, float):
                try:
                    object.__setattr__(self, f, float(v))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"session config {f!r}: expected a float, got {v!r}"
                    ) from None
        for f in ("n_nodes", "mics_per_node", "n_freq", "block_frames", "update_every"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"session config {f!r}: expected a positive int, got {v!r}")
        if self.n_nodes < 2:
            raise ValueError(
                f"session config n_nodes: the distributed exchange needs >= 2 "
                f"nodes, got {self.n_nodes}"
            )
        if self.block_frames % self.update_every:
            raise ValueError(
                f"session config block_frames ({self.block_frames}) must be a "
                f"multiple of update_every ({self.update_every}): chunk-exact "
                f"streaming continuation needs refresh-aligned block boundaries"
            )
        if not 0 <= self.ref_mic < self.mics_per_node:
            raise ValueError(
                f"session config ref_mic {self.ref_mic} outside [0, "
                f"{self.mics_per_node})"
            )
        if self.policy not in SERVE_POLICIES:
            raise ValueError(
                f"session config policy {self.policy!r} not servable; one of "
                f"{SERVE_POLICIES} (oracle policies are offline-only)"
            )
        if self.masks not in MASK_SOURCES:
            raise ValueError(
                f"session config masks {self.masks!r} unknown; one of "
                f"{MASK_SOURCES}"
            )
        if self.domain not in DOMAINS:
            raise ValueError(
                f"session config domain {self.domain!r} unknown; one of "
                f"{DOMAINS}"
            )
        if self.domain == "time":
            # the chained lane's window STFT derives its hop from the
            # config's frequency grid (hop = n_fft/2 = n_freq - 1); the
            # model-mask lane estimates masks from STFT-domain wire blocks,
            # which a time session never sends
            if self.n_freq < 2:
                raise ValueError(
                    "session config domain='time' needs n_freq >= 2 "
                    "(hop is derived as n_freq - 1)"
                )
            if self.masks != "client":
                raise ValueError(
                    "session config domain='time' supports masks='client' "
                    "only: the model-mask lane fills masks from STFT wire "
                    "blocks, which a time-domain session never sends"
                )
        if not 0.0 < float(self.lambda_cor) < 1.0:
            raise ValueError(
                f"session config lambda_cor must be in (0, 1), got {self.lambda_cor!r}"
            )
        # the shared solver grammar (the validator rank1_gevd dispatches
        # by), so a bad wire-decoded spec fails at admission with a clean
        # error instead of at first dispatch inside the tick loop
        from disco_tpu_torch.solver_spec import parse_solver_spec

        try:
            parse_solver_spec(self.solver)
        except ValueError as e:
            raise ValueError(f"session config solver: {e}") from None

    @property
    def hop(self):
        """STFT hop of the chained (time-domain) lane's window transform —
        derived from the config's frequency grid (n_fft/2 = n_freq - 1)."""
        return self.n_freq - 1

    @property
    def block_samples(self):
        """Samples per full time-domain window: the window whose STFT has
        exactly ``block_frames`` frames (T = 1 + samples // hop)."""
        return (self.block_frames - 1) * self.hop

    def frames_of(self, samples: int) -> int:
        """STFT frame count of a ``samples``-long time window."""
        return 1 + samples // self.hop

    @property
    def block_shape(self):
        """Shape of one input block: (K, C, F, T) mixture STFT frames for
        ``domain='stft'``, (K, C, samples) float window for ``'time'``."""
        if self.domain == "time":
            return (self.n_nodes, self.mics_per_node, self.block_samples)
        return (self.n_nodes, self.mics_per_node, self.n_freq, self.block_frames)

    @property
    def mask_shape(self):
        return (self.n_nodes, self.n_freq, self.block_frames)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SessionConfig":
        if not isinstance(d, dict):
            raise ValueError(f"session config: expected a mapping, got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"session config: unknown field(s) {unknown}")
        return cls(**d)


class Session:
    """One live stream: config + streaming carry + queues + accounting.

    The scheduler owns ``state`` (tensors on the device between ticks,
    numpy arrays right after open or resume) and the input queue; the
    server's connection handler owns the output delivery.  All queue
    operations are lock-protected — blocks arrive on the asyncio I/O
    thread while the dispatch thread drains them.
    """

    def __init__(self, session_id: str, config: SessionConfig, *,
                 z_avail=None, state=None, blocks_done: int = 0,
                 priority: bool = False, replay_blocks: int = 64):
        self.id = session_id
        self.config = config
        #: (K,) or (K, B_plan) float availability of the exchanged streams —
        #: the per-session fault plan (``disco_tpu_torch.fault``); None = fault-free.
        self.z_avail = None if z_avail is None else np.asarray(z_avail, np.float32)
        #: streaming_tango continuation carry (tensors between ticks; numpy
        #: arrays right after open/resume).
        self.state = state
        self.status = OPEN
        self.blocks_done = int(blocks_done)   # blocks fully enhanced + delivered to the writer
        self.blocks_in = int(blocks_done)     # highest contiguous seq accepted + 1
        #: blocks dispatched on device but not yet read back (the scheduler's
        #: double-buffered super-tick overlap) — dispatch-thread-only, so no
        #: lock; a session only finishes once queue AND inflight are empty
        self.inflight = 0
        self.close_requested = False
        self._lock = threading.Lock()
        self._pending: list = []              # [(seq, Y, mask_z, mask_w)] FIFO
        self.error: str | None = None
        #: wall-clock enqueue time per pending seq (latency accounting)
        self.enqueued_at: dict[int, float] = {}
        #: causal-trace context per in-flight seq (obs.trace SpanCtx) —
        #: populated only for traced blocks while tracing is enabled;
        #: empty (and untouched) for pre-span clients, so back-compat is
        #: structural.  Guarded by the queue lock: the I/O thread stores at
        #: enqueue while the dispatch thread advances per hop.
        self.trace_ctx: dict[int, object] = {}
        #: newest delivered (seq, yf) host blocks, bounded — the reattach
        #: replay buffer: outputs delivered while the connection was down
        #: are re-sent from here so a parked-and-reattached stream stitches
        #: bit-exact with zero lost frames (scheduler-side, so it survives
        #: the connection that died)
        self.replay: "deque[tuple[int, np.ndarray]]" = deque(maxlen=max(1, replay_blocks))
        #: ladder shedding spares priority sessions (wire ``open`` field)
        self.priority = bool(priority)
        #: admission sequence number (shedding targets the NEWEST
        #: non-priority session — earlier streams keep their progress)
        self.open_seq = 0
        #: monotonic park timestamp while PARKED (TTL accounting), else None
        self.parked_at: float | None = None
        #: lifetime count of transport-exhausted quarantines — the
        #: scheduler's ``max_quarantines``-th offense evicts
        self.quarantine_count = 0
        #: scheduler tick number at which a QUARANTINED session re-opens
        self.quarantine_until_tick = 0
        #: tick of this session's last outage transition (park, reattach,
        #: quarantine, release).  Queue-wait samples observed within the
        #: scheduler's grace window after it are EXCLUDED from the
        #: degradation ladder's p95: a block that waited out a park or a
        #: retry storm measures the outage, not the load, and feeding it to
        #: the ladder would shed the very session that just survived
        #: (outage → hot p95 → shed → park → outage: a feedback loop).
        #: The serve_queue_wait_ms histogram still sees every sample —
        #: latency accounting stays honest, only the controller is gated.
        self.outage_tick = -(1 << 30)

    # -- input side (I/O thread) --------------------------------------------
    def push_block(self, seq: int, Y, mask_z, mask_w, t_wall: float,
                   trace_ctx=None) -> None:
        with self._lock:
            self._pending.append((int(seq), Y, mask_z, mask_w))
            self.enqueued_at[int(seq)] = t_wall
            self.blocks_in = max(self.blocks_in, int(seq) + 1)
            if trace_ctx is not None:
                self.trace_ctx[int(seq)] = trace_ctx

    def set_trace(self, seq: int, ctx) -> None:
        """Advance one in-flight block's causal-trace head (dispatch
        thread; see :attr:`trace_ctx`)."""
        with self._lock:
            self.trace_ctx[int(seq)] = ctx

    def get_trace(self, seq: int):
        """The block's current trace context, or None (untraced)."""
        with self._lock:
            return self.trace_ctx.get(int(seq))

    def pop_trace(self, seq: int):
        """Take (and drop) the block's trace context at delivery."""
        with self._lock:
            return self.trace_ctx.pop(int(seq), None)

    def drain_traces(self) -> list:
        """Clear every stored trace context, returning the seqs — the
        terminal-state cleanup (evict/close/park-expiry) that keeps the
        tracer's in-flight table from accumulating ghost entries for
        blocks that will never deliver."""
        with self._lock:
            seqs = list(self.trace_ctx)
            self.trace_ctx.clear()
        return seqs

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- dispatch side (scheduler thread) -----------------------------------
    def pop_blocks(self, max_n: int) -> list:
        """Take up to ``max_n`` queued blocks, in arrival order."""
        with self._lock:
            take, self._pending = self._pending[:max_n], self._pending[max_n:]
            return take

    def requeue_front(self, blocks: list) -> None:
        """Return popped-but-undispatched blocks to the FRONT of the queue,
        order preserved — a transport-exhausted dispatch must not lose or
        reorder the stream (the carry never advanced for these blocks, so a
        later retry is bit-identical).  Enqueue times stay in
        ``enqueued_at``: the eventual latency observation charges the whole
        outage, honestly."""
        if not blocks:
            return
        with self._lock:
            self._pending = list(blocks) + self._pending

    def record_delivery(self, seq: int, yf) -> None:
        """Remember one delivered output block in the bounded replay buffer
        — the source of truth the server's posting cursor drains, and what
        a reattaching client's missed frames are re-sent from (see
        :attr:`replay`).  Locked: the dispatch thread appends while the I/O
        thread may be validating a reattach."""
        with self._lock:
            self.replay.append((int(seq), yf))

    def replay_from(self, have: int) -> list:
        """Buffered deliveries with ``seq >= have``, in order — the frames
        a client's posting cursor at ``have`` has not seen.  Raises
        :class:`SessionStateError` when the buffer no longer reaches back
        to ``have`` (delivered frames would be lost; the reattach must be
        refused, not stitched with a hole).  Locked against concurrent
        :meth:`record_delivery`; the consistency check uses the buffer's
        own newest seq, so a ``blocks_done`` racing ahead can never fail a
        valid reattach."""
        with self._lock:
            entries = list(self.replay)
        missing = [(s, yf) for (s, yf) in entries if s >= have]
        newest = entries[-1][0] if entries else self.blocks_done - 1
        expect = list(range(have, newest + 1))
        if [s for (s, _) in missing] != expect:
            raise SessionStateError(
                f"session {self.id}: replay buffer no longer covers blocks "
                f"[{have}, {newest + 1}) — the client was gone longer "
                f"than replay_blocks deliveries; cannot reattach without "
                f"losing frames"
            )
        return missing

    def block_z_avail(self, seq: int, n_blocks: int):
        """Availability columns for input block ``seq`` (``n_blocks``
        refresh blocks wide): slice of the per-session plan, all-ones when
        fault-free or past the plan horizon (plan columns are per
        ``update_every`` refresh block)."""
        K = self.config.n_nodes
        if self.z_avail is None:
            return np.ones((K, n_blocks), np.float32)
        if self.z_avail.ndim == 1:
            return np.broadcast_to(self.z_avail[:, None], (K, n_blocks)).copy()
        per_block = self.config.block_frames // self.config.update_every
        b0 = seq * per_block
        cols = np.ones((K, n_blocks), np.float32)
        hi = min(self.z_avail.shape[1], b0 + n_blocks)
        if b0 < hi:
            cols[:, : hi - b0] = self.z_avail[:, b0:hi]
        return cols


# -- checkpointing -----------------------------------------------------------
def _pack_tree(tree):
    """Nested dict/tuple/list pytree of numpy arrays -> msgpack-ready
    structure (arrays via the wire codec — complex-safe, self-describing)."""
    from disco_tpu_torch.serve.protocol import encode_array

    if isinstance(tree, dict):
        return {"__map__": {k: _pack_tree(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_pack_tree(v) for v in tree]}
    return encode_array(np.asarray(tree))


def _unpack_tree(obj):
    from disco_tpu_torch.serve.protocol import decode_array

    if isinstance(obj, dict) and "__map__" in obj:
        return {k: _unpack_tree(v) for k, v in obj["__map__"].items()}
    if isinstance(obj, dict) and "__seq__" in obj:
        return tuple(_unpack_tree(v) for v in obj["__seq__"])
    return decode_array(obj)


class SessionStateError(ValueError):
    """A session checkpoint failed its integrity probe or config check."""


def save_session_state(path, session: Session, state_host=None) -> Path:
    """Checkpoint one live session's continuation carry atomically.

    The carry (``session.state``) is fetched to the host in one batched
    readback if it still lives on the device, packed as msgpack with a
    sha256 digest of the state payload embedded, and placed with the
    tmp+fsync+``os.replace`` protocol of :mod:`disco_tpu_torch.io.atomic`:
    an interrupted server never leaves a truncated checkpoint at the final
    path (the ``mid_write`` chaos seam fires inside).  The file is the JAX
    package's: either package resumes the other's checkpoints.

    ``state_host``: pass an already-fetched host pytree to skip the device
    readback (the drain path fetches all sessions' states in one
    ``device.to_host``).
    """
    from disco_tpu_torch.io.atomic import atomic_write

    if state_host is None:
        state_host = fetch_state_host(session.state)
    state_bytes = packb(_pack_tree(state_host))
    payload = packb(
        {
            "version": _STATE_VERSION,
            "session": session.id,
            "config": session.config.to_dict(),
            "blocks_done": session.blocks_done,
            "z_avail": None if session.z_avail is None
            else _pack_tree(session.z_avail),
            "state": state_bytes,
            "state_sha256": hashlib.sha256(state_bytes).hexdigest(),
        },
    )
    path = Path(path)
    with atomic_write(path) as fh:
        fh.write(payload)
    return path


def probe_session_state(path) -> bool:
    """True iff ``path`` holds a complete, digest-consistent checkpoint —
    the validate-before-trust probe of the resume path (a checkpoint
    truncated behind the atomic writer's back must read as not-done)."""
    try:
        load_session_state(path)
        return True
    except Exception:
        return False


def load_session_state(path) -> Session:
    """Load a checkpoint into a fresh :class:`Session` (numpy state; the
    scheduler moves it to its device at the session's first dispatch).  Raises
    :class:`SessionStateError` on truncation, digest mismatch, or a config
    that no longer validates."""
    try:
        raw = Path(path).read_bytes()
        d = unpackb(raw)
    except Exception as e:
        raise SessionStateError(f"{path}: not a readable session checkpoint: {e}") from None
    if not isinstance(d, dict) or d.get("version") != _STATE_VERSION:
        raise SessionStateError(
            f"{path}: unknown checkpoint version {d.get('version') if isinstance(d, dict) else d!r}"
        )
    state_bytes = d.get("state")
    digest = d.get("state_sha256")
    if not isinstance(state_bytes, bytes) or not digest:
        raise SessionStateError(f"{path}: checkpoint missing state payload/digest")
    if hashlib.sha256(state_bytes).hexdigest() != digest:
        raise SessionStateError(
            f"{path}: state digest mismatch — checkpoint corrupt, refusing to resume"
        )
    try:
        state = _unpack_tree(unpackb(state_bytes))
        config = SessionConfig.from_dict(d["config"])
    except (KeyError, ValueError) as e:
        raise SessionStateError(f"{path}: bad checkpoint contents: {e}") from None
    z_avail = d.get("z_avail")
    return Session(
        str(d.get("session")), config,
        z_avail=None if z_avail is None else _unpack_tree(z_avail),
        state=state, blocks_done=int(d.get("blocks_done", 0)),
    )


def fetch_state_host(state):
    """Device carry -> numpy pytree in ONE batched readback
    (``device.to_host``); a pytree of numpy arrays passes through untouched.

    Float32 and complex64 leaves cross as they are; bool leaves (the hold
    carries' seen flags) cross as float32 0/1 and come back as bool; leaves
    of any other dtype are copied one by one."""
    leaves = list(_iter_leaves(state))
    if all(isinstance(x, np.ndarray) for x in leaves):
        return state
    import torch

    from disco_tpu_torch.device import to_host

    batched = [x for x in leaves if isinstance(x, torch.Tensor)
               and x.dtype in (torch.float32, torch.complex64, torch.bool)]
    host = to_host([x.float() if x.dtype == torch.bool else x for x in batched]) if batched else []
    by_id = {id(x): (h.astype(bool) if x.dtype == torch.bool else h)
             for x, h in zip(batched, host)}

    def leaf(x):
        if id(x) in by_id:
            return by_id[id(x)]
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return _map_tree(state, leaf)


def _map_tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _map_tree(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_map_tree(v, leaf) for v in tree)
    return leaf(tree)


def _iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree
