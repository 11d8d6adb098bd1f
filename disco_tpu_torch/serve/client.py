"""NumPy streaming client for the online enhancement service (the port's
copy of ``disco_tpu/serve/client.py``).

This module (with :mod:`disco_tpu_torch.serve.protocol`) is the whole
client-side surface: numpy and stdlib, and no CUDA call — a client never
touches the card the server runs on.  It speaks the JAX package's wire,
so it is served by either package's server.  A client holds one session
per connection; open several clients for several streams.

>>> client = ServeClient(("127.0.0.1", 7433))
>>> client.open(SessionConfig(n_nodes=4, mics_per_node=2, n_freq=257,
...                           block_frames=8))
>>> yf = client.enhance_clip(Y, mask_z, mask_w)   # (K, F, T) enhanced STFT
>>> client.close()

Frames from the server are demultiplexed by a reader thread, so a client
may stream blocks ahead of reading outputs (the server's admission control
bounds how far: a ``backpressure`` error frame means wait and resend).

Survival (the client half of the serving survival layer): the initial
connect retries connection-refused with bounded **seeded-jitter backoff**
(a server restart window is not an outage; the jitter desynchronizes K
clients reconnecting at once, deterministically per seed), and a session
interrupted by a dropped connection / a ``parked`` error frame
**reconnects and reattaches transparently**: the client re-opens with its
resume token and its next-needed output seq (``have``), the server replays
the deliveries it missed from the bounded replay buffer and names the next
input seq it expects, and the resend machinery (the same ``resend_from``
rollback that serves backpressure) re-sends anything the dead socket ate —
the stitched stream is bit-exact, no frame lost or duplicated.  The retry
loops here are stdlib-inline: the client does not import the server's
resilience module, which imports torch to name its transport errors.
"""
from __future__ import annotations

import queue as queue_mod
import random
import socket
import threading
import time

import numpy as np

from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.serve import protocol
from disco_tpu_torch.serve.session import SessionConfig


class ServeError(RuntimeError):
    """An ``error`` frame from the server (code + message), or a dead
    connection."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class ServeClient:
    """One streaming session over one socket connection.

    Args:
      address: ``(host, port)`` tuple or unix-socket path.
      timeout_s: per-frame receive timeout.
      connect_retries: extra connect attempts on ``OSError`` (connection
        refused during a server restart window), with seeded-jitter
        exponential backoff.  0 restores fail-on-first-error.
      reattach_retries: automatic reconnect-and-reattach budget for a
        session interrupted mid-stream (dropped connection, ``parked``
        frame).  0 disables transparent reattach.
      retry_seed: drives every backoff jitter draw (deterministic
        schedules; give concurrent clients distinct seeds to spread their
        reconnect storm).
      trace: causal-tracing opt-in — True mints a trace/span header
        (``obs.trace``, stdlib-only) per submitted block and
        rides it in the ``block`` frame so the server can thread the
        block's end-to-end span chain; False never sends one (the
        pre-span wire shape); None (default) follows the process-global
        tracer (``obs.trace.enabled()``), so enabling tracing in-process
        traces loopback clients with zero per-call-site wiring.
    """

    def __init__(self, address, timeout_s: float = 120.0, *,
                 connect_retries: int = 3,
                 connect_base_delay_s: float = 0.05,
                 reattach_retries: int = 3,
                 reattach_timeout_s: float = 15.0,
                 retry_seed: int = 0,
                 trace: bool | None = None):
        self.timeout_s = timeout_s
        self.address = address
        self.connect_retries = int(connect_retries)
        self.connect_base_delay_s = float(connect_base_delay_s)
        self.reattach_timeout_s = float(reattach_timeout_s)
        self._trace = trace
        self._reattach_left = int(reattach_retries)
        self._rng = random.Random(retry_seed)
        self.session_id: str | None = None
        self.config: SessionConfig | None = None
        self.blocks_done = 0          # server-acknowledged start block on open
        self.next_seq = 0
        self.draining = False
        self.resend_from: int | None = None   # lowest seq the server rejected
        self.closed_info: dict | None = None
        self.reattaches = 0           # completed transparent reattaches
        #: {output seq: weight generation id} for generation-tagged
        #: ``enhanced`` frames (sessions served with masks="model"); empty
        #: for classic client-mask sessions — the wire carries no tag there
        self.gen_of: dict[int, str] = {}
        self._next_expected = 0       # lowest output seq not yet received
        self._frames: "queue_mod.Queue" = queue_mod.Queue()
        self._enhanced: dict[int, np.ndarray] = {}
        self._reader: threading.Thread | None = None
        self._sock: socket.socket | None = None
        self._connect()

    # -- connection plumbing -------------------------------------------------
    def _connect(self) -> None:
        """Dial the server and start a reader thread for the new socket.

        Bounded seeded-backoff retry on ``OSError``: a client must survive
        the window where the server is restarting (connection refused), and
        K clients retrying in lockstep would all reconnect in the same
        instant — each delay is ``min(base * 2^i, 1s)`` shrunk by up to 50%
        from this client's seeded jitter stream.  (Inline stdlib retry:
        module docstring.)"""
        address = self.address
        family = (socket.AF_UNIX if isinstance(address, (str, bytes))
                  else socket.AF_INET)
        target = address if isinstance(address, (str, bytes)) else tuple(address)
        attempt = 0
        while True:
            sock = socket.socket(family, socket.SOCK_STREAM)
            try:
                sock.connect(target)
                break
            except OSError:
                sock.close()
                if attempt >= self.connect_retries:
                    raise
                delay = min(self.connect_base_delay_s * 2 ** attempt, 1.0)
                time.sleep(delay * (1.0 - 0.5 * self._rng.random()))
                attempt += 1
        self._sock = sock
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,), daemon=True)
        self._reader.start()

    # -- frame plumbing ------------------------------------------------------
    def _read_loop(self, sock):
        try:
            while True:
                frame = protocol.recv_frame(sock)
                if frame is None:
                    self._frames.put(None)
                    return
                self._frames.put(frame)
        except (OSError, protocol.ProtocolError) as e:
            self._frames.put(e)

    def _next_frame(self, timeout_s=None):
        try:
            item = self._frames.get(timeout=timeout_s or self.timeout_s)
        except queue_mod.Empty:
            raise ServeError("timeout", "no frame from server within timeout") from None
        if item is None:
            raise ServeError("eof", "server closed the connection")
        if isinstance(item, BaseException):
            raise ServeError("io", str(item))
        return item

    def _fold(self, frame: dict) -> None:
        """Fold one session-level frame into client state (raises for
        non-recoverable ``error`` frames)."""
        kind = frame.get("type")
        if kind == "enhanced":
            seq = int(frame["seq"])
            self._enhanced[seq] = frame["yf"]
            if frame.get("gen") is not None:
                self.gen_of[seq] = frame["gen"]
            self._next_expected = max(self._next_expected, seq + 1)
        elif kind == "draining":
            self.draining = True
        elif kind == "closed":
            self.closed_info = frame
        elif kind == "error":
            seq = frame.get("seq")
            if frame.get("code") == "backpressure" and seq is not None:
                # the server's queue bound rejected this block — recoverable:
                # remember the resend point and roll the auto-seq back so the
                # stream resumes from the rejection (docstring contract above)
                seq = int(seq)
                if self.resend_from is None or seq < self.resend_from:
                    self.resend_from = seq
                self.next_seq = min(self.next_seq, seq)
            else:
                raise ServeError(frame.get("code", "?"), frame.get("message", ""))

    def _pump(self, timeout_s=None) -> dict:
        """Read one frame, folding session-level notices into client state;
        returns the frame (callers match on ``type``).  A dropped
        connection or a ``parked`` frame triggers transparent
        reconnect-and-reattach (bounded by ``reattach_retries``)."""
        while True:
            try:
                frame = self._next_frame(timeout_s)
            except ServeError as e:
                if e.code in ("eof", "io") and self._can_reattach():
                    self._reattach(f"connection lost ({e.code})")
                    if self.closed_info is not None:
                        return self.closed_info   # finished during the drop
                    if self.resend_from is not None:
                        return {"type": "reattached",
                                "resend_from": self.resend_from}
                    continue
                raise
            if (frame.get("type") == "error"
                    and frame.get("code") == "parked"
                    and self._can_reattach()):
                self._reattach(
                    "server parked the session",
                    retry_after_s=float(frame.get("retry_after_s", 0.0)))
                if self.closed_info is not None:
                    return self.closed_info
                if self.resend_from is not None:
                    # the drop ate input blocks the server never queued:
                    # blocking for another frame would deadlock (the server
                    # is idle, waiting for the resend) — hand control back
                    # so the wait loops re-check the resend cursor
                    # (``recv_enhanced`` raises its documented
                    # ``backpressure``; ``enhance_clip`` rolls ``next_send``
                    # back and resends)
                    return {"type": "reattached",
                            "resend_from": self.resend_from}
                continue
            self._fold(frame)
            return frame

    # -- transparent reattach ------------------------------------------------
    def _can_reattach(self) -> bool:
        return (self._reattach_left > 0 and self.session_id is not None
                and self.config is not None and self.closed_info is None)

    def _reattach(self, reason: str, retry_after_s: float = 0.0) -> None:
        """Reconnect and reattach the interrupted session (docstring at
        module level describes the protocol).  Raises :class:`ServeError`
        (``reattach_failed`` or the server's rejection code) when the
        session cannot be stitched."""
        self._reattach_left -= 1
        sock, reader = self._sock, self._reader
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if reader is not None:
            reader.join(timeout=5.0)
        # the dead reader's leftovers: fold real frames (deliveries that
        # raced the drop), discard its EOF/error sentinel
        while True:
            try:
                item = self._frames.get_nowait()
            except queue_mod.Empty:
                break
            if item is None or isinstance(item, BaseException):
                continue
            if item.get("type") == "error" and item.get("code") == "parked":
                # a shed notice that reached us behind a failed send: its
                # back-off hint holds all the same (reattaching at once
                # would land on the rung that shed us, and be shed again)
                retry_after_s = max(retry_after_s,
                                    float(item.get("retry_after_s", 0.0)))
            else:
                self._fold(item)
        if self.closed_info is not None:
            # the dead reader's leftovers included the 'closed' frame: the
            # session actually finished — there is nothing to reattach
            return
        if retry_after_s > 0:
            time.sleep(retry_after_s)
        try:
            self._connect()
        except OSError as e:
            raise ServeError(
                "reattach_failed",
                f"could not reconnect after {reason}: {e}") from None
        protocol.send_frame(self._sock, {
            "type": "open", "config": self.config.to_dict(),
            "resume": self.session_id, "have": self._next_expected,
        })
        reply = self._next_frame(timeout_s=self.reattach_timeout_s)
        if reply.get("type") == "error":
            raise ServeError(reply.get("code", "reattach_failed"),
                             reply.get("message", ""))
        if reply.get("type") != "open_ok":
            raise ServeError("reattach_failed",
                             f"expected open_ok, got {reply.get('type')!r}")
        self.blocks_done = int(reply.get("blocks_done", 0))
        server_next = int(reply.get("next_seq", self.blocks_done))
        if server_next < self.next_seq:
            # the dead socket ate input blocks [server_next, next_seq):
            # roll the resend cursor back — send_block / enhance_clip
            # re-send from there exactly like after a backpressure reject
            if self.resend_from is None or server_next < self.resend_from:
                self.resend_from = server_next
            self.next_seq = server_next
        self.reattaches += 1

    # -- session lifecycle ---------------------------------------------------
    def open(self, config: SessionConfig | dict, *, session_id: str | None = None,
             z_mask=None, resume: str | None = None) -> str:
        """Open (or resume) the session; returns the server session id."""
        cfg = config if isinstance(config, SessionConfig) else SessionConfig.from_dict(config)
        frame = {"type": "open", "config": cfg.to_dict()}
        if session_id is not None:
            frame["session"] = session_id
        if z_mask is not None:
            frame["z_mask"] = np.asarray(z_mask, np.float32)
        if resume is not None:
            frame["resume"] = resume
        protocol.send_frame(self._sock, frame)
        reply = self._pump()
        if reply.get("type") != "open_ok":
            raise ServeError("protocol", f"expected open_ok, got {reply.get('type')!r}")
        self.session_id = reply["session"]
        self.config = cfg
        self.blocks_done = int(reply.get("blocks_done", 0))
        self.next_seq = int(reply.get("next_seq", self.blocks_done))
        self._next_expected = self.blocks_done
        return self.session_id

    def _send(self, frame: dict) -> None:
        """Send one frame; a dead socket triggers reattach (bounded) and
        ONE re-send of the frame — a stale ``block`` seq after reattach is
        then corrected by the server's backpressure reply, the same
        convergence as any other resend."""
        while True:
            try:
                protocol.send_frame(self._sock, frame)
                return
            except OSError as e:
                if not self._can_reattach():
                    raise ServeError("io", f"send failed: {e}") from None
                # the peer closed: let the reader take in what it sent
                # before closing (a ``parked`` notice and its back-off hint)
                if self._reader is not None:
                    self._reader.join(timeout=1.0)
                self._reattach(f"send failed: {e}")
                if self.closed_info is not None:
                    return   # the session finished during the drop: the
                             # frame is moot, callers observe closed_info

    def send_block(self, Y, mask_z=None, mask_w=None,
                   seq: int | None = None) -> int:
        """Stream one input block; returns its seq.  ``Y`` (K, C, F, T)
        complex64, masks (K, F, T) float32; T = config.block_frames except
        for a shorter final block.  Sessions opened with
        ``SessionConfig(masks="model")`` send NO masks (the server fills
        both from its live weight generation) — pass None, the default.
        Chained sessions (``SessionConfig(domain="time")``) send float32
        (K, C, samples) time windows instead — one whole super-tick window
        per block, masks on the window's STFT grid (K, F, 1 + samples //
        (n_freq - 1)) — and receive (K, samples) enhanced float windows."""
        if self.session_id is None:
            raise ServeError("protocol", "send_block before open")
        seq = self.next_seq if seq is None else int(seq)
        if self.resend_from is not None and seq <= self.resend_from:
            self.resend_from = None      # resending from the rejection point
        wire_dtype = (np.float32
                      if self.config is not None and self.config.domain == "time"
                      else np.complex64)
        frame = {
            "type": "block", "seq": seq,
            "Y": np.ascontiguousarray(Y, dtype=wire_dtype),
            "mask_z": (None if mask_z is None
                       else np.ascontiguousarray(mask_z, dtype=np.float32)),
            "mask_w": (None if mask_w is None
                       else np.ascontiguousarray(mask_w, dtype=np.float32)),
        }
        if self._trace or (self._trace is None and obs_trace.enabled()):
            # mint the causal root at submission: the client_block span is
            # the chain's origin, and the wire header lets the server
            # thread every later hop under it (a resend of the same seq
            # after backpressure/reattach mints a fresh trace — honest:
            # it IS a new submission).  With the process-global tracer off
            # (explicit trace=True in a bare client process) the ids are
            # minted without a local span event — the server-side chain
            # then starts at its enqueue hop, by design.
            ctx = obs_trace.root("client_block", seq=seq,
                                 session=self.session_id)
            if ctx is None:
                ctx = obs_trace.SpanCtx(trace=obs_trace.new_id(),
                                        span=obs_trace.new_id())
            frame["trace"] = ctx.to_wire()
        self._send(frame)
        self.next_seq = seq + 1
        return seq

    def recv_enhanced(self, seq: int, timeout_s=None) -> np.ndarray:
        """Block until the enhanced output for ``seq`` arrives.

        Raises a ``backpressure`` :class:`ServeError` if the server rejected
        ``seq`` (or an earlier block) — the output would never arrive;
        resend from :attr:`resend_from` (``send_block`` with ``seq=None``
        already rolls back there) and call again."""
        while seq not in self._enhanced:
            if self.resend_from is not None and self.resend_from <= seq:
                raise ServeError(
                    "backpressure",
                    f"block {self.resend_from} was rejected by the server's "
                    f"queue bound; resend from seq {self.resend_from} before "
                    f"waiting on {seq}",
                )
            self._pump(timeout_s)
        return self._enhanced.pop(seq)

    def close(self, timeout_s=None) -> dict:
        """Finish the session: ask the server to flush, wait for the
        ``closed`` frame.  Returns its payload (``blocks_done``,
        ``state_path`` when the server checkpointed)."""
        if self.session_id is None:
            raise ServeError("protocol", "close before open")
        frame = {"type": "close", "session": self.session_id}
        self._send(frame)
        sent_gen = self.reattaches
        while self.closed_info is None:
            self._pump(timeout_s)
            if self.reattaches != sent_gen:
                # a reattach happened since the close frame went out: the
                # reattached (OPEN again) session never saw it — re-send,
                # or the wait below outlives the server's memory of it
                self._send(frame)
                sent_gen = self.reattaches
        return self.closed_info

    def status(self, timeout_s=None) -> dict:
        """Read-only live introspection: send one ``status`` frame, return
        the server's ``status_ok`` payload.  Works with or without an open
        session; session-level frames that arrive first are folded into
        client state as usual."""
        self._send({"type": "status"})
        while True:
            frame = self._next_frame(timeout_s)
            if frame.get("type") == "status_ok":
                return frame
            self._fold(frame)

    def wait_closed(self, timeout_s=None) -> dict:
        """Wait for a server-initiated close (a drain) without sending
        anything — collects stray enhanced frames on the way."""
        while self.closed_info is None:
            self._pump(timeout_s)
        return self.closed_info

    def shutdown(self) -> None:
        self._reattach_left = 0   # a deliberate teardown must stay torn down
        if self._sock is None:
            return
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    # -- convenience ---------------------------------------------------------
    def enhance_clip(self, Y, mask_z=None, mask_w=None, *, window: int = 4,
                     on_block=None) -> np.ndarray:
        """Stream a whole (K, C, F, T) clip through the open session and
        return the (K, F, T) enhanced STFT.

        Blocks of ``config.block_frames`` frames are kept at most
        ``window`` in flight (sending everything first would trip the
        server's queue bound on long clips); a ``backpressure`` rejection
        (a window wider than the server's ``max_queue_blocks``) rolls the
        send cursor back and the rejected blocks are resent once outputs
        drain the queue.  Starts at the session's ``blocks_done``
        (resume-aware).  ``on_block(seq, yf)`` observes each output as it
        lands.
        """
        if self.config is None:
            raise ServeError("protocol", "enhance_clip before open")
        T = Y.shape[-1]
        Tb = self.config.block_frames
        n_blocks = -(-T // Tb)
        outs: dict[int, np.ndarray] = {}
        start = self.blocks_done
        if start >= n_blocks:
            # resumed checkpoint already covers the whole clip: nothing to
            # stream, nothing to return (the earlier blocks were delivered
            # to the pre-resume client)
            return np.zeros(
                (self.config.n_nodes, self.config.n_freq, 0), np.complex64
            )
        next_send = start
        next_recv = start
        while next_recv < n_blocks:
            if self.resend_from is not None and self.resend_from < next_send:
                next_send = self.resend_from
            while next_send < n_blocks and next_send - next_recv < window:
                lo, hi = next_send * Tb, min((next_send + 1) * Tb, T)
                self.send_block(
                    Y[..., lo:hi],
                    None if mask_z is None else mask_z[..., lo:hi],
                    None if mask_w is None else mask_w[..., lo:hi],
                    seq=next_send)
                next_send += 1
            if next_recv in self._enhanced:
                yf = self._enhanced.pop(next_recv)
                outs[next_recv] = yf
                if on_block is not None:
                    on_block(next_recv, yf)
                next_recv += 1
                continue
            self._pump()
        return np.concatenate([outs[i] for i in range(start, n_blocks)], axis=-1)
