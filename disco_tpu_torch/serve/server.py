"""The online enhancement server: asyncio I/O + one dispatch thread (the
port's copy of ``disco_tpu/serve/server.py``).

All socket I/O runs on an asyncio event loop (its own thread), which only
decodes frames into numpy arrays and hands them to the scheduler's
thread-safe session queues; ALL device work — every launch, readback and
checkpoint fetch — runs on the single dispatch thread driving
:meth:`~disco_tpu_torch.serve.scheduler.Scheduler.tick`.  Deliveries go
back through ``loop.call_soon_threadsafe`` onto per-connection writer
queues.  The wire is the JAX package's, so either package's clients are
served.

``device``: where the sessions run — ``"cuda"`` when None (the server
raises ``RuntimeError`` at construction without a CUDA device),
``"cpu"`` for the plain versions on the host.

Lifecycle:

* graceful interruption — the dispatch loop polls
  :func:`disco_tpu_torch.runs.interrupt.stop_requested` between ticks: the
  first SIGINT/SIGTERM (or :meth:`EnhanceServer.stop`) stops admitting
  sessions, notifies every client (``draining`` frame), finishes every
  queued block, checkpoints the live sessions (``state_dir``; atomic
  msgpack + digest, :func:`~disco_tpu_torch.serve.session.
  save_session_state`) and closes them with a ``closed`` frame naming
  ``blocks_done`` + the checkpoint path: no truncated or lost frames, and
  every stream resumable.
* chaos — the ``serve_tick`` seam fires at every tick; an injected
  :class:`~disco_tpu_torch.runs.chaos.ChaosCrash` unwinds the dispatch
  thread like a process death (connections drop, nothing more is written)
  and is re-raised to the embedding caller by :meth:`EnhanceServer.wait`.

One session per connection; a client wanting N concurrent streams opens N
connections (they share the one device through the scheduler).
"""
from __future__ import annotations

import asyncio
import contextlib
import itertools
import socket
import threading
import time

from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.serve import protocol
from disco_tpu_torch.serve.scheduler import (
    DEFAULT_MAX_BLOCKS_PER_TICK,
    QueueFull,
    Scheduler,
)
from disco_tpu_torch.serve.session import CLOSED, DRAINING, EVICTED, OPEN, PARKED, QUARANTINED

#: Writer-queue bound per connection: a client that stops reading while the
#: scheduler keeps producing gets evicted (with a clean ``error`` frame)
#: once this many frames are backed up — bounded host memory per client.
DEFAULT_MAX_BACKLOG = 64


class _Conn:
    """Per-connection bookkeeping shared between the I/O and dispatch
    threads (the queue crossing happens via call_soon_threadsafe)."""

    _born = itertools.count()

    def __init__(self):
        self.session = None
        self.outq: asyncio.Queue | None = None
        self.notified_draining = False
        self.closed_sent = False
        #: creation order: after a park+reattach two conns can briefly
        #: reference one session — deliveries go to the newest live one
        self.born = next(_Conn._born)
        #: the posting cursor: next output seq this connection is owed.
        #: ONLY the dispatch loop advances it, draining the session's
        #: replay buffer — one poster thread, so a reattach's replay can
        #: never race an in-flight delivery into a duplicate or a loss.
        #: None until a session is attached (the I/O thread sets it BEFORE
        #: ``session``, which is the dispatch loop's gate).
        self.next_out: int | None = None
        #: frames posted but not yet written to the socket (counted from
        #: the post, not from the queue: a frame whose put is still a
        #: pending loop callback counts too), and whether the writer died
        self.unflushed = 0
        self.writer_done = False
        self._count_lock = threading.Lock()

    def count_posted(self, n: int) -> None:
        with self._count_lock:
            self.unflushed += n

    def flushing(self) -> bool:
        """True while frames posted to this connection are not yet on its
        socket and its writer still runs."""
        with self._count_lock:
            return self.unflushed > 0 and not self.writer_done


class EnhanceServer:
    """Embeddable server: ``start()`` binds and spins the loop + dispatch
    threads, ``stop()`` drains gracefully, ``wait()`` joins (re-raising a
    dispatch-thread crash).  :meth:`serve_forever` adds the
    signal story on top."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 unix_path: str | None = None,
                 scheduler: Scheduler | None = None,
                 max_sessions: int = 16, max_queue_blocks: int = 8,
                 max_blocks_per_tick: int = DEFAULT_MAX_BLOCKS_PER_TICK,
                 blocks_per_super_tick: int = 1,
                 overlap_readback: bool | None = None,
                 allow_chained: bool = True,
                 max_backlog: int = DEFAULT_MAX_BACKLOG,
                 tick_interval_s: float = 0.002,
                 state_dir=None, fault_spec=None, tap=None,
                 park_on_disconnect: bool = True,
                 park_ttl_s: float = 60.0,
                 replay_blocks: int = 64,
                 dispatch_retries: int = 2,
                 retry_seed: int = 0,
                 tick_deadline_s: float | None = None,
                 quarantine_ticks: int = 20,
                 ladder=None,
                 sock_sndbuf: int | None = None,
                 write_buffer_high: int | None = None,
                 promote=None,
                 resident=None,
                 run_info: dict | None = None,
                 device=None):
        self.host, self.port, self.unix_path = host, port, unix_path
        if ladder is True:
            from disco_tpu_torch.serve.ladder import DegradationLadder

            ladder = DegradationLadder()
        elif not ladder:
            ladder = None   # False/None both mean: no overload controller
        self.scheduler = scheduler or Scheduler(
            max_sessions=max_sessions, max_queue_blocks=max_queue_blocks,
            max_blocks_per_tick=max_blocks_per_tick,
            blocks_per_super_tick=blocks_per_super_tick,
            overlap_readback=overlap_readback, allow_chained=allow_chained,
            fault_spec=fault_spec, tap=tap,
            park_ttl_s=park_ttl_s, replay_blocks=replay_blocks,
            dispatch_retries=dispatch_retries, retry_seed=retry_seed,
            tick_deadline_s=tick_deadline_s,
            quarantine_ticks=quarantine_ticks,
            ladder=ladder, state_dir=state_dir, promote=promote,
            resident=resident, device=device,
        )
        self.promote = (promote if promote is not None
                        else getattr(self.scheduler, "promote", None))
        self.resident = (resident if resident is not None
                         else getattr(self.scheduler, "resident", None))
        #: connection drops / mid-frame protocol truncations PARK the
        #: session (resume token, bounded TTL, bit-exact reattach) instead
        #: of evicting; False restores the old evict-on-drop behavior
        self.park_on_disconnect = park_on_disconnect
        self.max_backlog = max_backlog
        #: bandwidth shaping for tests/drills: SO_SNDBUF applied to every
        #: accepted socket, and the asyncio transport's write high-water
        #: mark.  ``max_backlog`` only meters frames the writer could not
        #: flush, so proving the slow-client eviction path needs a pipe
        #: that actually jams — with both set small, drain() blocks as
        #: soon as the peer stops reading instead of whenever the kernel's
        #: autotuned buffers happen to fill.  None (default) = untouched.
        self.sock_sndbuf = sock_sndbuf
        self.write_buffer_high = write_buffer_high
        self.tick_interval_s = tick_interval_s
        self.state_dir = state_dir
        #: extra attrs folded into the ``run_start`` event (the CLI rides
        #: its preflight result and knob settings here)
        self.run_info = dict(run_info or {})
        self.address = None            # (host, port) or unix path once bound
        self.crashed: BaseException | None = None
        self.checkpoints: dict = {}    # {session_id: state path} after a drain
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = None
        self._loop_thread: threading.Thread | None = None
        self._dispatch_thread: threading.Thread | None = None
        self._stop_event = threading.Event()      # programmatic drain trigger
        self._started = threading.Event()
        self._conns: set[_Conn] = set()
        self._conns_lock = threading.Lock()

    # -- connection handling (asyncio thread) --------------------------------
    async def _read_frame(self, reader: asyncio.StreamReader):
        try:
            head = await reader.readexactly(protocol.frame_header_size())
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        n = int.from_bytes(head, "big")
        if n > protocol.MAX_FRAME_BYTES:
            raise protocol.ProtocolError(f"frame length {n} exceeds MAX_FRAME_BYTES")
        try:
            payload = await reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            raise protocol.ProtocolError("connection closed mid-frame") from None
        return protocol.unpack_payload(payload)

    async def _writer_task(self, conn: _Conn, writer: asyncio.StreamWriter):
        try:
            while True:
                item = await conn.outq.get()
                if item is None:
                    break
                writer.write(item)
                await writer.drain()
                conn.count_posted(-1)
        except (ConnectionError, RuntimeError):
            pass
        finally:
            conn.writer_done = True

    def _post(self, conn: _Conn, frame: dict) -> None:
        """Queue one frame for a connection (any thread).  Evicts the
        session instead of growing without bound when the client is not
        draining its socket."""
        data = protocol.pack_frame(frame)
        loop, outq = self._loop, conn.outq
        if loop is None or outq is None or loop.is_closed():
            return
        if frame.get("type") == "enhanced" and conn.session is not None:
            if conn.session.status == EVICTED:
                return   # already evicted this session: drop stale deliveries
            if outq.qsize() >= self.max_backlog:
                self.scheduler.evict(conn.session, "slow client: output backlog "
                                     f"exceeded max_backlog={self.max_backlog}")
                err = protocol.pack_frame({
                    "type": "error", "code": "evicted",
                    "message": f"evicted: {conn.session.error}",
                    "session": conn.session.id,
                })
                conn.count_posted(1)
                with contextlib.suppress(RuntimeError):
                    loop.call_soon_threadsafe(outq.put_nowait, err)
                    loop.call_soon_threadsafe(outq.put_nowait, None)
                return
        conn.count_posted(1)
        with contextlib.suppress(RuntimeError):
            loop.call_soon_threadsafe(outq.put_nowait, data)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self.sock_sndbuf is not None:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sock_sndbuf)
        if self.write_buffer_high is not None:
            writer.transport.set_write_buffer_limits(
                high=self.write_buffer_high)
        conn = _Conn()
        conn.outq = asyncio.Queue()
        with self._conns_lock:
            self._conns.add(conn)
        wtask = asyncio.ensure_future(self._writer_task(conn, writer))
        try:
            while True:
                try:
                    frame = await self._read_frame(reader)
                except protocol.ProtocolError as e:
                    # a mid-frame truncation must never corrupt the stream:
                    # the partial block never reached push_block, so parking
                    # here (resume token in the error frame) lets the client
                    # reattach and RESEND it — bit-exact, nothing torn
                    if self._park(conn.session, f"protocol error: {e}"):
                        self._post(conn, self._parked_frame(
                            conn.session, f"protocol error: {e}"))
                    else:
                        self._post(conn, {"type": "error", "code": "protocol",
                                          "message": str(e)})
                    break
                if frame is None:
                    break
                if not self._on_frame(conn, frame):
                    break
                if conn.closed_sent:
                    break
        finally:
            if (conn.session is not None
                    and conn.session.status not in (CLOSED, EVICTED, PARKED)
                    and not self._park(conn.session, "connection dropped")):
                # connection died with a live session and parking is off
                # (or raced a close): free the slot the old way
                self.scheduler.evict(conn.session, "connection closed")
            with self._conns_lock:
                self._conns.discard(conn)
            # end-of-stream sentinel goes through the same call_soon path as
            # every frame, so it can never overtake a just-posted error
            self._post_end(conn)
            with contextlib.suppress(Exception):
                await asyncio.wait_for(wtask, timeout=5.0)
            with contextlib.suppress(Exception):
                writer.close()

    def _park(self, session, reason: str) -> bool:
        """Park a live session on connection trouble (I/O thread); False
        when parking is off or the session already left the registry."""
        if session is None or not self.park_on_disconnect:
            return False
        if session.status not in (OPEN, DRAINING, QUARANTINED):
            return False
        return self.scheduler.park(session, reason)

    def _parked_frame(self, session, reason: str,
                      retry_after_s: float = 0.0) -> dict:
        """The ``parked`` error frame: carries the resume token the client
        reattaches with (``open`` + ``resume``/``have``) and a back-off
        hint for shed sessions."""
        return {"type": "error", "code": "parked",
                "message": f"session parked: {reason}; reattach with the "
                           f"resume token within the park TTL",
                "session": session.id, "resume": session.id,
                "retry_after_s": float(retry_after_s)}

    def _on_frame(self, conn: _Conn, frame: dict) -> bool:
        """Handle one client frame (asyncio thread).  Returns False to end
        the connection."""
        kind = frame.get("type")
        if kind == "status":
            # read-only live introspection: allowed before (or without) an
            # open session, never touches the device — session states,
            # ladder rung, counters/gauges, latency percentiles and
            # in-flight spans, all host-side reads under their own locks
            from disco_tpu_torch.serve.status import status_payload

            self._post(conn, {"type": "status_ok",
                              **status_payload(self.scheduler)})
            return True
        if kind == "open":
            if conn.session is not None:
                self._post(conn, {"type": "error", "code": "protocol",
                                  "message": "session already open on this connection"})
                return False
            resume = frame.get("resume")
            resume_path = None
            if resume is not None:
                # a PARKED session reattaches in place: same carry, same
                # queue, missed deliveries replayed from the bounded buffer
                # — the stream stitches bit-exact with no frame lost or
                # duplicated.  Only when nothing is parked under the token
                # do we fall through to the checkpoint-resume path (which
                # also serves parked sessions of a PREVIOUS server process,
                # via the park checkpoint).
                have = frame.get("have")   # None = fresh client, plain resume
                try:
                    hit = self.scheduler.reattach(
                        resume, frame.get("config"), have)
                    if hit is None and self.park_on_disconnect:
                        # the client reconnected FASTER than the dead
                        # connection's teardown parked the session (both
                        # run on this I/O thread, so the check is
                        # race-free): park it now and reattach — the
                        # resume token is authoritative, newest
                        # connection wins
                        live = self.scheduler.get(resume)
                        if (live is not None
                                and live.status in (OPEN, DRAINING,
                                                    QUARANTINED)):
                            self.scheduler.park(
                                live, "reattach raced the disconnect")
                            hit = self.scheduler.reattach(
                                resume, frame.get("config"), have)
                except Exception as e:
                    code = getattr(e, "code", "bad_open")
                    self._post(conn, {"type": "error", "code": code,
                                      "message": str(e)})
                    return False
                if hit is not None:
                    session, resume_seq = hit
                    with self._conns_lock:
                        for c in self._conns:
                            if c is not conn and c.session is session:
                                c.session = None   # detach the dead conn
                    # cursor BEFORE session: session is the dispatch
                    # loop's gate, and the loop (not this thread) re-sends
                    # the missed frames from the replay buffer
                    conn.next_out = resume_seq
                    conn.session = session
                    self._post(conn, {
                        "type": "open_ok", "session": session.id,
                        "blocks_done": session.blocks_done,
                        "next_seq": session.blocks_in, "reattached": True,
                    })
                    if self.scheduler.draining:
                        self._notify_draining(conn)
                    return True
                if self.state_dir is None:
                    self._post(conn, {"type": "error", "code": "no_state_dir",
                                      "message": "server has no state dir; cannot resume"})
                    return False
                from pathlib import Path

                resume_path = Path(self.state_dir) / f"session_{resume}.state.msgpack"
                if not resume_path.is_file():
                    self._post(conn, {"type": "error", "code": "unknown_session",
                                      "message": f"no checkpoint for session {resume!r}"})
                    return False
            try:
                conn.session = self.scheduler.open_session(
                    frame.get("config"),
                    session_id=frame.get("session") or resume,
                    z_mask=frame.get("z_mask"),
                    resume_from=resume_path,
                    priority=bool(frame.get("priority", False)),
                )
            except Exception as e:  # AdmissionError carries .code; rest default
                code = getattr(e, "code", "bad_open")
                self._post(conn, {"type": "error", "code": code, "message": str(e)})
                return False
            conn.next_out = conn.session.blocks_done
            self._post(conn, {"type": "open_ok", "session": conn.session.id,
                              "blocks_done": conn.session.blocks_done,
                              "next_seq": conn.session.blocks_in})
            if self.scheduler.draining:
                # admitted in the race window right before draining flipped
                self._notify_draining(conn)
            return True
        if conn.session is None:
            self._post(conn, {"type": "error", "code": "protocol",
                              "message": f"{kind!r} before 'open'"})
            return False
        if kind == "block":
            try:
                self.scheduler.push_block(
                    conn.session, int(frame.get("seq", -1)),
                    frame.get("Y"), frame.get("mask_z"), frame.get("mask_w"),
                    trace=frame.get("trace"),
                )
            except QueueFull as e:
                self._post(conn, {"type": "error", "code": "backpressure",
                                  "message": str(e), "session": conn.session.id,
                                  "seq": frame.get("seq")})
            except Exception as e:
                self._post(conn, {"type": "error", "code": "bad_block",
                                  "message": f"{type(e).__name__}: {e}",
                                  "session": conn.session.id})
                return False
            return True
        if kind == "close":
            self.scheduler.request_close(conn.session)
            return True
        self._post(conn, {"type": "error", "code": "protocol",
                          "message": f"unknown frame type {kind!r}"})
        return False

    def _notify_draining(self, conn: _Conn) -> None:
        if conn.session is not None and not conn.notified_draining:
            conn.notified_draining = True
            self._post(conn, {"type": "draining", "session": conn.session.id})

    # -- dispatch loop (its own thread; the only thread that touches the device)
    def _dispatch_loop(self):
        from disco_tpu_torch.runs.interrupt import stop_requested

        try:
            while True:
                stopping = self._stop_event.is_set() or stop_requested()
                if stopping and not self.scheduler.draining:
                    obs_events.record("interrupted", stage="serve",
                                      reason="drain requested")
                    self.scheduler.start_drain()
                    with self._conns_lock:
                        conns = list(self._conns)
                    for conn in conns:
                        self._notify_draining(conn)
                deliveries = self.scheduler.tick()
                self._post_enhanced()
                for session, reason, retry_after in \
                        self.scheduler.drain_park_notices():
                    # shed-to-park happened on the dispatch thread with the
                    # connection still up: name it to the client (resume
                    # token + back-off hint), then end the stream
                    conn = self._conn_of(session)
                    if conn is None:
                        continue
                    conn.closed_sent = True
                    self._post(conn, self._parked_frame(
                        session, reason, retry_after_s=retry_after))
                    self._post_end(conn)
                self._flush_finished()
                if self.scheduler.draining and self.scheduler.pending_blocks() == 0:
                    self._drain_finish()
                    return
                if not deliveries:
                    time.sleep(self.tick_interval_s)
        except BaseException as e:  # ChaosCrash included: simulated death
            # wait() reads the stash only after join() proves this thread
            # dead: the join is the happens-before edge
            self.crashed = e  # disco-torch-race: disable=DR007 -- wait() reads the stash only after join() proves this thread dead (and clears it on the caller thread); the join is the happens-before edge a lock would duplicate
            self._shutdown_loop()

    def _post_enhanced(self) -> None:
        """Post every connection's owed ``enhanced`` frames (dispatch
        thread — the ONE poster).  Frames are drained from the session's
        replay buffer through the per-conn cursor, so a delivery landing
        mid-reattach is posted exactly once: either the cursor was set
        before it landed (the loop picks it up next pass) or after (the
        cursor starts past it) — never both, never neither."""
        from disco_tpu_torch.serve.session import SessionStateError

        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            s, nxt = conn.session, conn.next_out
            if s is None or nxt is None or conn.closed_sent:
                continue
            if s.blocks_done <= nxt:
                continue
            try:
                entries = s.replay_from(nxt)
            except SessionStateError as e:
                # the cursor fell behind the bounded buffer — impossible
                # while this loop keeps up (it drains every pass), kept as
                # a refuse-to-corrupt guard rather than a silent hole
                self.scheduler.evict(s, f"replay cursor gap: {e}")
                continue
            for seq, yf in entries:
                if conn.session is not s or s.status == EVICTED:
                    break   # evicted mid-drain (slow client) / detached
                frame = {"type": "enhanced", "session": s.id,
                         "seq": int(seq), "yf": yf}
                if s.generation is not None:
                    # the weight generation that enhanced this block: only
                    # model sessions carry the key, so the wire of a
                    # promote-less server is unchanged
                    frame["gen"] = s.gen_for(seq)
                self._post(conn, frame)
                conn.next_out = seq + 1

    def _conn_of(self, session) -> _Conn | None:
        with self._conns_lock:
            best = None
            for conn in self._conns:
                if conn.session is session and not conn.closed_sent:
                    # after a reattach two conns can briefly share a session
                    # (the dead one not torn down yet): newest wins
                    if best is None or conn.born > best.born:
                        best = conn
            return best

    def _flush_finished(self) -> None:
        """Send ``closed`` frames for sessions the scheduler finished (close
        requested + queue drained) this tick."""
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            s = conn.session
            if s is None or conn.closed_sent:
                continue
            if s.status == CLOSED:
                conn.closed_sent = True
                self._post(conn, {"type": "closed", "session": s.id,
                                  "blocks_done": s.blocks_done})
                self._post_end(conn)
            elif s.status == EVICTED and s.error != "connection closed":
                conn.closed_sent = True
                # name the eviction before the stream ends (the slow-client
                # path already posted one; its writer is gone by now, so a
                # duplicate never reaches the socket)
                self._post(conn, {"type": "error", "code": "evicted",
                                  "message": f"evicted: {s.error}",
                                  "session": s.id})
                self._post_end(conn)

    def _post_end(self, conn: _Conn) -> None:
        loop, outq = self._loop, conn.outq
        if loop is not None and outq is not None and not loop.is_closed():
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(outq.put_nowait, None)

    def _drain_finish(self) -> None:
        """All queues empty under drain: checkpoint live sessions, close
        every stream with its resume coordinates, stop the loop."""
        if self.state_dir is not None:
            self.checkpoints = self.scheduler.checkpoint_sessions(self.state_dir)
        else:
            self.checkpoints = {}
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            s = conn.session
            if s is None or conn.closed_sent:
                continue
            conn.closed_sent = True
            # drained == closed: everything was delivered and checkpointed,
            # so the connection teardown must not read this as a live
            # session and record a spurious evict
            s.status = CLOSED
            self._post(conn, {
                "type": "closed", "session": s.id, "blocks_done": s.blocks_done,
                "resumable": s.id in self.checkpoints,
                "state_path": self.checkpoints.get(s.id),
            })
            self._post_end(conn)
        obs_events.record(
            "session", stage="serve", action="drain",
            n_checkpointed=len(self.checkpoints),
        )
        self._shutdown_loop(grace_s=2.0)

    def _shutdown_loop(self, grace_s: float = 0.0) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        if grace_s:
            # let writer tasks flush the closing frames before the loop
            # dies: a frame counts from its post (its put may still be a
            # pending loop callback) until its bytes are on the socket
            deadline = time.perf_counter() + grace_s
            while time.perf_counter() < deadline:
                with self._conns_lock:
                    busy = any(c.flushing() for c in self._conns)
                if not busy:
                    break
                time.sleep(0.01)
        with contextlib.suppress(RuntimeError):
            loop.call_soon_threadsafe(loop.stop)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Bind and start serving; returns the bound address ((host, port)
        tuple, or the unix socket path)."""
        self._loop = asyncio.new_event_loop()

        async def _bind():
            if self.unix_path is not None:
                # a previous server's socket file survives its process (unix
                # sockets are not unlinked on close) and would fail the bind
                # with EADDRINUSE; clear it ONLY if it really is a socket
                import os
                import stat

                try:
                    if stat.S_ISSOCK(os.stat(self.unix_path).st_mode):
                        os.unlink(self.unix_path)
                except FileNotFoundError:
                    pass
                self._server = await asyncio.start_unix_server(
                    self._handle, path=str(self.unix_path))
                self.address = str(self.unix_path)
            else:
                self._server = await asyncio.start_server(
                    self._handle, host=self.host, port=self.port)
                self.address = self._server.sockets[0].getsockname()[:2]

        def _run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(_bind())
            self._started.set()
            self._loop.run_forever()
            # loop stopped: close the listener FIRST (a stopped server must
            # refuse connections, not accept into a void — clients' connect
            # retries need the refusal to find the next server), then cancel
            # whatever is left and close
            if self._server is not None:
                self._server.close()
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            with contextlib.suppress(Exception):
                self._loop.run_until_complete(
                    asyncio.gather(*asyncio.all_tasks(self._loop),
                                   return_exceptions=True))
            self._loop.close()

        self._loop_thread = threading.Thread(
            target=_run, name="disco-serve-io", daemon=True)
        self._loop_thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("serve: event loop failed to start")
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="disco-serve-dispatch", daemon=True)
        self._dispatch_thread.start()
        if self.promote is not None:
            # resume, then run: an interrupted rollout is settled from the
            # ledger before any session can open against it
            self.promote.start()
        obs_events.record("run_start", stage="serve", tool="disco-serve",
                          address=str(self.address), **self.run_info)
        return self.address

    def stop(self, timeout_s: float = 60.0) -> None:
        """Graceful drain from the embedding caller: finish queued blocks,
        checkpoint, close streams, stop threads.  Raises the dispatch
        thread's crash, if any (a chaos-injected death must surface)."""
        self._stop_event.set()
        if self.promote is not None:
            self.promote.stop()
        self.wait(timeout_s)

    def wait(self, timeout_s: float | None = None) -> None:
        """Join the dispatch thread (and then the loop thread), re-raising
        a crash from either tick or drain."""
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout_s)
            if self._dispatch_thread.is_alive():
                raise TimeoutError("serve: dispatch thread did not stop in time")
        if self._loop_thread is not None:
            self._loop_thread.join(5.0)
        if self.promote is not None:
            self.promote.stop()
            self.promote.wait(timeout_s=5.0)
        if self.resident is not None:
            # the dispatch thread (its only stepper) is gone by here, so the
            # flag-only close cannot race a running slice
            self.resident.close()
        if self.crashed is not None:
            crash, self.crashed = self.crashed, None
            raise crash

    def serve_forever(self) -> None:
        """Serve until the first SIGINT/SIGTERM, then drain (install a
        :class:`~disco_tpu_torch.runs.interrupt.GracefulInterrupt` scope
        around this call)."""
        self.start()
        if isinstance(self.address, tuple):
            print(f"disco-serve listening on {self.address[0]}:{self.address[1]}")
        else:
            print(f"disco-serve listening on {self.address}")
        self.wait()
