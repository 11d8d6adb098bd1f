"""Wire protocol of the online enhancement service: length-prefixed msgpack
frames over a stream socket (the port's copy of
``disco_tpu/serve/protocol.py``, byte for byte the same wire).

Every frame is a 4-byte big-endian payload length followed by one msgpack
map with a ``"type"`` key.  Arrays travel as self-describing maps
(``{"__nd__": 1, "dtype", "shape", "data"}``; complex dtypes are split into
``data``/``imag`` float halves: msgpack has no complex type).  The bytes
are written and read by the port's own msgpack codec
(``nn.serialization.packb``/``unpackb``), which writes what
``msgpack.packb(..., use_bin_type=True)`` writes for these values, so a
frame of either package is a frame of the other.  Everything in this module
is numpy and stdlib: a client makes no CUDA call.

Frame types (client → server):

* ``open``    — start (or resume/reattach) a session; carries the
  :class:`~disco_tpu_torch.serve.session.SessionConfig` fields and optionally:
  ``z_mask``; ``resume`` (the resume token — a parked session reattaches
  in place, otherwise the server falls back to its checkpoint); ``have``
  (the next output seq the client still needs — the server replays the
  parked session's missed deliveries from its bounded replay buffer, so
  nothing is lost or duplicated); ``priority`` (ladder shedding spares
  priority sessions).
* ``block``   — one streaming input block: ``seq`` (0-based block index),
  ``Y`` (K, C, F, T) complex64 mixture STFT frames, ``mask_z`` / ``mask_w``
  (K, F, T) step-1/2 masks; optionally ``trace`` — the causal-tracing
  header (``{"trace": <id>, "span": <id>}``, ``obs.trace``)
  minted at submission so the server can thread the block's span chain.
  **Back-compat**: the header is optional and unvalidated-by-rejection — a
  pre-span client (no ``trace`` key) is served byte-for-byte unchanged.
* ``close``   — no more blocks; flush and finish the session.
* ``status``  — read-only live introspection: no session required, never
  mutates anything; the server answers with one ``status_ok`` frame.

Server → client:

* ``open_ok``  — session admitted: ``session`` id, ``blocks_done`` (>0 when
  resumed from a checkpoint), ``next_seq`` (the next INPUT seq the server
  expects — after a reattach the client re-sends from here, the same
  rollback that serves backpressure), ``reattached`` (true when a parked
  session was stitched in place).
* ``enhanced`` — one enhanced output block: ``seq``, ``yf`` (K, F, T)
  complex64 — the streaming TANGO outputs for the matching input block.
* ``draining`` — the server received a graceful stop: the session's queued
  blocks will still be enhanced and delivered, then the session is
  checkpointed and closed; stop sending new blocks.
* ``closed``   — session over: ``blocks_done``, optional ``state_path`` of
  the checkpoint a resumed session can continue from.
* ``status_ok`` — the ``status`` reply: the
  :func:`~disco_tpu_torch.serve.status.status_payload` sections (session
  states, scheduler tick, ladder rung, counters/gauges, latency
  percentiles, in-flight spans).
* ``error``    — admission rejection, eviction, protocol violation;
  ``code`` + human-readable ``message``.  Code ``parked`` is special: the
  session was parked (connection trouble or ladder shedding), and the
  frame carries ``resume`` (the token to reattach with) and
  ``retry_after_s`` (a back-off hint for shed sessions) —
  :class:`~disco_tpu_torch.serve.client.ServeClient` reattaches
  transparently.
"""
from __future__ import annotations

import socket
import struct

import numpy as np

from disco_tpu_torch.nn.serialization import packb, unpackb

#: Hard per-frame size bound (64 MiB).  A corrupt / hostile length prefix
#: must fail fast instead of allocating unbounded memory server-side.
MAX_FRAME_BYTES = 64 << 20

_LEN = struct.Struct(">I")


class ProtocolError(RuntimeError):
    """A malformed frame (bad length prefix, bad msgpack, bad array map)."""


# -- array codec -------------------------------------------------------------
def encode_array(arr) -> dict:
    """numpy array -> msgpack-ready map.  Complex arrays are split into two
    real byte strings (msgpack has no complex type); everything else ships
    as raw C-order bytes + dtype string."""
    arr = np.ascontiguousarray(arr)
    if np.iscomplexobj(arr):
        re = np.ascontiguousarray(arr.real)
        im = np.ascontiguousarray(arr.imag)
        return {"__nd__": 1, "dtype": arr.dtype.str, "shape": list(arr.shape),
                "data": re.tobytes(), "imag": im.tobytes()}
    return {"__nd__": 1, "dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": arr.tobytes()}


def decode_array(d) -> np.ndarray:
    """Inverse of :func:`encode_array` (validating: a wrong payload size for
    the declared dtype/shape raises :class:`ProtocolError`, never a numpy
    internal error)."""
    if not isinstance(d, dict) or d.get("__nd__") != 1:
        raise ProtocolError(f"not an encoded array: {type(d).__name__}")
    try:
        dtype = np.dtype(d["dtype"])
        shape = tuple(int(s) for s in d["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad array header: {e}") from None
    if dtype.kind == "c":
        half = np.dtype(f"f{dtype.itemsize // 2}")
        try:
            re = np.frombuffer(d["data"], half)
            im = np.frombuffer(d["imag"], half)
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad complex array payload: {e}") from None
        if re.size != n or im.size != n:
            raise ProtocolError(
                f"array payload size mismatch: {re.size}/{im.size} elements "
                f"for shape {shape}"
            )
        return (re + 1j * im).astype(dtype).reshape(shape)
    try:
        flat = np.frombuffer(d["data"], dtype)
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad array payload: {e}") from None
    if flat.size != n:
        raise ProtocolError(
            f"array payload size mismatch: {flat.size} elements for shape {shape}"
        )
    return flat.reshape(shape)


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return encode_array(obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            return decode_array(obj)
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


# -- framing -----------------------------------------------------------------
def pack_frame(frame: dict) -> bytes:
    """One frame dict -> length-prefixed msgpack bytes."""
    payload = packb(_encode(frame))
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}); send smaller blocks"
        )
    return _LEN.pack(len(payload)) + payload


def unpack_payload(payload: bytes) -> dict:
    """msgpack payload bytes -> frame dict (arrays decoded)."""
    try:
        d = unpackb(payload)
    except Exception as e:  # the codec's DecodeError, or a malformed map
        raise ProtocolError(f"bad msgpack payload: {e}") from None
    if not isinstance(d, dict) or "type" not in d:
        raise ProtocolError("frame must be a map with a 'type' key")
    return _decode(d)


def read_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes from a blocking socket; None on clean EOF at
    a frame boundary (EOF mid-frame raises — that is a truncated frame)."""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict | None:
    """Blocking read of one frame; None on clean EOF."""
    head = read_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} exceeds MAX_FRAME_BYTES")
    payload = read_exact(sock, n)
    if payload is None:
        raise ProtocolError("connection closed between length prefix and payload")
    return unpack_payload(payload)


def send_frame(sock: socket.socket, frame: dict) -> None:
    """Blocking write of one frame."""
    sock.sendall(pack_frame(frame))


def frame_header_size() -> int:
    """Byte length of the frame length-prefix header."""
    return _LEN.size
