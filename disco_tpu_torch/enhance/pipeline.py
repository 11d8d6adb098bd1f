"""Corpus throughput engine: overlapped prefetch / dispatch / readback
(counterpart of ``disco_tpu/enhance/pipeline.py``).

The batched corpus driver (:func:`disco_tpu_torch.enhance.driver.
enhance_rirs_batched`) composes two overlap primitives:

* :class:`ChunkPrefetcher` — a double-buffered background loader: while the
  card runs chunk N, a daemon thread loads and pads chunk N+1 (wav decode,
  numpy padding, ledger ``in_flight`` marks and the ``chunk_load`` chaos
  seam all run *with the work*, on the loader thread, so crash-safe resume
  semantics are preserved — an interrupted prefetched chunk is in_flight
  but not done and is redone on resume).  The loader runs numpy only: the
  main thread is the only CUDA user.
* :func:`fetch_chunk_host` — the six ISTFTs of each real clip on the card
  (:func:`clip_time_domain`, the per-clip call of the sequential path),
  then everything a chunk's scoring needs — the time-domain streams,
  step-1/2 masks and exported z streams — crosses to the host in ONE copy
  (:func:`~disco_tpu_torch.device.to_host`).  Scoring workers then get
  numpy arrays only.

Observability, the JAX package's names: each fetch records a
``chunk_readback`` stage event, the ``readback_ms`` gauge and histogram and
the ``chunk_readbacks`` counter; :func:`note_chunk_overlap` the
``prefetch_stall_ms`` gauge and histogram, the ``overlap_efficiency`` gauge
and the ``chunks_pipelined`` counter; a loader that outlives
:meth:`ChunkPrefetcher.close` a ``warning`` event and the
``prefetch_orphaned`` counter.

No reference counterpart: the reference enhances clips one at a time in a
Python loop (SURVEY.md §5.5).
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from disco_tpu_torch.core.dsp import istft
from disco_tpu_torch.device import to_host
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry

#: Scoring backpressure: at most this many chunks of pending scoring
#: futures are kept in flight before the dispatch thread blocks on the
#: oldest, so chunk N-1's scoring overlaps chunk N's dispatch AND chunk
#: N+1's prefetch without unbounded host memory growth.
MAX_PENDING_CHUNKS = 2


@dataclass
class LoadedChunk:
    """One corpus chunk, loaded and padded, ready to dispatch."""

    bucket: int          # padded clip length Lp (the length bucket)
    chunk: list          # [(rir, out_path, layout), ...] — n_real entries
    sigs: list           # per-clip load_input_signals tuples (y, s, n, ...)
    ys: np.ndarray       # (B, K, C, Lp) padded mixture stack (B >= n_real)
    ss: np.ndarray       # (B, K, C, Lp) padded target stack
    ns: np.ndarray       # (B, K, C, Lp) padded noise stack
    n_real: int          # real clips in the batch (the rest is pad)

    @property
    def clip_lengths(self) -> list:
        """True (unpadded) length per real clip — what ISTFT trims to."""
        return [self.sigs[i][0].shape[-1] for i in range(self.n_real)]


_END = object()


class ChunkPrefetcher:
    """Double-buffered background chunk loader.

    Iterating yields ``(LoadedChunk, stall_s)`` where ``stall_s`` is how
    long the consumer waited for the chunk (``stall_s ≈ 0`` means the
    prefetch fully hid the load behind the previous chunk's work).

    ``depth`` bounds lookahead: with the default 2, at most one chunk sits
    ready in the queue while a second is being loaded.  Exceptions from the
    loader (including :class:`~disco_tpu_torch.runs.chaos.ChaosCrash`, a
    ``BaseException`` — an injected crash must kill the run exactly like a
    process death) are re-raised at the consuming site, and
    ``stop_requested`` (the graceful SIGTERM/SIGINT flag of
    ``disco_tpu_torch.runs.interrupt``) is polled between chunks so an
    interrupted run stops marking new work ``in_flight``.

    Always :meth:`close` in a ``finally``: a consumer that unwinds
    mid-iteration would otherwise leave the loader thread blocked on a full
    queue.  A loader still inside one chunk read when ``close`` times out is
    recorded (a ``warning`` event and the ``prefetch_orphaned`` counter).
    """

    def __init__(self, work, load_chunk, depth: int = 2, stop_requested=None):
        if depth < 2:
            raise ValueError(f"ChunkPrefetcher needs depth >= 2 (double buffering), got {depth}")
        # a generator stays lazy and is drained ON the loader thread (the
        # training batch feed, nn.training._prefetch_host_batches, does its
        # numpy prep inside next()); finite lists are snapshotted against
        # caller mutation
        self._work = work if hasattr(work, "__next__") else list(work)
        self._load = load_chunk
        self._stop = threading.Event()
        self._stop_requested = stop_requested or (lambda: False)
        # depth - 1 queued + 1 being loaded = depth chunks of lookahead
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth - 1)
        self._thread = threading.Thread(target=self._run, name="disco-chunk-prefetch",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to :meth:`close`."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self):
        try:
            for work_item in self._work:
                if self._stop.is_set() or self._stop_requested():
                    break
                loaded = self._load(*work_item)
                if not self._put(loaded):
                    return
            self._put(_END)
        except BaseException as e:  # ChaosCrash included — re-raised at get()
            self._put(e)

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            stall_s = time.perf_counter() - t0
            if item is _END:
                self._thread.join(timeout=5.0)
                return
            if isinstance(item, BaseException):
                raise item
            yield item, stall_s

    def close(self, join_timeout: float = 5.0) -> bool:
        """Stop the loader and release it: set the stop flag, drain the
        queue (unblocking a pending put) and join.  Idempotent.  Returns
        True when the loader exited; a loader still inside one slow chunk
        read starts nothing new afterwards, and outliving the timeout is
        recorded, never swallowed."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                break
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            obs_registry.counter("prefetch_orphaned").inc()
            obs_events.record(
                "warning", stage="chunk_load",
                reason="prefetch loader still inside a chunk read after "
                       f"close({join_timeout:g}s); it will exit after that "
                       "read without starting new work",
            )
            return False
        return True


def clip_time_domain(res, length: int) -> torch.Tensor:
    """One clip's six time-domain streams — yf, z_y, sf, nf, z_s, z_n of a
    (K, F, T) :class:`~disco_tpu_torch.enhance.tango.TangoResult` — as ONE
    (6, K, length) ISTFT on the result's device.  The sequential and the
    pipelined engines both call this per clip, with the same shapes, so
    their outputs agree bit for bit."""
    return istft(torch.stack([res.yf, res.z_y, res.sf, res.nf, res.z_s, res.z_n]), length=length)


def clip_slice(res_b, i: int):
    """Clip ``i`` of a batched result, as views."""
    return type(res_b)(**{k: getattr(res_b, k)[i] for k in
                          ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn", "masks_z", "mask_w")})


def fetch_chunk_host(res_b, clip_lengths, n_real: int) -> dict:
    """Move one chunk's scoring inputs to the host in ONE copy.

    The time-domain conversion happens first, on the result's device, one
    clip at a time at its own length (:func:`clip_time_domain`), with no
    readback between clips; then the whole payload crosses at once.

    Args:
      res_b: batched :class:`~disco_tpu_torch.enhance.tango.TangoResult`
        (leaves ``(B, K, F, T)``).
      clip_lengths: true (unpadded) sample length per real clip.
      n_real: number of real clips (pad clips are never fetched).

    Returns:
      dict with ``td`` (list of per-clip 6-tuples ``(sh_t, szh_t, sf_t,
      nf_t, szf_t, nzf_t)``, each ``(K, L_i)`` float32 numpy), ``masks_z``
      / ``mask_w`` (``(n_real, K, F, T)`` float32) and ``z_y``
      (``(n_real, K, F, T)`` complex64).
    """
    with obs_events.stage("chunk_readback", n_clips=n_real):
        td = [clip_time_domain(clip_slice(res_b, i), int(clip_lengths[i]))
              for i in range(n_real)]
        t0 = time.perf_counter()
        host = to_host(td + [res_b.masks_z[:n_real], res_b.mask_w[:n_real],
                             res_b.z_y[:n_real]])
        _note_readback(time.perf_counter() - t0)
    return {"td": [tuple(t) for t in host[:n_real]], "masks_z": host[n_real],
            "mask_w": host[n_real + 1], "z_y": host[n_real + 2]}


def _note_readback(dt_s: float) -> None:
    """One chunk readback's copy time in the ``readback_ms`` gauge and
    histogram, and the ``chunk_readbacks`` count."""
    dt_ms = dt_s * 1e3
    obs_registry.gauge("readback_ms").set(dt_ms)
    obs_registry.histogram("readback_ms").observe(dt_ms)
    obs_registry.counter("chunk_readbacks").inc()


def fetch_chained_host(out_b, clip_lengths, n_real: int) -> dict:
    """Chained-lane twin of :func:`fetch_chunk_host`: the chained runner
    already converted every clip to time domain (its export payload carries
    six (B, K, Lp) stacks), so this moves the payload in ONE copy and trims
    each clip's bucket padding to its true length on the host (numpy
    views).  Returns the same dict shape as :func:`fetch_chunk_host`.

    The trimmed streams are the ISTFTs of the padded clip, sliced — not a
    per-clip ``istft(length=L_i)`` — so chained artifacts match the staged
    path at the chained lane's tolerance, not bit for bit."""
    with obs_events.stage("chunk_readback", n_clips=n_real, chained=True):
        t0 = time.perf_counter()
        td, masks_z, mask_w, z_y = to_host([torch.stack(out_b["td"])[:, :n_real],
                                            out_b["masks_z"][:n_real],
                                            out_b["mask_w"][:n_real], out_b["z_y"][:n_real]])
        _note_readback(time.perf_counter() - t0)
    return {"td": [tuple(td[:, i, ..., :int(clip_lengths[i])]) for i in range(n_real)],
            "masks_z": masks_z, "mask_w": mask_w, "z_y": z_y}


def note_chunk_overlap(stall_s: float, busy_s: float) -> None:
    """Record one chunk's overlap economics: the stall the dispatch loop
    paid waiting for the prefetcher and the busy time it then spent, in the
    ``prefetch_stall_ms`` / ``overlap_efficiency`` gauges (last chunk), the
    stall histogram (whole run) and the ``chunks_pipelined`` counter.
    ``overlap_efficiency`` is busy / (busy + stall): 1.0 means the prefetch
    fully hid the load."""
    stall_ms = stall_s * 1e3
    obs_registry.gauge("prefetch_stall_ms").set(stall_ms)
    obs_registry.histogram("prefetch_stall_ms").observe(stall_ms)
    total = busy_s + stall_s
    obs_registry.gauge("overlap_efficiency").set(busy_s / total if total > 0 else 1.0)
    obs_registry.counter("chunks_pipelined").inc()
