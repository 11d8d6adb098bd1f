"""Streaming shard dataset: tapped serve traffic -> CRNN training batches
(the port's counterpart of ``disco_tpu/flywheel/dataset.py``: the same
windows in the same order, draw for draw).

Reads the shard files a :class:`~disco_tpu_torch.flywheel.tap.CorpusTap`
wrote and windows them into the (x, y) batch convention the training
stack consumes (``nn/data.DiscoDataset`` item shape, reference
dnn/data/datasets.py:102-162): ``x`` is the reference-mic magnitude STFT
window ``(win_len, F)`` float32 of one node, ``y`` the matching step-1
mask window — the mask the served session actually used.

* Deterministic seeded shuffle: shard order is a permutation drawn from
  ``(seed, epoch)`` and the window order inside a shard from ``(seed,
  epoch, crc32(shard name))`` by numpy's ``default_rng``, so two runs with
  one seed see identical batch streams and a resumed run sees the same
  per-shard order whatever was already consumed.
* Ledger resume: with a :class:`~disco_tpu_torch.runs.RunLedger`, every
  shard's consumption is an ``in_flight`` -> ``done`` record (unit
  ``shard:<name>:epoch:<e>``, artifacts = the shard digest), and
  :meth:`ShardDataset.batches` skips shards whose record verifies.
* Corrupt-shard skip: a shard failing :func:`~disco_tpu_torch.flywheel.
  shards.read_shard` validation is skipped with a ``warning`` obs event
  and the ``shards_skipped`` counter.

Host-only (numpy and stdlib): ``nn.training.fit`` moves the batches to the
device.
"""
from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from disco_tpu_torch.flywheel.shards import ShardError, list_shards, read_shard
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs import trace as obs_trace
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry


def unit_shard_epoch(name: str, epoch: int) -> str:
    """Ledger work-unit id of one shard's consumption in one epoch."""
    return f"shard:{name}:epoch:{int(epoch)}"


class ShardDataset:
    """Windowed training batches over a directory of flywheel shards.

    Args:
      shard_dir: the tap directory (shards + manifest).
      win_len: frames per training window; windows never cross block
        boundaries (the reference's per-segment windowing).
      win_hop: window hop (default ``win_len``: no overlap).
      ref_mic: the node channel whose magnitude is the input.
      seed: base seed of every draw.
    """

    def __init__(self, shard_dir, *, win_len: int = 8, win_hop: int | None = None,
                 ref_mic: int = 0, seed: int = 0):
        if win_len < 1:
            raise ValueError(f"win_len must be >= 1, got {win_len}")
        self.shard_dir = Path(shard_dir)
        self.win_len = int(win_len)
        self.win_hop = int(win_hop) if win_hop else self.win_len
        self.ref_mic = int(ref_mic)
        self.seed = int(seed)

    def shard_paths(self) -> list[Path]:
        """Sorted shard files on disk now (integrity is checked as each
        shard is read)."""
        return list_shards(self.shard_dir)

    # -- windowing -----------------------------------------------------------
    def _shard_windows(self, path: Path, epoch: int, shuffle: bool = True):
        """(xs, ys) window stacks of one shard — in the shard's per-epoch
        order when ``shuffle``, in natural (record, node, frame) order
        otherwise; None when the shard is corrupt (skipped loudly) or
        holds no window."""
        try:
            _meta, records = read_shard(path)
        except ShardError as e:
            obs_registry.counter("shards_skipped").inc()
            obs_events.record("warning", stage="flywheel", path=str(path),
                              reason=f"corrupt shard skipped: {e}")
            return None
        xs, ys = [], []
        tracing = obs_trace.enabled()
        for rec in records:
            if tracing and rec.get("trace") is not None:
                # the chain's last hop: this served block became training
                # input (one span per traced record, only while tracing)
                obs_trace.span(
                    "train_batch", obs_trace.from_wire(rec["trace"]),
                    shard=path.name, epoch=int(epoch),
                    session=rec.get("session"), seq=rec.get("seq"),
                )
            Y, mz = rec["Y"], rec["mask_z"]
            mag = np.abs(np.asarray(Y)[:, self.ref_mic]).astype(np.float32)
            K, _F, T = mag.shape
            for k in range(K):
                for t0 in range(0, T - self.win_len + 1, self.win_hop):
                    # (F, win) -> (win, F): the DiscoDataset item convention
                    xs.append(mag[k, :, t0:t0 + self.win_len].T)
                    ys.append(np.asarray(mz, np.float32)[k, :, t0:t0 + self.win_len].T)
        if not xs:
            return None
        if not shuffle:
            return np.stack(xs), np.stack(ys)
        order = self._shard_rng(path.name, epoch).permutation(len(xs))
        return (np.stack([xs[i] for i in order]),
                np.stack([ys[i] for i in order]))

    def _shard_rng(self, name: str, epoch: int) -> np.random.Generator:
        """Per-(shard, epoch) generator keyed by NAME, not position: a
        resumed epoch reproduces each remaining shard's window order."""
        return np.random.default_rng([self.seed, int(epoch), zlib.crc32(name.encode())])

    # -- the batch stream ----------------------------------------------------
    def batches(self, batch_size: int, *, epoch: int = 0, shuffle: bool = True,
                ledger=None, drop_last: bool = True, recent: int | None = None):
        """Yield ``(x, y)`` numpy batches for one epoch.

        Batches never cross shard boundaries (one shard resident at a
        time), shard order is the ``(seed, epoch)`` permutation when
        ``shuffle`` and the sorted order otherwise, and ``drop_last`` drops
        each shard's ragged tail batch so a step sees one batch shape.

        ``ledger``: a :class:`~disco_tpu_torch.runs.RunLedger` (or path)
        arms verified resume — consumed shards are recorded per epoch and
        skipped when their digest still matches.

        ``recent``: consume only the newest this many shards (by shard
        number) this epoch — a continuous trainer over a growing tap
        directory needs it, or each epoch re-reads the whole history.
        """
        from disco_tpu_torch.runs.ledger import RunLedger

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        own_ledger = ledger is not None and not isinstance(ledger, RunLedger)
        if own_ledger:
            ledger = RunLedger(ledger)
        try:
            done: set = set()
            if ledger is not None:
                done, _requeued = ledger.verified_done()
            paths = self.shard_paths()
            if recent is not None:
                if int(recent) < 1:
                    raise ValueError(f"recent must be >= 1, got {recent}")
                paths = paths[-int(recent):]
            if shuffle:
                order = np.random.default_rng([self.seed, int(epoch)]).permutation(len(paths))
                paths = [paths[i] for i in order]
            for path in paths:
                unit = unit_shard_epoch(path.name, epoch)
                if unit in done:
                    continue
                windows = self._shard_windows(path, epoch, shuffle=shuffle)
                if windows is None:
                    continue
                if ledger is not None:
                    ledger.mark_in_flight(unit)
                xs, ys = windows
                n = len(xs)
                for start in range(0, n, batch_size):
                    if drop_last and start + batch_size > n:
                        break
                    yield xs[start:start + batch_size], ys[start:start + batch_size]
                if ledger is not None:
                    ledger.mark_done(unit, artifact_paths=[path], n_windows=n)
        finally:
            if own_ledger:
                ledger.close()  # one leaked handle an epoch would exhaust descriptors

    def batch_fn(self, batch_size: int, *, shuffle: bool = True, ledger=None,
                 drop_last: bool = True):
        """A ``fit``-compatible zero-argument callable: each call is one
        epoch's batch iterator, the epoch counter advancing per call.  It
        has ``set_start_epoch(n)``, which ``nn.training.fit`` calls on a
        resumed run so the data epochs line up with the training epochs
        (else a reused ``ledger`` would make the first resumed epochs
        yield nothing)."""
        from disco_tpu_torch.runs.ledger import RunLedger

        if ledger is not None and not isinstance(ledger, RunLedger):
            ledger = RunLedger(ledger)  # one handle for the whole run
        state = {"epoch": 0}

        def make():
            epoch = state["epoch"]
            state["epoch"] += 1
            return self.batches(batch_size, epoch=epoch, shuffle=shuffle,
                                ledger=ledger, drop_last=drop_last)

        def set_start_epoch(epoch: int) -> None:
            state["epoch"] = int(epoch)

        make.set_start_epoch = set_start_epoch
        return make

    def peek_geometry(self) -> dict | None:
        """(n_nodes, mics_per_node, n_freq, block_frames) of the first
        readable shard; None when no intact shard exists."""
        return peek_geometry(self.shard_dir)


def peek_geometry(shard_dir) -> dict | None:
    """Module-level twin of :meth:`ShardDataset.peek_geometry`, for sizing
    a model before choosing window parameters."""
    for path in list_shards(shard_dir):
        try:
            _meta, records = read_shard(path)
        except ShardError:
            continue
        if records:
            Y = np.asarray(records[0]["Y"])
            return {"n_nodes": int(Y.shape[0]),
                    "mics_per_node": int(Y.shape[1]),
                    "n_freq": int(Y.shape[2]),
                    "block_frames": int(Y.shape[3])}
    return None
