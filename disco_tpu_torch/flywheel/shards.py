"""Training-shard files: the on-disk format of the serve -> train flywheel
(the port's copy of ``disco_tpu/flywheel/shards.py``: the same bytes, so
each package reads the other's shards).

A shard is one self-describing msgpack file holding a bounded list of
served-traffic records — each record is one delivered streaming block's
``(noisy Y, enhanced yf, mask_z, mask_w)`` arrays plus its session/seq
metadata.  Arrays travel in the wire codec of
:mod:`disco_tpu_torch.serve.protocol` (``encode_array``: complex dtypes
split into two real byte strings — msgpack has no complex type), and the
msgpack itself is the port's codec (:mod:`disco_tpu_torch.nn.serialization`),
which writes what ``msgpack.packb(..., use_bin_type=True)`` writes for
these values.  This module is numpy and stdlib: the tap's writer thread
runs it and never touches torch.

Integrity is layered as in the session checkpoints: the record payload
carries an embedded sha256 of its own bytes, the file is placed with the
tmp + fsync + ``os.replace`` protocol of :mod:`disco_tpu_torch.io.atomic`
(the ``mid_write`` chaos seam fires inside, and a crash there never leaves
a torn shard at the final path), and :func:`probe_shard` is the
validate-before-trust read the dataset and the manifest ledger use: a
truncated or tampered shard reads as *not a shard*, never as silently
wrong training data.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from disco_tpu_torch.nn.serialization import packb, unpackb
from disco_tpu_torch.serve.protocol import decode_array, encode_array

#: bump on incompatible shard-format changes; readers reject unknown
#: versions loudly instead of misparsing
SHARD_VERSION = 1

#: final-path suffix of every flywheel shard (``tap-000001.shard.msgpack``)
SHARD_SUFFIX = ".shard.msgpack"

#: the array fields every record carries (the tap's post-readback payload)
RECORD_ARRAYS = ("Y", "yf", "mask_z", "mask_w")


class ShardError(ValueError):
    """A shard file is truncated, tampered with, or not a shard at all."""


def unit_shard(name: str) -> str:
    """Ledger work-unit id of one shard (manifest and dataset-resume records)."""
    return f"shard:{name}"


def _pack(obj):
    """Msgpack-ready structure: numpy arrays via the complex-safe wire
    codec, numpy scalars to Python, containers walked."""
    if isinstance(obj, np.ndarray):
        return encode_array(obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v) for v in obj]
    return obj


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            return decode_array(obj)
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    return obj


def write_shard(path, records, meta: dict | None = None) -> Path:
    """Write one shard atomically; returns the final path.

    ``records``: list of dicts, each carrying the :data:`RECORD_ARRAYS`
    numpy arrays (complex ``Y``/``yf`` included — the codec splits them)
    plus scalar metadata (``session``, ``seq``, ``t``).  The record bytes
    are digested (sha256) into the envelope, and the payload goes through
    :func:`disco_tpu_torch.io.atomic.atomic_write`, whose ``mid_write``
    chaos seam fires between payload and rename.
    """
    from disco_tpu_torch.io.atomic import atomic_write

    records_bytes = packb([_pack(r) for r in records])
    payload = packb({
        "version": SHARD_VERSION,
        "meta": _pack(dict(meta or {})),
        "n_records": len(records),
        "records": records_bytes,
        "records_sha256": hashlib.sha256(records_bytes).hexdigest(),
    })
    path = Path(path)
    with atomic_write(path) as fh:
        fh.write(payload)
    return path


def read_shard(path) -> tuple[dict, list]:
    """Load one shard as ``(meta, records)`` with full validation.

    Raises :class:`ShardError` on unreadable/truncated msgpack, an unknown
    version, a record-digest mismatch (torn or tampered payload) or a
    record-count mismatch.
    """
    path = Path(path)
    try:
        d = unpackb(path.read_bytes())
    except Exception as e:
        raise ShardError(f"{path}: not a readable shard: {e}") from None
    if not isinstance(d, dict) or d.get("version") != SHARD_VERSION:
        raise ShardError(
            f"{path}: unknown shard version "
            f"{d.get('version') if isinstance(d, dict) else d!r}"
        )
    records_bytes = d.get("records")
    digest = d.get("records_sha256")
    if not isinstance(records_bytes, bytes) or not digest:
        raise ShardError(f"{path}: shard missing records payload/digest")
    if hashlib.sha256(records_bytes).hexdigest() != digest:
        raise ShardError(
            f"{path}: records digest mismatch — shard corrupt, refusing to "
            "feed it to training"
        )
    try:
        records = _unpack(unpackb(records_bytes))
    except Exception as e:
        raise ShardError(f"{path}: bad shard records: {e}") from None
    if not isinstance(records, list) or len(records) != int(d.get("n_records", -1)):
        raise ShardError(
            f"{path}: record count mismatch "
            f"({len(records) if isinstance(records, list) else '?'} vs "
            f"declared {d.get('n_records')})"
        )
    return _unpack(d.get("meta") or {}), records


def probe_shard(path) -> bool:
    """True iff ``path`` holds a complete, digest-consistent shard."""
    try:
        read_shard(path)
        return True
    except Exception:
        return False


def list_shards(shard_dir) -> list[Path]:
    """Sorted final-path shard files under ``shard_dir`` (not recursive: a
    tap directory holds its shards flat beside the manifest ledger).
    Discovery only: the dataset probes as it reads."""
    return sorted(Path(shard_dir).glob(f"*{SHARD_SUFFIX}"))
