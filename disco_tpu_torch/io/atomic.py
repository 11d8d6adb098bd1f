"""Atomic artifact I/O: tmp-file + fsync + ``os.replace`` writers and cheap
integrity probes (the port's copy of ``disco_tpu/io/atomic.py``).

The writers give the crash-safety invariant every resume path relies on:
**the final path either holds the complete artifact or does not exist**.
The payload is written to a same-directory temp file, flushed and fsynced,
then ``os.replace``d over the destination (atomic on POSIX within one
filesystem); the directory entry is fsynced best-effort so the rename
itself survives a power loss.  A crash at any point leaves at most a
``*.tmp.*`` litter file, never a truncated artifact.

The probes are the matching read side: cheap self-validating loads that
distinguish "done" from "truncated" for each artifact family, used by the
verified-resume checks (``disco_tpu_torch.runs.ledger``) and by the
validate-before-skip idempotency guards.  :func:`file_digest` provides the
sidecar digest the run ledger records per artifact.

``.msgpack`` files (flax checkpoints of either package) are probed by a
full decode with the port's own msgpack reader
(:mod:`disco_tpu_torch.nn.serialization`), as the JAX package probes them
with flax's.

No reference counterpart: the reference writes everything in place and its
restart story is "delete the partial output by hand" (SURVEY.md §5.3).
"""
from __future__ import annotations

import contextlib
import hashlib
import io as _io
import os
import pickle
import struct
import zipfile
from pathlib import Path

import numpy as np

from disco_tpu_torch.io.audio import write_wav as _write_wav_raw

#: Suffix pattern of the temp files :func:`atomic_write` creates.  A
#: ``*.tmp.<pid>`` file is by construction an abandoned partial write,
#: never a finished artifact; :func:`remove_tmp_litter` (called by the
#: verified-resume paths) deletes survivors of a REAL crash — a process
#: death between ``open`` and ``os.replace`` skips the in-process cleanup
#: that an exception unwind runs.
TMP_SUFFIX = ".tmp"


def remove_tmp_litter(root) -> list:
    """Delete abandoned atomic-write temp files under ``root`` (recursive);
    returns the removed paths.  Only exact ``<name>.tmp.<pid>`` shapes are
    touched, and each is deleted best-effort — litter cleanup must never
    break the resume doing it."""
    root = Path(root)
    removed: list[str] = []
    if not root.is_dir():
        return removed
    for p in root.rglob(f"*{TMP_SUFFIX}.*"):
        stem, _, pid = p.name.rpartition(".")
        if not stem.endswith(TMP_SUFFIX) or not pid.isdigit():
            continue
        with contextlib.suppress(OSError):
            p.unlink()
            removed.append(str(p))
    return removed


def _fsync_dir(path: Path) -> None:
    """Best-effort fsync of a directory entry so a rename survives power
    loss.  Some filesystems refuse O_RDONLY dir fsync — degrade silently;
    the rename is still atomic against process crashes either way."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb", **open_kwargs):
    """Context manager yielding a file handle whose contents appear at
    ``path`` atomically on successful exit.

    ``open_kwargs`` forward to :func:`open` (text-mode writers need e.g.
    ``newline=""`` for the csv module).

    Writes go to ``<path>.tmp.<pid>`` in the same directory (same
    filesystem, so the final ``os.replace`` is atomic), are flushed and
    fsynced, then renamed over ``path``.  On ANY exception the temp file is
    removed and ``path`` is untouched — a crashed writer can never leave a
    truncated artifact at the final location.

    The ``mid_write`` chaos seam (``disco_tpu_torch.runs.chaos``) fires after the
    payload is written but before the rename: an injected crash there
    proves the invariant the chaos gate asserts — tmp litter, complete
    final tree.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.name}{TMP_SUFFIX}.{os.getpid()}"
    fh = open(tmp, mode, **open_kwargs)
    try:
        yield fh
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        from disco_tpu_torch.runs import chaos

        chaos.tick("mid_write", path=str(path))
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    except BaseException:
        with contextlib.suppress(OSError):
            fh.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def write_bytes_atomic(path, data: bytes) -> Path:
    """Atomic ``Path.write_bytes``."""
    with atomic_write(path) as fh:
        fh.write(data)
    return Path(path)


def write_wav_atomic(path, data, fs, subtype: str = "FLOAT") -> Path:
    """Atomic :func:`disco_tpu_torch.io.audio.write_wav`: the RIFF container is
    encoded into memory, then placed with the tmp+fsync+replace protocol —
    a reader can never observe a header without its data chunk."""
    buf = _io.BytesIO()
    _write_wav_raw(buf, data, fs, subtype=subtype)
    return write_bytes_atomic(path, buf.getvalue())


def save_npy_atomic(path, arr, allow_pickle: bool = False) -> Path:
    """Atomic ``np.save``.  Unlike ``np.save(path, ...)``, the final name is
    exactly ``path`` with a ``.npy`` suffix ensured (np.save's own
    append-suffix behavior, made explicit so callers know the artifact
    name they must verify)."""
    path = Path(path)
    if path.suffix != ".npy":
        path = path.with_name(path.name + ".npy")
    with atomic_write(path) as fh:
        np.save(fh, arr, allow_pickle=allow_pickle)
    return path


def savez_atomic(path, **arrays) -> Path:
    """Atomic ``np.savez`` (the per-epoch loss-history artifact)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    with atomic_write(path) as fh:
        np.savez(fh, **arrays)
    return path


def dump_pickle_atomic(path, obj, protocol=pickle.HIGHEST_PROTOCOL) -> Path:
    """Atomic ``pickle.dump`` (the per-RIR OIM results dicts)."""
    with atomic_write(path) as fh:
        pickle.dump(obj, fh, protocol=protocol)
    return Path(path)


# -- integrity probes --------------------------------------------------------
def probe_wav(path) -> bool:
    """True iff ``path`` is a structurally complete WAV: RIFF/WAVE magic,
    a parsable fmt chunk, and a data chunk whose declared size fits inside
    the file.  Reads only the chunk headers — O(#chunks), not O(bytes)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(12)
            if len(head) < 12:
                return False
            riff, _size, wave = struct.unpack("<4sI4s", head)
            if riff != b"RIFF" or wave != b"WAVE":
                return False
            end = os.fstat(fh.fileno()).st_size
            saw_fmt = saw_data = False
            while True:
                chead = fh.read(8)
                if len(chead) < 8:
                    break
                cid, csize = struct.unpack("<4sI", chead)
                if fh.tell() + csize > end:
                    return False  # declared chunk runs past EOF: truncated
                if cid == b"fmt ":
                    saw_fmt = True
                elif cid == b"data":
                    saw_data = True
                fh.seek(csize + (csize % 2), 1)
            return saw_fmt and saw_data
    except OSError:
        return False


def probe_npy(path) -> bool:
    """True iff ``path`` is a complete ``.npy``.

    Public-API only (no ``np.lib.format`` internals, which have changed
    shape across numpy versions): a memory-mapped ``np.load`` validates the
    header and refuses a payload shorter than the (shape, dtype) promise
    without reading the data.  Object arrays (the ``allow_pickle`` infos
    files) cannot be mapped and fall back to a full validating load — as
    does any mmap refusal, so an unmappable-but-intact file still probes
    True and a truncated one still probes False."""
    try:
        arr = np.load(path, mmap_mode="r", allow_pickle=False)
        del arr
        return True
    except Exception:
        try:
            np.load(path, allow_pickle=True)
            return True
        except Exception:
            return False


def probe_npz(path) -> bool:
    """True iff ``path`` is a complete ``.npz``: the zip central directory
    is intact and every member CRC-checks (``zipfile.testzip``)."""
    try:
        with zipfile.ZipFile(path) as zf:
            return zf.testzip() is None
    except Exception:
        return False


def probe_pickle(path) -> bool:
    """True iff ``path`` unpickles to completion.  Full load — the OIM
    result dicts this guards are a few KB, so "cheap" holds; a truncated
    stream raises inside ``pickle`` and reads as not-done."""
    try:
        with open(path, "rb") as fh:
            pickle.load(fh)
        return True
    except Exception:
        return False


def probe_msgpack(path) -> bool:
    """True iff ``path`` decodes as one complete flax-serialization msgpack
    value (structure only — whether it fits a model is the loader's job,
    ``nn.training.load_checkpoint``)."""
    from disco_tpu_torch.nn.serialization import unpackb

    try:
        unpackb(Path(path).read_bytes())
        return True
    except Exception:
        return False


#: Probe dispatch by suffix (:func:`probe_artifact`).
_PROBES = {
    ".wav": probe_wav,
    ".npy": probe_npy,
    ".npz": probe_npz,
    ".p": probe_pickle,
    ".pkl": probe_pickle,
    ".pickle": probe_pickle,
    ".msgpack": probe_msgpack,
}


def probe_artifact(path) -> bool:
    """Self-validating existence check: True iff ``path`` exists AND its
    format-specific probe passes.  Unknown suffixes degrade to a non-empty
    existence check (still strictly stronger than ``Path.exists``)."""
    path = Path(path)
    try:
        if not path.is_file():
            return False
        probe = _PROBES.get(path.suffix.lower())
        if probe is None:
            return path.stat().st_size > 0
        return probe(path)
    except OSError:
        return False


def file_digest(path, algo: str = "sha256") -> str:
    """Sidecar digest of a finished artifact, ``"sha256:<hex>"`` — what the
    run ledger records per artifact and re-checks on verified resume."""
    h = hashlib.new(algo)
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return f"{algo}:{h.hexdigest()}"


def verify_digest(path, digest: str) -> bool:
    """True iff ``path`` exists and hashes to ``digest`` (same algo)."""
    try:
        algo = digest.split(":", 1)[0]
        return file_digest(path, algo) == digest
    except (OSError, ValueError):
        return False
