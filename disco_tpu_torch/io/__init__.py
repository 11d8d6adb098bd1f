"""Corpus I/O of the port (counterpart of ``disco_tpu/io``): WAV read/write,
atomic artifact writers and probes, the dataset layout, batched WAV reads."""
from disco_tpu_torch.io.atomic import (
    atomic_write,
    dump_pickle_atomic,
    file_digest,
    probe_artifact,
    save_npy_atomic,
    savez_atomic,
    verify_digest,
    write_bytes_atomic,
    write_wav_atomic,
)
from disco_tpu_torch.io.audio import read_wav, write_wav
from disco_tpu_torch.io.fastwav import read_wavs_batch
from disco_tpu_torch.io.layout import DatasetLayout

__all__ = [
    "DatasetLayout",
    "atomic_write",
    "dump_pickle_atomic",
    "file_digest",
    "probe_artifact",
    "read_wav",
    "read_wavs_batch",
    "save_npy_atomic",
    "savez_atomic",
    "verify_digest",
    "write_bytes_atomic",
    "write_wav",
    "write_wav_atomic",
]
