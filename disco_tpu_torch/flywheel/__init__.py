"""disco_tpu_torch.flywheel — the serve -> train learning loop (the port's
counterpart of ``disco_tpu/flywheel``).

* :mod:`.tap` — :class:`CorpusTap`, a never-blocking spool on the serve
  scheduler's post-readback seam that rotates delivered blocks into shard
  files on a host-only writer thread (overflow drops and counts).
* :mod:`.shards` — the self-describing atomic shard format (complex-split
  wire codec, embedded sha256, ``probe_shard``), the JAX package's bytes.
* :mod:`.dataset` — :class:`ShardDataset`, the streaming reader: seeded
  shuffle (the JAX package's windows in its order), ledger-verified
  resume, corrupt-shard skip, ``fit``-ready batch callables.
* :mod:`.resident` — :class:`ResidentTrainer`, the co-resident trainer:
  bounded slices of train steps on the serve scheduler's dispatch thread,
  ledger-restartable, ladder-throttled, publishing generations through the
  promotion store.
* :mod:`.check` — the loop's legs as functions of a device.

``shards``, ``tap`` and ``dataset`` import no torch: the tap's writer
thread runs them beside the dispatch thread that owns the card.
"""
from disco_tpu_torch.flywheel.dataset import ShardDataset, peek_geometry, unit_shard_epoch
from disco_tpu_torch.flywheel.resident import ResidentTrainer
from disco_tpu_torch.flywheel.shards import (
    RECORD_ARRAYS,
    SHARD_SUFFIX,
    SHARD_VERSION,
    ShardError,
    list_shards,
    probe_shard,
    read_shard,
    unit_shard,
    write_shard,
)
from disco_tpu_torch.flywheel.tap import MANIFEST_NAME, CorpusTap

__all__ = [
    "CorpusTap",
    "MANIFEST_NAME",
    "RECORD_ARRAYS",
    "ResidentTrainer",
    "SHARD_SUFFIX",
    "SHARD_VERSION",
    "ShardDataset",
    "ShardError",
    "list_shards",
    "peek_geometry",
    "probe_shard",
    "read_shard",
    "unit_shard",
    "unit_shard_epoch",
    "write_shard",
]
