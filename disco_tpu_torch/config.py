"""One typed configuration tree (the port's copy of ``disco_tpu/config.py``).

The same dataclasses, fields and defaults as the JAX package's — every
default a canonical value of the reference (citations inline) — and the
same loaders, so one file configures either package: :func:`config_from_dict`
builds a :class:`DiscoConfig` from nested dicts, :func:`load_config` reads a
JSON or YAML file into it and :func:`save_config` writes one back as YAML.

Files: :func:`read_config_file` parses JSON first and YAML only when the
text is not JSON, importing ``yaml`` then (a JSON file needs no YAML
parser; ``fault/spec.py`` reads fault specs the same way).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from disco_tpu_torch.sim.defaults import RoomDefaults, SignalDefaults


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Reference tango.py:28-29, post_generator.py:27-28."""

    n_fft: int = 512
    hop: int = 256
    fs: int = 16000

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """The 4-node x 4-mic circular WASN geometry (tango.py:30-32,
    convolve_signals.py:362-363)."""

    mics_per_node: tuple = (4, 4, 4, 4)
    ref_mics: tuple = (0, 0, 0, 0)
    radius_m: float = 0.05

    @property
    def n_nodes(self) -> int:
        return len(self.mics_per_node)

    @property
    def n_channels(self) -> int:
        return int(sum(self.mics_per_node))


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """TANGO inference constants (tango.py:33-38, speech_enhancement/utils.py:7-10)."""

    win_len: int = 21
    pred_frame: str = "mid"  # 'first' | 'mid' | 'last'
    snr_range: tuple = ((0, 6),)
    mu: float = 1.0
    filter_type: str = "gevd"
    rank: int = 1
    # rank-1 GEVD solver spec: 'eigh' | 'power' | 'power:N' | 'jacobi' |
    # 'jacobi-pallas' | 'fused' | 'fused-xla' | 'fused-pallas' (all with
    # optional ':N'; beam.filters.rank1_gevd).  The TANGO CLI resolves its
    # solver as: explicit --solver > enhance.solver from a --config file >
    # the driver's mode-aware default (cli/tango.py resolve_solver); this
    # field's default is the JAX package's.
    solver: str = "power"
    stft_clip: tuple = (1e-6, 1e3)
    frames_lost: int = 6  # conv-cropped frames of the CRNN (utils.py:10)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """CRNN training hyperparameters (train.py:66-85, crnn.py:105,
    datasets.py:6-9)."""

    archi: str = "crnn"
    batch_size: int = 500
    epochs: int = 150
    lr: float = 1e-3
    optimizer: str = "rmsprop"
    win_len: int = 21
    win_hop: int = 8
    val_split: float = 0.0909
    output_frames: str = "all"
    grad_clip: float | None = None
    train_dur_s: float = 11.0
    early_stop_patience: int = 10
    # CRNN architecture (dnn/utils.py:145-151)
    filters: tuple = (32, 64, 64)
    kernel: tuple = (3, 3)
    pool: tuple = (1, 4)
    rnn_units: int = 256
    ff_units: int = 257


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    """Corpus shape (tango.py:43-45, post_generator.py:49-50)."""

    n_train: int = 10000
    n_val: int = 1000
    n_test: int = 1000
    scenario: str = "living"
    noise: str = "ssn"

    @property
    def splits(self) -> tuple:
        return (self.n_train, self.n_val, self.n_test)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh dims of the sharded pipelines (SURVEY.md §2.9): ``n_node``
    ranks over the nodes, ``n_batch`` over clips, ``n_frame`` over STFT
    frames.  ``disco_tpu_torch.parallel.mesh_from_config`` builds the
    ``torch.distributed`` DeviceMesh it describes over a world of that many
    ranks (one process a card)."""

    n_node: int | None = None  # None -> every rank the other dims leave
    n_batch: int = 1
    n_frame: int = 1  # sequence-parallel frame-axis shards


@dataclasses.dataclass(frozen=True)
class DiscoConfig:
    """The root of the tree."""

    root: str = "dataset"
    stft: StftConfig = StftConfig()
    array: ArrayConfig = ArrayConfig()
    enhance: EnhanceConfig = EnhanceConfig()
    train: TrainConfig = TrainConfig()
    corpus: CorpusConfig = CorpusConfig()
    mesh: MeshConfig = MeshConfig()
    room: RoomDefaults = RoomDefaults()
    signal: SignalDefaults = SignalDefaults()


_SECTIONS = {
    "stft": StftConfig,
    "array": ArrayConfig,
    "enhance": EnhanceConfig,
    "train": TrainConfig,
    "corpus": CorpusConfig,
    "mesh": MeshConfig,
    "room": RoomDefaults,
    "signal": SignalDefaults,
}


def _to_plain(obj):
    """Dataclass tree -> YAML-safe nested dict (tuples become lists)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_to_plain(v) for v in obj]
    if hasattr(obj, "item"):  # numpy scalar
        return obj.item()
    return obj


def _tuplify(v):
    return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v


def config_from_dict(d: dict) -> DiscoConfig:
    """Build a :class:`DiscoConfig` from a nested dict, applying defaults for
    anything absent and tuplifying lists (YAML and JSON have no tuples)."""
    kwargs = {}
    for name, section in d.items():
        if name in _SECTIONS:
            cls = _SECTIONS[name]
            valid = {f.name for f in dataclasses.fields(cls)}
            unknown = set(section) - valid
            if unknown:
                raise ValueError(f"unknown keys in config section {name!r}: {sorted(unknown)}")
            kwargs[name] = cls(**{k: _tuplify(v) for k, v in section.items()})
        elif name == "root":
            kwargs["root"] = section
        else:
            raise ValueError(f"unknown config section {name!r}")
    return DiscoConfig(**kwargs)


def read_config_file(path):
    """The parsed contents of a JSON or YAML config file (None when empty):
    JSON first, then YAML, whose parser is imported only then."""
    text = Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def load_config(path) -> DiscoConfig:
    """Load a JSON or YAML file into a config (via :func:`config_from_dict`)."""
    return config_from_dict(read_config_file(path) or {})


def save_config(cfg: DiscoConfig, path) -> Path:
    """Write the config back to YAML at ``path`` (inverse of
    :func:`load_config`; the JAX package's file, which either package
    loads)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(_to_plain(cfg), fh, sort_keys=False)
    return path
