"""The port's copy of the training hyperparameters of
``disco_tpu/config.py::TrainConfig`` (reference train.py:66-85,
crnn.py:105, datasets.py:6-9).

The JAX package keeps one typed configuration tree with a YAML round trip;
the port needs only the training block so far, and keeps it here as a plain
frozen dataclass with the same fields and defaults.
"""
from __future__ import annotations

import dataclasses


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
