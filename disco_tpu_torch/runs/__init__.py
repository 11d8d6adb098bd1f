"""Crash-safe run management for the corpus driver, dataset
generation and training (counterpart of
``disco_tpu/runs``): the append-only run ledger with verified resume
(:mod:`~disco_tpu_torch.runs.ledger`), graceful SIGTERM/SIGINT handling
(:mod:`~disco_tpu_torch.runs.interrupt`) and deterministic crash injection
at named seams (:mod:`~disco_tpu_torch.runs.chaos`).  Atomic artifact
writes and integrity probes live in :mod:`disco_tpu_torch.io.atomic`."""
from disco_tpu_torch.runs.chaos import ChaosCrash
from disco_tpu_torch.runs.interrupt import GracefulInterrupt, request_stop, stop_requested
from disco_tpu_torch.runs.ledger import (
    RunLedger,
    digest_artifacts,
    unit_epoch,
    unit_rir,
    unit_scene,
)

__all__ = [
    "ChaosCrash",
    "GracefulInterrupt",
    "RunLedger",
    "digest_artifacts",
    "request_stop",
    "stop_requested",
    "unit_epoch",
    "unit_rir",
    "unit_scene",
]
