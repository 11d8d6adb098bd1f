"""The generation store: immutable, digest-addressed CRNN weight bundles
(the port's counterpart of ``disco_tpu/promote/store.py``: the same files,
so a generation staged by either package is served by the other's store).

A *weight generation* is the unit of live rollout: the inference slice of
a training checkpoint (``params`` + ``batch_stats`` in the flax module's
layout, never the optimizer state) serialized to canonical bytes, named
by the digest of those bytes, and written once through
:func:`disco_tpu_torch.io.atomic.atomic_write`, so a generation on disk is
complete or absent.

The bytes are the JAX package's: the JAX store hashes
``flax.serialization.msgpack_serialize(to_state_dict(tree))`` of the
key-sorted tree, and the port writes the same key-sorted tree through
:func:`disco_tpu_torch.nn.serialization.packb`, which writes flax's
ndarray extension byte for byte.  The same numpy weights therefore give
the same ``weights.msgpack`` and the same ``gen_id`` in both packages.
A port module enters as :meth:`GenerationStore.stage_module`
(``nn.convert.flax_from_state_dict`` of its state dict).

Layout under one promote dir::

    <root>/generations/<gen_id>/weights.msgpack   immutable weight bytes
    <root>/generations/<gen_id>/meta.json         arch kwargs + provenance
    <root>/ACTIVE                                 gen_id of the live generation
    <root>/rollouts.jsonl                         the rollout RunLedger

``meta.json`` is written after the weights (its presence marks the
generation complete), and ``ACTIVE`` is a one-line pointer file replaced
atomically: the restart truth for the generation every resumed session
adopts.  Staging is idempotent (same weights -> same digest -> same
generation) and ledger-aware: a checkpoint of a run whose latest
``epoch:*`` unit is still ``in_flight`` is refused with
:class:`PublishRefused` naming the unit.

The module imports no torch: listing, staging numpy trees and the rollout
ledger are host work.  :meth:`GenerationStore.load` builds a port CRNN
(torch imported there).  The JAX package caches one flax module per
architecture so that a swap never retraces; the port has no trace to
protect, and ``load`` builds one module per call (the scheduler keeps one
per generation on its device).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path

from disco_tpu_torch.io.atomic import atomic_write, file_digest, write_bytes_atomic
from disco_tpu_torch.runs.ledger import RunLedger

#: The inference slice of a training checkpoint (``save_checkpoint``
#: payload keys) that a generation carries.  Optimizer state stays behind.
WEIGHT_KEYS = ("params", "batch_stats")

#: Name of the atomic pointer file naming the live generation.
ACTIVE_FILE = "ACTIVE"

#: ``arch`` keys that configure the optimizer (the JAX ``build_crnn``
#: returns one), not the module: the port's ``build_crnn`` does not take them.
_OPTIMIZER_KEYS = ("learning_rate", "clip_grad_norm")


class PublishRefused(RuntimeError):
    """A candidate checkpoint was refused at the publish seam.  ``unit``
    names the offending run-ledger unit (e.g. ``"epoch:3"``) when the
    refusal came from an interrupted training run."""

    def __init__(self, message: str, unit: str | None = None):
        super().__init__(message)
        self.unit = unit


@dataclasses.dataclass(frozen=True)
class Generation:
    """One immutable staged weight generation."""

    gen_id: str        # "g" + first 12 hex chars of the weight digest
    path: Path         # <root>/generations/<gen_id>
    digest: str        # "sha256:<hex>" over the canonical weight bytes
    serial: int        # staging order (1-based): the weight_generation gauge
    arch: dict         # build_crnn(**arch) kwargs
    meta: dict         # full meta.json payload

    @property
    def weights_path(self) -> Path:
        return self.path / "weights.msgpack"


def _canonical(tree):
    """Recursively key-sort a tree of dicts, so the bytes (and the digest)
    do not depend on insertion order."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    return tree


def _ledger_in_flight_epoch(ledger_path) -> str | None:
    """The first ``epoch:*`` unit whose latest recorded state is still
    ``in_flight`` (an interrupted training run), or None for a clean run."""
    latest = RunLedger(ledger_path).replay()
    for unit in sorted(latest):
        if unit.startswith("epoch:") and latest[unit]["state"] == "in_flight":
            return unit
    return None


def model_for_arch(arch: dict):
    """A port CRNN built by ``nn.crnn.build_crnn(**arch)`` (the optimizer
    keys of ``arch`` left out) on the CPU, in eval mode, its weights the
    constructor's."""
    import torch

    from disco_tpu_torch.nn.crnn import build_crnn

    kw = {k: v for k, v in arch.items() if k not in _OPTIMIZER_KEYS}
    with torch.random.fork_rng(devices=[]):  # the caller's generator stays as it was
        model = build_crnn(**kw)
    return model.eval()


class GenerationStore:
    """Digest-addressed weight generations under one promote dir.

    All writes go through ``io.atomic``; all methods are safe from any
    thread (staging takes no lock: idempotence by digest makes concurrent
    stages of the same weights converge on the same files).
    """

    def __init__(self, root):
        self.root = Path(root)
        (self.root / "generations").mkdir(parents=True, exist_ok=True)

    # -- staging -------------------------------------------------------------
    def stage_checkpoint(self, ckpt_path, *, arch: dict, ledger=None,
                         source: str | None = None) -> Generation:
        """Stage a training checkpoint (``nn.training.save_checkpoint``
        payload, written by either package) as a weight generation.
        ``ledger``: the training run's ledger path — a run whose latest
        ``epoch:*`` unit is still ``in_flight`` is refused with
        :class:`PublishRefused` naming the unit.  Idempotent."""
        import numpy as np

        from disco_tpu_torch.nn.serialization import unpackb

        ckpt_path = Path(ckpt_path)
        if ledger is not None:
            unit = _ledger_in_flight_epoch(ledger)
            if unit is not None:
                raise PublishRefused(
                    f"refusing to stage {ckpt_path.name}: training run "
                    f"ledger {Path(ledger).name} shows unit {unit!r} still "
                    f"in_flight — the checkpoint on disk predates an "
                    f"interrupted epoch and is not a finished candidate",
                    unit=unit,
                )
        try:
            payload = unpackb(ckpt_path.read_bytes())
            if not isinstance(payload, dict):
                raise ValueError(f"a {type(payload).__name__}, not a map")
        except Exception as e:
            raise PublishRefused(
                f"refusing to stage {ckpt_path.name}: not a readable "
                f"checkpoint ({type(e).__name__}: {e})"
            ) from e
        missing = [k for k in WEIGHT_KEYS if k not in payload]
        if missing:
            raise PublishRefused(
                f"refusing to stage {ckpt_path.name}: checkpoint payload "
                f"missing {missing} (keys: {sorted(payload)})"
            )
        variables = {k: payload[k] for k in WEIGHT_KEYS}
        extra = {"source_ckpt": str(ckpt_path),
                 "source_ckpt_digest": file_digest(ckpt_path)}
        n_done = None
        if "epochs_done" in payload:
            try:
                n_done = int(np.asarray(payload["epochs_done"]).reshape(()))
                extra["epochs_done"] = float(n_done)
            except (TypeError, ValueError):
                pass
        for k in ("val_loss", "train_loss"):
            # the payload carries the whole zero-padded loss history: the
            # meta scalar is the last completed epoch's value
            if k in payload:
                try:
                    hist = np.asarray(payload[k], np.float64).reshape(-1)
                except (TypeError, ValueError):
                    continue
                if n_done is not None:
                    hist = hist[:n_done]
                if hist.size:
                    extra[k] = float(hist[-1])
        return self.stage_variables(variables, arch=arch, source=source, **extra)

    def stage_variables(self, variables: dict, *, arch: dict,
                        source: str | None = None, **extra) -> Generation:
        """Stage an in-memory ``{"params", "batch_stats"}`` tree of numpy
        arrays in the flax module's layout.  Writes weights then meta,
        each atomically; returns the (possibly pre-existing)
        :class:`Generation`."""
        from disco_tpu_torch.nn.serialization import packb

        variables = {k: variables[k] for k in WEIGHT_KEYS}
        blob = packb(_canonical(variables))
        digest = "sha256:" + hashlib.sha256(blob).hexdigest()
        gen_id = "g" + digest.split(":", 1)[1][:12]
        gen_dir = self.root / "generations" / gen_id
        meta_path = gen_dir / "meta.json"
        if meta_path.exists():
            return self.get(gen_id)
        gen_dir.mkdir(parents=True, exist_ok=True)
        write_bytes_atomic(gen_dir / "weights.msgpack", blob)
        meta = {
            "gen": gen_id,
            "digest": digest,
            "serial": len(self.list_ids()) + 1,
            "arch": dict(arch),
            "source": source,
            "staged_t": time.time(),
            **extra,
        }
        with atomic_write(meta_path, mode="w", encoding="utf-8") as fh:
            json.dump(meta, fh, sort_keys=True, indent=1)
            fh.write("\n")
        return Generation(gen_id=gen_id, path=gen_dir, digest=digest,
                          serial=int(meta["serial"]), arch=dict(arch), meta=meta)

    def stage_module(self, model, *, arch: dict, source: str | None = None,
                     **extra) -> Generation:
        """Stage a port CRNN's weights: its state dict in the flax layout
        (``nn.convert.flax_from_state_dict``), then :meth:`stage_variables`.
        The weights are read back to the host here."""
        from disco_tpu_torch.nn.convert import flax_from_state_dict

        return self.stage_variables(flax_from_state_dict(model.state_dict(), model),
                                    arch=arch, source=source, **extra)

    # -- reading -------------------------------------------------------------
    def list_ids(self) -> list:
        """Complete generation ids (meta.json present), staging order."""
        gens = []
        base = self.root / "generations"
        for d in base.iterdir() if base.is_dir() else ():
            if (d / "meta.json").is_file():
                gens.append(self.get(d.name))
        return [g.gen_id for g in sorted(gens, key=lambda g: g.serial)]

    def get(self, gen_id: str) -> Generation:
        """One generation's metadata (``FileNotFoundError`` for an unknown
        or incomplete generation)."""
        gen_dir = self.root / "generations" / gen_id
        meta = json.loads((gen_dir / "meta.json").read_text())
        return Generation(gen_id=gen_id, path=gen_dir, digest=meta["digest"],
                          serial=int(meta["serial"]), arch=dict(meta["arch"]), meta=meta)

    def read_variables(self, gen_id: str) -> dict:
        """The host ``{"params", "batch_stats"}`` tree of one generation,
        its weight file digest-verified first: a torn or tampered file
        raises :class:`PublishRefused`, never gives silent garbage masks."""
        from disco_tpu_torch.nn.serialization import unpackb

        gen = self.get(gen_id)
        actual = file_digest(gen.weights_path)
        if actual != gen.digest:
            raise PublishRefused(
                f"generation {gen_id}: weight file digest {actual} does not "
                f"match staged digest {gen.digest} — torn or corrupt file"
            )
        return unpackb(gen.weights_path.read_bytes())

    def load(self, gen_id: str, device=None):
        """(model, variables) for one generation: a port CRNN of its arch
        (:func:`model_for_arch`) holding its weights
        (``nn.convert.state_dict_from_flax``), on ``device`` (the CPU when
        None) in eval mode, and the host flax-layout tree.  Digest-verified
        first (:meth:`read_variables`)."""
        from disco_tpu_torch.nn.convert import state_dict_from_flax

        variables = self.read_variables(gen_id)
        model = model_for_arch(self.get(gen_id).arch)
        model.load_state_dict(state_dict_from_flax(variables, model))
        if device is not None:
            model = model.to(device)
        return model, variables

    # -- the ACTIVE pointer --------------------------------------------------
    def active(self) -> str | None:
        """gen_id of the live generation, or None before first activation."""
        path = self.root / ACTIVE_FILE
        if not path.is_file():
            return None
        gen_id = path.read_text().strip()
        return gen_id or None

    def set_active(self, gen_id: str) -> None:
        """Atomically repoint ``ACTIVE`` (the promotion commit point: after
        this rename, every restart adopts ``gen_id``)."""
        self.get(gen_id)   # unknown/incomplete generations must not go live
        write_bytes_atomic(self.root / ACTIVE_FILE, (gen_id + "\n").encode())

    # -- retention -------------------------------------------------------------
    def collect(self, *, keep_last: int, pinned=()) -> list:
        """Bounded retention: delete every complete generation except the
        ACTIVE one, the ``keep_last`` most recently staged (by serial), the
        candidate/incumbent of any rollout whose ledger unit is still
        ``in_flight``, and anything in ``pinned``.  Returns the collected
        gen_ids, oldest first; ticks ``generations_collected`` and records
        one ``promotion`` ``action="collected"`` event per sweep that
        removed anything.  Opt-in only."""
        import shutil

        from disco_tpu_torch.obs import events as obs_events
        from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry

        if keep_last < 0:
            raise ValueError(f"keep_last must be >= 0, got {keep_last}")
        ids = self.list_ids()      # serial order, oldest first
        keep = set(pinned)
        active = self.active()
        if active is not None:
            keep.add(active)
        keep.update(ids[len(ids) - keep_last:] if keep_last else ())
        for unit, rec in RunLedger(self.root / "rollouts.jsonl").replay().items():
            if not unit.startswith("rollout:") or rec["state"] != "in_flight":
                continue
            keep.add(unit.split(":", 1)[1])
            incumbent = (rec.get("attrs") or {}).get("incumbent")
            if incumbent:
                keep.add(incumbent)
        collected = []
        for gen_id in ids:
            if gen_id in keep:
                continue
            # meta first: a crash mid-delete leaves an incomplete dir (no
            # meta.json), which every reader treats as absent
            gen_dir = self.root / "generations" / gen_id
            (gen_dir / "meta.json").unlink(missing_ok=True)
            shutil.rmtree(gen_dir, ignore_errors=True)
            collected.append(gen_id)
        if collected:
            obs_registry.counter("generations_collected").inc(len(collected))
            obs_events.record("promotion", stage="promote", action="collected",
                              gens=collected, keep_last=int(keep_last), kept=len(keep))
        return collected

    # -- the rollout ledger ----------------------------------------------------
    def rollout_ledger(self) -> RunLedger:
        """The store's rollout ledger (``rollouts.jsonl``): one
        ``rollout:<gen_id>`` unit per attempted promotion, the phase in its
        attrs.  Callers own closing it."""
        return RunLedger(self.root / "rollouts.jsonl")
