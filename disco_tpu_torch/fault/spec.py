"""Declarative, seeded fault specifications for the TANGO network seams (the
port's copy of ``disco_tpu/fault/spec.py``).

The reference pipeline — and our port until this module — assumes every
node's compressed signal ``z_k`` arrives intact at every other node
(``tango_step2`` hard-concatenates all K-1 exchanged streams).  A real
ad-hoc wireless acoustic sensor network loses nodes, drops links for a few
blocks, and occasionally delivers corrupted or stale packets.  A
:class:`FaultSpec` names those scenarios declaratively; the injector
(``disco_tpu_torch.fault.inject``) turns one into a concrete, seeded
:class:`~disco_tpu_torch.fault.inject.FaultPlan` that the pipeline consumes as a
``(K,)``/``(K, B)`` availability mask plus per-node NaN-corruption flags.

No reference counterpart: the reference has no fault model at all (its
"network" is ``np.concatenate``, tango.py:142-155).  The spec format is the
one documented in ``doc/source/robustness.rst``.

Fault kinds:

* ``node_dropout`` / ``dropout_prob`` — a node's z never arrives anywhere
  (listed node ids, plus an optional per-node Bernoulli).
* ``link_loss_prob`` (optionally restricted to ``link_loss_nodes``) — a
  node's z is lost for individual blocks of ``update_every`` frames: the
  per-(node, block) Bernoulli of intermittent radio loss.
* ``stale_prob`` — a block's z arrives too late to use; the streaming
  consumer reuses the previous block's z (mechanically identical to a
  per-block loss under the last-good-z hold policy, tracked as its own
  fault kind in telemetry).
* ``nan_z`` / ``nan_prob`` — a node's exchanged streams are corrupted to
  NaN.  The offline pipeline *injects real NaNs* and relies on the
  finiteness guard at the z-exchange seam to detect and exclude them; the
  streaming pipeline (whose recursive covariances a single NaN would poison
  forever) realizes corruption as unavailability.

Every random draw comes from ``np.random.default_rng(seed)`` in a fixed
documented order, so the same (spec, seed, K, B) always yields the same
plan — the determinism contract pinned by tests/test_fault.py.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

_FAULT_FIELDS = (
    "seed",
    "node_dropout",
    "dropout_prob",
    "link_loss_prob",
    "link_loss_nodes",
    "stale_prob",
    "nan_z",
    "nan_prob",
)


def _as_node_tuple(v, field: str) -> tuple[int, ...]:
    if v is None:
        return ()
    # bool is an int subclass: 'node_dropout: true' would otherwise silently
    # become node id 1 — reject it as the malformed spec it is
    if isinstance(v, bool):
        raise ValueError(f"fault spec {field!r}: expected a list of node ids, got {v!r}")
    if isinstance(v, (int,)):
        return (int(v),)
    try:
        if any(isinstance(x, bool) for x in v):
            raise ValueError
        nodes = tuple(int(x) for x in v)
    except (TypeError, ValueError):
        raise ValueError(f"fault spec {field!r}: expected a list of node ids, got {v!r}") from None
    if any(n < 0 for n in nodes):
        raise ValueError(f"fault spec {field!r}: node ids must be >= 0, got {nodes}")
    return nodes


def _as_prob(v, field: str) -> float:
    try:
        p = float(v)
    except (TypeError, ValueError):
        raise ValueError(f"fault spec {field!r}: expected a probability, got {v!r}") from None
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"fault spec {field!r}: probability must be in [0, 1], got {p}")
    return p


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault scenario (see module docstring for semantics).

    Immutable and hashable so it can ride through functools caches and be
    embedded in run manifests; ``to_dict``/``from_dict`` round-trip the
    YAML/JSON file format consumed by ``--fault-spec``.
    """

    seed: int = 0
    node_dropout: tuple[int, ...] = ()
    dropout_prob: float = 0.0
    link_loss_prob: float = 0.0
    link_loss_nodes: tuple[int, ...] | None = None
    stale_prob: float = 0.0
    nan_z: tuple[int, ...] = ()
    nan_prob: float = 0.0

    def __post_init__(self):
        try:
            object.__setattr__(self, "seed", int(self.seed))
        except (TypeError, ValueError):
            raise ValueError(
                f"fault spec 'seed': expected an integer, got {self.seed!r}"
            ) from None
        object.__setattr__(self, "node_dropout", _as_node_tuple(self.node_dropout, "node_dropout"))
        object.__setattr__(self, "dropout_prob", _as_prob(self.dropout_prob, "dropout_prob"))
        object.__setattr__(self, "link_loss_prob", _as_prob(self.link_loss_prob, "link_loss_prob"))
        if self.link_loss_nodes is not None:
            object.__setattr__(
                self, "link_loss_nodes", _as_node_tuple(self.link_loss_nodes, "link_loss_nodes")
            )
        object.__setattr__(self, "stale_prob", _as_prob(self.stale_prob, "stale_prob"))
        object.__setattr__(self, "nan_z", _as_node_tuple(self.nan_z, "nan_z"))
        object.__setattr__(self, "nan_prob", _as_prob(self.nan_prob, "nan_prob"))

    def any_fault(self) -> bool:
        """True when this spec can inject anything at all (an all-defaults
        spec is the explicit 'no faults' scenario)."""
        return bool(
            self.node_dropout
            or self.nan_z
            or self.dropout_prob
            or self.link_loss_prob
            or self.stale_prob
            or self.nan_prob
        )

    def validate_for(self, n_nodes: int) -> None:
        """Raise ``ValueError`` if the spec names nodes outside ``[0, K)``."""
        for field in ("node_dropout", "nan_z", "link_loss_nodes"):
            nodes = getattr(self, field) or ()
            bad = [n for n in nodes if n >= n_nodes]
            if bad:
                raise ValueError(
                    f"fault spec {field!r} names node(s) {bad} but the array has "
                    f"{n_nodes} nodes (ids 0..{n_nodes - 1})"
                )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["node_dropout"] = list(d["node_dropout"])
        d["nan_z"] = list(d["nan_z"])
        if d["link_loss_nodes"] is not None:
            d["link_loss_nodes"] = list(d["link_loss_nodes"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        if not isinstance(d, dict):
            raise ValueError(f"fault spec: expected a mapping, got {type(d).__name__}")
        unknown = sorted(set(d) - set(_FAULT_FIELDS))
        if unknown:
            raise ValueError(
                f"fault spec: unknown field(s) {unknown}; known fields: {list(_FAULT_FIELDS)}"
            )
        return cls(**d)


def load_fault_spec(source) -> FaultSpec:
    """Load a :class:`FaultSpec` from a dict, a YAML/JSON file path, or an
    existing spec (pass-through) — the ``--fault-spec`` entry point.

    YAML files use the same keys as :meth:`FaultSpec.to_dict`; a JSON file
    is just YAML that happens to use braces.
    """
    if isinstance(source, FaultSpec):
        return source
    if isinstance(source, dict):
        return FaultSpec.from_dict(source)
    path = Path(source)
    text = path.read_text()
    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        try:
            d = yaml.safe_load(text)
        except yaml.YAMLError as e:
            # a ValueError naming the file, not a parser traceback
            raise ValueError(f"{path}: not valid YAML/JSON: {e}") from None
    if d is None:
        d = {}
    if not isinstance(d, dict):
        raise ValueError(f"{path}: fault spec must be a mapping of fields, got {type(d).__name__}")
    return FaultSpec.from_dict(d)
