"""Seeded fault injection at the z-exchange seam (the port's copy of
``disco_tpu/fault/inject.py``: the same plan for the same spec).

:func:`plan_faults` expands a declarative :class:`~disco_tpu_torch.fault.spec.FaultSpec`
into a concrete :class:`FaultPlan` for one (K nodes, B blocks) run: a
``(K, B)`` per-source availability matrix, per-node NaN-corruption flags,
and a host-side list of every injected fault (the ``fault`` events that
:meth:`FaultPlan.record` emits through ``disco_tpu_torch.obs``).

The plan is what the pipeline actually consumes:

* offline ``tango``: ``plan.avail_offline`` (``(K,)`` — a stream counts as
  available only if delivered in *every* block, since the offline
  frame-mean covariance spans the whole clip) and ``plan.z_nan`` (real NaN
  injection, detected and excluded by the finiteness guard at the
  exchange).
* ``streaming_tango``: ``plan.avail_streaming`` (``(K, B)`` — lost/stale
  blocks are bridged by the last-good-z hold policy; NaN corruption folds
  into unavailability because a single NaN would poison the recursive
  covariances forever).

Determinism contract (tests/test_fault.py): all randomness comes from
``np.random.default_rng(spec.seed)`` with draws in a fixed order —
dropout ``(K,)``, link loss ``(K, B)``, stale ``(K, B)``, nan ``(K,)`` —
drawn unconditionally so toggling one probability never reshuffles the
others' streams.

No reference counterpart: the reference assumes a perfect in-process
z-exchange; fault injection exists only in this rebuild.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A spec expanded against concrete (K, B) dimensions.  All arrays are
    host numpy — the plan is built before any device work and is what the
    telemetry describes."""

    spec: "FaultSpec"
    n_nodes: int
    n_blocks: int
    avail: np.ndarray  # (K, B) float32: 1 = z_k delivered in block b
    z_nan: np.ndarray  # (K,) bool: NaN-corrupt node k's exchanged streams
    faults: tuple[dict, ...]  # host-side description of every injected fault

    @property
    def avail_offline(self) -> np.ndarray:
        """(K,) availability for the offline pipeline: the frame-mean
        covariances span the whole clip, so a partially-delivered stream is
        conservatively excluded (available only if delivered every block)."""
        return self.avail.min(axis=1)

    @property
    def avail_streaming(self) -> np.ndarray:
        """(K, B) availability for the streaming pipeline, with NaN-corrupted
        nodes folded in as unavailable (the hold policy bridges them; real
        NaNs would poison the recursive covariance state forever)."""
        return self.avail * (~self.z_nan[:, None]).astype(self.avail.dtype)

    def any_fault(self) -> bool:
        return bool(self.faults)

    def record(self, mode: str | None = None) -> None:
        """Emit one ``fault`` event per injected fault plus the injection
        counters (``faults_injected``, ``fault_blocks_lost``) through
        ``disco_tpu_torch.obs``; the events are a no-op while recording is
        off."""
        from disco_tpu_torch.obs import events as obs_events
        from disco_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.counter("faults_injected").inc(len(self.faults))
        n_lost = int((self.avail < 1.0).sum())
        if n_lost:
            REGISTRY.counter("fault_blocks_lost").inc(n_lost)
        if not obs_events.enabled():
            return
        for f in self.faults:
            attrs = {k: v for k, v in f.items() if k != "fault"}
            if mode is not None:
                attrs["mode"] = mode
            obs_events.record("fault", stage="inject", fault=f["fault"], **attrs)

    def n_unavailable_offline(self) -> int:
        return int((self.avail_offline < 1.0).sum())


def plan_faults(spec, n_nodes: int, n_blocks: int = 1) -> FaultPlan:
    """Expand ``spec`` into a :class:`FaultPlan` for ``n_nodes`` sources and
    ``n_blocks`` exchange blocks (offline callers pass ``n_blocks=1``)."""
    from disco_tpu_torch.fault.spec import load_fault_spec

    spec = load_fault_spec(spec)
    spec.validate_for(n_nodes)
    K, B = int(n_nodes), max(int(n_blocks), 1)
    rng = np.random.default_rng(spec.seed)
    avail = np.ones((K, B), np.float32)
    z_nan = np.zeros(K, bool)
    faults: list[dict] = []

    # Fixed draw order (module docstring): dropout, link loss, stale, nan.
    drop_draw = rng.random(K)
    link_draw = rng.random((K, B))
    stale_draw = rng.random((K, B))
    nan_draw = rng.random(K)

    dropped = set(spec.node_dropout)
    for k in range(K):
        if k not in dropped and drop_draw[k] < spec.dropout_prob:
            dropped.add(k)
    for k in sorted(dropped):
        avail[k, :] = 0.0
        faults.append({"fault": "node_dropout", "node": k})

    link_nodes = set(spec.link_loss_nodes) if spec.link_loss_nodes is not None else set(range(K))
    for k in range(K):
        if k in dropped:
            continue
        lost = np.zeros(B, bool)
        if k in link_nodes and spec.link_loss_prob:
            lost |= link_draw[k] < spec.link_loss_prob
        stale = stale_draw[k] < spec.stale_prob if spec.stale_prob else np.zeros(B, bool)
        stale &= ~lost
        if lost.any():
            avail[k, lost] = 0.0
            faults.append(
                {"fault": "link_loss", "node": k, "n_blocks": int(lost.sum()),
                 "blocks": np.flatnonzero(lost).tolist()}
            )
        if stale.any():
            avail[k, stale] = 0.0
            faults.append(
                {"fault": "stale_delivery", "node": k, "n_blocks": int(stale.sum()),
                 "blocks": np.flatnonzero(stale).tolist()}
            )

    nan_nodes = set(spec.nan_z)
    for k in range(K):
        if k not in nan_nodes and nan_draw[k] < spec.nan_prob:
            nan_nodes.add(k)
    for k in sorted(nan_nodes):
        if k in dropped:
            continue  # a dropped node's z never arrives; nothing to corrupt
        z_nan[k] = True
        faults.append({"fault": "nan_z", "node": k})

    return FaultPlan(
        spec=spec, n_nodes=K, n_blocks=B, avail=avail, z_nan=z_nan, faults=tuple(faults)
    )
