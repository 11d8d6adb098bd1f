"""The fault-tolerance gate (the port's counterpart of
``disco_tpu/fault/check.py``).

Builds a synthetic scene, injects a node dropout plus a NaN-corrupted z
through the declarative spec machinery, runs the two-step TANGO in degraded
mode with recording on, and asserts the robustness contract:

* every consumer's enhanced output is finite (the dropped and corrupted
  streams were excluded, not propagated);
* the fault-free run of the SAME scene is finite too and differs from the
  degraded one (the injection reached the pipeline);
* the event log carries one ``node_dropout`` and one ``nan_z`` ``fault``
  event and a ``degraded`` entry, and the counters snapshot shows the
  injections.

:func:`check_faults` is the gate as a function of a device: the CPU tests
call it on ``device="cpu"`` at the JAX gate's size (4 nodes × 2 mics, 8192
samples), ``chip_smoke.py`` on the card at the north-star width with
``solver='fused'``.  ``python -m disco_tpu_torch.fault.check`` runs it on
``cuda`` (``--device cpu`` for the host).

No reference counterpart: the reference models no comms faults.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

#: the JAX gate's size: nodes, mics per node, samples
K, C, L = 4, 2, 8192


def scene(n_nodes: int, n_mics: int, length: int, seed: int = 0, noise_scale: float = 0.8):
    """The JAX package's synthetic scene recipe (``milestones._scene``): a
    white source through a random 8-tap filter per mic plus white noise;
    (y, s, n), each (K, C, L) float32 numpy."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(length)
    s = np.stack([
        np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same")
                  for _ in range(n_mics)])
        for _ in range(n_nodes)
    ]).astype(np.float32)
    n = noise_scale * rng.standard_normal((n_nodes, n_mics, length)).astype(np.float32)
    return s + n, s, n


def check_faults(failures: list, tmp, *, device=None, n_nodes: int = K, n_mics: int = C,
                 length: int = L, solver: str = "power") -> dict:
    """Node 1 dropped and node 2's z NaN on one scene: the degraded run and
    its events against the fault-free run of the same scene.  Appends what
    it finds wrong to ``failures``; returns the gate's numbers."""
    import torch

    from disco_tpu_torch import obs
    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.device import resolve_device, to_host
    from disco_tpu_torch.enhance.tango import oracle_masks, tango
    from disco_tpu_torch.fault import FaultSpec, plan_faults

    dev = resolve_device(device)
    y, s, n = (torch.as_tensor(a, device=dev) for a in scene(n_nodes, n_mics, length, seed=11))
    Y, S, N = stft(y), stft(s), stft(n)
    masks = oracle_masks(S, N, "irm1")

    spec = FaultSpec(seed=0, node_dropout=(1,), nan_z=(2,))
    plan = plan_faults(spec, n_nodes=n_nodes, n_blocks=1)
    log = Path(tmp) / "fault_check.jsonl"
    with obs.recording(log):
        obs.write_manifest(config=spec.to_dict(), tool="fault-check")
        plan.record(mode="offline")
        obs.record("degraded", stage="mwf", mode="offline",
                   n_streams_excluded=plan.n_unavailable_offline(),
                   nodes=np.flatnonzero(plan.avail_offline < 1).tolist())
        res = tango(Y, S, N, masks, masks, policy="local", solver=solver,
                    z_mask=plan.avail_offline, z_nan=plan.z_nan, device=dev)
        (yf,) = to_host([res.yf])
        obs.record("counters", **obs.REGISTRY.snapshot())
    events = obs.read_events(log)  # schema-validating read

    if not np.isfinite(yf).all():
        bad = [k for k in range(n_nodes) if not np.isfinite(yf[k]).all()]
        failures.append(f"non-finite degraded-mode output at node(s) {bad}")
    (yf_clean,) = to_host([tango(Y, S, N, masks, masks, policy="local", solver=solver,
                                 device=dev).yf])
    if not np.isfinite(yf_clean).all():
        failures.append("non-finite fault-free output (scene itself is broken)")
    if np.allclose(yf, yf_clean):
        failures.append("degraded output identical to fault-free output — "
                        "the injection never reached the pipeline")

    fault_events = [e for e in events if e["kind"] == "fault"]
    kinds = [e["attrs"].get("fault") for e in fault_events]
    for want in ("node_dropout", "nan_z"):
        if kinds.count(want) != 1:
            failures.append(f"event log holds {kinds.count(want)} {want!r} fault events, "
                            "expected one")
    if not any(e["kind"] == "degraded" for e in events):
        failures.append("event log missing the degraded-mode entry")
    counters = next((e["attrs"] for e in reversed(events) if e["kind"] == "counters"), {})
    if int(counters.get("counters", {}).get("faults_injected", 0)) < 2:
        failures.append(f"faults_injected counter below 2 in snapshot: {counters}")
    return {
        "n_fault_events": len(fault_events),
        "excluded_nodes": np.flatnonzero(plan.avail_offline < 1).tolist(),
        "nan_nodes": np.flatnonzero(plan.z_nan).tolist(),
        "degraded_vs_clean_max_abs": float(np.abs(yf - yf_clean).max()),
    }


def main(argv=None) -> int:
    """Run the fault-tolerance gate; exit 1 on failure.  Runs on ``cuda``
    unless ``--device cpu`` (RuntimeError without a CUDA device)."""
    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.fault.check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        out = check_faults(failures, tmp, device=args.device)
    if failures:
        for f in failures:
            print(f"fault-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"fault_check": "ok", **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
