"""Workload-sized stage costs — the roofline join's cost side (counterpart
of ``disco_tpu/analysis/meter/stages.py``).

The committed manifests are structural (tiny shapes).  This module builds
the stages of the offline path at a *workload's* shapes — the fused
spec+magnitude STFT over the stacked y/s/n streams, the irm mask stage,
step 1 (and its fused twin), the whole two-step ``tango`` (step 2 is the
whole minus step 1, as the JAX bench times it), the ISTFT, the headline
pipeline and the chained clip — and costs them with the same model,
traced for the card on fake tensors: no FLOP runs and no card is needed.
:func:`stage_programs` hands the same programs to a caller that times
them on the card (``chip_smoke.py`` phase 3n), so a measured stage time
joins the cost of the same program.

The streaming-scan and serve lanes get per-window / per-block costs from
the same model.
"""
from __future__ import annotations

import dataclasses

import torch

from disco_tpu_torch.analysis.meter import costmodel
from disco_tpu_torch.analysis.trace.fingerprint import Struct

#: the stage keys of the JAX bench's ``stage_ms``, in pipeline order
STAGE_KEYS = ("stft_x3", "masks", "step1_local_mwf", "step1_fused_mwf",
              "step2_exchange_mwf", "istft", "full_pipeline", "chained_clip")


@dataclasses.dataclass(frozen=True)
class Workload:
    """One offline workload: the headline is the JAX bench's — the
    8-node / 4-mic north-star scene on 10 s clips, 16 at a time."""

    batch: int = 16
    dur_s: float = 10.0
    fs: int = 16000
    n_nodes: int = 8
    mics_per_node: int = 4

    @property
    def samples(self) -> int:
        return int(self.dur_s * self.fs)

    @property
    def frames(self) -> int:
        return 1 + self.samples // 256


HEADLINE = Workload()
F_BINS = 257


def stage_programs(workload: Workload = HEADLINE, solver: str = "power") -> dict:
    """stage -> ``(fn, args)`` with :class:`Struct` inputs, each the
    program the stage runs (``step2_exchange_mwf`` is absent: it is
    ``tango_full`` minus ``step1_local_mwf``, and ``tango_full`` is here)."""
    from disco_tpu_torch.core.dsp import istft
    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.enhance.tango import tango
    from disco_tpu_torch.enhance.zexport import compute_z_signals
    from disco_tpu_torch.ops.stft_ops import stft_with_mag

    w = workload
    lead = (w.batch, w.n_nodes, w.mics_per_node)
    y = Struct(lead + (w.samples,), torch.float32)
    spec = Struct(lead + (F_BINS, w.frames), torch.complex64)
    mag = Struct(lead + (F_BINS, w.frames), torch.float32)
    mask = Struct((w.batch, w.n_nodes, F_BINS, w.frames), torch.float32)

    def f_stft(a, b, c):
        return stft_with_mag(torch.stack([a, b, c]))

    def f_mask(ms, mn):
        return tf_mask_mag(ms[..., 0, :, :], mn[..., 0, :, :], "irm1")

    def f_step1(Y, S, N, m, solver_=solver):
        return compute_z_signals(None, None, None, Y=Y, S=S, N=N, masks_z=m, solver=solver_,
                                 device=Y.device)["z_y"]

    def f_full(Y, S, N, m):
        return tango(Y, S, N, m, m, policy="local", solver=solver, device=Y.device).yf

    def f_istft(Z):
        return istft(Z, length=w.samples)

    def f_headline(a, b, c):
        sp, mg = stft_with_mag(torch.stack([a, b, c]))
        m = tf_mask_mag(mg[1][..., 0, :, :], mg[2][..., 0, :, :], "irm1")
        return tango(sp[0], sp[1], sp[2], m, m, policy="local", solver=solver,
                     device=a.device).yf

    def f_chained(a, b, c):
        return tango_clip_fused.__wrapped__(a, b, c, solver="fused", device=a.device)

    return {
        "stft_x3": (f_stft, (y, y, y)),
        "masks": (f_mask, (mag, mag)),
        "step1_local_mwf": (f_step1, (spec, spec, spec, mask)),
        "step1_fused_mwf": (lambda Y, S, N, m: f_step1(Y, S, N, m, "fused"),
                            (spec, spec, spec, mask)),
        "tango_full": (f_full, (spec, spec, spec, mask)),
        "istft": (f_istft, (Struct((w.batch, w.n_nodes, F_BINS, w.frames),
                                   torch.complex64),)),
        "full_pipeline": (f_headline, (y, y, y)),
        "chained_clip": (f_chained, (y, y, y)),
    }


def _cost(fn, args, program: str) -> dict:
    rep = costmodel.cost_of_fn(fn, args, program=program)
    return {"flops": rep["flops"], "traffic_bytes": rep["traffic_bytes"],
            "arithmetic_intensity": rep["arithmetic_intensity"]}


def _sub(a: dict, b: dict) -> dict:
    """A stage's cost as a difference (step 2 is the whole minus step 1)."""
    flops = max(a["flops"] - b["flops"], 0)
    traffic = max(a["traffic_bytes"] - b["traffic_bytes"], 0)
    return {"flops": flops, "traffic_bytes": traffic,
            "arithmetic_intensity": round(flops / traffic, 6) if traffic else None}


def offline_stage_costs(workload: Workload = HEADLINE, solver: str = "power") -> dict:
    """Cost of each :data:`STAGE_KEYS` stage at the workload's shapes,
    ``{stage: {flops, traffic_bytes, arithmetic_intensity}}``, each over
    the WHOLE batch."""
    progs = stage_programs(workload, solver)
    c = {name: _cost(fn, args, f"stage:{name}") for name, (fn, args) in progs.items()}
    out = {k: c[k] for k in STAGE_KEYS if k in c}
    out["step2_exchange_mwf"] = _sub(c["tango_full"], c["step1_local_mwf"])
    return {k: out[k] for k in STAGE_KEYS}


def streaming_scan_cost(dur_s: float = 10.0, fs: int = 16000, n_nodes: int = 4,
                        mics_per_node: int = 4, update_every: int = 4,
                        blocks_per_dispatch: int = 8) -> dict | None:
    """Per-window cost of the scanned super-tick at the JAX bench lane's
    shapes (its block shrink included); None when the clip cannot hold
    the window."""
    from disco_tpu_torch.enhance.streaming import initial_stream_state, streaming_tango_scan

    K, C, u = n_nodes, mics_per_node, update_every
    T = 1 + int(dur_s * fs) // 256
    block = 4 * u
    if T < blocks_per_dispatch * block:
        block = (T // (blocks_per_dispatch * u)) * u
    if block < u:
        return None
    window = blocks_per_dispatch * block
    state = initial_stream_state(K, C, F_BINS, update_every=u)

    def run_scan(Yw, mw, av):
        return streaming_tango_scan.__wrapped__(
            Yw, mw, mw, update_every=u, policy="local", state=state, z_avail=av,
            blocks_per_dispatch=blocks_per_dispatch, device=Yw.device)["yf"]

    out = _cost(run_scan, (Struct((K, C, F_BINS, window), torch.complex64),
                           Struct((K, F_BINS, window), torch.float32),
                           Struct((K, window // u), torch.float32)), "lane:streaming_scan")
    out.update(window_frames=window, block_frames=block, blocks_per_dispatch=blocks_per_dispatch)
    return out


def serve_block_cost(n_nodes: int = 4, mics_per_node: int = 2, update_every: int = 4) -> dict:
    """Per-block cost of the program the serve scheduler dispatches every
    tick (``streaming_tango`` with continuation state) at the JAX serve
    bench lane's session shape (K=4, C=2, u=4, block 4·u)."""
    from disco_tpu_torch.enhance.streaming import initial_stream_state, streaming_tango

    K, C, u = n_nodes, mics_per_node, update_every
    block = 4 * u
    state = initial_stream_state(K, C, F_BINS, update_every=u)

    def run_block(Yb, mb, av):
        return streaming_tango.__wrapped__(Yb, mb, mb, update_every=u, policy="local",
                                           state=state, z_avail=av, device=Yb.device)["yf"]

    out = _cost(run_block, (Struct((K, C, F_BINS, block), torch.complex64),
                            Struct((K, F_BINS, block), torch.float32),
                            Struct((K, block // u), torch.float32)), "lane:serve_block")
    out.update(block_frames=block)
    return out


def fused_pipeline_cost(workload: Workload = HEADLINE) -> dict:
    """Whole-batch cost of the headline pipeline on the fused solve."""
    return offline_stage_costs(workload, solver="fused")["full_pipeline"]
