"""Where the CRNN-masked clip of ``chip_smoke.py``'s phase 3d moves when one
formulation under it changes, on a CUDA card.

The scene, the two canonical CRNNs of seeded random weights and the masks
are phase 3d's (``chip_smoke.scene``, ``chip_smoke.canonical_crnn``,
``estimate_masks`` through the kernels).  With those masks fixed, the clip
``istft(tango(Y, S, N, masks_z, mask_w, solver='fused').yf)`` is computed
with the kernels and with plain versions that differ from them, or from
each other, in one formulation at a time:

* the spectra: the STFT kernel's, ``stft_matmul``'s (its plain version) or
  ``core.dsp._stft_rfft``'s (the rFFT route);
* the covariances: the kernel, the float32 fold (``masked_covariances_folded``,
  the f32 plain version), the kernel's slice order and fused multiply-adds
  in float32 (``_masked_cov_sliced(..., 'f32')``) or that order with every
  product and sum rounded alone;
* the solve: the kernel or ``fused_mwf_plain``.

Each clip's distance to the kernels' clip and to one another is printed as
max-abs over max-abs (phase 3's "of the output scale"), with the step-1
covariances' distances to the kernel's.  Run from the repo root:

    python exp/crnn_clip_witness.py

It writes ``chiprun_out/crnn_clip_witness.json``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from disco_tpu_torch.core import dsp  # noqa: E402
from disco_tpu_torch.enhance.driver import estimate_masks  # noqa: E402
from disco_tpu_torch.enhance.tango import tango  # noqa: E402
from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops  # noqa: E402


def _unfused(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a b + c`` in float32, a rounded product and a rounded sum."""
    return a * b + c


def sliced_unfused(y: torch.Tensor, mask: torch.Tensor):
    """The kernel's slice order in float32 with every product and sum
    rounded alone (``_masked_cov_sliced(..., 'f32')`` without its model of
    the kernel's fused multiply-adds)."""
    with mock.patch.object(cov_ops, "_fma", _unfused):
        return cov_ops._masked_cov_sliced(y, mask, "f32")


COVS = {
    "kernel": None,
    "folded": lambda y, m, precision="f32": cov_ops.masked_covariances_folded(y, m),
    "sliced": lambda y, m, precision="f32": cov_ops._masked_cov_sliced(y, m, "f32"),
    "sliced_unfused": lambda y, m, precision="f32": sliced_unfused(y, m),
}


def clip(spec, masks, cov: str, solve: str, L: int) -> torch.Tensor:
    """The clip from ``spec`` (3, K, C, F, T) and the masks, with the
    covariances ``cov`` and the solve ``solve`` ('kernel' or 'plain')."""
    saved = cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel
    if COVS[cov] is not None:
        cov_ops.masked_cov_kernel = COVS[cov]
    if solve == "plain":
        mwf_ops.fused_mwf_kernel = mwf_ops.fused_mwf_plain
    try:
        out = dsp.istft(tango(spec[0], spec[1], spec[2], *masks, solver="fused").yf, L)
        torch.cuda.synchronize()
        return out
    finally:
        cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("crnn_clip_witness: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.phase1_build()
    dev = torch.device("cuda")
    L = int(cs.DUR_S * cs.FS)
    y, s, n = cs.scene(cs.K, cs.C, L, noise_scale=cs.NOISE_SCALE)
    x = torch.stack([torch.from_numpy(a) for a in (y, s, n)]).to(dev)
    models = [cs.canonical_crnn(1, cs.CRNN_SEEDS["step1"], dev),
              cs.canonical_crnn(cs.K, cs.CRNN_SEEDS["step2"], dev)]
    spec_k, mag = stft_ops.stft_with_mag(x)
    masks = estimate_masks(spec_k[0], spec_k[1], spec_k[2], models, "irm1", cs.K,
                           z_sigs="zs_hat", mags=(mag[1], mag[2]))
    spectra = {"kernel": spec_k, "stft_matmul": stft_ops.stft_matmul(x),
               "rfft": dsp._stft_rfft(x, 512, 256)}
    res = {"device": smi, "spectra_max_rel_to_kernel": {}, "step1_cov_max_rel_to_kernel": {},
           "clip_max_rel": {}}
    for k, v in spectra.items():
        res["spectra_max_rel_to_kernel"][k] = cs.max_rel(v, spec_k)
    # step 1's covariance launch of tango: every node's C mics, the step-1 mask
    Rk = cov_ops.masked_cov_kernel(spec_k[0], masks[0])
    for name, fn in COVS.items():
        if fn is not None:
            R = fn(spec_k[0], masks[0])
            res["step1_cov_max_rel_to_kernel"][name] = {
                "max_rel": max(cs.max_rel(a, b) for a, b in zip(R, Rk)),
                "bit_identical": all(torch.equal(a, b) for a, b in zip(R, Rk))}
    runs = {("kernel", "kernel", "kernel"): None,
            ("kernel", "kernel", "plain"): None,
            ("kernel", "sliced_unfused", "plain"): None,
            ("kernel", "sliced", "plain"): None,
            ("kernel", "folded", "plain"): None,
            ("stft_matmul", "folded", "plain"): None,      # phase 3's plain versions
            ("stft_matmul", "sliced", "plain"): None,
            ("rfft", "folded", "plain"): None}
    for key in runs:
        runs[key] = clip(spectra[key[0]], masks, key[1], key[2], L)
    ref = runs[("kernel", "kernel", "kernel")]
    for key, out in runs.items():
        res["clip_max_rel"]["/".join(key) + " vs kernels"] = cs.max_rel(out, ref)
    pairs = [(("stft_matmul", "folded", "plain"), ("rfft", "folded", "plain"),
              "two plain STFT formulations"),
             (("stft_matmul", "folded", "plain"), ("stft_matmul", "sliced", "plain"),
              "two plain covariance orders"),
             (("kernel", "folded", "plain"), ("kernel", "sliced", "plain"),
              "two plain covariance orders on the kernel's spectra"),
             (("kernel", "sliced_unfused", "plain"), ("kernel", "sliced", "plain"),
              "the kernel's order, unfused against fused")]
    for a, b, label in pairs:
        res["clip_max_rel"][label] = cs.max_rel(runs[a], runs[b])
    res["si_sdr_node0_db"] = {"/".join(key): cs.si_sdr(s[0, 0], out[0].cpu().numpy())
                              for key, out in runs.items()}
    print(json.dumps(res, indent=1))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "crnn_clip_witness.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
