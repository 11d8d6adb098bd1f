"""The whole offline clip — STFT, masks, both MWF steps, ISTFT — in one call
(counterpart of ``disco_tpu/enhance/fused.py::tango_clip_fused``).

    stft_with_mag -> tf_mask_mag -> masked covariances -> fused step-1
    -> z-exchange -> fused step-2 -> istft

On a CUDA device this runs the three hand-written kernels of the port: one
STFT launch over the stacked y/s/n streams, and per step one covariance
launch and one fused-solve launch.  The streaming twin
(``streaming_clip_fused``) waits for the streaming port.
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.dsp import istft
from disco_tpu_torch.core.masks import tf_mask_mag
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.tango import oracle_masks, tango
from disco_tpu_torch.ops.resolve import resolve_precision
from disco_tpu_torch.ops.stft_ops import stft_with_mag


def _clip_oracle_masks(spec, mag, mask_type: str, ref_mic: int):
    """(..., K, F, T) oracle step masks from the fused STFT's outputs: the
    irm/ibm families use the emitted magnitudes, the iam family the complex
    spectra."""
    if mask_type[:-1] in ("irm", "ibm"):
        return tf_mask_mag(mag[1][..., ref_mic, :, :], mag[2][..., ref_mic, :, :], mask_type)
    return oracle_masks(spec[1], spec[2], mask_type, ref_mic=ref_mic)


def tango_clip_fused(y, s, n, masks_z=None, mask_w=None, mu: float = 1.0,
                     policy: str | None = "local", ref_mic: int = 0, mask_type: str = "irm1",
                     oracle_step1_stats: bool = False, solver: str = "fused",
                     cov_impl: str = "auto", stft_impl: str = "auto", precision: str = "f32",
                     export: bool = False, device=None):
    """Enhance one clip (or a leading batch of clips) end to end.

    Args:
      y, s, n: (..., K, C, L) float mixture / speech / noise node signals
        (numpy or tensors).
      masks_z, mask_w: optional (..., K, F, T) step-1 / step-2 masks; None
        computes oracle masks of ``mask_type`` from the fused STFT's
        magnitudes, and ``mask_w=None`` reuses ``masks_z``.
      solver: rank-1 GEVD-MWF solver spec (``beam.filters.rank1_gevd``),
        ``'fused'`` by default — the hand-written fused-solve kernel.
      cov_impl / stft_impl / precision: the ``ops`` seams.
      export: False returns the (..., K, L) enhanced signal; True returns
        ``td`` (the 6-tuple of (..., K, L) ISTFTs: yf, z_y, sf, nf, z_s,
        z_n), ``masks_z``/``mask_w`` and the complex ``z_y``.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device),
        ``"cpu"`` for the plain versions on the host.
    """
    precision = resolve_precision(precision)
    dev = resolve_device(device)
    y, s, n = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (y, s, n))
    L = y.shape[-1]
    spec, mag = stft_with_mag(torch.stack([y, s, n]), impl=stft_impl, precision=precision)
    if masks_z is None:
        masks_z = _clip_oracle_masks(spec, mag, mask_type, ref_mic)
    if mask_w is None:
        mask_w = masks_z
    res = tango(spec[0], spec[1], spec[2], masks_z, mask_w, mu=mu, policy=policy,
                ref_mic=ref_mic, mask_type=mask_type, oracle_step1_stats=oracle_step1_stats,
                solver=solver, cov_impl=cov_impl, precision=precision, device=dev)
    if not export:
        return istft(res.yf, length=L)
    td = istft(torch.stack([res.yf, res.z_y, res.sf, res.nf, res.z_s, res.z_n]), length=L)
    return {
        "td": tuple(td[i] for i in range(6)),
        "masks_z": res.masks_z,
        "mask_w": res.mask_w,
        "z_y": res.z_y,
    }
