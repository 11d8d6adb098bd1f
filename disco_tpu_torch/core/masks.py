"""Ideal time-frequency masks (counterpart of ``disco_tpu/core/masks.py``
``tf_mask`` / ``tf_mask_mag``; reference sigproc_utils.py:58-86)."""
from __future__ import annotations

import torch

from disco_tpu_torch.core.mathx import FLOAT64_EPS as _EPS
from disco_tpu_torch.core.mathx import db2lin


def _from_ratio(xi, family: str, bin_thr: float, dtype):
    if family == "irm":
        return xi / (1.0 + xi)
    return (xi >= float(db2lin(bin_thr))).to(dtype)


def tf_mask(s: torch.Tensor, n: torch.Tensor, mask_type: str = "irm1", bin_thr: float = 0.0):
    """Ideal TF mask from complex target/noise spectrograms: ``'irmX'``
    (ratio), ``'ibmX'`` (binary) or ``'iamX'`` (amplitude), X the power
    applied to the magnitude ratio."""
    power = int(mask_type[-1])
    family = mask_type[:-1]
    if family in ("irm", "ibm"):
        xi = (s.abs() / n.abs().clamp_min(_EPS)) ** power
        return _from_ratio(xi, family, bin_thr, s.real.dtype)
    if family == "iam":
        # eps floor: all-silent bins (|s+n| = 0) must yield 0, not 0/0
        return (s.abs() / (s + n).abs().clamp_min(_EPS)) ** power
    raise ValueError('Unknown mask type. Should be "irmX", "ibmX" or "iamX"')


def tf_mask_mag(mag_s: torch.Tensor, mag_n: torch.Tensor, mask_type: str = "irm1",
                bin_thr: float = 0.0):
    """:func:`tf_mask` from magnitude spectrograms (the consumer of the
    fused STFT's magnitude output); irm/ibm only — the iam family needs the
    complex sum."""
    power = int(mask_type[-1])
    family = mask_type[:-1]
    if family not in ("irm", "ibm"):
        raise ValueError(
            'tf_mask_mag supports "irmX" and "ibmX" (iam needs the complex sum '
            "— use tf_mask)"
        )
    xi = (mag_s / mag_n.clamp_min(_EPS)) ** power
    return _from_ratio(xi, family, bin_thr, mag_s.dtype)
