"""Spatial covariance estimation (counterpart of
``disco_tpu/beam/covariance.py``: the offline frame-mean estimator of
reference tango.py:357-364)."""
from __future__ import annotations

import torch


def frame_mean_covariance(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Frame-averaged spatial covariance: (..., C, F, T) ->
    (..., F, C, C) ``mean_t a[..., c, f, t] conj(b[..., d, f, t])``."""
    b = a if b is None else b
    return torch.einsum("...cft,...dft->...fcd", a, b.conj()) / a.shape[-1]


def masked_covariances(y: torch.Tensor, mask: torch.Tensor):
    """Speech/noise covariances from a mixture (..., C, F, T) and a real TF
    mask (..., F, T) broadcast over channels: the materializing form of
    reference tango.py:347-348 (``m * y`` and ``(1 - m) * y``)."""
    m = mask[..., None, :, :]
    return frame_mean_covariance(m * y), frame_mean_covariance((1.0 - m) * y)
