"""Fused masked spatial covariances — counterpart of
``disco_tpu/ops/cov_ops.py``.

Per frequency bin, with T frames,

    Rss[c, d] = (1/T) sum_t w_s Y_c conj(Y_d)
    Rnn[c, d] = (1/T) sum_t w_n Y_c conj(Y_d)

with ``w_s = m^2``, ``w_n = (1 - m)^2`` for a mask shared by the channels
((..., F, T)), or ``w_s = m_c m_d``, ``w_n = (1 - m_c)(1 - m_d)`` for
per-channel masks ((..., C, F, T), the step-2 ``[local mics ‖ z]`` stack
under the 'distant' policy).

* :func:`masked_cov_kernel` — the wrapper of the hand-written CUDA kernel
  ``csrc/cov.cu`` (port of ``masked_cov_pallas`` -> ``_cov_kernel`` /
  ``_cov_kernel_chan``): reads the complex64 spectra and the mask once and
  writes the (..., F, C, C) complex64 pair directly; the masked copies
  never exist.  Its frames are summed in slices combined in a fixed order
  (``tests/test_torch_port_cov_partition.py`` models it), so it meets the
  plain version within 1e-5 and itself bit for bit.  On a CPU tensor it runs :func:`masked_covariances_folded`.
* :func:`masked_covariances_folded` / :func:`weighted_cov_folded` — the
  plain version: the mask weights contracted inside one ``torch.einsum``
  per covariance.  :func:`weighted_cov_folded` alone is also the 'none'
  policy's single-covariance fold, which the reference computes outside
  any kernel on every backend.
* :func:`masked_covariances_fused` — the ``cov_impl`` seam.
"""
from __future__ import annotations

import math

import torch

from disco_tpu_torch.ops import _build
from disco_tpu_torch.ops.resolve import check_impl, resolve_precision

#: the largest channel count the covariance kernel takes (a bin's threads,
#: 4 per upper-triangle pair: 544 at C = 16)
MAX_CHANNELS = 16


def _weighted_cov_shared(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``R[..., f, c, d] = (1/T) sum_t w[..., f, t] y_c conj(y_d)``."""
    return torch.einsum("...ft,...cft,...dft->...fcd", w.to(y.dtype), y, y.conj()) / y.shape[-1]


def _weighted_cov_chan(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``R[..., f, c, d] = (1/T) sum_t m_c m_d y_c conj(y_d)``, ``m``
    (..., C, F, T) real."""
    a = m.to(y.dtype) * y
    return torch.einsum("...cft,...dft->...fcd", a, a.conj()) / y.shape[-1]


def weighted_cov_folded(y: torch.Tensor, mask: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """One covariance of the mask-applied stack without materializing the
    masked spectra: ``mask`` (..., F, T) shared (weights ``m^2``) or
    (..., C, F, T) per-channel (weights ``m_c m_d``)."""
    resolve_precision(precision)
    mask = mask.to(torch.float32)
    if mask.ndim == y.ndim:
        return _weighted_cov_chan(y, mask)
    return _weighted_cov_shared(y, mask * mask)


def masked_covariances_folded(y: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    """The plain version of :func:`masked_cov_kernel`: ``Rss`` weighted by
    the mask, ``Rnn`` by its complement."""
    mask = mask.to(torch.float32)
    return (weighted_cov_folded(y, mask, precision),
            weighted_cov_folded(y, 1.0 - mask, precision))


def masked_cov_kernel(y: torch.Tensor, mask: torch.Tensor):
    """The covariance kernel's wrapper (port of ``masked_cov_pallas``): ``y``
    (..., C, F, T) complex64 and ``mask`` (..., F, T) or (..., C, F, T) ->
    ``(Rss, Rnn)``, each (..., F, C, C) complex64.

    A CUDA tensor launches ``csrc/cov.cu`` (counted in
    ``masked_cov_kernel.launches``); a CPU tensor runs
    :func:`masked_covariances_folded`.
    """
    if y.device.type == "cpu":
        return masked_covariances_folded(y, mask)
    if y.device.type != "cuda" or mask.device != y.device:
        raise ValueError(f"masked_cov_kernel: spectra on {y.device}, mask on {mask.device}; "
                         "expected both on one CUDA device (or the CPU)")
    if y.dtype != torch.complex64:
        raise TypeError(f"masked_cov_kernel: expected complex64 spectra, got {y.dtype}")
    *lead, C, F, T = y.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"masked_cov_kernel: {C} channels; the kernel takes 1..{MAX_CHANNELS}")
    chan = mask.ndim == y.ndim
    mshape = tuple(lead) + ((C,) if chan else ()) + (F, T)
    m = mask.to(torch.float32).expand(mshape).contiguous()
    yc = y.contiguous()
    rss = torch.empty(tuple(lead) + (F, C, C), dtype=torch.complex64, device=y.device)
    rnn = torch.empty_like(rss)
    lib = _build.load()
    rc = lib.disco_masked_cov(yc.data_ptr(), m.data_ptr(), rss.data_ptr(), rnn.data_ptr(),
                              math.prod(lead), C, F, T, int(chan),
                              _build.stream_handle(y.device))
    _build.check(rc, "disco_masked_cov")
    masked_cov_kernel.launches += 1
    return rss, rnn


masked_cov_kernel.launches = 0


def masked_covariances_fused(y: torch.Tensor, mask: torch.Tensor, impl: str = "auto",
                             precision: str = "f32"):
    """Masked speech/noise covariance pair behind the ``cov_impl`` seam:
    the hand-written kernel on a CUDA tensor (``'auto'``/``'pallas'``), the
    folded einsum on a CPU tensor; ``'xla'`` on a CUDA tensor raises."""
    resolve_precision(precision)
    check_impl(impl, y, "masked_covariances_folded")
    return masked_cov_kernel(y, mask)
