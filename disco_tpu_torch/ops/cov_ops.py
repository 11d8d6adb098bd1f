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
  plain version within 1e-5 and itself bit for bit.  ``precision='bf16'``
  launches its bf16 instance, which rounds the spectra's real and
  imaginary planes to bf16 once, as each tile lands in shared memory
  (``ops/resolve.py``'s rounding points), and sums in the plain version's
  order (:func:`_masked_cov_sliced`, bit for bit).  On a CPU tensor it runs :func:`masked_covariances_plain`.
* :func:`masked_covariances_plain` — the plain version: the f32 lane is
  :func:`masked_covariances_folded`; the bf16 lane the same float32 fold on
  the spectra rounded to bf16, with the kernel's float32 weights.
* :func:`masked_covariances_folded` / :func:`weighted_cov_folded` — the mask
  weights contracted inside one ``torch.einsum`` per covariance.
  :func:`weighted_cov_folded` alone is also the 'none' policy's
  single-covariance fold, which the reference computes outside any kernel
  on every backend; under ``precision='bf16'`` it rounds every operand to
  bf16, the weights included, as the reference's folded einsum does.
* :func:`outer_acc_bf16` — the streaming covariance tail accumulation of
  the bf16 lane (not a kernel in either package).
* :func:`masked_covariances_fused` — the ``cov_impl`` seam.
"""
from __future__ import annotations

import math

import torch

from disco_tpu_torch.ops import _build
from disco_tpu_torch.ops.resolve import (
    bf16_round,
    bf16_round_complex,
    check_impl,
    resolve_precision,
)

#: the largest channel count the covariance kernel takes (a bin's threads,
#: 4 per upper-triangle pair: 544 at C = 16)
MAX_CHANNELS = 16
#: the kernel's frame slices (``csrc/cov.cu`` kSlices): frame t is summed in
#: slice t % KERNEL_SLICES, the slices added in order
KERNEL_SLICES = 4


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
    (..., C, F, T) per-channel (weights ``m_c m_d``).  Under
    ``precision='bf16'`` the spectra's planes and the weights (``m^2``, or
    each ``m_c``) are rounded to bf16 and contracted in float32."""
    bf16 = resolve_precision(precision) == "bf16"
    mask = mask.to(torch.float32)
    if bf16:
        y = bf16_round_complex(y)
    if mask.ndim == y.ndim:
        return _weighted_cov_chan(y, bf16_round(mask) if bf16 else mask)
    w = mask * mask
    return _weighted_cov_shared(y, bf16_round(w) if bf16 else w)


def masked_covariances_folded(y: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    """``Rss`` weighted by the mask, ``Rnn`` by its complement, each a
    :func:`weighted_cov_folded` (the f32 lane: the plain version of
    :func:`masked_cov_kernel`)."""
    mask = mask.to(torch.float32)
    return (weighted_cov_folded(y, mask, precision),
            weighted_cov_folded(y, 1.0 - mask, precision))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of float32 tensors, correctly rounded: the product
    is exact in float64; the float64 sum ``s`` and its error ``e`` (two-sum,
    exact) give the sum rounded to odd (``s`` one step towards ``e`` where
    ``e != 0`` and ``s`` is even), which rounds to float32 as the exact sum
    does, since 53 >= 24 + 2."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.where(e > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((e != 0) & even, torch.nextafter(s, towards), s).float()


def _masked_cov_sliced(y: torch.Tensor, mask: torch.Tensor, precision: str = "bf16"):
    """The kernel's sums in its own order and arithmetic: per
    upper-triangle pair (c, d), row by row, the float32 weights
    ``(m m) / T`` of the kernel, the pair products, and one running float32
    sum per frame slice, frame after frame, the slices then added in order;
    the lower triangle mirrored, the diagonal's imaginary part 0.

    In the bf16 lane the planes are rounded to bf16 first, so the pair
    products are exact; a weighted term is a rounded product, then a
    rounded sum, as the ``BF16`` instance's ``__fmul_rn``/``__fadd_rn``.
    In the f32 lane the planes are used as they are, and the f32
    instance's multiply-adds, which ``nvcc`` fuses, are modelled by
    :func:`_fma`: ``prr = fma(rc, rd, ic id)``, ``pii = fma(ic, rd,
    -(rc id))``, ``acc = fma(w, p, acc)``.  Either lane gives the kernel's
    bits."""
    *lead, C, F, T = y.shape
    c, d = torch.triu_indices(C, C, device=y.device)
    bf16 = resolve_precision(precision) == "bf16"
    yr, yi = (bf16_round(y.real), bf16_round(y.imag)) if bf16 else (y.real, y.imag)
    chan = mask.ndim == y.ndim
    m = mask.to(torch.float32)
    inv_t = torch.ones((), dtype=torch.float32, device=y.device) / T
    S = KERNEL_SLICES
    acc = torch.zeros(tuple(lead) + (4, len(c), F, S), dtype=torch.float32, device=y.device)
    for t0 in range(0, T, S):
        sl = slice(t0, min(t0 + S, T))
        rc, ic, rd, id_ = yr[..., c, :, sl], yi[..., c, :, sl], yr[..., d, :, sl], yi[..., d, :, sl]
        if bf16:
            prr, pii = rc * rd + ic * id_, ic * rd - rc * id_
        else:
            prr, pii = _fma(rc, rd, ic * id_), _fma(ic, rd, -(rc * id_))
        if chan:
            mc, md = m[..., c, :, sl], m[..., d, :, sl]
            ws, wn = (mc * md) * inv_t, ((1.0 - mc) * (1.0 - md)) * inv_t
        else:
            mm = m[..., None, :, sl]
            om = 1.0 - mm
            ws, wn = (mm * mm) * inv_t, (om * om) * inv_t
        n = prr.shape[-1]
        if bf16:
            terms = torch.stack([ws * prr, ws * pii, wn * prr, wn * pii], dim=-4)
            acc[..., :n] = acc[..., :n] + terms
        else:
            ws, wn = ws.expand_as(prr), wn.expand_as(prr)
            acc[..., :n] = _fma(torch.stack([ws, ws, wn, wn], dim=-4),
                                torch.stack([prr, pii, prr, pii], dim=-4), acc[..., :n])
    tot = acc[..., 0]
    for j in range(1, S):
        tot = tot + acc[..., j]                                   # (..., 4, P, F)
    tot = tot.transpose(-1, -2)                                    # (..., 4, F, P)
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    out = []
    for k in (0, 2):                              # (re, im) of Rss, then of Rnn
        re_, im_ = tot[..., k, :, :], torch.where(c == d, zero, tot[..., k + 1, :, :])
        R = torch.zeros(tuple(lead) + (F, C, C), dtype=torch.complex64, device=y.device)
        R[..., d, c] = torch.complex(re_, -im_)   # the mirror first: the diagonal's
        R[..., c, d] = torch.complex(re_, im_)    # own entry is the upper one
        out.append(R)
    return tuple(out)


def masked_covariances_plain(y: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    """The plain version of :func:`masked_cov_kernel`: in the f32 lane the
    float32 fold (:func:`masked_covariances_folded`, within 1e-5 of the
    kernel's sliced order); in the bf16 lane the kernel's own order on the
    spectra rounded to bf16, its weights float32 (:func:`_masked_cov_sliced`,
    bit for bit)."""
    if resolve_precision(precision) == "bf16":
        return _masked_cov_sliced(y, mask)
    return masked_covariances_folded(y, mask)


def outer_acc_bf16(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_t w_t x_t x_t^H`` over a (..., u, F, D) complex stream and its
    (u,) weights, with the operands rounded to bf16 and a float32
    contraction (the bf16 lane of the streaming tail accumulation,
    ``disco_tpu/ops/cov_ops.py::outer_acc_bf16``): (..., F, D, D)."""
    xb = bf16_round_complex(x)
    wb = bf16_round(w.to(torch.float32))[:, None, None]
    return torch.einsum("...tfc,...tfd->...fcd", wb * xb, xb.conj())


def _masked_cov_launch(y: torch.Tensor, mask: torch.Tensor, bf16: bool):
    """One launch of ``csrc/cov.cu`` (its bf16 instance under ``bf16``) on
    CUDA tensors."""
    *lead, C, F, T = y.shape
    chan = mask.ndim == y.ndim
    mshape = tuple(lead) + ((C,) if chan else ()) + (F, T)
    m = mask.to(torch.float32).expand(mshape).contiguous()
    yc = y.contiguous()
    rss = torch.empty(tuple(lead) + (F, C, C), dtype=torch.complex64, device=y.device)
    rnn = torch.empty_like(rss)
    lib = _build.load()
    rc = lib.disco_masked_cov(yc.data_ptr(), m.data_ptr(), rss.data_ptr(), rnn.data_ptr(),
                              math.prod(lead), C, F, T, int(chan), int(bf16),
                              _build.stream_handle(y.device))
    _build.check(rc, "disco_masked_cov")
    if bf16:
        masked_cov_kernel.launches_bf16 += 1
    else:
        masked_cov_kernel.launches += 1
    return rss, rnn


def _masked_cov_fake(y, mask, bf16):
    *lead, C, F, _ = y.shape
    rss = y.new_empty(tuple(lead) + (F, C, C), dtype=torch.complex64)
    return rss, torch.empty_like(rss)


#: the covariance kernel as a named op: ``csrc/cov.cu`` on a CUDA tensor,
#: :func:`masked_covariances_plain` on a CPU tensor
_masked_cov_op = _build.kernel_op(
    "masked_cov(Tensor y, Tensor mask, bool bf16) -> (Tensor, Tensor)",
    cuda=_masked_cov_launch,
    cpu=lambda y, mask, bf16: masked_covariances_plain(y, mask, "bf16" if bf16 else "f32"),
    fake=_masked_cov_fake)


def masked_cov_kernel(y: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    """The covariance kernel's wrapper (port of ``masked_cov_pallas``): ``y``
    (..., C, F, T) complex64 and ``mask`` (..., F, T) or (..., C, F, T) ->
    ``(Rss, Rnn)``, each (..., F, C, C) complex64.

    One call of the op ``disco_torch::masked_cov``: a CUDA tensor launches
    ``csrc/cov.cu``, its bf16 instance under ``precision='bf16'`` (counted
    in ``masked_cov_kernel.launches`` and ``masked_cov_kernel.launches_bf16``);
    a CPU tensor runs :func:`masked_covariances_plain`.
    """
    bf16 = resolve_precision(precision) == "bf16"
    if y.device.type not in ("cpu", "cuda") or mask.device != y.device:
        raise ValueError(f"masked_cov_kernel: spectra on {y.device}, mask on {mask.device}; "
                         "expected both on one CUDA device (or the CPU)")
    if y.device.type == "cuda":
        if y.dtype != torch.complex64:
            raise TypeError(f"masked_cov_kernel: expected complex64 spectra, got {y.dtype}")
        C = y.shape[-3]
        if not 1 <= C <= MAX_CHANNELS:
            raise ValueError(f"masked_cov_kernel: {C} channels; the kernel takes "
                             f"1..{MAX_CHANNELS}")
    return _masked_cov_op(y, mask, bf16)


masked_cov_kernel.launches = 0
masked_cov_kernel.launches_bf16 = 0


def masked_covariances_fused(y: torch.Tensor, mask: torch.Tensor, impl: str = "auto",
                             precision: str = "f32"):
    """Masked speech/noise covariance pair behind the ``cov_impl`` seam:
    the hand-written kernel of the ``precision`` lane on a CUDA tensor
    (``'auto'``/``'pallas'``), its plain version on a CPU tensor; ``'xla'``
    on a CUDA tensor raises."""
    precision = resolve_precision(precision)
    check_impl(impl, y, "masked_covariances_plain")
    return masked_cov_kernel(y, mask, precision)
