"""Precision resolution, the bf16 lane's rounding points, and the
kernel-routing rule shared by every kernel family in
:mod:`disco_tpu_torch.ops`.

Counterpart of ``disco_tpu/ops/resolve.py``.  The JAX package resolves an
``impl`` knob (``'auto' | 'xla' | 'pallas'``) by backend, with a
``DISCO_TPU_*_IMPL`` environment escape hatch.  The port routes by the
device of the tensor instead and has no escape hatch:

* a CPU tensor always takes the kernel's plain PyTorch version;
* a CUDA tensor under ``'auto'``/``'pallas'`` launches the hand-written
  kernel; under ``'xla'`` (which names the plain version) it raises
  ValueError — the plain version never runs on a card tensor;
* a tensor on any other device raises.

Two precision lanes: ``'f32'`` (true float32 everywhere, TF32 off) and
``'bf16'``, documented as "bf16 multiply inner loops, f32 accumulators,
everything downstream f32".  The JAX package has no single bf16
arithmetic (its interpret-mode kernels and its XLA formulations round at
different points), so the port fixes its own rounding points, once, and
both halves of each kernel pair follow them.  A bf16 x bf16 product is
exact in float32, so under these rules a kernel and its plain version
differ only in the order of their float32 sums:

* **STFT** — the windowed frame ``w[n] x[n]`` is computed in float32 and
  rounded to bf16 once; the DFT tables (``stft_ops.dft_matrices``, exact
  integer-mod angles) are rounded to bf16; products and sums are float32;
  the magnitude comes from the float32 re/im.
* **Masked covariances** — the real and imaginary planes of ``y`` are
  rounded to bf16 at load; the pair products, the mask weights (``m^2/T``,
  ``(1-m)^2/T``, ``m_c m_d/T``, ``(1-m_c)(1-m_d)/T``) and the sums are
  float32.
* **Fused solve** — the real and imaginary planes of ``Rss`` and ``Rnn``
  are rounded to bf16 at load; everything after is the f32 lane's chain.
* **The folded einsum** (``cov_ops.weighted_cov_folded``) and **the
  streaming tail accumulator** (``cov_ops.outer_acc_bf16``), which are not
  kernels in either package: every operand is rounded to bf16, the weight
  included, as in the JAX package; the contraction is float32.

Rounding is round-to-nearest-even (:func:`bf16_round`), the conversion of
``Tensor.to(torch.bfloat16)`` and of CUDA's ``__float2bfloat16_rn``.
"""
from __future__ import annotations

import torch

#: the ``impl`` knob values every kernel family accepts
IMPL_CHOICES = ("auto", "xla", "pallas")

#: the compute-precision lanes: ``'f32'`` (default, true float32) or
#: ``'bf16'`` (bf16 operands, float32 accumulators; the rounding points of
#: the module docstring)
PRECISIONS = ("f32", "bf16")


def resolve_precision(precision: str) -> str:
    """Validate/normalize a ``precision`` token to its canonical form
    (``'f32'`` or ``'bf16'``)."""
    p = str(precision).strip().lower()
    if p not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return p


def check_canonical_precision(precision: str) -> str:
    """Require an already-canonical precision token (the guard of the
    entry points whose JAX counterparts take ``precision`` as a static jit
    argument)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision {precision!r} is not canonical; pass one of {PRECISIONS} "
            "(canonicalize user input with resolve_precision first)"
        )
    return precision


def compute_dtype(precision: str) -> torch.dtype:
    """The operand dtype of a precision lane (the accumulator is float32 in
    both lanes)."""
    return torch.bfloat16 if resolve_precision(precision) == "bf16" else torch.float32


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """A real tensor rounded to bf16 (nearest, ties to even) and back to
    float32 — the bf16 lane's one rounding step."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_round_complex(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor with its real and imaginary planes rounded to bf16,
    as complex64."""
    return torch.complex(bf16_round(z.real), bf16_round(z.imag))


def check_impl(impl: str, x: torch.Tensor, plain: str) -> None:
    """Validate an ``impl`` knob against the device of ``x``: every choice
    is valid on a CPU tensor (the kernel wrappers then run their plain
    versions); on a CUDA tensor ``'xla'``, which selects the plain version
    ``plain``, raises ValueError.  Any other device raises too."""
    if impl not in IMPL_CHOICES:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPL_CHOICES}")
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}; the port runs on 'cuda' or 'cpu'")
    if kind == "cuda" and impl == "xla":
        raise ValueError(
            f"impl='xla' selects the plain version {plain}, which never runs on a "
            "CUDA tensor; use 'auto' or 'pallas' (the hand-written kernel)"
        )
