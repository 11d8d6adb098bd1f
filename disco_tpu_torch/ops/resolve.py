"""Precision resolution and the kernel-routing rule shared by every kernel
family in :mod:`disco_tpu_torch.ops`.

Counterpart of ``disco_tpu/ops/resolve.py``.  The JAX package resolves an
``impl`` knob (``'auto' | 'xla' | 'pallas'``) by backend, with a
``DISCO_TPU_*_IMPL`` environment escape hatch.  The port routes by the
device of the tensor instead and has no escape hatch:

* a CPU tensor always takes the kernel's plain PyTorch version;
* a CUDA tensor under ``'auto'``/``'pallas'`` launches the hand-written
  kernel; under ``'xla'`` (which names the plain version) it raises
  ValueError — the plain version never runs on a card tensor;
* a tensor on any other device raises.
"""
from __future__ import annotations

import torch

#: the ``impl`` knob values every kernel family accepts
IMPL_CHOICES = ("auto", "xla", "pallas")

#: the precision lanes the port implements (the reference's 'bf16' lane is
#: ROADMAP Queue 1 work)
PRECISIONS = ("f32",)

_BF16_TODO = ("the 'bf16' precision lane is not ported yet "
              "(ROADMAP.md Queue 1: the bf16 lanes of the STFT, covariance "
              "and fused-solve kernels)")


def resolve_precision(precision: str) -> str:
    """Validate/normalize a ``precision`` token to its canonical form.
    Only ``'f32'`` is supported; ``'bf16'`` raises NotImplementedError."""
    p = str(precision).strip().lower()
    if p == "bf16":
        raise NotImplementedError(_BF16_TODO)
    if p not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return p


def check_canonical_precision(precision: str) -> str:
    """Require an already-canonical precision token (the guard of the
    entry points whose JAX counterparts take ``precision`` as a static jit
    argument)."""
    if precision == "bf16":
        raise NotImplementedError(_BF16_TODO)
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision {precision!r} is not canonical; pass one of {PRECISIONS} "
            "(canonicalize user input with resolve_precision first)"
        )
    return precision


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
