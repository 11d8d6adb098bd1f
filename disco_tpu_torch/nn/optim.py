"""The optimizer of the JAX package's ``build_crnn``/``build_rnn``:
``optax.rmsprop(lr, decay=0.99, eps=1e-8)``, optionally chained after
``optax.clip_by_global_norm`` (``disco_tpu/nn/crnn.py:165-167, 222-224``),
as a ``torch.optim.Optimizer``.

``torch.optim.RMSprop`` is not that optimizer: optax's ``scale_by_rms``
puts ``eps`` inside the square root, ``g * rsqrt(nu + eps)``, where torch
computes ``g / (sqrt(nu) + eps)``.  With ``nu`` starting at 0 a first-step
gradient of 1e-5 moves its parameter by 0.1 lr in optax and by 9.9 lr in
torch.  So the update is written out here, in optax's order:

    g  <- g * max_norm / max(||g||, max_norm)     (with clipping; ||.|| over
                                                   every parameter at once)
    nu <- (1 - decay) g^2 + decay nu
    p  <- p + (-lr) g rsqrt(nu + eps)

Its state is one ``nu`` per parameter (``state[p]["nu"]``, float32 like
the parameter), which is the ``nu`` leaf of the optax state.
"""
from __future__ import annotations

import torch


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (``scale_by_rms(decay, eps)`` then
    ``scale_by_learning_rate(lr)``, no momentum, no centering, no bias
    correction), with optax's ``clip_by_global_norm(clip_norm)`` before it
    when ``clip_norm`` is set."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.99, eps: float = 1e-8,
                 clip_norm: float | None = None):
        if lr < 0 or not 0 <= decay < 1 or eps < 0:
            raise ValueError(f"invalid RMSprop hyperparameters lr={lr} decay={decay} eps={eps}")
        if clip_norm is not None and clip_norm <= 0:
            raise ValueError(f"clip_norm must be positive, got {clip_norm}")
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [(group, [p for p in group["params"] if p.grad is not None])
                  for group in self.param_groups]
        factor = None
        if self.clip_norm is not None:
            # optax's global norm: sqrt of the sum of every leaf's squares
            norms = torch._foreach_norm([p.grad for _, ps in groups for p in ps])
            if norms:
                norm = torch.linalg.vector_norm(torch.stack(norms))
                factor = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        for group, ps in groups:
            if not ps:
                continue
            gs = [p.grad for p in ps]
            if factor is not None:
                gs = torch._foreach_mul(gs, factor)
            for p in ps:
                if "nu" not in self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            nus = [self.state[p]["nu"] for p in ps]
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - decay)
            scaled = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scaled)
            torch._foreach_mul_(scaled, gs)
            torch._foreach_add_(ps, scaled, alpha=-group["lr"])
        return loss


def build_optimizer(model: torch.nn.Module, learning_rate: float = 1e-3,
                    clip_grad_norm: float | None = None) -> RMSprop:
    """The optimizer half of the JAX package's ``build_crnn``/``build_rnn``
    (their ``tx``): RMSprop at ``learning_rate``, decay 0.99, eps 1e-8,
    after a global-norm clip when ``clip_grad_norm`` is set (reference
    crnn.py:105, dnn/utils.py:143-152).  The port's ``build_crnn`` and
    ``build_rnn`` return the module alone; build its optimizer here."""
    return RMSprop(model.parameters(), lr=learning_rate, decay=0.99, eps=1e-8,
                   clip_norm=clip_grad_norm or None)
