"""Training losses (counterpart of ``disco_tpu/nn/losses.py``; reference
dnn/engine/losses.py).

``reconstruction_loss`` is the reference's masked MSE: the squared mask
error weighted by the input magnitude STFT, so loud TF bins dominate
(losses.py:15-25), averaged by a mean that ignores NaNs (losses.py:4-12).
"""
import torch


def nanmean(v: torch.Tensor) -> torch.Tensor:
    """Mean ignoring NaNs (reference losses.py:4-12)."""
    mask = ~torch.isnan(v)
    return torch.where(mask, v, 0.0).sum() / mask.sum()


def reconstruction_loss(y_true, y_pred, y_in) -> torch.Tensor:
    """MSE of the predicted mask applied on the input STFT:
    ``nanmean(((y_pred - y_true) * y_in)**2)`` (reference losses.py:15-25)."""
    return nanmean(((y_pred - y_true) * y_in) ** 2)
