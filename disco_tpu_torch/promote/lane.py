"""The server-side model-mask lane: per-block CRNN masks from a generation
(the port's counterpart of ``disco_tpu/promote/lane.py``).

Sessions opened with ``SessionConfig(masks="model")`` send blocks without
``mask_z``/``mask_w``; the scheduler fills them at dispatch time from the
session's current weight generation through :func:`block_masks` — the
reference mic's magnitude of each of the block's K nodes as the single
CRNN input channel, in one batch
(:func:`disco_tpu_torch.enhance.inference.crnn_masks_batched`; the
reference's local single-channel inference path, tango.py:211-215), and
the sigmoid mask for both the compression (``mask_z``) and the filter
(``mask_w``) roles.

The masks stay on the device: the JAX lane reads them back, and the port's
would then add a device-to-host copy a block and break serving's one
readback a tick.  A tapped model session's masks ride the tick's one
``device.to_host`` instead.

Determinism: the mask is a function of ``(Y block, generation weights)``
only — same block, same generation, same device -> the same bits, served
or replayed offline.  cuDNN runs its deterministic algorithms without
autotuning for the call (``nn.training.deterministic_cudnn``), and the
batch is the block's K nodes in both, so the library picks the same
kernels.
"""
from __future__ import annotations

import numpy as np


def block_masks(Y, model, *, ref_mic: int = 0):
    """(K, F, T) float32 masks, on the model's device, for one (K, C, F, T)
    complex block (host numpy, as the client sent it, or a tensor).

    Reference counterpart: the CRNN branch of ``get_mask``
    (tango.py:211-215), here per served block instead of per clip.
    """
    import torch

    from disco_tpu_torch.enhance.inference import crnn_masks_batched
    from disco_tpu_torch.nn.training import deterministic_cudnn

    dev = next(model.parameters()).device
    if isinstance(Y, torch.Tensor):
        Ys = Y[:, ref_mic].contiguous()
    else:
        Ys = np.ascontiguousarray(np.asarray(Y)[:, ref_mic])   # (K, F, T) complex
    with deterministic_cudnn():
        return crnn_masks_batched(Ys, model, win_len=int(model.input_shape[1]), device=dev)
