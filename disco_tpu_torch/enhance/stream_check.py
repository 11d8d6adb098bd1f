"""The per-block oracle of the scanned streaming path (counterpart of
``disco_tpu/enhance/stream_check.py::per_block_reference``).

Inside the port, a stream driven through ``streaming_tango_scan`` super
ticks is bit-identical to the same stream driven block by block through
``streaming_tango`` with the state carried; this loop is that per-block
side, the one calling convention the checks compare against.
"""
from __future__ import annotations

import numpy as np
import torch

from disco_tpu_torch.enhance.streaming import streaming_tango


def per_block_reference(Y, m, *, block: int, update_every: int, state, plan=None,
                        solver: str = "eigh", precision: str = "f32", device=None):
    """``streaming_tango`` block by block over (K, C, F, T) spectra ``Y``
    and (K, F, T) masks ``m`` (both steps use ``m``): blocks of ``block``
    frames, the explicit ``state`` carried from call to call, and per-block
    ``z_avail`` columns of ``plan`` ((K, T // update_every), all ones when
    None).

    Returns (yf (K, F, T // block * block), the final state)."""
    K, T = Y.shape[0], Y.shape[-1]
    per = block // update_every
    outs = []
    for i in range(T // block):
        lo, hi = i * block, (i + 1) * block
        avail = (np.ones((K, per), np.float32) if plan is None
                 else plan[:, i * per:(i + 1) * per])
        o = streaming_tango(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi],
                            update_every=update_every, state=state, z_avail=avail,
                            solver=solver, precision=precision, device=device)
        state = o["state"]
        outs.append(o["yf"])
    return torch.cat(outs, dim=-1), state
