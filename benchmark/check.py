"""The comparison that decides ``correct``.

What is judged is the program's product as the window made it: the enhanced
signals of whole batches that ``device.to_host`` copied to the host, a sample
of the window's batches drawn from the seed.  The reference recomputes each
from the same input batch in float64, a few clips at a time, and each (clip,
node) signal's error is its relative L2 distance from the reference's.  The
number compared is the worst of them (``err_worst``), against the cell's
limit (``benchmark/cells/<cell>.json``).  A non-finite output reads as
infinitely far.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CLIPS_A_BLOCK = 2


def errors(pipe, x: torch.Tensor, host: np.ndarray, dtype=torch.float64) -> torch.Tensor:
    """(B, K) relative L2 errors of the output ``host`` (B, K, L) of batch
    ``x`` (3, B, K, C, L) against the reference in ``dtype``."""
    out = []
    for b0 in range(0, x.shape[1], CLIPS_A_BLOCK):
        ref = pipe.reference(x[:, b0:b0 + CLIPS_A_BLOCK], dtype).to(torch.float64)
        got = torch.as_tensor(host[b0:b0 + CLIPS_A_BLOCK], device=ref.device).to(torch.float64)
        err = torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
        out.append(torch.where(torch.isfinite(err), err, torch.full_like(err, math.inf)))
    return torch.cat(out)


def compare(pipe, pool, batches, limits: dict) -> dict:
    """{name: {value, limit}} of the numbers compared over the sampled
    ``batches`` [(window index, host output)]."""
    worst = 0.0
    for i, host in batches:
        e = errors(pipe, pool[i % len(pool)], host)
        worst = max(worst, float(e.max()))
    return {"err_worst": {"value": worst, "limit": limits["err_worst"]}}
