"""The compressed z signals of step 1 over all nodes (counterpart of
``disco_tpu/enhance/zexport.py::compute_z_signals``; reference
speech_enhancement/get_z_signals.py:213-317).

The file export (``export_z``, ``load_node_signals``,
``load_mixture_signals``) comes with the corpus driver.
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.dsp import stft
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.tango import oracle_masks, tango_step1
from disco_tpu_torch.ops.resolve import check_canonical_precision


def compute_z_signals(y, s, n, masks_z=None, mask_type: str = "irm1", mu: float = 1.0,
                      oracle_stats: bool = False, Y=None, S=None, N=None, solver: str = "power",
                      cov_impl: str = "auto", precision: str = "f32", device=None):
    """Step 1 over all nodes: (K, C, L) time signals → dict of (K, F, T) z
    streams (reference get_z_signals.py:213-317, vectorized).

    ``masks_z`` may be given explicitly (K, F, T) — e.g. CRNN-estimated —
    else oracle masks of ``mask_type`` are computed from S and N.  With
    explicit masks, ``s``/``n`` may be None (z_s/z_n then come out zero).
    Precomputed STFTs may be passed as ``Y``/``S``/``N`` to skip the
    transform.

    ``solver``/``cov_impl``/``precision`` go to the step-1 covariance and
    solve stages as in :func:`~disco_tpu_torch.enhance.tango.tango`, with
    the JAX package's defaults ('power'/'auto'/'f32').  The port's step 1
    runs all K × F pencils as one covariance launch and one solve for every
    solver spec, which is the structure of the JAX package's fused-spec
    branch; its other branch, K vmapped per-node steps, computes the same.

    Returns the dict of :func:`~disco_tpu_torch.enhance.tango.tango_step1`
    plus ``masks_z``.  ``device``: ``"cuda"`` when None.
    """
    precision = check_canonical_precision(precision)
    dev = resolve_device(device)

    def spec(x, X):
        if X is not None:
            return torch.as_tensor(X, dtype=torch.complex64, device=dev)
        return None if x is None else stft(torch.as_tensor(x, dtype=torch.float32, device=dev))

    Y = spec(y, Y)
    S, N = (a if a is not None else torch.zeros_like(Y) for a in (spec(s, S), spec(n, N)))
    if masks_z is None:
        if s is None or n is None:
            raise ValueError("either pass masks_z explicitly or provide s and n for oracle masks")
        masks_z = oracle_masks(S, N, mask_type)
    masks_z = torch.as_tensor(masks_z, dtype=torch.float32, device=dev)
    out = tango_step1(Y, S, N, masks_z, mu=mu, oracle_stats=oracle_stats, solver=solver,
                      cov_impl=cov_impl, precision=precision)
    out["masks_z"] = masks_z
    return out
