"""TANGO — the two-step distributed rank-1 GEVD-MWF pipeline (counterpart of
``disco_tpu/enhance/tango.py``; reference speech_enhancement/tango.py:252-457).

Every function here is batched over leading axes: the JAX package
``vmap``s its per-node steps over the node axis, the port writes that axis
out.  So step 1 runs all K nodes' masked covariances as ONE launch and all
K x F pencils as ONE solve — for every solver spec, which is the structure
of the reference's fused-spec step-1 branch (tango.py:450-466) — and step 2
stacks the K per-node ``[y_k ‖ z_{j!=k}]`` inputs as (K, D, F, T),
D = C + K - 1, for one covariance launch and one solve.  A leading clip
axis in front of the node axis batches whole clips the same way.

The "network transport" of the reference (``concatenate_signals``,
tango.py:142-155) is indexing: node k filters ``[y_k ‖ z_{j<k} ‖ z_{j>k}]``
in the ascending skip-k order of :func:`others_index`.

Ported mask-for-z policies: 'local', 'none'/None and 'distant'.  The
'compressed' and oracle policies and the fault seam (``z_mask``, ``z_nan``,
``z_avail``) raise NotImplementedError (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco_tpu_torch.beam.covariance import frame_mean_covariance
from disco_tpu_torch.beam.filters import rank1_gevd
from disco_tpu_torch.core.masks import tf_mask
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.ops.cov_ops import masked_covariances_fused, weighted_cov_folded
from disco_tpu_torch.ops.resolve import check_canonical_precision

Policy = str | None
_POLICIES = ("local", "none", "distant", "compressed", "use_oracle_refs", "use_oracle_zs")
_PORTED_POLICIES = ("local", "none", None, "distant")


@dataclasses.dataclass
class TangoResult:
    """Outputs of the two-step pipeline, all (..., K, F, T) complex unless
    noted — the 9-tuple of reference tango.py:457."""

    yf: torch.Tensor  # filtered mixture (the enhanced signal)
    sf: torch.Tensor  # filter applied to clean speech (for metrics)
    nf: torch.Tensor  # filter applied to clean noise (for metrics)
    z_y: torch.Tensor  # compressed mixture (the exchanged signal)
    z_s: torch.Tensor  # speech component of z
    z_n: torch.Tensor  # noise component of z
    zn: torch.Tensor  # compressed-noise estimate y_ref - z_y
    masks_z: torch.Tensor  # step-1 masks (real)
    mask_w: torch.Tensor  # step-2 masks (real)


def others_index(K: int) -> np.ndarray:
    """(K, K-1) index matrix: row k lists all nodes j != k ascending — the
    concatenation order of reference tango.py:142-155."""
    return np.stack([[j for j in range(K) if j != k] for k in range(K)])


def oracle_masks(S: torch.Tensor, N: torch.Tensor, mask_type: str = "irm1", ref_mic: int = 0):
    """Oracle TF masks at each node's reference mic: (..., K, C, F, T) ->
    (..., K, F, T) (the irm/ibm/iam branch of tango.py:189-211)."""
    return tf_mask(S[..., ref_mic, :, :], N[..., ref_mic, :, :], mask_type)


def _masked_cov_pair(X, mask, cov_impl: str = "auto", precision: str = "f32"):
    """(Rss, Rnn) of ``mask * X`` / ``(1 - mask) * X`` — the shared
    mask -> covariance stage of both steps, through the ``cov_impl`` seam
    (``ops.cov_ops.masked_covariances_fused``).  ``mask`` is (..., F, T)
    shared or (..., C, F, T) per-channel."""
    return masked_covariances_fused(X, mask, impl=cov_impl, precision=precision)


# ------------------------------------------------------------------ step 1
def _step1_covariances(Y, S, N, mask_z, oracle_stats: bool, cov_impl: str, precision: str):
    """The covariance stage of step 1: (..., F, C, C) (Rss, Rnn) pencils
    from the masked mixture, or from the oracle S/N under ``oracle_stats``
    (reference tango.py:326-349)."""
    if oracle_stats:
        return frame_mean_covariance(S), frame_mean_covariance(N)
    return _masked_cov_pair(Y, mask_z, cov_impl, precision)


def _step1_apply(w, t1, Y, S, N, ref_mic: int = 0):
    """The filter-application stage of step 1: (..., F, C) weights -> the
    compressed (..., F, T) exchange streams (the ``np.inner`` applications
    of reference tango.py:361-374)."""
    wc = w.conj()
    z_y = torch.einsum("...fc,...cft->...ft", wc, Y)
    return {
        "z_y": z_y,
        "z_s": torch.einsum("...fc,...cft->...ft", wc, S),
        "z_n": torch.einsum("...fc,...cft->...ft", wc, N),
        "zn": Y[..., ref_mic, :, :] - z_y,
        # np.inner(t1, .): no conjugate
        "z_t1_s": torch.einsum("...fc,...cft->...ft", t1, S),
        "z_t1_n": torch.einsum("...fc,...cft->...ft", t1, N),
    }


def tango_step1(Y, S, N, mask_z, mu: float = 1.0, oracle_stats: bool = False, ref_mic: int = 0,
                solver: str = "power", cov_impl: str = "auto", precision: str = "f32"):
    """Step 1: local rank-1 GEVD-MWF -> compressed signals, for every node
    of the leading axes at once (reference tango.py:326-377).

    Args:
      Y, S, N: (..., C, F, T) complex STFTs of mixture / speech / noise.
      mask_z: (..., F, T) step-1 mask at the reference mic.

    Returns:
      dict of (..., F, T): z_y/z_s/z_n/zn and the t1-projected references
      z_t1_s/z_t1_n.
    """
    precision = check_canonical_precision(precision)
    Rss, Rnn = _step1_covariances(Y, S, N, mask_z, oracle_stats, cov_impl, precision)
    w, t1 = rank1_gevd(Rss, Rnn, mu=mu, solver=solver, precision=precision)
    return _step1_apply(w, t1, Y, S, N, ref_mic)


# ------------------------------------------------------------------ step 2
def tango_step2(Y, S, N, mask_w_k, k, all_z, all_masks_w, all_S_ref, all_N_ref,
                mu: float = 1.0, policy: Policy = "local", ref_mic: int = 0,
                mask_type: str = "irm1", solver: str = "power", cov_impl: str = "auto",
                precision: str = "f32", z_avail=None):
    """Step 2: global rank-1 GEVD-MWF on ``[y_k ‖ z_{j!=k}]`` (reference
    tango.py:380-455).

    Args:
      Y, S, N: (C, F, T) local STFTs of node ``k`` (an int), or (..., K', C,
        F, T) with ``k`` a (K',) sequence of node indices — the stacked
        form :func:`tango` uses.
      mask_w_k: (F, T) / (..., K', F, T) step-2 masks of those nodes.
      all_z: dict of (..., K, F, T) step-1 outputs of ALL nodes (the
        z-exchange).
      all_masks_w: (..., K, F, T) step-2 masks (the 'distant' policy).
      all_S_ref, all_N_ref: (..., K, F, T) ref-mic clean components (the
        oracle policies, not ported yet).

    Returns:
      (yf, sf, nf): filtered mixture / speech / noise, (F, T) / (..., K', F, T).
    """
    precision = check_canonical_precision(precision)
    if z_avail is not None:
        raise NotImplementedError("the z-exchange fault seam (z_avail) is not ported yet "
                                  "(ROADMAP.md Queue 1: fault seam)")
    _check_policy(policy)
    K = all_z["z_y"].shape[-3]
    C = Y.shape[-3]
    k = torch.as_tensor(k, device=Y.device)
    ar = torch.arange(K - 1, device=Y.device)
    oth = ar + (ar >= k[..., None]).long()  # ascending j != k

    def sel(v):
        return v[..., oth, :, :]

    in_y = torch.cat([Y, sel(all_z["z_y"])], dim=-3)  # (..., C+K-1, F, T)
    m_c = mask_w_k[..., None, :, :].expand(mask_w_k.shape[:-2] + (C,) + mask_w_k.shape[-2:])
    if policy == "local":
        # node k's own mask on every stacked channel (tango.py:418-420)
        Rss, Rnn = _masked_cov_pair(in_y, mask_w_k, cov_impl, precision)
    elif policy == "distant":
        # producer masks on the z channels, the consumer mask on the local
        # mics (tango.py:398-400): one per-channel mask stack
        chan_mask = torch.cat([m_c, sel(all_masks_w)], dim=-3)
        Rss, Rnn = _masked_cov_pair(in_y, chan_mask, cov_impl, precision)
    else:
        # unmasked z for the speech stats, zn = y_ref - z for the noise
        # stats (tango.py:421-424): two single-covariance folds
        ones = torch.ones(m_c.shape[:-3] + (K - 1,) + m_c.shape[-2:],
                          dtype=m_c.dtype, device=m_c.device)
        Rss = weighted_cov_folded(in_y, torch.cat([m_c, ones], dim=-3), precision)
        in_zn = torch.cat([Y, sel(all_z["zn"])], dim=-3)
        Rnn = weighted_cov_folded(in_zn, torch.cat([1.0 - m_c, ones], dim=-3), precision)
    w, _ = rank1_gevd(Rss, Rnn, mu=mu, solver=solver, precision=precision)  # (..., F, D)

    wc = w.conj()
    in_s = torch.cat([S, sel(all_z["z_s"])], dim=-3)
    in_n = torch.cat([N, sel(all_z["z_n"])], dim=-3)
    yf = torch.einsum("...fc,...cft->...ft", wc, in_y)
    sf = torch.einsum("...fc,...cft->...ft", wc, in_s)
    nf = torch.einsum("...fc,...cft->...ft", wc, in_n)
    return yf, sf, nf


def _check_policy(policy: Policy) -> None:
    if policy not in _POLICIES and policy is not None:
        raise ValueError(f"unknown mask_for_z policy {policy!r}; expected one of {_POLICIES}")
    if policy not in _PORTED_POLICIES:
        raise NotImplementedError(f"mask_for_z policy {policy!r} is not ported yet "
                                  "(ROADMAP.md Queue 1: the other TANGO policies)")


# ------------------------------------------------------------- full pipeline
def tango(Y, S, N, masks_z, mask_w, mu: float = 1.0, policy: Policy = "local",
          ref_mic: int = 0, mask_type: str = "irm1", oracle_step1_stats: bool = False,
          solver: str = "power", cov_impl: str = "auto", precision: str = "f32",
          z_mask=None, z_nan=None, device=None) -> TangoResult:
    """The full two-step pipeline; the z-exchange is plain indexing.

    Args:
      Y, S, N: (..., K, C, F, T) complex STFT stacks (numpy or tensors).
      masks_z, mask_w: (..., K, F, T) step-1 / step-2 masks.
      device: where to run — ``"cuda"`` when None (RuntimeError without a
        CUDA device), ``"cpu"`` for the plain versions on the host.
      z_mask, z_nan: the fault seam, not ported yet (NotImplementedError).
    """
    precision = check_canonical_precision(precision)
    if z_mask is not None or z_nan is not None:
        raise NotImplementedError("the z-exchange fault seam (z_mask, z_nan) is not ported yet "
                                  "(ROADMAP.md Queue 1: fault seam)")
    _check_policy(policy)
    dev = resolve_device(device)
    Y, S, N = (torch.as_tensor(a, dtype=torch.complex64, device=dev) for a in (Y, S, N))
    masks_z = torch.as_tensor(masks_z, dtype=torch.float32, device=dev)
    mask_w = torch.as_tensor(mask_w, dtype=torch.float32, device=dev)
    all_z = tango_step1(Y, S, N, masks_z, mu=mu, oracle_stats=oracle_step1_stats,
                        ref_mic=ref_mic, solver=solver, cov_impl=cov_impl, precision=precision)
    K = Y.shape[-4]
    yf, sf, nf = tango_step2(
        Y, S, N, mask_w, torch.arange(K, device=dev), all_z, mask_w,
        S[..., ref_mic, :, :], N[..., ref_mic, :, :], mu=mu, policy=policy, ref_mic=ref_mic,
        mask_type=mask_type, solver=solver, cov_impl=cov_impl, precision=precision,
    )
    return TangoResult(yf=yf, sf=sf, nf=nf, z_y=all_z["z_y"], z_s=all_z["z_s"],
                       z_n=all_z["z_n"], zn=all_z["zn"], masks_z=masks_z, mask_w=mask_w)
