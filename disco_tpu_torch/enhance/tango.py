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

Every mask-for-z policy of the reference is ported: 'local', 'none'/None
and 'distant' run their statistics as masked covariances of the stacked
streams (the kernel, or the folded einsum for 'none'); 'compressed',
'use_oracle_refs' and 'use_oracle_zs' substitute other signals for the z
channels and take the materializing ``frame_mean_covariance`` path, as
the JAX package does.

Both precision lanes run through both steps: ``precision='bf16'`` rounds
the covariance kernels' spectra, the folded einsum's operands and, under
the ``'fused*'`` solvers, the solve's pencils to bf16, with float32
accumulators (``ops/resolve.py``).

The z-exchange fault seam (no reference counterpart): ``z_mask`` ((K,) per
source node, or (K, K) with row k what consumer k received) and ``z_nan``
(NaN injected into a node's exchanged streams after step 1).  Either one
arms the finiteness guard (:func:`finite_z_guard`), and the step-2
consumers see a (K, K) availability: an unavailable z channel is zeroed by
a select (:func:`_masked_select`) before the covariances are formed, and
its noise-covariance diagonal is loaded (:func:`_regularize_excluded`),
which decouples it from the GEVD, so the surviving channels solve the
subset problem; with every link down a node falls back to its local MWF.
With ``z_mask=None`` and ``z_nan=None`` the fault-free path runs
unchanged.

The steps run on a rank's shard under ``disco_tpu_torch.parallel``:
``tango_step2`` takes the (..., K') node indices of the shard's nodes,
and both steps take a ``frame_group`` (the JAX package's ``frame_axis``):
with one, each covariance is a frame sum ``all_reduce``d over the group's
ranks, by the materializing einsum.  Without one every result is what it
was.
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


def _masked_cov_pair(X, mask, cov_impl: str = "auto", precision: str = "f32",
                     frame_group=None):
    """(Rss, Rnn) of ``mask * X`` / ``(1 - mask) * X`` — the shared
    mask -> covariance stage of both steps, through the ``cov_impl`` seam
    (``ops.cov_ops.masked_covariances_fused``).  ``mask`` is (..., F, T)
    shared or (..., C, F, T) per-channel.  With a ``frame_group``
    (sequence parallelism) the masked copies are made and their frame sums
    ``all_reduce``d (:func:`frame_mean_covariance`), as the JAX package's
    ``frame_axis`` path does: no covariance kernel runs there."""
    if frame_group is None:
        return masked_covariances_fused(X, mask, impl=cov_impl, precision=precision)
    m = mask[..., None, :, :] if mask.ndim == X.ndim - 1 else mask
    return (frame_mean_covariance(m * X, group=frame_group),
            frame_mean_covariance((1.0 - m) * X, group=frame_group))


# ------------------------------------------------------------------ step 1
def _step1_covariances(Y, S, N, mask_z, oracle_stats: bool, cov_impl: str, precision: str,
                       frame_group=None):
    """The covariance stage of step 1: (..., F, C, C) (Rss, Rnn) pencils
    from the masked mixture, or from the oracle S/N under ``oracle_stats``
    (reference tango.py:326-349)."""
    if oracle_stats:
        return (frame_mean_covariance(S, group=frame_group),
                frame_mean_covariance(N, group=frame_group))
    return _masked_cov_pair(Y, mask_z, cov_impl, precision, frame_group)


def _apply(w, X):
    """``sum_c w[..., f, c] X[..., c, f, t]``: (..., F, C) filters on
    (..., C, F, T) streams, as a product and a sum over the channel axis.
    A batched matrix product would let cuBLAS pick its kernel by the
    batch, so on the card a clip would come out of a chunk of two in other
    bits than alone, and a resumed corpus run, whose chunks are other sizes,
    would not rewrite the same files (ROADMAP Queue 3, fault 5); the
    product and the sum give each output the same arithmetic in any batch,
    and at the north-star batch are no slower
    (`exp/batch_invariance_probe.py`, H100)."""
    return (w.transpose(-1, -2)[..., None] * X).sum(-3)


def _step1_apply(w, t1, Y, S, N, ref_mic: int = 0):
    """The filter-application stage of step 1: (..., F, C) weights -> the
    compressed (..., F, T) exchange streams (the ``np.inner`` applications
    of reference tango.py:361-374)."""
    wc = w.conj()
    z_y = _apply(wc, Y)
    return {
        "z_y": z_y,
        "z_s": _apply(wc, S),
        "z_n": _apply(wc, N),
        "zn": Y[..., ref_mic, :, :] - z_y,
        # np.inner(t1, .): no conjugate
        "z_t1_s": _apply(t1, S),
        "z_t1_n": _apply(t1, N),
    }


def tango_step1(Y, S, N, mask_z, mu: float = 1.0, oracle_stats: bool = False, ref_mic: int = 0,
                solver: str = "power", cov_impl: str = "auto", precision: str = "f32",
                frame_group=None):
    """Step 1: local rank-1 GEVD-MWF -> compressed signals, for every node
    of the leading axes at once (reference tango.py:326-377).

    Args:
      Y, S, N: (..., C, F, T) complex STFTs of mixture / speech / noise.
      mask_z: (..., F, T) step-1 mask at the reference mic.
      frame_group: the process group the frame axis is sharded over
        (sequence parallelism; the JAX package's ``frame_axis``), or None.

    Returns:
      dict of (..., F, T): z_y/z_s/z_n/zn and the t1-projected references
      z_t1_s/z_t1_n.
    """
    precision = check_canonical_precision(precision)
    Rss, Rnn = _step1_covariances(Y, S, N, mask_z, oracle_stats, cov_impl, precision,
                                  frame_group)
    w, t1 = rank1_gevd(Rss, Rnn, mu=mu, solver=solver, precision=precision)
    return _step1_apply(w, t1, Y, S, N, ref_mic)


# ------------------------------------------------------------------ step 2
def _masked_select(z_oth, a_oth):
    """Zero the unavailable channels of a gathered (..., K-1, F, T) stack,
    ``a_oth`` (..., K-1).  A select, not a product: a corrupted stream may
    carry NaN, and ``0 * nan`` is NaN."""
    return torch.where(a_oth[..., None, None] > 0, z_oth, torch.zeros((), dtype=z_oth.dtype))


def _regularize_excluded(Rnn, n_mics: int, a_oth):
    """Load the noise-covariance diagonal of the excluded z channels of
    (..., F, D, D) pencils (D = n_mics + K - 1) by the mean Rnn diagonal, at
    least ``tiny``: the zeroed channel's generalized eigenvalue falls to the
    clamp floor, its gain to ~0, and the others solve the subset MWF.
    ``a_oth`` (..., K-1) is the availability of the pencils' z channels, its
    leading axes broadcasting against the pencils' (..., F)."""
    D = Rnn.shape[-1]
    excluded = 1.0 - (a_oth > 0).to(Rnn.real.dtype)
    reg = torch.cat([excluded.new_zeros(excluded.shape[:-1] + (n_mics,)), excluded], dim=-1)
    tr = torch.diagonal(Rnn, dim1=-2, dim2=-1).real.sum(-1) / D          # (..., F)
    load = tr.clamp_min(torch.finfo(tr.dtype).tiny)[..., None] * reg        # (..., F, D)
    return Rnn + torch.diag_embed(load).to(Rnn.dtype)


def finite_z_guard(z_y):
    """(..., K) availability flags from the finiteness of the exchanged
    streams (..., K, F, T): a node whose z carries any non-finite value is
    treated as unavailable."""
    fin = torch.isfinite(z_y.real) & torch.isfinite(z_y.imag)
    return fin.all(dim=-1).all(dim=-1).to(z_y.real.dtype)


def _z_stats(policy: Policy, all_z, all_masks_w, all_S_ref, all_N_ref, mask_type: str):
    """Speech / noise statistic streams of the exchanged z under the
    policies that substitute other signals for them (tango.py:401-411), and
    under 'none' and 'distant' when the frame axis is sharded (their folded
    covariances then give way to these): (..., K, F, T) each, indexed by
    source node."""
    z_y = all_z["z_y"]
    if policy is None or policy == "none":
        # unmasked z for the speech stats, zn for the noise (tango.py:421-424)
        return z_y, all_z["zn"]
    if policy == "distant":
        # each z_j masked with its producer's own mask (tango.py:398-400)
        return all_masks_w * z_y, (1.0 - all_masks_w) * z_y
    if policy == "compressed":
        # a mask estimated on the compressed signal itself
        mc = tf_mask(all_z["z_s"], all_z["z_n"], mask_type)
        return mc * z_y, (1.0 - mc) * z_y
    if policy == "use_oracle_refs":
        # the oracle ref-mic clean components in place of z
        return all_S_ref, all_N_ref
    # 'use_oracle_zs': the true speech / noise components of z
    return all_z["z_s"], all_z["z_n"]


def tango_step2(Y, S, N, mask_w_k, k, all_z, all_masks_w, all_S_ref, all_N_ref,
                mu: float = 1.0, policy: Policy = "local", ref_mic: int = 0,
                mask_type: str = "irm1", solver: str = "power", cov_impl: str = "auto",
                precision: str = "f32", z_avail=None, frame_group=None):
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
        'use_oracle_refs' policy).
      z_avail: optional availability of the exchanged streams as each
        consumer sees them: (..., K) for an int ``k``, (..., K', K) for a
        sequence (1 = arrived intact).  Unavailable channels are excluded
        from the MWF (module docstring); None is the fault-free path.
      frame_group: the process group the frame axis is sharded over, or
        None.  With one, every covariance is a frame sum ``all_reduce``d
        over it, and 'none' and 'distant' give up their folded
        covariances for the materializing ones, as the JAX package's
        ``frame_axis`` path does.

    Returns:
      (yf, sf, nf): filtered mixture / speech / noise, (F, T) / (..., K', F, T).
    """
    precision = check_canonical_precision(precision)
    _check_policy(policy)
    K = all_z["z_y"].shape[-3]
    C = Y.shape[-3]
    k = torch.as_tensor(k, device=Y.device)
    ar = torch.arange(K - 1, device=Y.device)
    oth = ar + (ar >= k[..., None]).long()  # ascending j != k

    def take(v):
        return v[..., oth, :, :]

    if z_avail is None:
        sel = take
    else:
        z_avail = torch.as_tensor(z_avail, device=Y.device)
        a_oth = torch.take_along_dim(z_avail, oth.expand(z_avail.shape[:-1] + oth.shape[-1:]),
                                     dim=-1)

        def sel(v):
            return _masked_select(take(v), a_oth)

    in_y = torch.cat([Y, sel(all_z["z_y"])], dim=-3)  # (..., C+K-1, F, T)
    m_c = mask_w_k[..., None, :, :].expand(mask_w_k.shape[:-2] + (C,) + mask_w_k.shape[-2:])
    fold_ok = frame_group is None  # sequence parallelism keeps the all_reduce path
    if policy == "local":
        # node k's own mask on every stacked channel (tango.py:418-420)
        Rss, Rnn = _masked_cov_pair(in_y, mask_w_k, cov_impl, precision, frame_group)
    elif policy == "distant" and fold_ok:
        # producer masks on the z channels, the consumer mask on the local
        # mics (tango.py:398-400): one per-channel mask stack
        chan_mask = torch.cat([m_c, take(all_masks_w)], dim=-3)
        Rss, Rnn = _masked_cov_pair(in_y, chan_mask, cov_impl, precision)
    elif policy in (None, "none") and fold_ok:
        # unmasked z for the speech stats, zn = y_ref - z for the noise
        # stats (tango.py:421-424): two single-covariance folds
        ones = torch.ones(m_c.shape[:-3] + (K - 1,) + m_c.shape[-2:],
                          dtype=m_c.dtype, device=m_c.device)
        Rss = weighted_cov_folded(in_y, torch.cat([m_c, ones], dim=-3), precision)
        in_zn = torch.cat([Y, sel(all_z["zn"])], dim=-3)
        Rnn = weighted_cov_folded(in_zn, torch.cat([1.0 - m_c, ones], dim=-3), precision)
    else:
        # other signals in place of z: the materializing covariances
        zs_stat, zn_stat = _z_stats(policy, all_z, all_masks_w, all_S_ref, all_N_ref, mask_type)
        m = mask_w_k[..., None, :, :]
        Rss = frame_mean_covariance(torch.cat([m * Y, sel(zs_stat)], dim=-3), group=frame_group)
        Rnn = frame_mean_covariance(torch.cat([(1.0 - m) * Y, sel(zn_stat)], dim=-3),
                                    group=frame_group)
    if z_avail is not None:
        Rnn = _regularize_excluded(Rnn, C, a_oth[..., None, :])
    w, _ = rank1_gevd(Rss, Rnn, mu=mu, solver=solver, precision=precision)  # (..., F, D)

    wc = w.conj()
    in_s = torch.cat([S, sel(all_z["z_s"])], dim=-3)
    in_n = torch.cat([N, sel(all_z["z_n"])], dim=-3)
    return _apply(wc, in_y), _apply(wc, in_s), _apply(wc, in_n)


def _check_policy(policy: Policy) -> None:
    if policy not in _POLICIES and policy is not None:
        raise ValueError(f"unknown mask_for_z policy {policy!r}; expected one of {_POLICIES}")


# ------------------------------------------------------------- full pipeline
def tango(Y, S, N, masks_z, mask_w, mu: float = 1.0, policy: Policy = "local",
          ref_mic: int = 0, mask_type: str = "irm1", oracle_step1_stats: bool = False,
          solver: str = "power", cov_impl: str = "auto", precision: str = "f32",
          z_mask=None, z_nan=None, device=None) -> TangoResult:
    """The full two-step pipeline; the z-exchange is plain indexing.

    Args:
      Y, S, N: (..., K, C, F, T) complex STFT stacks (numpy or tensors).
      masks_z, mask_w: (..., K, F, T) step-1 / step-2 masks.
      precision: ``'f32'`` or ``'bf16'`` (canonical tokens only), both
        steps' covariances and, under the ``'fused*'`` solvers, the solve.
      z_mask: optional availability of the exchanged z streams — (K,) per
        source node, or (K, K) with row k what consumer k received.
        Unavailable streams are excluded from the step-2 MWF; with none
        available a node beamforms with its own mics alone.
      z_nan: optional (K,) flags — node k's exchanged streams turn NaN after
        step 1 (fault injection at the exchange seam).  Either fault input
        arms the finiteness guard: a node whose z is not finite is
        excluded, injected or not.
      device: where to run — ``"cuda"`` when None (RuntimeError without a
        CUDA device), ``"cpu"`` for the plain versions on the host.
    """
    precision = check_canonical_precision(precision)
    _check_policy(policy)
    dev = resolve_device(device)
    Y, S, N = (torch.as_tensor(a, dtype=torch.complex64, device=dev) for a in (Y, S, N))
    masks_z = torch.as_tensor(masks_z, dtype=torch.float32, device=dev)
    mask_w = torch.as_tensor(mask_w, dtype=torch.float32, device=dev)
    all_z = tango_step1(Y, S, N, masks_z, mu=mu, oracle_stats=oracle_step1_stats,
                        ref_mic=ref_mic, solver=solver, cov_impl=cov_impl, precision=precision)
    K = Y.shape[-4]
    avail = None
    if z_nan is not None:
        # every stream the corrupted node sends turns NaN, as a garbled
        # packet would look to its consumers (the guard below catches it)
        bad = (torch.as_tensor(z_nan, device=dev) > 0)[:, None, None]
        nanc = torch.full((), complex(float("nan"), float("nan")), dtype=torch.complex64,
                          device=dev)
        all_z = {key: torch.where(bad, nanc, val) for key, val in all_z.items()}
    if z_mask is not None or z_nan is not None:
        fin = finite_z_guard(all_z["z_y"])[..., None, :]              # (..., 1, K) by source
        if z_mask is None:
            avail = fin.expand(fin.shape[:-2] + (K, K))
        else:
            zm = torch.as_tensor(z_mask, dtype=torch.float32, device=dev)
            avail = zm.expand(K, K) * fin                             # rows: consumer
    yf, sf, nf = tango_step2(
        Y, S, N, mask_w, torch.arange(K, device=dev), all_z, mask_w,
        S[..., ref_mic, :, :], N[..., ref_mic, :, :], mu=mu, policy=policy, ref_mic=ref_mic,
        mask_type=mask_type, solver=solver, cov_impl=cov_impl, precision=precision,
        z_avail=avail,
    )
    return TangoResult(yf=yf, sf=sf, nf=nf, z_y=all_z["z_y"], z_s=all_z["z_s"],
                       z_n=all_z["z_n"], zn=all_z["zn"], masks_z=masks_z, mask_w=mask_w)
