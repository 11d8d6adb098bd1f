"""The corpus driver's mask stage (counterpart of the mask functions of
``disco_tpu/enhance/driver.py``): step-1 and step-2 masks, oracle or from
CRNNs, for one clip (:func:`estimate_masks`) or a batch of clips
(:func:`_batched_masks`).

A CRNN model is the port's module with its weights loaded (for weights of
the JAX package: :func:`disco_tpu_torch.nn.convert.state_dict_from_flax`),
on the device the call runs on.  The rest of the driver (``enhance_rir``,
``enhance_rirs_batched``, the batch runners and the files) comes with the
corpus-driver port.
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.masks import tf_mask_mag
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.inference import crnn_masks_batched
from disco_tpu_torch.enhance.tango import oracle_masks, others_index
from disco_tpu_torch.enhance.zexport import compute_z_signals


def _spectra(dev, *arrays):
    return tuple(None if a is None else torch.as_tensor(a, dtype=torch.complex64, device=dev)
                 for a in arrays)


def estimate_masks(Y, S, N, models, mask_type: str, n_nodes: int, mu: float = 1.0,
                   z_sigs: str = "zs_hat", mags=None, device=None):
    """Step-1 and step-2 masks of one clip, oracle or CRNN (reference
    tango.py:189-225, 387-394).

    Args:
      Y, S, N: (K, C, F, T) STFTs (S and N only for oracle masks and the
        z diagnostics; None where no oracle mask is asked for).
      models: a 2-list; each entry None (the oracle mask of ``mask_type``)
        or a CRNN module.  The step-2 CRNN reads the local reference channel
        and the exchanged z streams, so step 1 runs first to produce them,
        through :func:`compute_z_signals` with its default solver
        (``'power'``), whatever solver the TANGO run that follows uses.
      mags: optional ``(mag_S, mag_N)`` (K, C, F, T) magnitudes from the
        fused STFT (``ops.stft_ops.stft_with_mag``): the irm/ibm oracle
        masks then read them instead of the complex spectra.
      device: ``"cuda"`` when None.

    Returns:
      (masks_z, mask_w), each (K, F, T) float32 on ``device``.
    """
    dev = resolve_device(device)
    one = tuple(None if a is None else a[None] for a in _spectra(dev, Y, S, N))
    mags = None if mags is None else tuple(m[None] for m in mags)
    masks_z, mask_w = _batched_masks(*one, models, mask_type, mu, n_nodes, z_sigs, device=dev,
                                     mags=mags)
    return masks_z[0], mask_w[0]


def _z_for_mask_device(z_y, zn, n_nodes: int, z_sigs: str):
    """:func:`~disco_tpu_torch.enhance.inference.get_z_for_mask` for all
    nodes at once, on the device: (..., K, F, T) z streams → (..., K, n_z,
    F, T) per-node NN inputs ('zs_hat' / 'zn_hat': the other nodes' z_y /
    zn; the pair: [z_y_j, zn_j] interleaved, the local pair dropped)."""
    if z_sigs in ("zs_hat", "zn_hat"):
        z_in = z_y if z_sigs == "zs_hat" else zn
        oth = torch.as_tensor(others_index(n_nodes), device=z_in.device)  # (K, K-1)
        return z_in[..., oth, :, :]
    inter = torch.stack([z_y, zn], dim=-3)
    inter = inter.reshape(inter.shape[:-4] + (2 * n_nodes,) + inter.shape[-2:])
    keep = torch.as_tensor([[j for j in range(2 * n_nodes) if j not in (2 * k, 2 * k + 1)]
                            for k in range(n_nodes)], device=z_y.device)
    return inter[..., keep, :, :]


def _batched_masks(Yb, Sb, Nb, models, mask_type, mu, n_nodes, z_sigs, device=None, mags=None):
    """Step-1/step-2 masks for a whole clip batch (B, K, C, F, T): the
    (B K) node forwards of each CRNN step run as one
    :func:`crnn_masks_batched` call, step 1 as one :func:`compute_z_signals`
    call over the batch (its default solver, ``'power'``).  ``mags``:
    optional (B, K, C, F, T) ``(mag_S, mag_N)`` for the irm/ibm oracle
    masks (see :func:`estimate_masks`).  Returns (Mz, Mw), each
    (B, K, F, T)."""
    dev = resolve_device(device)
    Yb, Sb, Nb = _spectra(dev, Yb, Sb, Nb)
    B, K, _, F, T = Yb.shape
    refs = Yb[:, :, 0].reshape(B * K, F, T)

    def oracle():
        if mags is not None and mask_type[:-1] in ("irm", "ibm"):
            mag_s, mag_n = (torch.as_tensor(m, device=dev) for m in mags)
            return tf_mask_mag(mag_s[..., 0, :, :], mag_n[..., 0, :, :], mask_type)
        return oracle_masks(Sb, Nb, mask_type)

    if models[0] is None:
        Mz = oracle()
    else:
        Mz = crnn_masks_batched(refs, models[0], device=dev).reshape(B, K, F, T)
    if models[1] is None:
        return Mz, oracle()
    out = compute_z_signals(None, None, None, Y=Yb, S=Sb, N=Nb, masks_z=Mz, mu=mu, device=dev)
    zs = _z_for_mask_device(out["z_y"], out["zn"], n_nodes, z_sigs).reshape(B * K, -1, F, T)
    Mw = crnn_masks_batched(refs, models[1], zs=zs, device=dev).reshape(B, K, F, T)
    return Mz, Mw
