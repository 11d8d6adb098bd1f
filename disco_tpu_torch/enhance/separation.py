"""Source separation over the distributed array — the MEETIT use case
(counterpart of ``disco_tpu/enhance/separation.py``; reference gen_meetit
and the ICASSP 2021 setup).

The same two-step MWF once per source: the port's :func:`tango` is batched
over leading axes, so the source axis is one more leading axis (the JAX
package ``vmap``s over it).
"""
from __future__ import annotations

import torch

from disco_tpu_torch.core.masks import tf_mask
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.tango import tango


def separate_sources(Y, S_imgs, mu: float = 1.0, policy="distant", mask_type: str = "irm1",
                     ref_mic: int = 0, device=None):
    """Oracle-mask separation: every source extracted at every node.

    Args:
      Y: (K, C, F, T) mixture STFTs.
      S_imgs: (n_src, K, C, F, T) per-source image STFTs (sum = Y's signal
        part); source s's interference is ``Y - S_imgs[s]``.
      device: ``"cuda"`` when None.

    Returns:
      (n_src, K, F, T) complex estimates: source s as extracted by node k.
    """
    dev = resolve_device(device)
    Y = torch.as_tensor(Y, dtype=torch.complex64, device=dev)
    S = torch.as_tensor(S_imgs, dtype=torch.complex64, device=dev)
    N = Y - S
    m = tf_mask(S[..., ref_mic, :, :], N[..., ref_mic, :, :], mask_type)
    return tango(Y.expand_as(S), S, N, m, m, mu=mu, policy=policy, ref_mic=ref_mic,
                 mask_type=mask_type, device=dev).yf


def separate_with_masks(Y, masks, mu: float = 1.0, policy="distant", mask_type: str = "irm1",
                        ref_mic: int = 0, device=None):
    """Mask-driven separation (the deployment path — no oracle images).

    Args:
      Y: (K, C, F, T) mixture STFTs.
      masks: (n_src, K, F, T) per-source per-node TF masks (e.g. CRNN
        estimates, or the saved MEETIT IRMs).
      device: ``"cuda"`` when None.

    Returns:
      (n_src, K, F, T) complex per-source estimates.
    """
    if policy not in ("local", "none", "distant", None):
        # oracle/compressed policies need clean components, which the
        # mask-only path replaces with zeros (-> degenerate statistics)
        raise ValueError(
            f"separate_with_masks supports policies 'local'/'none'/'distant'; got {policy!r}"
        )
    dev = resolve_device(device)
    Y = torch.as_tensor(Y, dtype=torch.complex64, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    Yx = Y.expand(masks.shape[:1] + Y.shape)
    Z = torch.zeros_like(Yx)
    return tango(Yx, Z, Z, masks, masks, mu=mu, policy=policy, ref_mic=ref_mic,
                 mask_type=mask_type, device=dev).yf
