"""Inference glue: STFT streams shaped into CRNN batches and back into masks
(counterpart of ``disco_tpu/enhance/inference.py``; reference
speech_enhancement/utils.py:13-138, tango.py:158-249).

Two paths, as in the JAX package:

* :func:`crnn_mask` — host-side numpy prep (``sliding_window_view``) and
  one forward over all windows of one stream; the simple entry point.
* :func:`crnn_masks_batched` — the production path: normalization, window
  gathering and the forwards run on the device, in groups of 8 streams
  (the last group filled by repeating the last stream, whose masks are
  dropped), with the CRNN's conv stack hoisted to the full stream
  (``CRNN.forward(stream=True)``) so the convs run once instead of once per
  window.  Models whose convs pad, stride or pool along time, and models
  with no convs, take the per-window route.  PCEN runs on the host, so
  that normalization takes the per-stream route through :func:`crnn_mask`.

PCEN is written natively (the reference calls librosa.pcen,
speech_enhancement/utils.py:61-64): per-channel IIR smoothing with
librosa's coefficient from ``time_constant``, then the
``(E/(eps+M)^gain + bias)^power − bias^power`` compression, in numpy and
scipy as in the JAX package.

On the card the convs, BatchNorm, recurrent and linear layers are torch's
own (cuDNN/cuBLAS) with TF32 off: the JAX package computes these through
XLA, not through a kernel of its own.
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from disco_tpu_torch.core.masks import vad_oracle_batch, vad_to_mask
from disco_tpu_torch.core.mathx import quantile_linear
from disco_tpu_torch.device import check_module_device, resolve_device
from disco_tpu_torch.nn.bricks import _pair, broadcast_arg, spec_per_layer

STFT_MIN, STFT_MAX = 1e-6, 1e3  # utils.py:7
FS = 16000
N_FFT = 512
N_HOP = 256
FRAMES_LOST = 6  # utils.py:10 — conv-cropped frames of the canonical CRNN
GROUP = 8  # streams a forward of crnn_masks_batched (inference.py:262-266 of the JAX package)


def get_frames_to_pad(in_len: int, output_frames: str, out_len: int | None = None) -> tuple[int, int]:
    """(left, right) zero-frames so the selected output frame lines up with
    the first input frame (reference utils.py:13-33)."""
    out_len = in_len if out_len is None else out_len
    if output_frames == "mid":
        return int(np.floor(in_len / 2)), int(np.floor(in_len / 2))
    if output_frames == "last":
        selected = (in_len + out_len) // 2
        return selected - 1, in_len - selected
    if output_frames == "all":
        return 0, 0
    raise ValueError("output_frames should be 'mid', 'last' or 'all'")


def pcen(S, sr: int = FS, hop_length: int = N_HOP, gain: float = 0.98, bias: float = 2.0,
         power: float = 0.5, time_constant: float = 0.400, eps: float = 1e-6, axis: int = -1):
    """Per-channel energy normalization over the frame axis, float64 on the
    host (reference utils.py:61-64's librosa.pcen)."""
    S = np.asarray(S, dtype=np.float64)
    t_frames = time_constant * sr / float(hop_length)
    b = (np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)
    zi = (1 - b) * np.expand_dims(S.take(0, axis=axis), axis)
    M, _ = scipy.signal.lfilter([b], [1, b - 1], S, axis=axis, zi=zi)
    smooth = np.exp(-gain * (np.log(eps) + np.log1p(M / eps)))
    return (S * smooth + bias) ** power - bias**power


def normalization(x, norm_type: str | None = None, axis: int = 0):
    """Inference-time feature normalization on the host (reference
    utils.py:36-66): None | 'scale_to_unit_norm' | 'scale_to_1' (q99) |
    'center_and_scale' | 'pcen'.  Input may be complex; output is a
    normalized magnitude."""
    x = np.clip(np.abs(x), STFT_MIN, STFT_MAX)
    if norm_type == "pcen":
        return pcen(x * 2**31)
    if norm_type == "scale_to_unit_norm":
        x_norm = np.linalg.norm(x, axis=axis, keepdims=True)
    elif norm_type == "scale_to_1":
        x_norm = np.quantile(x, 0.99, axis=axis, keepdims=True)
    elif norm_type == "center_and_scale":
        x = x - np.mean(x, axis=axis, keepdims=True)
        x_norm = np.std(x, axis=axis, keepdims=True)
    else:
        return x
    return x / x_norm


def prepare_data(y_data, three_d_tensor: bool, z_data=None, win_len: int = 21, win_hop: int = 1,
                 frame_to_pred: str = "last", norm_type: str | None = None,
                 frames_lost: int = FRAMES_LOST):
    """(F, T) stream(s) → (n_windows, …) float32 model input on the host
    (reference utils.py:69-138): normalize, pad so the predicted frame
    covers every original frame, slide ``win_len`` windows with hop
    ``win_hop``, stack z channels on the channel axis (3-D CRNN) or the
    frequency axis (2-D RNN)."""
    chans = [normalization(y_data, norm_type=norm_type, axis=1)]
    if z_data is not None:
        chans += [normalization(z, norm_type=norm_type, axis=1) for z in z_data]

    pad = get_frames_to_pad(win_len, frame_to_pred, out_len=win_len - frames_lost)
    stacked = np.stack([np.pad(c, ((0, 0), pad)) for c in chans])  # (C, F, Tp)
    wins = np.lib.stride_tricks.sliding_window_view(stacked, win_len, axis=-1)
    wins = wins[:, :, ::win_hop]  # (C, F, n, win_len)
    out = np.ascontiguousarray(np.transpose(wins, (2, 0, 3, 1)), dtype=np.float32)
    if not three_d_tensor:
        n, c, t, f = out.shape
        out = np.ascontiguousarray(np.transpose(out, (0, 2, 1, 3))).reshape(n, t, c * f)
    return out


def reshape_mask(mask_stack, output_frame: str = "last"):
    """Stacked per-window model outputs (n, win_out, F) → one (F, T) mask
    (reference tango.py:228-240)."""
    if output_frame == "last":
        out = mask_stack[:, -1, :]
    elif output_frame == "mid":
        win_len = mask_stack.shape[1]
        out = mask_stack[:, int(np.floor(win_len / 2)), :]
    elif output_frame == "all":
        raise NotImplementedError("'all' inference reshaping is not implemented (as in the reference)")
    else:
        raise ValueError("output_frame should be 'last' or 'mid'")
    return np.squeeze(out).T


def get_z_for_mask(z_s, z_n, k: int, nb_nodes: int = 4, z_sigs="zs_hat"):
    """Select/reorder the exchanged z streams for the NN input at node k, on
    the host (reference tango.py:158-186): a single z kind drops the local
    node; the zs&zn pair interleaves [zs_j, zn_j, …] then drops the local
    pair."""
    if z_sigs in ("zs_hat", "zn_hat"):
        z_in = np.asarray(z_s if z_sigs == "zs_hat" else z_n)
        keep = [j for j in range(nb_nodes) if j != k]
        return z_in[keep]
    z_s, z_n = np.asarray(z_s), np.asarray(z_n)
    inter = np.empty((2 * nb_nodes,) + z_s.shape[1:], z_s.dtype)
    inter[0::2] = z_s
    inter[1::2] = z_n
    keep = [j for j in range(2 * nb_nodes) if j not in (2 * k, 2 * k + 1)]
    return inter[keep]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _forward(model: torch.nn.Module, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """One inference forward: eval mode (running BatchNorm statistics, no
    dropout, the JAX package's ``train=False``) and no autograd; the
    model's mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(x, **kwargs)
    finally:
        model.train(was_training)


def crnn_mask(Y, model, z=None, win_len: int = 21, frame_to_pred: str = "last",
              norm_type: str | None = None, three_d_tensor: bool = True, device=None):
    """The CRNN inference path of reference get_mask (tango.py:211-215):
    host prep, then one forward over all sliding windows → (F, T) numpy
    mask.

    Args:
      Y: (F, T) complex mixture STFT at the node's reference mic.
      model: a port :class:`~disco_tpu_torch.nn.crnn.CRNN` (or ``RNNMask``)
        on ``device``.
      z: optional sequence of (F, T) compressed streams from other nodes.
      device: where the forward runs — ``"cuda"`` when None.
    """
    dev = resolve_device(device)
    check_module_device(model, dev)
    frames_lost = win_len - model.conv_output_hw()[0]
    x = prepare_data(_host(Y), three_d_tensor, z_data=None if z is None else [_host(a) for a in z],
                     win_len=win_len, win_hop=1, frame_to_pred=frame_to_pred,
                     norm_type=norm_type, frames_lost=frames_lost)
    m_stack = _forward(model, torch.from_numpy(x).to(dev))
    return reshape_mask(_host(m_stack), frame_to_pred)


def normalization_device(x: torch.Tensor, norm_type: str | None = None, axis: int = -1):
    """:func:`normalization` on tensors over (..., F, T) streams (the host
    version runs per (F, T) stream along axis 1, the time axis, hence the
    default axis -1); 'pcen' is host-only and raises here.  The q99 of
    'scale_to_1' is :func:`~disco_tpu_torch.core.mathx.quantile_linear`,
    ``jnp.quantile``'s arithmetic at any size."""
    x = x.abs().clamp(STFT_MIN, STFT_MAX)
    if norm_type is None:
        return x
    if norm_type == "scale_to_unit_norm":
        return x / torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    if norm_type == "scale_to_1":
        return x / quantile_linear(x, 0.99, dim=axis, keepdim=True)
    if norm_type == "center_and_scale":
        x = x - x.mean(dim=axis, keepdim=True)
        return x / x.std(dim=axis, keepdim=True, correction=0)
    raise ValueError(f"norm_type {norm_type!r} has no device implementation (pcen is host-only)")


def _conv_stream_safe(model) -> bool:
    """True iff hoisting the model's conv stack to the full stream is exact:
    no padding, stride 1 and no pooling along time — then the full-stream
    conv output is the concatenation of the per-window outputs.  Other CRNN
    configurations and conv-free models take the per-window route."""
    if not hasattr(model, "cnn_filters"):
        return False
    n = len(model.cnn_filters)
    pads = [_pair(p) for p in broadcast_arg(model.conv_padding, n)]
    strides = [_pair(s) for s in spec_per_layer(model.conv_strides, n)]
    pools = [_pair(k) for k in spec_per_layer(model.pool_kernels, n)]
    return (all(p[0] == 0 for p in pads) and all(s is None or s[0] == 1 for s in strides)
            and all(k is None or k[0] == 1 for k in pools))


def _group_masks(model, mags: torch.Tensor, win_len: int, frame_to_pred: str,
                 stream: bool) -> torch.Tensor:
    """(G, F, T) masks of one group of (G, C, F, Tp) padded magnitude
    streams: the stream route (convs over the full streams, RNN/FF per
    post-conv window) or the per-window route (every window through the
    whole model)."""
    G, C, Fq, Tp = mags.shape
    T = Tp - win_len + 1
    if stream:
        out = _forward(model, mags, stream=True)  # (G, T, win_out, F)
        sel = out.shape[2] - 1 if frame_to_pred == "last" else out.shape[2] // 2
        return out[:, :, sel, :].transpose(1, 2)
    idx = (torch.arange(T, device=mags.device)[:, None]
           + torch.arange(win_len, device=mags.device)[None, :])
    wins = mags[:, :, :, idx]  # (G, C, F, T, win)
    x = wins.permute(0, 3, 1, 4, 2).reshape(G * T, C, win_len, Fq)
    out = _forward(model, x)  # (G T, win_out, F)
    sel = out.shape[1] - 1 if frame_to_pred == "last" else out.shape[1] // 2
    return out[:, sel, :].reshape(G, T, -1).transpose(1, 2)


def crnn_masks_batched(Ys, model, zs=None, win_len: int = 21, frame_to_pred: str = "last",
                       norm_type: str | None = None, three_d_tensor: bool = True, device=None):
    """Masks for many streams on the device (the production path).

    Normalization, window gathering and the forwards run on ``device``, a
    group of 8 streams a forward; when B is not a multiple of 8 the last
    group is filled by repeating the last stream and the filler's masks are
    dropped.  For a CRNN whose convs leave time alone the conv stack runs
    over the full streams (see ``CRNN.forward``); otherwise every window
    runs through the whole model.  Streams share (F, T).

    Args:
      Ys: (B, F, T) complex mixture STFTs (B = nodes, or clips x nodes),
        numpy or tensors.
      model: the port's CRNN or RNNMask, on ``device`` (else ValueError).
      zs: optional (B, n_z, F, T) exchanged streams per entry.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device).

    Returns:
      (B, F, T) float32 masks on ``device``.
    """
    if frame_to_pred == "all":
        raise NotImplementedError("'all' inference reshaping is not implemented (as in the reference)")
    dev = resolve_device(device)
    check_module_device(model, dev)
    if norm_type == "pcen":  # host-only IIR: the per-stream route
        Ys_h = _host(Ys)
        zs_h = None if zs is None else _host(zs)
        return torch.from_numpy(np.stack([
            crnn_mask(Ys_h[i], model, z=None if zs_h is None else list(zs_h[i]), win_len=win_len,
                      frame_to_pred=frame_to_pred, norm_type=norm_type,
                      three_d_tensor=three_d_tensor, device=dev)
            for i in range(len(Ys_h))
        ]).astype(np.float32)).to(dev)
    stream = _conv_stream_safe(model)
    frames_lost = win_len - model.conv_output_hw()[0]
    pad = get_frames_to_pad(win_len, frame_to_pred, out_len=win_len - frames_lost)
    Ys = torch.as_tensor(Ys, device=dev)
    zs = None if zs is None else torch.as_tensor(zs, device=dev)
    B = Ys.shape[0]
    group = max(1, min(B, GROUP))
    n_groups = -(-B // group)
    order = torch.arange(n_groups * group, device=dev).clamp_max(B - 1)  # filler: the last stream
    out = []
    for g in range(n_groups):
        rows = order[g * group:(g + 1) * group]
        chans = Ys[rows][:, None] if zs is None else torch.cat([Ys[rows][:, None], zs[rows]], 1)
        mags = F.pad(normalization_device(chans, norm_type, axis=-1), pad).to(torch.float32)
        out.append(_group_masks(model, mags, win_len, frame_to_pred, stream))
    return torch.cat(out)[:B].contiguous()


def vad_mask(ts, n_freq: int, n_frames: int) -> torch.Tensor:
    """'ivad' mask: the oracle VAD of a waveform spread across frequencies,
    (n_freq, n_frames) float32 (reference tango.py:216-222)."""
    vad = vad_oracle_batch(torch.as_tensor(ts), win_len=N_FFT, win_hop=N_HOP)
    return vad_to_mask(vad, n_freq, n_frames, hop=N_HOP)
