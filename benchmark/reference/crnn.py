"""The plain CRNN mask estimator of DISCO (nfurnon/disco
``dnn/models/crnn.py:9-108``, ``dnn/utils.py:143-152``) applied as the corpus
driver applies it (``speech_enhancement/tango.py:211-240``): each frame's
mask is the last output frame of a 21-frame window that ends 3 frames after
it.

Per stream: the magnitudes of its channels clipped to [1e-6, 1e3], 17 zero
frames before and 3 after, three blocks of 3x3 convolution (padding 1 along
frequency only), BatchNorm with its running statistics and a (1, 4) max-pool
along frequency; the (frames, frequency, channels) features merged with the
channel index fastest; a GRU of 256 units that starts from zero in every
window of 15 post-conv frames; a 257-wide sigmoid layer on its last state.

The convolutions have no padding, stride or pooling along time, so they are
computed once over each whole padded stream: their output frames are the
same as those of every window computed alone.  Plain torch in the dtype of
the parameters handed in; the GRU is written out (torch's gate order r, z,
n, with ``n = tanh(W_in x + b_in + r (W_hn h + b_hn))``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WIN, WIN_OUT, PAD_BEFORE, PAD_AFTER = 21, 15, 17, 3
N_CONV = 3


def masks(streams: torch.Tensor, p: dict, block: int = 8) -> torch.Tensor:
    """(N, n_ch, F, T) complex streams -> (N, F, T) masks, ``block`` streams
    at a time; ``p`` maps the parameter names of ``benchmark/weights.py`` to
    tensors of the reference's dtype and device."""
    return torch.cat([_masks(part, p) for part in streams.split(block)])


def _masks(streams: torch.Tensor, p: dict) -> torch.Tensor:
    dtype = p["ff.layers.0.weight"].dtype
    x = streams.abs().clamp(1e-6, 1e3).to(dtype)
    T = x.shape[-1]
    x = F.pad(x, (PAD_BEFORE, PAD_AFTER)).transpose(-1, -2)              # (N, c, Tp, F)
    for i in range(N_CONV):
        x = F.conv2d(x, p[f"cnn.convs.{i}.weight"], p[f"cnn.convs.{i}.bias"], padding=(0, 1))
        bn = f"cnn.bns.{i}."
        inv = torch.rsqrt(p[bn + "running_var"] + 1e-5) * p[bn + "weight"]
        x = (x - p[bn + "running_mean"][:, None, None]) * inv[:, None, None] \
            + p[bn + "bias"][:, None, None]
        x = F.max_pool2d(x, (1, 4))
    n, c, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(n, t, f * c)                        # channels fastest
    W_ih, W_hh = p["rnn.layers.0.weight_ih_l0"], p["rnn.layers.0.weight_hh_l0"]
    b_ih, b_hh = p["rnn.layers.0.bias_ih_l0"], p["rnn.layers.0.bias_hh_l0"]
    H = W_hh.shape[1]
    gi = x @ W_ih.T + b_ih                                                 # (n, t, 3H), a frame once
    h = x.new_zeros((n, T, H))
    for s in range(WIN_OUT):
        g = gi[:, s:s + T]                                                 # window j's frame s
        gh = h @ W_hh.T + b_hh
        r = torch.sigmoid(g[..., :H] + gh[..., :H])
        z = torch.sigmoid(g[..., H:2 * H] + gh[..., H:2 * H])
        cand = torch.tanh(g[..., 2 * H:] + r * gh[..., 2 * H:])
        h = (1.0 - z) * cand + z * h
    out = torch.sigmoid(h @ p["ff.layers.0.weight"].T + p["ff.layers.0.bias"])
    return out.transpose(-1, -2)                                           # (n, F, T)
