"""The CRNN mask-estimation network and the 2-D RNN (counterpart of
``disco_tpu/nn/crnn.py``; reference dnn/models/crnn.py:9-108).

CNN2d feature extractor → reshape keeping the time axis → RNN → FF
(sigmoid), predicting a per-frame mask over ``n_freq`` bins.  The canonical
DISCO instantiation (reference dnn/utils.py:143-152, tango.py:127-132) is

    input (n_ch, 21, 257) → conv filters (32, 64, 64), 3×3, stride 1,
    freq-only pooling (1, 4), conv padding (0, 1) → GRU(256) → FF(257,
    sigmoid)

which crops the 21-frame window to 15 output frames; :func:`loss_frame_bounds`
and :meth:`CRNN.loss_frames` keep the frame bookkeeping.

After the convs the (time, freq, channels) features are merged into
``freq * channels`` with the channel index fastest, as the JAX package's
NHWC reshape does: the NCHW activations are permuted to (B, T, F, C)
before the reshape, so weights carried across by :mod:`.convert` line up.

``build_crnn`` and ``build_rnn`` return the module alone; the optimizer
comes with the training port.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from disco_tpu_torch.nn.bricks import CNN2d, FF, RNN, cnn_output_dim


def loss_frame_bounds(win_len: int, part) -> tuple[int, int]:
    """(first, last) frame selecting which of ``win_len`` frames enter the
    loss: 'all' | 'mid' | 'last' | an explicit index
    (reference dnn/utils.py:189-209)."""
    if part == "all":
        return 0, win_len
    if part == "mid":
        first = int(math.ceil(win_len) / 2)
        return first, first + 1
    if part == "last":
        return win_len - 1, win_len
    if isinstance(part, int):
        return part, part + 1
    raise ValueError(f"Unknown output_frames value {part!r}; use 'all', 'mid', 'last' or an int")


class CRNN(nn.Module):
    """CRNN mask estimator (reference crnn.py:9-87).  ``input_shape`` is
    (n_ch, win_len, n_freq); the other arguments are the JAX module's
    fields, with its defaults."""

    def __init__(self, input_shape, cnn_filters=(32, 64, 64), conv_kernels=3, conv_strides=1,
                 pool_kernels=((1, 4), (1, 4), (1, 4)), pool_strides=None,
                 conv_padding=((0, 1), (0, 1), (0, 1)), pool_types="max", rnn_units=(256,),
                 rnn_cell: str = "gru", rnn_dropouts=0.0, rnn_bi=False, ff_units=(257,),
                 ff_activation="sigmoid"):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.cnn_filters = tuple(cnn_filters)
        self.conv_kernels = conv_kernels
        self.conv_strides = conv_strides
        self.pool_kernels = pool_kernels
        self.pool_strides = pool_strides
        self.conv_padding = conv_padding
        self.cnn = CNN2d(self.input_shape[0], self.cnn_filters, conv_kernels=conv_kernels,
                         conv_strides=conv_strides, pool_kernels=pool_kernels,
                         pool_strides=pool_strides, conv_padding=conv_padding,
                         pool_types=pool_types)
        f_out = self.conv_output_hw()[1]
        self.rnn = RNN(f_out * self.cnn_filters[-1], rnn_units, cell_type=rnn_cell,
                       dropouts=rnn_dropouts, bidirectional=rnn_bi)
        self.ff = FF(self.rnn.out_features, ff_units, activations=ff_activation)

    def conv_output_hw(self) -> tuple[int, int]:
        """Analytic (time, freq) shape after the conv stack
        (reference crnn.py:50)."""
        return cnn_output_dim(
            (self.input_shape[1], self.input_shape[2]), self.conv_kernels, self.conv_strides,
            self.pool_kernels, self.pool_strides, conv_padding=self.conv_padding,
            n_layers=len(self.cnn_filters))

    def loss_frames(self, output_frames) -> tuple[tuple[int, int], tuple[int, int]]:
        """((ff_in, lf_in), (ff_out, lf_out)): which input frames line up
        with which output frames, given the frames the unpadded convs crop
        (reference crnn.py:65-87)."""
        win_in = self.input_shape[1]
        win_out = self.conv_output_hw()[0]
        if output_frames == "last":
            new_len = (win_in + win_out) // 2
            ff_in, lf_in = new_len - 1, new_len
        elif output_frames == "mid":
            ff_in = int(math.ceil(win_in) / 2)
            lf_in = ff_in + 1
        elif output_frames == "all":
            ff_in = (win_in - win_out) // 2
            lf_in = (win_in + win_out) // 2
        else:
            raise ValueError(f"Unknown output_frames value {output_frames!r}")
        return (ff_in, lf_in), loss_frame_bounds(win_out, output_frames)

    def forward(self, x: torch.Tensor, stream: bool = False) -> torch.Tensor:
        """Windowed mode (default): ``x`` is (B, C, win_len, F) sliding
        windows (3-D input gets a singleton channel, reference
        crnn.py:56-57); returns (B, win_out, n_freq).

        Stream mode (``stream=True``, inference): ``x`` is (B, C, F, Tp)
        full padded magnitude streams.  The conv stack has no time padding,
        stride or pooling (the canonical model's padding is along frequency
        only), so its output over the full stream is the concatenation of
        the per-window outputs: the convs run once per stream, and the
        RNN/FF, whose state starts anew in every window, run per gathered
        post-conv window.  Returns (B, T, win_out, n_freq), T = Tp -
        win_len + 1.
        """
        if stream:
            x = x.transpose(-1, -2)  # (B, C, F, Tp) → (B, C, Tp, F)
        elif x.ndim == 3:
            x = x[:, None]  # (B, T, F) → (B, 1, T, F)
        x = self.cnn(x).permute(0, 2, 3, 1)  # (B, t, f, c): channels fastest below
        b, t, f, c = x.shape
        if stream:
            win_out = self.conv_output_hw()[0]
            n_win = t - win_out + 1
            idx = (torch.arange(n_win, device=x.device)[:, None]
                   + torch.arange(win_out, device=x.device)[None, :])
            x = x[:, idx].reshape(b * n_win, win_out, f * c)  # (B n_win, win_out, f c)
        else:
            x = x.reshape(b, t, f * c)  # keep time, merge (freq, channels) (crnn.py:59)
        x = self.ff(self.rnn(x))
        if stream:
            return x.reshape(b, n_win, win_out, -1)
        return x


def build_crnn(n_ch: int = 1, win_len: int = 21, n_freq: int = 257, rnn_dropouts=0.5,
               **overrides) -> CRNN:
    """The CRNN in the canonical DISCO configuration — conv (32, 64, 64)
    3×3 / pool (1, 4) / GRU 256 / FF 257 sigmoid (reference
    crnn.py:90-108, dnn/utils.py:143-152).  The reference's
    ``rnn_dropouts=0.5`` is a no-op for the single-layer GRU (last-layer
    dropout is forced to 0) — kept, as the JAX package keeps it."""
    return CRNN(input_shape=(n_ch, win_len, n_freq), rnn_dropouts=rnn_dropouts, **overrides)


class RNNMask(nn.Module):
    """2-D RNN mask estimator — the reference's 'rnn' architecture
    (freq-stacked inputs, datasets.py:120-151, speech_enhancement/utils.py
    prepare_data:100-120): a recurrent stack straight over (B, T,
    n_ch*n_freq) windows, no convs, so every input frame maps to an output
    frame.  ``input_shape`` is (win_len, n_ch * n_freq)."""

    def __init__(self, input_shape, rnn_units=(256, 256), rnn_cell: str = "gru",
                 rnn_dropouts=0.0, rnn_bi=False, ff_units=(257,), ff_activation="sigmoid"):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.rnn = RNN(self.input_shape[1], rnn_units, cell_type=rnn_cell, dropouts=rnn_dropouts,
                       bidirectional=rnn_bi)
        self.ff = FF(self.rnn.out_features, ff_units, activations=ff_activation)

    def conv_output_hw(self) -> tuple[int, int]:
        """No conv cropping: output frames == input frames (the shared
        frames-lost bookkeeping of ``enhance.inference``)."""
        return self.input_shape[0], self.input_shape[1]

    def loss_frames(self, output_frames) -> tuple[tuple[int, int], tuple[int, int]]:
        win = self.input_shape[0]
        return loss_frame_bounds(win, output_frames), loss_frame_bounds(win, output_frames)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:  # (B, C, T, F) → freq-stack the channels
            b, c, t, f = x.shape
            x = x.transpose(1, 2).reshape(b, t, c * f)
        return self.ff(self.rnn(x))


def build_rnn(n_ch: int = 1, win_len: int = 21, n_freq: int = 257, **overrides) -> RNNMask:
    """The 2-D RNN architecture — the 'rnn' branch the reference selects
    with archi != 'crnn' (train.py:73-74, utils.py 2-D tensors)."""
    overrides.setdefault("ff_units", (n_freq,))
    return RNNMask(input_shape=(win_len, n_ch * n_freq), **overrides)
