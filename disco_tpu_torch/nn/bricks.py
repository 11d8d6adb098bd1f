"""Composable NN bricks (counterpart of ``disco_tpu/nn/bricks.py``;
reference dnn/models/nn_structures.py:39-245).

The same three building blocks with the same knobs, as ``nn.Module``s:

* :class:`FF` — a stack of linear layers with per-layer activations
  fetched by name;
* :class:`RNN` — stacked RNN/LSTM/GRU layers over (batch, time,
  features), per-layer dropout (0 on the last layer) and optional
  bidirectionality;
* :class:`CNN2d` — Conv2d → BatchNorm2d → pool per layer over
  (batch, channels, time, freq), plus the analytic output shape
  :func:`cnn_output_dim`.

Layout: the JAX package runs its convs in NHWC (time as H, frequency as W);
these bricks run torch's NCHW with the same H and W, so a flax kernel
``(kh, kw, in, out)`` is a torch weight ``(out, in, kh, kw)``
(:mod:`.convert`).  Unlike flax, torch needs each layer's input width, so
the bricks take it as their first argument.  The flax modules' hashable
fields exist only because jit statics must hash; the port needs none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "softplus": F.softplus,
    "identity": lambda x: x,
    "linear": lambda x: x,
    None: lambda x: x,
}


def activation_by_name(name):
    """An activation by (torch-style, lowercase) name, or ``name`` itself
    when it is callable (nn_structures.py:75)."""
    if callable(name):
        return name
    key = name.lower() if isinstance(name, str) else name
    if key in _ACTIVATIONS:
        return _ACTIVATIONS[key]
    fn = getattr(F, key, None)
    if fn is None:
        raise ValueError(f"Unknown activation {name!r}")
    return fn


def broadcast_arg(arg, n: int) -> list:
    """Scalar → n-list; pair-tuple → repeated n times; list (or tuple of
    per-layer tuples) → as-is (nn_structures.py:14-35)."""
    if isinstance(arg, list):
        if len(arg) == 1:
            return arg * n
        if len(arg) != n:
            raise ValueError(f"expected 1 or {n} values, got {len(arg)}")
        return arg
    if isinstance(arg, tuple):
        if len(arg) == n and all(e is None or isinstance(e, (tuple, list)) for e in arg):
            return list(arg)  # explicit per-layer spec written as a tuple
        return [arg] * n  # a (h, w) pair, repeated per layer
    return [arg] * n


def spec_per_layer(arg, n: int) -> list:
    """Per-layer structural spec (kernels/strides/pools): sequences are
    indexed per layer as-is, scalars broadcast (nn_structures.py:188-191)."""
    if arg is None or not isinstance(arg, (tuple, list)):
        return [arg] * n
    if len(arg) != n:
        raise ValueError(f"expected {n} per-layer values, got {len(arg)}")
    return list(arg)


def _pair(v) -> tuple:
    """int → (int, int); tuples/lists pass through."""
    if v is None:
        return v
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _freeze(v):
    """A list argument as the flax module holds it: the JAX bricks freeze
    list fields to tuples (to hash them), and :func:`broadcast_arg` reads a
    tuple otherwise than a list — ``[True, False]`` reaches it as a pair
    and is repeated for every layer.  The bricks freeze their arguments
    the same way, so a configuration means what it means in the JAX
    package."""
    return tuple(_freeze(e) for e in v) if isinstance(v, (list, tuple)) else v


class FF(nn.Module):
    """Feed-forward stack: linear layers with named activations
    (nn_structures.py:39-76)."""

    def __init__(self, in_features: int, features, activations="sigmoid"):
        super().__init__()
        features, activations = _freeze(features), _freeze(activations)
        feats = features if isinstance(features, tuple) else (features,)
        acts = broadcast_arg(list(activations) if isinstance(activations, (tuple, list))
                             else activations, len(feats))
        widths = (in_features,) + feats
        self.layers = nn.ModuleList(nn.Linear(widths[i], widths[i + 1]) for i in range(len(feats)))
        self.activations = [activation_by_name(a) for a in acts]
        self.out_features = feats[-1]

    def forward(self, x):
        for layer, act in zip(self.layers, self.activations):
            x = act(layer(x))
        return x


_CELLS = {"rnn": nn.RNN, "lstm": nn.LSTM, "gru": nn.GRU}


class RNN(nn.Module):
    """Stacked recurrent layers over (batch, time, features), each a torch
    ``nn.RNN``/``nn.LSTM``/``nn.GRU`` (bidirectional outputs concatenated
    [forward, backward]), with per-layer dropout forced to 0 on the last
    layer (nn_structures.py:122-126).  Every layer starts from a zero
    state, as flax's ``nn.RNN`` does."""

    def __init__(self, in_features: int, features, cell_type: str = "gru", dropouts=0.0,
                 bidirectional=False):
        super().__init__()
        features, dropouts, bidirectional = (_freeze(a) for a in (features, dropouts, bidirectional))
        n = len(features)
        drops = list(broadcast_arg(list(dropouts) if isinstance(dropouts, tuple) else dropouts, n))
        drops[-1] = 0.0  # no dropout after the last layer (nn_structures.py:126)
        bidis = broadcast_arg(bidirectional, n)
        cell_cls = _CELLS[cell_type.lower()]
        self.cell_type = cell_type.lower()
        self.bidirectional = [bool(b) for b in bidis]
        self.layers = nn.ModuleList()
        self.dropouts = nn.ModuleList()
        width = in_features
        for units, drop, bidi in zip(features, drops, self.bidirectional):
            self.layers.append(cell_cls(width, units, batch_first=True, bidirectional=bidi))
            self.dropouts.append(nn.Dropout(float(drop)) if drop else nn.Identity())
            width = units * (2 if bidi else 1)
        self.out_features = width

    def forward(self, x):
        for layer, drop in zip(self.layers, self.dropouts):
            x = drop(layer(x)[0])
        return x


class CNN2d(nn.Module):
    """Conv2d → BatchNorm2d → pool stack over (batch, channels, time, freq)
    (nn_structures.py:162-217).  Integer paddings follow torch semantics
    (a zero-pad of (pad_t, pad_f) on both sides); pools are unpadded and
    a ``pool_strides`` entry of None means the pool kernel.  BatchNorm's
    epsilon is flax's and torch's 1e-5; its momentum 0.1 is flax's 0.9
    written the torch way."""

    def __init__(self, in_channels: int, features, conv_kernels=3, conv_strides=1,
                 pool_kernels=None, pool_strides=None, conv_padding=0, pool_types="max",
                 conv_bias=True):
        super().__init__()
        (features, conv_kernels, conv_strides, pool_kernels, pool_strides, conv_padding, pool_types,
         conv_bias) = (_freeze(a) for a in (features, conv_kernels, conv_strides, pool_kernels,
                                            pool_strides, conv_padding, pool_types, conv_bias))
        n = len(features)
        kernels = [_pair(k) for k in spec_per_layer(conv_kernels, n)]
        strides = [_pair(s) for s in spec_per_layer(conv_strides, n)]
        pads = [_pair(p) for p in broadcast_arg(conv_padding, n)]
        pools = [_pair(p) for p in spec_per_layer(pool_kernels, n)]
        pstrides = [_pair(s) for s in spec_per_layer(pool_strides, n)]
        ptypes = broadcast_arg(pool_types, n)
        biases = broadcast_arg(conv_bias, n)
        chans = (in_channels,) + features
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], kernels[i], stride=strides[i] or 1,
                      padding=pads[i], bias=bool(biases[i]))
            for i in range(n))
        self.bns = nn.ModuleList(nn.BatchNorm2d(c, eps=1e-5, momentum=0.1) for c in features)
        self.pools = nn.ModuleList()
        for i in range(n):
            if pools[i] is None:
                self.pools.append(nn.Identity())
                continue
            stride = pstrides[i] if pstrides[i] is not None else pools[i]
            pool = nn.MaxPool2d if str(ptypes[i]).lower().startswith("max") else nn.AvgPool2d
            self.pools.append(pool(pools[i], stride=stride))

    def forward(self, x):
        for conv, bn, pool in zip(self.convs, self.bns, self.pools):
            x = pool(bn(conv(x)))
        return x


def cnn_output_dim(input_hw, conv_kernels, conv_strides, pool_kernels, pool_strides,
                   conv_padding=0, n_layers: int | None = None) -> tuple[int, int]:
    """Analytic (time, freq) output shape of the conv stack (torch
    Conv2d/MaxPool2d floor formulas, nn_structures.py:219-245)."""
    if n_layers is None:
        n_layers = len(conv_kernels) if isinstance(conv_kernels, (list, tuple)) else 1
    kernels = [_pair(k) for k in spec_per_layer(conv_kernels, n_layers)]
    strides = [_pair(s) for s in spec_per_layer(conv_strides, n_layers)]
    pads = [_pair(p) for p in broadcast_arg(conv_padding, n_layers)]
    pools = [_pair(p) for p in spec_per_layer(pool_kernels, n_layers)]
    pstrides = [_pair(s) for s in spec_per_layer(pool_strides, n_layers)]

    h, w = input_hw
    for i in range(n_layers):
        cs = (1, 1) if strides[i] is None else strides[i]
        h = math.floor((h + 2 * pads[i][0] - (kernels[i][0] - 1) - 1) / cs[0] + 1)
        w = math.floor((w + 2 * pads[i][1] - (kernels[i][1] - 1) - 1) / cs[1] + 1)
        if pools[i] is not None:
            ps = pools[i] if pstrides[i] is None else pstrides[i]
            h = math.floor((h - (pools[i][0] - 1) - 1) / ps[0] + 1)
            w = math.floor((w - (pools[i][1] - 1) - 1) / ps[1] + 1)
    return int(h), int(w)
