"""CRNN weights drawn from the run's seed, on the device, in a few large
calls: one normal and one uniform draw a network, cut into the parameters of
the canonical CRNN (conv (32, 64, 64) 3x3, BatchNorm, pool (1, 4), GRU 256,
FF 257) under the names of its torch module.

Kernels are normal with variance 1 / fan-in; biases, BatchNorm shifts and
running means normal with standard deviation 0.1; BatchNorm scales uniform
in [0.5, 1.5] and running variances in [0.5, 2].  The GRU's hidden-side r and
z biases are 0, as in the flax layout that the port's modules keep.  Speed
and agreement with the reference do not depend on training; these draws
keep every gate and the sigmoid away from saturation at the scenes' level.
"""
from __future__ import annotations

import math

import torch


FILTERS, N_FREQ, HIDDEN, POOL = (32, 64, 64), 257, 256, 4


def crnn_layout(n_ch: int) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every parameter and buffer: law
    'normal' (scale: the standard deviation), 'uniform' ([scale, 3 scale]),
    'uniform4' ([scale, 4 scale]) or 'gru_hh' (normal, r and z rows 0)."""
    out, c_in, f = [], n_ch, N_FREQ
    for i, c_out in enumerate(FILTERS):
        out += [(f"cnn.convs.{i}.weight", (c_out, c_in, 3, 3), "normal", 1 / math.sqrt(9 * c_in)),
                (f"cnn.convs.{i}.bias", (c_out,), "normal", 0.1),
                (f"cnn.bns.{i}.weight", (c_out,), "uniform", 0.5),
                (f"cnn.bns.{i}.bias", (c_out,), "normal", 0.1),
                (f"cnn.bns.{i}.running_mean", (c_out,), "normal", 0.1),
                (f"cnn.bns.{i}.running_var", (c_out,), "uniform4", 0.5)]
        c_in, f = c_out, f // POOL
    feat = f * c_in
    hidden, n_freq = HIDDEN, N_FREQ
    out += [("rnn.layers.0.weight_ih_l0", (3 * hidden, feat), "normal", 1 / math.sqrt(feat)),
            ("rnn.layers.0.weight_hh_l0", (3 * hidden, hidden), "normal", 1 / math.sqrt(hidden)),
            ("rnn.layers.0.bias_ih_l0", (3 * hidden,), "normal", 0.1),
            ("rnn.layers.0.bias_hh_l0", (3 * hidden,), "gru_hh", 0.1),
            ("ff.layers.0.weight", (n_freq, hidden), "normal", 1 / math.sqrt(hidden)),
            ("ff.layers.0.bias", (n_freq,), "normal", 0.1)]
    return out


def draw_crnn(n_ch: int, gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """The parameters of one canonical CRNN with ``n_ch`` input channels,
    from ``gen`` on ``device``: {name: tensor}."""
    layout = crnn_layout(n_ch)
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    normal = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    unif = torch.rand(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for (name, shape, law, scale), size in zip(layout, sizes):
        nrm, u = normal[at:at + size].reshape(shape), unif[at:at + size].reshape(shape)
        at += size
        if law == "normal":
            out[name] = nrm * scale
        elif law == "uniform":                       # [0.5, 1.5]
            out[name] = scale + u * 2 * scale
        elif law == "uniform4":                      # [0.5, 2]
            out[name] = scale + u * 3 * scale
        else:                                        # GRU hidden biases: r, z rows 0
            h = shape[0] // 3
            out[name] = torch.cat([torch.zeros(2 * h, device=device, dtype=dtype),
                                   nrm[2 * h:] * scale])
    return out


def load_into(module: torch.nn.Module, params: dict) -> None:
    """Copy ``params`` into ``module`` (its own tensors; every name must
    match, and no parameter or running statistic may be left out)."""
    state = {k: v.clone() for k, v in params.items()}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    module.load_state_dict(state, strict=True)
