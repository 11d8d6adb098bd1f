"""Scalar and array math helpers (counterpart of ``disco_tpu/core/mathx.py``;
reference disco_theque/math_utils.py:4-233), on tensors."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# float64 machine epsilon — the reference's ``sys.float_info.epsilon``
# (sigproc_utils.py:74, internal_formulas.py:6); shared across the package.
FLOAT64_EPS = 2.220446049250313e-16


def floor_to_multiple(num, div):
    """Largest multiple of ``div`` that is <= ``num`` (math_utils.py:4-21)."""
    return int(num - (num % div))


def round_to_base(x, base=1):
    """Round ``x`` to the nearest multiple of ``base``, halves to even
    (math_utils.py:24-43)."""
    return base * torch.round(torch.as_tensor(x) / base)


def db2lin(x, exp=1):
    """dB -> linear. ``exp=1`` for power, ``exp=2`` for magnitude."""
    return 10.0 ** (torch.as_tensor(x) / (10.0 * exp))


def lin2db(x):
    """Linear power -> dB (math_utils.py:65-75)."""
    return 10.0 * torch.log10(torch.as_tensor(x))


def cart2pol(x, y):
    """Cartesian -> polar, angle in radians (math_utils.py:78-97).  A point
    whose coordinates are both subnormal is at the origin to float
    precision and gets the ``atan2(0, 0) = 0`` angle, as in the JAX package
    (whose ``arctan2`` gives NaN there)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    phi = torch.atan2(y, x)
    tiny = torch.finfo(phi.dtype).tiny
    origin = (x.abs() < tiny) & (y.abs() < tiny)
    return torch.sqrt(x ** 2 + y ** 2), torch.where(origin, torch.zeros_like(phi), phi)


def pol2cart(r, theta):
    """Polar -> cartesian (math_utils.py:100-115)."""
    r, theta = torch.as_tensor(r), torch.as_tensor(theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def my_mse(x, y):
    """Mean of squared differences, reduced over the last axis then the rest
    (math_utils.py:118-131)."""
    return torch.mean(torch.mean((torch.as_tensor(x) - torch.as_tensor(y)) ** 2, dim=-1))


def next_pow_2(x):
    """Smallest power of two >= ``x`` (math_utils.py:155-165). Host-side int."""
    return int(2 ** int(np.ceil(np.log2(x))))


def quantile_linear(x: torch.Tensor, q: float, dim: int = -1, keepdim: bool = False):
    """The ``q``-quantile along ``dim`` by linear interpolation, the
    arithmetic of ``jnp.quantile`` (method 'linear'): the position
    ``q (n - 1)`` in float32, the two neighbouring order statistics
    weighted ``1 - frac`` and ``frac``; a slice holding a NaN gives NaN.
    By sorting, so any size works (``torch.quantile`` refuses inputs of
    more than 2^24 elements)."""
    n = x.shape[dim]
    pos = np.float32(q) * np.float32(n - 1)
    lo = int(np.clip(np.floor(pos), 0, n - 1))
    hi = int(np.clip(np.ceil(pos), 0, n - 1))
    w_hi = np.float32(pos - np.floor(pos))
    w_lo = np.float32(1) - w_hi
    s = torch.sort(x, dim=dim).values
    out = s.narrow(dim, lo, 1) * float(w_lo) + s.narrow(dim, hi, 1) * float(w_hi)
    out = torch.where(torch.isnan(x).any(dim=dim, keepdim=True),
                      torch.full_like(out, float("nan")), out)
    return out if keepdim else out.squeeze(dim)


@dataclasses.dataclass
class WelfordState:
    """State of Welford's online mean/variance over 2-D data
    (feature_dim x n_frames), math_utils.py:168-232."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor

    @property
    def std(self):
        return torch.sqrt(self.m2 / self.count.clamp_min(1))


def welford_init(feature_dim: int, dtype=torch.float32, device=None) -> WelfordState:
    """Zeroed Welford running-stats state for ``feature_dim`` features."""
    return WelfordState(mean=torch.zeros(feature_dim, dtype=dtype, device=device),
                        m2=torch.zeros(feature_dim, dtype=dtype, device=device),
                        count=torch.zeros((), dtype=torch.int32, device=device))


def welford_update(state: WelfordState, data: torch.Tensor) -> WelfordState:
    """Chunk update (the ``quick_update`` semantics of math_utils.py:214-232):
    one pass over a (feature_dim x n_frames) block."""
    delta = data - state.mean[:, None]
    count = state.count + data.shape[-1]
    mean = state.mean + delta.sum(dim=-1) / count
    delta2 = data - mean[:, None]
    m2 = state.m2 + torch.sum(delta2 * delta, dim=-1)
    return WelfordState(mean=mean, m2=m2, count=count)


class WelfordsOnlineAlgorithm:
    """Stateful wrapper around :func:`welford_update`, with the reference's
    attribute surface (mean/std/m2/count)."""

    def __init__(self, feature_dim: int, dtype=torch.float32, device=None):
        self.feature_dim = feature_dim
        self._state = welford_init(feature_dim, dtype, device)

    def update_stats(self, data):
        self.quick_update(data)

    def quick_update(self, data):
        data = torch.as_tensor(data, dtype=self._state.mean.dtype, device=self._state.mean.device)
        if data.shape[0] != self.feature_dim:
            raise ValueError(f"`data` should have {self.feature_dim} features, got {data.shape[0]}")
        self._state = welford_update(self._state, data)

    @property
    def mean(self):
        return self._state.mean

    @property
    def std(self):
        return self._state.std

    @property
    def m2(self):
        return self._state.m2

    @property
    def count(self):
        return int(self._state.count)
