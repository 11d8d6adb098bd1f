"""The covariance kernel's frame partition and fixed-order combination, on
the CPU.

``csrc/cov.cu`` sums a bin's frames in another order than its plain
version (one ``torch.einsum``): the frames go in tiles of ``kTile``; in each
tile, slice s of ``kSlices`` takes frames s, s + kSlices, ...; each thread
(one slice, one upper-triangle pair) sums its frames tile by tile, and the
slices' partial sums are added in slice order.  A block holds the groups of
several bins at small C.  The kernel runs only on the card, so this file
keeps a model of that order, with the tile and slice counts read from the
source's own constants, and checks that every frame and pair is covered
exactly once, and that the model meets ``masked_covariances_folded`` within
1e-5 of the output scale (max-rel), the kernel's tolerance on the card.
The launch itself (bins a block, shared memory) is held on the card, at
every C from 1 to 16 with both mask kinds, by ``test_torch_port_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from disco_tpu_torch.ops import cov_ops
from tests.torch_port_helpers import complex_normal, max_rel

TOL = 1e-5
SOURCE = (Path(cov_ops.__file__).resolve().parent.parent / "csrc" / "cov.cu").read_text()


def _const(name: str) -> int:
    """A ``constexpr int`` of ``cov.cu`` (an integer, or a product of two)."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    return int(np.prod([int(x) for x in expr.split("*")]))


TILE, SLICES = _const("kTile"), _const("kSlices")


def slice_frames(T: int, s: int) -> list[int]:
    """The frames slice ``s`` sums, in its order."""
    out = []
    for t0 in range(0, T, TILE):
        out += [t0 + tt for tt in range(s, min(TILE, T - t0), SLICES)]
    return out


def pair_of(p: int, C: int) -> tuple[int, int]:
    """The kernel's upper-triangle pair of thread index ``p``, row by row."""
    c, rem = 0, p
    while rem >= C - c:
        rem -= C - c
        c += 1
    return c, c + rem


@pytest.mark.parametrize("T", [1, 2, 3, 5, 63, 64, 127, 128, 129, 300, 626])
def test_frame_partition_covers_every_frame_once(T):
    frames = [t for s in range(SLICES) for t in slice_frames(T, s)]
    assert sorted(frames) == list(range(T))
    for s in range(SLICES):  # each slice in increasing order
        assert slice_frames(T, s) == sorted(slice_frames(T, s))


@pytest.mark.parametrize("C", list(range(1, 17)))
def test_pairs_cover_the_upper_triangle_once(C):
    P = C * (C + 1) // 2
    assert sorted(pair_of(p, C) for p in range(P)) == [(c, d) for c in range(C)
                                                       for d in range(c, C)]


def model_cov(y: torch.Tensor, mask: torch.Tensor):
    """The kernel's sums in its order: (..., C, F, T) complex64 spectra and a
    (..., F, T) or (..., C, F, T) mask -> (Rss, Rnn), (..., F, C, C)."""
    chan = mask.ndim == y.ndim
    C, T = y.shape[-3], y.shape[-1]
    inv_t = torch.tensor(1.0, dtype=torch.float32) / T
    yr, yi = y.real.movedim(-3, -2), y.imag.movedim(-3, -2)  # (..., F, C, T)
    m = mask.movedim(-3, -2) if chan else mask[..., None, :]  # (..., F, C or 1, T)
    cs, ds = zip(*(pair_of(p, C) for p in range(C * (C + 1) // 2)))
    cs, ds = list(cs), list(ds)
    mc, md = (m[..., cs, :], m[..., ds, :]) if chan else (m, m)
    if chan:
        w_s, w_n = (mc * md) * inv_t, ((1.0 - mc) * (1.0 - md)) * inv_t
    else:
        om = 1.0 - m
        w_s, w_n = (m * m) * inv_t, (om * om) * inv_t
    prr = yr[..., cs, :] * yr[..., ds, :] + yi[..., cs, :] * yi[..., ds, :]
    pii = yi[..., cs, :] * yr[..., ds, :] - yr[..., cs, :] * yi[..., ds, :]
    zero = torch.zeros(prr.shape[:-1], dtype=torch.float32)
    parts = []
    for s in range(SLICES):
        acc = [zero.clone() for _ in range(4)]
        for t in slice_frames(T, s):
            ws, wn = w_s[..., t], w_n[..., t]
            acc = [acc[0] + ws * prr[..., t], acc[1] + ws * pii[..., t],
                   acc[2] + wn * prr[..., t], acc[3] + wn * pii[..., t]]
        parts.append(acc)
    tot = parts[0]
    for part in parts[1:]:
        tot = [a + b for a, b in zip(tot, part)]
    diag = torch.tensor([c == d for c, d in zip(cs, ds)])
    out = []
    for re_, im_ in ((tot[0], tot[1]), (tot[2], tot[3])):
        im_ = torch.where(diag, torch.zeros_like(im_), im_)
        R = torch.zeros(re_.shape[:-1] + (C, C), dtype=torch.complex64)
        R[..., ds, cs] = torch.complex(re_, -im_)  # the mirror, then the pair
        R[..., cs, ds] = torch.complex(re_, im_)
        out.append(R)
    return tuple(out)


@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("C,T", [(1, 1), (4, 37), (3, 64), (11, 5), (5, 33)])
def test_model_of_the_kernel_matches_the_folded_einsum(C, T, chan):
    """Ragged T below one tile, one whole tile, T = 1, the path's C = 4 and
    D = 11 and the lane-group edge C = 5, with both mask kinds."""
    rng = np.random.default_rng(C * 100 + T)
    y = torch.from_numpy(complex_normal(rng, (1, C, 257, T)))
    m = torch.from_numpy(rng.random((1,) + ((C,) if chan else ()) + (257, T)).astype(np.float32))
    got = model_cov(y, m)
    want = cov_ops.masked_covariances_folded(y, m)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert max_rel(a, b) <= TOL, max_rel(a, b)
