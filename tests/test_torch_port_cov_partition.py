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

from disco_tpu_torch.ops import cov_ops, stft_ops
from disco_tpu_torch.ops.resolve import bf16_round
from tests.torch_port_helpers import complex_normal, max_rel, scene

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


def model_cov(y: torch.Tensor, mask: torch.Tensor, bf16: bool = False):
    """The kernel's sums in its order: (..., C, F, T) complex64 spectra and a
    (..., F, T) or (..., C, F, T) mask -> (Rss, Rnn), (..., F, C, C).  With
    ``bf16`` the ``BF16`` instance's arithmetic: each element rounded to
    bf16 once (as its tile lands), each pair sum by one fused multiply-add
    of two exact products (a float64 sum of the float32 products rounded
    once to float32: a correctly rounded sum of two float32 values, since
    53 >= 2 x 24 + 2), the weighted accumulations unfused."""
    chan = mask.ndim == y.ndim
    C, T = y.shape[-3], y.shape[-1]
    inv_t = torch.tensor(1.0, dtype=torch.float32) / T
    yr, yi = y.real.movedim(-3, -2), y.imag.movedim(-3, -2)  # (..., F, C, T)
    if bf16:
        yr, yi = bf16_round(yr), bf16_round(yi)
    m = mask.movedim(-3, -2) if chan else mask[..., None, :]  # (..., F, C or 1, T)
    cs, ds = zip(*(pair_of(p, C) for p in range(C * (C + 1) // 2)))
    cs, ds = list(cs), list(ds)
    mc, md = (m[..., cs, :], m[..., ds, :]) if chan else (m, m)
    if chan:
        w_s, w_n = (mc * md) * inv_t, ((1.0 - mc) * (1.0 - md)) * inv_t
    else:
        om = 1.0 - m
        w_s, w_n = (m * m) * inv_t, (om * om) * inv_t
    rc, ic, rd, id_ = yr[..., cs, :], yi[..., cs, :], yr[..., ds, :], yi[..., ds, :]
    if bf16:
        f64 = torch.float64
        prr = ((rc * rd).to(f64) + (ic * id_).to(f64)).to(torch.float32)
        pii = ((ic * rd).to(f64) - (rc * id_).to(f64)).to(torch.float32)
    else:
        prr = rc * rd + ic * id_
        pii = ic * rd - rc * id_
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
    D = 11 and the lane-group edge C = 5, with both mask kinds; and
    ``_masked_cov_sliced(..., 'f32')`` within 1e-6 of the model."""
    rng = np.random.default_rng(C * 100 + T)
    y = torch.from_numpy(complex_normal(rng, (1, C, 257, T)))
    m = torch.from_numpy(rng.random((1,) + ((C,) if chan else ()) + (257, T)).astype(np.float32))
    got = model_cov(y, m)
    want = cov_ops.masked_covariances_folded(y, m)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert max_rel(a, b) <= TOL, max_rel(a, b)
    # the f32 plain version in the kernel's order, its multiply-adds fused
    # (held to the kernel bit for bit on the card): the same order as the
    # model, apart only by the fused roundings
    for a, b in zip(cov_ops._masked_cov_sliced(y, m, "f32"), got):
        assert max_rel(a, b) <= 1e-6, max_rel(a, b)


@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("C,T", [(1, 1), (4, 37), (3, 64), (11, 5), (5, 33)])
def test_model_of_the_bf16_instance_is_its_plain_version_bit_for_bit(C, T, chan):
    """The ``BF16`` instance's arithmetic (each element rounded once, the
    exact pair products fused) gives ``_masked_cov_sliced``'s bits: what
    the card test at C = 1..16 requires of the kernel."""
    rng = np.random.default_rng(C * 100 + T)
    y = torch.from_numpy(complex_normal(rng, (1, C, 257, T)))
    m = torch.from_numpy(rng.random((1,) + ((C,) if chan else ()) + (257, T)).astype(np.float32))
    for a, b in zip(model_cov(y, m, bf16=True), cov_ops.masked_covariances_plain(y, m, "bf16")):
        assert torch.equal(a, b)


def test_fma_model_rounds_the_exact_sum_once():
    """``cov_ops._fma`` is ``fmaf``: where the unfused product and sum lose
    the result (``(1 + 2^-23)(1 - 2^-23) - 1``), and where the float64 sum
    lands on a float32 tie that the exact sum is not on (a double rounding
    would give 1, the exact sum rounds to 1 + 2^-23)."""
    f32 = torch.float32
    a, b, c = (torch.tensor([x], dtype=f32) for x in (1 + 2.0**-23, 1 - 2.0**-23, -1.0))
    assert float(a * b + c) == 0.0 and float(cov_ops._fma(a, b, c)) == -(2.0**-46)
    a, b = (torch.tensor([2.0**-12 * (1 + k * 2.0**-23)], dtype=f32) for k in (2896, -2895))
    one = torch.ones(1, dtype=f32)
    assert float((a.double() * b.double() + 1.0).float()) == 1.0
    assert float(cov_ops._fma(a, b, one)) == 1 + 2.0**-23
    assert float(cov_ops._fma(-a, b, -one)) == -(1 + 2.0**-23)


def _bf16_values(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """n random bf16-representable float32 values of either sign with
    magnitudes in [lo, hi): an 8-bit significand (1.xxxxxxx) times a power
    of two."""
    e = rng.integers(int(np.floor(np.log2(lo))), int(np.ceil(np.log2(hi))), n)
    mant = rng.integers(128, 256, n)
    return (rng.choice([-1.0, 1.0], n) * mant * np.exp2(e - 7.0)).astype(np.float32)


def test_bf16_products_are_exact_so_fusing_them_changes_no_bit():
    """The premise of the ``BF16`` instance's pair sums.  Over the range of
    the north-star scene's bf16 spectra (a 1-s cut of K=8 nodes x C=4 mics,
    its extremes included), a product of two bf16 values is exact in
    float32 (it equals the float64 product), so ``fmaf(a, b, c d)`` and the
    unfused ``a b + c d`` round the same exact sum once, and so do the
    imaginary part's ``fmaf(a, b, -(c d))`` and ``a b - c d``.  The fused
    result is emulated as the float64 sum rounded to float32, which is the
    correctly rounded float32 sum of the two (exact) float32 products."""
    y, _, _ = scene(8, 4, 16000, seed=0, noise_scale=0.5)
    spec = stft_ops.stft_matmul(torch.from_numpy(y), precision="bf16")
    planes = torch.cat([bf16_round(spec.real).flatten(), bf16_round(spec.imag).flatten()]).numpy()
    mags = np.abs(planes[planes != 0])
    lo, hi = float(mags.min()), float(mags.max())
    rng = np.random.default_rng(0)
    extremes = np.array([lo, -lo, hi, -hi, 0.0], np.float32)
    a, b, c, d = (np.concatenate([_bf16_values(rng, 200000, lo, hi), extremes,
                                  rng.permutation(extremes)]) for _ in range(4))
    assert np.array_equal(bf16_round(torch.from_numpy(a)).numpy(), a)
    ab, cd = a * b, c * d                                         # float32 products
    assert ab.dtype == np.float32
    assert np.array_equal(ab.astype(np.float64), a.astype(np.float64) * b.astype(np.float64))
    assert np.array_equal(cd.astype(np.float64), c.astype(np.float64) * d.astype(np.float64))
    for sign in (1.0, -1.0):
        fused = (ab.astype(np.float64) + sign * cd.astype(np.float64)).astype(np.float32)
        unfused = ab + np.float32(sign) * cd
        assert np.array_equal(fused.view(np.uint32), unfused.view(np.uint32))
