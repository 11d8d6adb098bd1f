"""The STFT kernel's host tables and index arithmetic, on the CPU.

``csrc/stft.cu`` computes the centered 512/256 STFT as a packed real FFT:
reflect padding by index, the window, z[m] = x[2m] + i x[2m+1], a four-step
16 x 16 FFT of z (each 16-point FFT a radix 4 x 4 in registers), and the
split post-pass to 257 bins.  The kernel runs only on the card, so this file
keeps a numpy model of exactly those steps, in the kernel's index order, fed
exactly the tables the wrapper hands the kernel (``stft_ops._fft_tables``),
and holds it to ``np.fft.rfft`` of the windowed frames (float64) within
1e-6 rel-l2: a wrong twiddle, packing or post-pass index shows here before
any chip time.  A float32 FFT of 512 points is ~1e-7 from the float64 one.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disco_tpu_torch.ops import stft_ops
from tests.torch_port_helpers import rel_l2, to_np

TOL = 1e-6
N, HOP, M = 512, 256, 256


def kernel_tables():
    """(window, tw, post) as numpy, as the wrapper hands them to the kernel."""
    return tuple(to_np(t) for t in stft_ops._fft_tables(N, "cpu"))


def fft4(r, o, s):
    """The kernel's ``fft4<O, S>``: y_k = sum_n a_n (-i)^{nk} in place on
    positions o + s j of the last axis."""
    a0, a1, a2, a3 = (r[..., o + s * j].copy() for j in range(4))
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    r[..., o] = t0 + t2
    r[..., o + s] = t1 - 1j * t3
    r[..., o + 2 * s] = t0 - t2
    r[..., o + 3 * s] = t1 + 1j * t3


def fft16(x, tw):
    """The kernel's ``fft16``: 4-point FFTs over n1 of x[4 n1 + n2], the
    twiddles tw[16 n2 k1], 4-point FFTs over n2, then the 4 x 4 transpose."""
    r = np.array(x, dtype=np.complex64)
    for n2 in range(4):
        fft4(r, n2, 4)
    for n2 in range(1, 4):
        for k1 in range(1, 4):
            r[..., 4 * k1 + n2] *= tw[16 * n2 * k1]
    for k1 in range(4):
        fft4(r, 4 * k1, 1)
    return r.reshape(r.shape[:-1] + (4, 4)).swapaxes(-1, -2).reshape(r.shape)


def strip_index(L, T):
    """(T, 512) row index of each frame's samples: padded position
    t * 256 + n, reflected at both ends of the row as the kernel's strip
    load does."""
    s = np.arange(T)[:, None] * HOP + np.arange(N)[None, :] - N // 2
    s = np.abs(s)
    return np.where(s >= L, 2 * (L - 1) - s, s)


def model_stft(x, win, tw, post):
    """The kernel's steps in numpy: (B, L) float32 -> (B, 257, T) complex."""
    B, L = x.shape
    T = 1 + L // HOP
    frames = x[:, strip_index(L, T)] * win                        # (B, T, 512)
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    lane = np.arange(16)
    # first pass: lane n2 transforms z[16 n1 + n2] over n1, then w256^(n2 k1)
    a = fft16(z.reshape(B, T, 16, 16).swapaxes(-1, -2), tw)      # [.., n2, k1]
    a = a * tw[(lane[:, None] * lane[None, :]) & (M - 1)]
    # second pass: lane k1 transforms B[n2][k1] over n2 into Z[k1 + 16 k2]
    zk = fft16(a.swapaxes(-1, -2), tw)                            # [.., k1, k2]
    Z = zk.swapaxes(-1, -2).reshape(B, T, M)
    k = np.arange(M + 1)
    za, zb = Z[..., k & (M - 1)], Z[..., (M - k) & (M - 1)]
    e = 0.5 * (za + np.conj(zb))
    o = 0.5 * (za.imag + zb.imag) + 1j * 0.5 * (zb.real - za.real)
    return (e + post[k] * o).swapaxes(-1, -2)


def test_tables_are_the_exact_twiddles():
    win, tw, post = kernel_tables()
    assert tw.dtype == post.dtype == np.complex64 and tw.shape == (M,) and post.shape == (M + 1,)
    np.testing.assert_array_equal(win, to_np(stft_ops.hann_periodic(N)))
    exact_tw = np.exp(-2j * np.pi * np.arange(M) / M)
    exact_post = np.exp(-2j * np.pi * np.arange(M + 1) / N)
    assert np.abs(tw - exact_tw).max() <= 6e-8
    assert np.abs(post - exact_post).max() <= 6e-8
    # the 16-point stages' twiddles are every 16th entry, and the quarter
    # turns come out as the float32 roundings of the float64 values
    np.testing.assert_array_equal(tw[::16], np.exp(-2j * np.pi * np.arange(16) / 16)
                                  .astype(np.complex64))
    # the cos/sin columns of the plain version's DFT tables at n = 1 are post
    dre, dim = stft_ops.dft_matrices(N)
    np.testing.assert_array_equal(dre[1], post.real)
    np.testing.assert_array_equal(dim[1], post.imag)


def test_fft16_model_is_a_dft():
    _, tw, _ = kernel_tables()
    x = np.random.default_rng(1).standard_normal((7, 16, 2)).astype(np.float32)
    x = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    assert rel_l2(fft16(x, tw), np.fft.fft(x.astype(np.complex128), axis=-1)) <= TOL


@pytest.mark.parametrize("L", [257, 300, 7999, 12345])
def test_reflect_index_is_torch_reflect_padding(L):
    """The kernel's reflected strip index reads the samples of
    ``F.pad(mode='reflect')`` frames, at the shortest signal too."""
    x = torch.arange(L, dtype=torch.float64)[None]
    T = 1 + L // HOP
    want = F.pad(x, (N // 2, N // 2), mode="reflect").unfold(-1, N, HOP)[0]
    assert want.shape == (T, N)
    np.testing.assert_array_equal(strip_index(L, T), to_np(want).astype(np.int64))


@pytest.mark.parametrize("shape", [(1, 257), (2, 300), (3, 12345), (2, 16128)])
def test_model_of_the_kernel_matches_rfft(shape):
    """Ragged T (12345 samples: 49 frames, tiles of 32), the shortest signal
    (257 samples: 2 frames, both edges reflected) and one streaming window
    (64 frames)."""
    win, tw, post = kernel_tables()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = model_stft(x, win, tw, post)
    T = 1 + shape[1] // HOP
    frames = x.astype(np.float64)[:, strip_index(shape[1], T)] * win.astype(np.float64)
    want = np.fft.rfft(frames, axis=-1).swapaxes(-1, -2)
    assert got.shape == want.shape == (shape[0], N // 2 + 1, T)
    assert rel_l2(got, want) <= TOL, rel_l2(got, want)
    # and the plain version, the kernel's yardstick on the card, agrees
    plain = stft_ops.stft_matmul(torch.from_numpy(x))
    assert rel_l2(got, plain) <= 1e-5
