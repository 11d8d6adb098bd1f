"""The plain reference against hand values and against the upstream formulas,
in float64 on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import scipy.linalg
import torch

from benchmark.reference import crnn as ref_crnn, dsp, tango as ref_tango

F64 = torch.float64


def test_stft_of_a_cosine_is_one_bin_and_its_neighbours():
    n, k0, amp = 4096, 37, 0.5
    t = torch.arange(n, dtype=F64)
    X = dsp.stft(amp * torch.cos(2 * np.pi * k0 * t / 512))
    assert X.shape == (257, 17)
    mid = X[:, 8].abs()
    assert mid[k0].item() == pytest.approx(amp * 512 / 4, rel=1e-12)        # A sum(w) / 2
    assert mid[k0 - 1].item() == pytest.approx(amp * 512 / 8, rel=1e-12)    # Hann's sidelobe
    far = torch.cat([mid[:k0 - 1], mid[k0 + 2:]])
    assert far.max().item() < 1e-9


def test_stft_equals_numpys_rfft_of_the_padded_windowed_frames():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(2000)
    xp = np.pad(x, 256, mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(512) / 512)
    want = np.stack([np.fft.rfft(xp[i * 256:i * 256 + 512] * win) for i in range(1 + 2000 // 256)],
                    axis=1)
    got = dsp.stft(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_istft_inverts_stft():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 5000)))
    y = dsp.istft(dsp.stft(x), 5000)
    assert (y - x).abs().max().item() < 1e-12


def test_irm1_by_hand():
    S = torch.tensor([3.0 + 0j, 1j, 2.0], dtype=torch.complex128)
    N = torch.tensor([4.0 + 0j, 1.0, 0.0], dtype=torch.complex128)
    m = ref_tango.irm1(S, N)
    assert m[0].item() == pytest.approx(3 / 7) and m[1].item() == pytest.approx(0.5)
    assert m[2].item() == pytest.approx(1.0, abs=1e-15)


def test_covariance_by_hand():
    X = torch.tensor([[[1.0 + 1j, 2.0]], [[0.0, 1j]]], dtype=torch.complex128)   # (D=2, F=1, T=2)
    R = ref_tango.covariance(X)[0]
    want = torch.tensor([[(2 + 4) / 2, (0 + 2 * -1j) / 2], [(0 + 1j * 2) / 2, 1 / 2]],
                        dtype=torch.complex128)
    assert torch.allclose(R, want, atol=1e-15)


@pytest.mark.parametrize("solver", ["eigh", "power"])
def test_rank1_pencil_gives_the_closed_form_filter(solver):
    """Rss = a a^H, Rnn = I: w = a conj(a_0) / (mu (1 + 1e-6) + |a|^2)."""
    a = torch.tensor([1.0 + 0.5j, -0.3j, 0.8, 0.1 + 0.1j], dtype=torch.complex128)
    Rss = torch.outer(a, a.conj())[None]
    Rnn = torch.eye(4, dtype=torch.complex128)[None]
    w = ref_tango.gevd_rank1(Rss, Rnn, mu=1.0, solver=solver)[0]
    want = a * a[0].conj() / (1.0 * (1 + 1e-6) + (a.abs() ** 2).sum())
    assert torch.allclose(w, want, rtol=1e-12, atol=1e-14)


def test_filter_equals_upstreams_formula_on_a_full_rank_pencil():
    """internal_formulas.py's 'gevd' rank 1 by scipy's generalized eig."""
    rng = np.random.default_rng(5)
    C = 5
    A = rng.standard_normal((C, 3 * C)) + 1j * rng.standard_normal((C, 3 * C))
    B = rng.standard_normal((C, 3 * C)) + 1j * rng.standard_normal((C, 3 * C))
    Rxx, Rnn = A @ A.conj().T / 15, B @ B.conj().T / 15
    D, Q = scipy.linalg.eig(Rxx, Rnn)
    D = np.clip(D.real, np.finfo(float).eps, 1e6)
    i = np.argmax(D)
    want = Q[:, i] * D[i] / (D[i] + 1.0) * np.linalg.inv(Q)[i, 0]
    got = ref_tango.gevd_rank1(torch.from_numpy(Rxx)[None], torch.from_numpy(Rnn)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)   # the 1e-6 loading


def test_a_non_finite_pencil_falls_back_to_the_reference_mic():
    R = torch.full((1, 3, 3), float("nan"), dtype=torch.complex128)
    w = ref_tango.gevd_rank1(R, torch.eye(3, dtype=torch.complex128)[None])
    assert torch.equal(w[0], torch.tensor([1, 0, 0], dtype=torch.complex128))


def test_crnn_reference_follows_the_ports_module():
    """The port's float32 masks within float32 rounding of the float64
    reference on the same weights: the same padding, windows, gate order
    and output frame."""
    from benchmark import weights
    from disco_tpu_torch.enhance.inference import crnn_masks_batched
    from disco_tpu_torch.nn.crnn import build_crnn

    gen = torch.Generator().manual_seed(11)
    for n_ch in (1, 3):
        p = weights.draw_crnn(n_ch, gen, "cpu")
        m = build_crnn(n_ch=n_ch).eval()
        weights.load_into(m, p)
        Y = torch.randn(3, n_ch, 257, 9, dtype=torch.complex128, generator=gen)
        got = crnn_masks_batched(Y[:, 0], m, zs=Y[:, 1:] if n_ch > 1 else None, device="cpu")
        want = ref_crnn.masks(Y, {k: v.double() for k, v in p.items()})
        assert want.shape == (3, 257, 9)
        assert (got - want).abs().max().item() < 1e-5
        assert 0.02 < want.mean().item() < 0.98 and want.std().item() > 0.02
