"""The port's STFT/ISTFT at sizes the kernels do not compute, against the
JAX package's own route for them.

``disco_tpu_torch.core.dsp`` picks a route by the size alone: the STFT at
the kernels' 512/256 goes to ``stft_ops.stft_fused`` (the kernel on a CUDA
tensor, ``stft_matmul`` on a CPU tensor), any other size to
``torch.fft.rfft``; the ISTFT at ``n_fft == 2 * hop`` to ``istft_matmul``,
any other size to ``torch.fft.irfft`` and the overlap-add by index.  The
reference computes every size off the TPU through ``_stft_rfft`` and
``_istft_ola`` (``impl='rfft'``/``'irfft'``).  Tolerance 1e-5 rel-l2 for
the STFT and 1e-5 of the output scale for the ISTFT and the round trip:
float32 FFTs of a few hundred points in both frameworks (observed ~1e-7 to
~2e-6).  The card's half (512/256 launches the kernel, 1024/512 launches
nothing) is ``tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu_torch.core import dsp as tdsp
from disco_tpu_torch.ops import stft_ops as tstft
from tests.torch_port_helpers import complex_normal, max_rel, rel_l2, to_np

TOL = 1e-5
SIZES = [(512, 128), (1024, 512)]


@pytest.fixture
def x():
    return np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_stft_matches_jax_rfft(x, n_fft, hop):
    ours = tdsp.stft(torch.from_numpy(x), n_fft, hop)
    ref = np.asarray(jdsp.stft(x, n_fft, hop, impl="rfft"))
    assert ours.dtype == torch.complex64
    assert ours.shape == ref.shape == (2, n_fft // 2 + 1, tdsp.n_stft_frames(4000, n_fft, hop))
    assert rel_l2(ours, ref) <= TOL, rel_l2(ours, ref)


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_istft_matches_jax_irfft(x, n_fft, hop):
    """The same spectra, made not STFT-consistent by a small complex
    perturbation, through both inverses."""
    spec = np.asarray(jdsp.stft(x, n_fft, hop, impl="rfft"))
    rng = np.random.default_rng(1)
    spec = (spec + 0.01 * complex_normal(rng, spec.shape)).astype(np.complex64)
    ours = tdsp.istft(torch.from_numpy(spec), 4000, n_fft, hop)
    ref = np.asarray(jdsp.istft(spec, 4000, n_fft, hop, impl="irfft"))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (2, 4000)
    assert max_rel(ours, ref) <= TOL, max_rel(ours, ref)


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_round_trip_reconstructs_the_signal(x, n_fft, hop):
    xt = torch.from_numpy(x)
    y = tdsp.istft(tdsp.stft(xt, n_fft, hop), 4000, n_fft, hop)
    assert max_rel(y, x) <= TOL, max_rel(y, x)


def test_istft_pads_and_keeps_leading_axes(x):
    """Batched leading axes, and ``length`` past the overlap-add output
    zero-padded (the last frames of a silent tail are exact zeros)."""
    xs = np.concatenate([x, np.zeros((2, 2000), np.float32)], axis=-1)[None]   # (1, 2, 6000)
    spec = tdsp.stft(torch.from_numpy(xs), 1024, 512)
    ours = tdsp.istft(spec, 7000, 1024, 512)
    ref = np.asarray(jdsp.istft(to_np(spec), 7000, 1024, 512, impl="irfft"))
    assert ours.shape == ref.shape == (1, 2, 7000)
    assert max_rel(ours, ref) <= TOL
    assert not to_np(ours)[..., 6000:].any()


def test_kernel_size_on_cpu_goes_to_the_kernels_plain_version(x, monkeypatch):
    """512/256 on a CPU tensor is ``stft_fused`` -> ``stft_kernel`` ->
    ``stft_matmul`` (bit for bit, no launch counted), and its inverse is
    ``istft_matmul``; at 1024/512 the STFT takes the rFFT route and the
    inverse (``n_fft == 2 * hop``) ``istft_matmul``; 512/128 reaches
    neither."""
    xt = torch.from_numpy(x)
    calls = []
    for name in ("stft_matmul", "istft_matmul"):
        real = getattr(tstft, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tstft, name, spy)
    before = tstft.stft_kernel.launches
    spec = tdsp.stft(xt)
    y = tdsp.istft(spec, 4000)
    assert calls == ["stft_matmul", "istft_matmul"]
    assert tstft.stft_kernel.launches == before
    np.testing.assert_array_equal(to_np(spec), to_np(tstft.stft_matmul(xt)))
    assert max_rel(y, x) <= TOL
    for n_fft, hop, want in ((1024, 512, ["istft_matmul"]), (512, 128, [])):
        calls.clear()
        tdsp.istft(tdsp.stft(xt, n_fft, hop), 4000, n_fft, hop)
        assert calls == want, (n_fft, hop, calls)
    with pytest.raises(ValueError, match="more than 512 samples"):
        tdsp.stft(xt[:, :512], 1024, 512)
