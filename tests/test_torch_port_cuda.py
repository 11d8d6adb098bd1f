"""The port's hand-written CUDA kernels against their plain versions, on
the card.  A CUDA kernel has no CPU mode, so every test here takes the
``cuda`` fixture, which skips with its reason on a host without an NVIDIA
Hopper GPU.  On the card, where JAX (which ``tests/conftest.py`` imports)
need not be installed::

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The shapes are the edges the main path does not reach (ragged frame and
pencil counts, the generic channel-count path, one channel); the main
path's own shapes are held by ``chip_smoke.py``.  Tolerances as in the
CPU parity tests: 1e-5 (rel-l2 for the STFT and the solve, max-rel for
the covariances).
"""
import numpy as np
import pytest
import torch

# by the module's own name (pytest puts ``tests/`` on the path): an installed
# package named ``tests`` would shadow this directory's ``tests.`` namespace
from torch_port_helpers import complex_normal, max_rel, pencils, rel_l2, scene

TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    from disco_tpu_torch.device import is_hopper

    if not is_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("with_mag", [False, True])
def test_stft_kernel(cuda, rng, with_mag):
    from disco_tpu_torch.ops import stft_ops

    x = torch.from_numpy(rng.standard_normal((5, 12345)).astype(np.float32)).to(cuda)
    before = stft_ops.stft_kernel.launches
    got = stft_ops.stft_kernel(x, with_mag=with_mag)
    want = stft_ops.stft_matmul(x, with_mag=with_mag)
    torch.cuda.synchronize()
    assert stft_ops.stft_kernel.launches == before + 1
    for a, b in zip(got if with_mag else (got,), want if with_mag else (want,)):
        assert a.shape == b.shape and rel_l2(a, b) <= TOL


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("C,T", [(1, 37), (3, 130), (11, 64), (16, 5)])
def test_masked_cov_kernel(cuda, rng, C, T, per_channel):
    from disco_tpu_torch.ops import cov_ops

    y = torch.from_numpy(complex_normal(rng, (2, C, 257, T))).to(cuda)
    m = torch.from_numpy(rng.random((2,) + ((C,) if per_channel else ()) + (257, T))
                         .astype(np.float32)).to(cuda)
    got = cov_ops.masked_cov_kernel(y, m)
    again = cov_ops.masked_cov_kernel(y, m)
    want = cov_ops.masked_covariances_folded(y, m)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert max_rel(a, b) <= TOL
        assert torch.equal(a, a2)  # fixed reduction order: bit-stable


@pytest.mark.parametrize("C", [2, 4, 7, 11, 16])
def test_fused_mwf_kernel(cuda, rng, C):
    from disco_tpu_torch.ops import mwf_ops

    Rss, Rnn = (torch.from_numpy(a.astype(np.complex64)).to(cuda) for a in pencils(rng, C, F=45))
    mu = torch.linspace(0.5, 2.0, 45, device=cuda)
    Rnn[7] = float("nan")
    got = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu)
    want = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert not torch.isfinite(a[7]).all() and not torch.isfinite(b[7]).all()
        ok = torch.arange(45, device=cuda) != 7
        assert rel_l2(a[ok], b[ok]) <= TOL


def test_plain_versions_never_run_on_card_tensors(cuda):
    from disco_tpu_torch.beam.filters import rank1_gevd
    from disco_tpu_torch.ops import cov_ops, stft_ops

    with pytest.raises(ValueError, match="stft_matmul"):
        stft_ops.stft_with_mag(torch.zeros(2, 4000, device=cuda), impl="xla")
    with pytest.raises(ValueError, match="masked_covariances_folded"):
        cov_ops.masked_covariances_fused(torch.zeros(1, 2, 257, 8, dtype=torch.complex64,
                                                     device=cuda),
                                         torch.zeros(1, 257, 8, device=cuda), impl="xla")
    eye = torch.eye(3, dtype=torch.complex64, device=cuda).expand(4, 3, 3)
    with pytest.raises(ValueError, match="fused_mwf_plain"):
        rank1_gevd(eye, eye, solver="fused-xla")


def test_clip_on_card_matches_plain_clip_on_host(cuda):
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    y, s, n = scene(3, 2, 10000, seed=3, noise_scale=0.5)
    got = tango_clip_fused(y, s, n).cpu()
    want = tango_clip_fused(y, s, n, device="cpu")
    assert max_rel(got, want) <= 1e-4
