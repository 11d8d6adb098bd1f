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
the covariances); the eigensolver is also held bit for bit to its plain
version, as its design promises (``csrc/eigh.cu``).
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


@pytest.mark.parametrize("shape", [(3, 257), (2, 12345), (2, 3, 2, 8500)])
def test_stft_kernel_edges(cuda, rng, shape):
    """The shortest rows (257 samples: 2 frames, both reflected at both
    ends), a frame count that is not a multiple of the kernel's 32-frame
    tile (49 frames), and batched leading axes."""
    from disco_tpu_torch.ops import stft_ops

    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    before = stft_ops.stft_kernel.launches
    spec, mag = stft_ops.stft_kernel(x, with_mag=True)
    p_spec, p_mag = stft_ops.stft_matmul(x, with_mag=True)
    torch.cuda.synchronize()
    assert stft_ops.stft_kernel.launches == before + 1
    assert spec.shape == p_spec.shape == shape[:-1] + (257, 1 + shape[-1] // 256)
    assert rel_l2(spec, p_spec) <= TOL and rel_l2(mag, p_mag) <= TOL
    with pytest.raises(ValueError, match="more than 256 samples"):
        stft_ops.stft_kernel(x[..., :256])
    with pytest.raises(ValueError, match="512/256"):
        stft_ops.stft_kernel(x, n_fft=256, hop=128)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("T", [1, 37, 128, 300, 626])
@pytest.mark.parametrize("C", list(range(1, 17)))
def test_masked_cov_kernel(cuda, rng, C, T, per_channel):
    """Every channel count, with T = 1, an odd T below the kernel's 128-frame
    tile, one whole tile, two tiles and a ragged third, and the clip's 626
    frames; bit-stable from run to run."""
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


def _solve_inputs(rng, C, n, cuda):
    """n (C, C) pencils on the card with a NaN one (index 7, when n > 7) and
    an identity pencil pair (index 3, when n > 3)."""
    Rss, Rnn = (torch.from_numpy(a.astype(np.complex64)).to(cuda) for a in pencils(rng, C, F=n))
    if n > 7:
        Rnn[7] = float("nan")
    if n > 3:
        Rss[3] = Rnn[3] = torch.eye(C, dtype=torch.complex64, device=cuda)
    return Rss, Rnn


def _check_solve(got, want, n, cuda):
    """Within TOL rel-l2 of the plain version, and bit for bit (``mwf.cu``
    is built to repeat its rounding); the NaN pencil stays non-finite."""
    ok = torch.arange(n, device=cuda) != 7
    for a, b in zip(got, want):
        if n > 7:
            assert not torch.isfinite(a[7]).all() and not torch.isfinite(b[7]).all()
        assert torch.isfinite(a[ok]).all()
        assert rel_l2(a[ok], b[ok]) <= TOL
        assert torch.equal(a[ok], b[ok])


@pytest.mark.parametrize("mu", ["scalar", "per-pencil", "one on the card"])
@pytest.mark.parametrize("C", list(range(1, 17)))
def test_fused_mwf_kernel(cuda, rng, C, mu):
    """Every pencil size the kernel takes (a thread per pencil up to C = 4,
    lane groups of 8 or 16 above), with a scalar mu, one mu per pencil and
    one mu as a tensor on the card."""
    from disco_tpu_torch.ops import mwf_ops

    Rss, Rnn = _solve_inputs(rng, C, 45, cuda)
    mu = {"scalar": 1.5, "per-pencil": torch.linspace(0.5, 2.0, 45, device=cuda),
          "one on the card": torch.tensor(0.7, device=cuda)}[mu]
    before = mwf_ops.fused_mwf_kernel.launches
    got = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu)
    want = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu)
    torch.cuda.synchronize()
    assert mwf_ops.fused_mwf_kernel.launches == before + 1
    _check_solve(got, want, 45, cuda)


@pytest.mark.parametrize("C,n", [(c, n) for c in (4, 5, 11, 16) for n in (1, 31, 2055, 2057)]
                         + [(11, 32896)])
def test_fused_mwf_kernel_ragged_batches(cuda, rng, C, n):
    """Pencil counts that are not a multiple of a block's (32 threads up to
    C = 4; 8 or 4 pencils a block of lane groups) and the 16-clip batch's
    step-2 launch (32,896 pencils at C = 11)."""
    from disco_tpu_torch.ops import mwf_ops

    Rss, Rnn = _solve_inputs(rng, C, n, cuda)
    got = mwf_ops.fused_mwf_kernel(Rss, Rnn)
    want = mwf_ops.fused_mwf_plain(Rss, Rnn)
    torch.cuda.synchronize()
    _check_solve(got, want, n, cuda)


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("C", [1, 2, 4, 7, 11, 16])
def test_eigh_jacobi_kernel(cuda, rng, C, complex_):
    """A ragged batch (130 matrices: blocks of 32 threads) with one NaN
    matrix and one degenerate one, against the plain version."""
    from disco_tpu_torch.ops import eigh_ops

    X = rng.standard_normal((130, C, C))
    if complex_:
        X = X + 1j * rng.standard_normal((130, C, C))
    A = X @ np.conj(np.swapaxes(X, -1, -2))
    A[7] = np.nan
    A[9] = 2.0 * np.eye(C)
    A = torch.from_numpy(A.astype(np.complex64 if complex_ else np.float32)).to(cuda)
    before = eigh_ops.eigh_jacobi_kernel.launches
    lam, V = eigh_ops.eigh_jacobi_kernel(A)
    p_lam, p_V = eigh_ops.eigh_jacobi_unsorted(A)
    s_lam, s_V = eigh_ops.eigh_jacobi_pallas(A)
    torch.cuda.synchronize()
    assert eigh_ops.eigh_jacobi_kernel.launches == before + 2
    assert V.dtype == A.dtype and lam.shape == (130, C)
    assert torch.isnan(lam[7]).all() and torch.isnan(p_lam[7]).all()
    ok = torch.arange(130, device=cuda) != 7
    assert rel_l2(lam[ok], p_lam[ok]) <= TOL and rel_l2(V[ok], p_V[ok]) <= TOL
    e_lam, e_V = eigh_ops.eigh_jacobi(A)
    assert rel_l2(s_lam[ok], e_lam[ok]) <= TOL and rel_l2(s_V[ok], e_V[ok]) <= TOL
    with pytest.raises(ValueError, match="up to 16x16"):
        eigh_ops.eigh_jacobi_kernel(torch.zeros(2, 17, 17, device=cuda))


@pytest.mark.parametrize("C", list(range(1, 17)))
def test_eigh_jacobi_kernel_bit_identical(cuda, rng, C):
    """Eigenvalues and eigenvectors bit for bit those of the plain version
    at every width the kernel takes, complex and real."""
    from disco_tpu_torch.ops import eigh_ops

    for complex_ in (True, False):
        X = rng.standard_normal((67, C, C))
        if complex_:
            X = X + 1j * rng.standard_normal((67, C, C))
        A = X @ np.conj(np.swapaxes(X, -1, -2))
        A[3] = 2.0 * np.eye(C)
        A = torch.from_numpy(A.astype(np.complex64 if complex_ else np.float32)).to(cuda)
        lam, V = eigh_ops.eigh_jacobi_kernel(A)
        p_lam, p_V = eigh_ops.eigh_jacobi_unsorted(A)
        torch.cuda.synchronize()
        assert torch.equal(lam, p_lam) and torch.equal(V, p_V), (C, complex_)


@pytest.mark.parametrize("C", [4, 11, 5])
@pytest.mark.parametrize("n", [1, 3, 33, 2057])
def test_eigh_jacobi_kernel_ragged_batches(cuda, rng, C, n):
    """Batches that are not a multiple of the matrices a block (32 at
    C <= 4, a thread each) or a warp (4 at C <= 8, 2 above) holds, with a NaN matrix
    where there is room for one: bit for bit the plain version, NaN pairs
    from the NaN matrix only."""
    from disco_tpu_torch.ops import eigh_ops

    X = rng.standard_normal((n, C, C)) + 1j * rng.standard_normal((n, C, C))
    A = X @ np.conj(np.swapaxes(X, -1, -2))
    bad = n - 1 if n > 1 else None
    if bad is not None:
        A[bad] = np.nan
    A = torch.from_numpy(A.astype(np.complex64)).to(cuda)
    lam, V = eigh_ops.eigh_jacobi_kernel(A)
    p_lam, p_V = eigh_ops.eigh_jacobi_unsorted(A)
    torch.cuda.synchronize()
    assert torch.equal(lam.nan_to_num(), p_lam.nan_to_num())
    assert torch.equal(V.nan_to_num(), p_V.nan_to_num())
    nan_rows = torch.isnan(lam).any(-1).nonzero().flatten().tolist()
    assert nan_rows == ([] if bad is None else [bad])


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
    with pytest.raises(ValueError, match="eigh_jacobi"):
        rank1_gevd(eye, eye, solver="jacobi")


def test_clip_on_card_matches_plain_clip_on_host(cuda):
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    y, s, n = scene(3, 2, 10000, seed=3, noise_scale=0.5)
    got = tango_clip_fused(y, s, n).cpu()
    want = tango_clip_fused(y, s, n, device="cpu")
    assert max_rel(got, want) <= 1e-4


def test_streaming_window_on_card_matches_plain_window_on_host(cuda):
    """Two super-tick windows through ``streaming_clip_fused`` with the
    eigensolver kernel, on the card and on the host.  The scene is scaled
    by 1e-3 so that the warm start's first refreshes are well posed, and
    the first refresh block's samples are skipped: there the step-2 filter
    is set by roundoff (tests/test_torch_port_streaming.py)."""
    from disco_tpu_torch.enhance.fused import streaming_clip_fused
    from disco_tpu_torch.ops import eigh_ops

    Lw = 256 * 15
    y, s, n = (a * 1e-3 for a in scene(3, 2, 2 * Lw, seed=4, noise_scale=0.5))
    outs = {}
    for dev in ("cuda", "cpu"):
        st, parts = None, []
        before = eigh_ops.eigh_jacobi_kernel.launches
        for w in range(2):
            sl = slice(w * Lw, (w + 1) * Lw)
            o = streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=st,
                                     solver="jacobi-pallas", blocks_per_dispatch=4, device=dev)
            st = o["state"]
            parts.append(o["yf"].cpu())
        outs[dev] = torch.cat(parts, -1)
        launches = eigh_ops.eigh_jacobi_kernel.launches - before
        assert launches == (2 * 2 * 4 if dev == "cuda" else 0), (dev, launches)
    skip = 2 * 4 * 256
    assert max_rel(outs["cuda"][:, skip:], outs["cpu"][:, skip:]) <= 1e-4
