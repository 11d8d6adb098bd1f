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
version, as its design promises (``csrc/eigh.cu``).  The bf16 lane's
kernels against their bf16 plain versions: the STFT within 1e-4 of the
output scale (max-abs; the tensor cores' float32 accumulation order is not
a sequential sum), the covariances and the solve bit for bit.  Serving
(``disco_tpu_torch.serve``) at the north-star width: concurrent sessions on
a CUDA server bit-identical to their offline streams in both tick modes,
with one batched readback a tick and the offline calls' launches.  The
flywheel: model-mask sessions on a CUDA server bit-identical to their
per-generation oracles across a swap, the lane's masks the same bits run
after run, and a generation staged from the card carrying the host's id.
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
    frames; bit-stable from run to run, and bit for bit the plain version
    in its order and arithmetic (``_masked_cov_sliced(..., 'f32')``, the
    fused multiply-adds modelled exactly)."""
    from disco_tpu_torch.ops import cov_ops

    y = torch.from_numpy(complex_normal(rng, (2, C, 257, T))).to(cuda)
    m = torch.from_numpy(rng.random((2,) + ((C,) if per_channel else ()) + (257, T))
                         .astype(np.float32)).to(cuda)
    got = cov_ops.masked_cov_kernel(y, m)
    again = cov_ops.masked_cov_kernel(y, m)
    want = cov_ops.masked_covariances_folded(y, m)
    sliced = cov_ops._masked_cov_sliced(y, m, "f32")
    torch.cuda.synchronize()
    for a, a2, b, c in zip(got, again, want, sliced):
        assert max_rel(a, b) <= TOL
        assert torch.equal(a, a2)  # fixed reduction order: bit-stable
        assert torch.equal(a, c), max_rel(a, c)


@pytest.mark.parametrize("shape", [(3, 257), (5, 12345), (2, 3, 2, 8500), (2, 16128),
                                   (1, 257), (1, 76544), (3, 23000)])
@pytest.mark.parametrize("with_mag", [False, True])
def test_stft_bf16_kernel(cuda, rng, shape, with_mag):
    """The bf16 lane's tensor-core DFT, whose tiles of 256 frames are
    numbered across rows: the shortest rows (2 frames, one row alone too),
    frame counts that are not a multiple of the tile (245 over 5 rows, 300
    in one row, 270 over 3 rows: a tile across rows), batched leading axes
    and one streaming window (64 frames)."""
    from disco_tpu_torch.ops import stft_ops

    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    before = stft_ops.stft_bf16_kernel.launches
    got = stft_ops.stft_bf16_kernel(x, with_mag=with_mag)
    want = stft_ops.stft_matmul(x, with_mag=with_mag, precision="bf16")
    torch.cuda.synchronize()
    assert stft_ops.stft_bf16_kernel.launches == before + 1
    for a, b in zip(got if with_mag else (got,), want if with_mag else (want,)):
        assert a.shape == b.shape == shape[:-1] + (257, 1 + shape[-1] // 256)
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    with pytest.raises(ValueError, match="512/256"):
        stft_ops.stft_bf16_kernel(x, n_fft=256, hop=128)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("T", [1, 37, 300, 626])
@pytest.mark.parametrize("C", list(range(1, 17)))
def test_masked_cov_kernel_bf16(cuda, rng, C, T, per_channel):
    """The covariance kernel's bf16 instances at every channel count: bit for
    bit their plain version (which sums in the kernel's order), and so
    bit-stable from run to run."""
    from disco_tpu_torch.ops import cov_ops

    y = torch.from_numpy(complex_normal(rng, (2, C, 257, T))).to(cuda)
    m = torch.from_numpy(rng.random((2,) + ((C,) if per_channel else ()) + (257, T))
                         .astype(np.float32)).to(cuda)
    before = cov_ops.masked_cov_kernel.launches_bf16
    got = cov_ops.masked_cov_kernel(y, m, precision="bf16")
    again = cov_ops.masked_cov_kernel(y, m, precision="bf16")
    want = cov_ops.masked_covariances_plain(y, m, precision="bf16")
    torch.cuda.synchronize()
    assert cov_ops.masked_cov_kernel.launches_bf16 == before + 2
    for a, a2, b in zip(got, again, want):
        assert max_rel(a, b) <= TOL
        assert torch.equal(a, b) and torch.equal(a, a2)


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


@pytest.mark.parametrize("C", list(range(1, 17)))
def test_fused_mwf_kernel_bf16(cuda, rng, C):
    """The fused solve's bf16 instances at every pencil size, bit for bit
    their plain version (the planes rounded at load, then the f32 chain)."""
    from disco_tpu_torch.ops import mwf_ops

    Rss, Rnn = _solve_inputs(rng, C, 45, cuda)
    mu = torch.linspace(0.5, 2.0, 45, device=cuda)
    before = mwf_ops.fused_mwf_kernel.launches_bf16
    got = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu, precision="bf16")
    want = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu, precision="bf16")
    torch.cuda.synchronize()
    assert mwf_ops.fused_mwf_kernel.launches_bf16 == before + 1
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


def test_stft_istft_sizes_take_their_routes_on_the_card(cuda, rng):
    """``core.dsp``'s STFT at 512/256 launches the STFT kernel once; at
    1024/512 (and 512/128) it takes the rFFT route and launches none.  Each
    size's STFT and ISTFT on the card match the same on the host."""
    from disco_tpu_torch.core import dsp
    from disco_tpu_torch.ops import stft_ops

    x = rng.standard_normal((2, 4000)).astype(np.float32)
    for n_fft, hop, launches in ((512, 256, 1), (1024, 512, 0), (512, 128, 0)):
        before = stft_ops.stft_kernel.launches, stft_ops.stft_bf16_kernel.launches
        spec = dsp.stft(torch.from_numpy(x).to(cuda), n_fft, hop)
        y = dsp.istft(spec, 4000, n_fft, hop)
        torch.cuda.synchronize()
        assert stft_ops.stft_kernel.launches == before[0] + launches
        assert stft_ops.stft_bf16_kernel.launches == before[1]
        host = dsp.stft(torch.from_numpy(x), n_fft, hop)
        assert rel_l2(spec.cpu(), host) <= TOL
        assert max_rel(y.cpu(), dsp.istft(host, 4000, n_fft, hop)) <= TOL
        assert max_rel(y.cpu(), torch.from_numpy(x)) <= TOL


def test_plain_versions_never_run_on_card_tensors(cuda):
    from disco_tpu_torch.beam.filters import rank1_gevd
    from disco_tpu_torch.ops import cov_ops, stft_ops

    with pytest.raises(ValueError, match="stft_matmul"):
        stft_ops.stft_with_mag(torch.zeros(2, 4000, device=cuda), impl="xla")
    for precision in ("f32", "bf16"):
        with pytest.raises(ValueError, match="stft_matmul"):
            stft_ops.stft_fused(torch.zeros(2, 4000, device=cuda), impl="xla",
                                precision=precision)
        with pytest.raises(ValueError, match="masked_covariances_plain"):
            cov_ops.masked_covariances_fused(torch.zeros(1, 2, 257, 8, dtype=torch.complex64,
                                                         device=cuda),
                                             torch.zeros(1, 257, 8, device=cuda), impl="xla",
                                             precision=precision)
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


def test_bf16_clip_on_card_matches_plain_clip_on_host(cuda):
    """The bf16 lane's clip: its three kernels on the card, their plain
    versions on the host.  The two devices sum in other orders before each
    bf16 rounding point, so a value near a rounding boundary may land one
    bf16 step apart (2^-8 relative) and move its bin's filter: the clips
    agree within 2^-8 of the output scale, not 1e-4."""
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    y, s, n = scene(3, 2, 10000, seed=3, noise_scale=0.5)
    got = tango_clip_fused(y, s, n, precision="bf16").cpu()
    want = tango_clip_fused(y, s, n, precision="bf16", device="cpu")
    assert max_rel(got, want) <= 2.0 ** -8


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


# ------------------------------------------------------------ CRNN masks
def _small_crnn(n_ch, seed):
    """A CRNN of the canonical structure at narrow widths, its torch
    initialization and every bias and BatchNorm statistic redrawn from a
    seeded generator."""
    from disco_tpu_torch.nn.crnn import CRNN

    torch.manual_seed(seed)
    model = CRNN(input_shape=(n_ch, 21, 257), cnn_filters=(4, 8),
                 pool_kernels=((1, 4), (1, 4)), conv_padding=((0, 1), (0, 1)), rnn_units=(16,))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
    return model.eval()


@pytest.fixture
def crnn_inputs():
    """(Ys (10, 257, 40), zs (10, 2, 257, 40)): ten streams, so the mask
    path runs a group of 8 and a group filled by repeating the last one."""
    from disco_tpu_torch.core.dsp import stft

    y, _, n = scene(5, 2, 10000, seed=6, noise_scale=0.5)
    Y = stft(torch.from_numpy(y)).reshape(10, 257, -1)
    Z = stft(torch.from_numpy(n)).reshape(10, 257, -1)
    return Y, torch.stack([Z, Z.roll(1, 0)], 1)


def test_crnn_masks_on_card_match_host(cuda, crnn_inputs):
    """The card's convs, BatchNorm, GRU and dense layers (cuDNN/cuBLAS,
    TF32 off) against the host's, on the same streams and weights, within
    1e-4 max-abs; the stream route within 1e-5 of the per-window route on
    the card; a second card run the same within 1e-6."""
    from unittest import mock

    from disco_tpu_torch.enhance import inference

    Ys, zs = crnn_inputs
    host = _small_crnn(3, 1)
    card = _small_crnn(3, 1).to(cuda)
    got = inference.crnn_masks_batched(Ys.to(cuda), card, zs=zs.to(cuda))
    want = inference.crnn_masks_batched(Ys, host, zs=zs, device="cpu")
    assert got.shape == (10, 257, Ys.shape[-1]) and got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    with mock.patch.object(inference, "_conv_stream_safe", lambda model: False):
        window = inference.crnn_masks_batched(Ys.to(cuda), card, zs=zs.to(cuda))
    assert float((got - window).abs().max()) <= 1e-5
    again = inference.crnn_masks_batched(Ys.to(cuda), card, zs=zs.to(cuda))
    assert float((got - again).abs().max()) <= 1e-6


def test_estimate_masks_on_card_matches_host(cuda, crnn_inputs):
    """The mask stage of one clip (K = 5 nodes of 2 mics) with two CRNNs:
    step 1 through the covariance kernel, masks on the card within 1e-4 of
    the host's."""
    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.enhance.driver import estimate_masks
    from disco_tpu_torch.ops import cov_ops

    y, s, n = scene(5, 2, 10000, seed=7, noise_scale=0.5)
    Y, S, N = (stft(torch.from_numpy(a)) for a in (y, s, n))
    models = {"cpu": [_small_crnn(1, 2), _small_crnn(5, 3)]}
    models["cuda"] = [m.to(cuda) for m in (_small_crnn(1, 2), _small_crnn(5, 3))]
    before = cov_ops.masked_cov_kernel.launches
    got = estimate_masks(Y, S, N, models["cuda"], "irm1", 5)
    assert cov_ops.masked_cov_kernel.launches == before + 1
    want = estimate_masks(Y, S, N, models["cpu"], "irm1", 5, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and float((a.cpu() - b).abs().max()) <= 1e-4


def test_mask_entry_points_raise_on_a_model_on_another_device(cuda, crnn_inputs):
    from disco_tpu_torch.enhance import driver, inference

    Ys, zs = crnn_inputs
    host = _small_crnn(3, 1)
    with pytest.raises(ValueError, match="lies on cpu"):
        inference.crnn_masks_batched(Ys, host, zs=zs)
    with pytest.raises(ValueError, match="lies on cpu"):
        inference.crnn_mask(Ys[0], host, z=list(zs[0]))
    card = _small_crnn(1, 1).to(cuda)
    with pytest.raises(ValueError, match="lies on cuda"):
        inference.crnn_masks_batched(Ys, card, device="cpu")
    Y = Ys.reshape(5, 2, 257, -1)
    with pytest.raises(ValueError, match="lies on cpu"):
        driver.estimate_masks(Y, None, None, [_small_crnn(1, 1), None], "irm1", 5)
    with pytest.raises(ValueError, match="lies on cpu"):
        driver._batched_masks(Y[None], Y[None], Y[None], [_small_crnn(1, 1), None], "irm1", 1.0,
                              5, "zs_hat")


def _training_crnn(seed):
    from disco_tpu_torch.nn.crnn import CRNN

    torch.manual_seed(seed)
    return CRNN((2, 9, 33), cnn_filters=(4, 8), pool_kernels=((1, 2), (1, 2)),
                conv_padding=((0, 1), (0, 1)), rnn_units=(16,), ff_units=(33,))


def test_train_step_on_card_matches_host(cuda, rng):
    """One RMSprop step of the same CRNN on the same batch, on the card and
    on the host: loss within 1e-5 relative, parameters and ``nu`` within
    1e-4 absolute, BatchNorm statistics within 1e-5 relative; and on each
    device ``nu`` element by element within 1e-6 of the 0.01 g^2 of the
    step's own gradient g, so a ``nu`` of 0 or of another decay fails."""
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, make_step_fns

    x = rng.random((16, 2, 9, 33)).astype(np.float32)
    y = rng.random((16, 9, 33)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        model = _training_crnn(0).to(dev)
        state = create_train_state(model, build_optimizer(model))
        train_step, _ = make_step_fns(model, "all")
        state, loss = train_step(state, x, y)
        out[str(dev)] = (float(loss), {k: v.cpu() for k, v in model.state_dict().items()},
                         [state.optimizer.state[p]["nu"].cpu() for p in model.parameters()])
        for p in model.parameters():
            torch.testing.assert_close(state.optimizer.state[p]["nu"], 0.01 * p.grad * p.grad,
                                       rtol=1e-6, atol=0)
    (l_h, sd_h, nu_h), (l_c, sd_c, nu_c) = out["cpu"], out["cuda"]
    assert abs(l_c - l_h) <= 1e-5 * abs(l_h)
    for k, v in sd_h.items():
        if "running" in k:
            torch.testing.assert_close(sd_c[k], v, rtol=1e-5, atol=1e-7)
        elif v.is_floating_point():
            torch.testing.assert_close(sd_c[k], v, rtol=0, atol=1e-4)
    for a, b in zip(nu_c, nu_h):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_postgen_stft_launches_and_files_on_card(cuda, tmp_path, rng):
    """``PostGenerator`` on the card launches the STFT kernel three times an
    RIR and writes the host run's files: WAVs byte-identical, STFTs within
    1e-5 of their scale, masks within 1e-6 of the host's mask of the card's
    spectra."""
    import shutil

    from disco_tpu_torch.core.masks import tf_mask
    from disco_tpu_torch.datagen.postgen import PostGenerator
    from disco_tpu_torch.io.audio import write_wav
    from disco_tpu_torch.ops import stft_ops

    base = tmp_path / "src" / "random" / "train" / "wav_original" / "cnv"
    for rir in (1, 2):
        for ch in range(1, 17):
            for kind, name in (("target", f"{rir}_S-1_Ch-{ch}"),
                               ("noise", f"{rir}_S-2_ssn_Ch-{ch}")):
                (base / kind).mkdir(parents=True, exist_ok=True)
                write_wav(base / kind / f"{name}.wav", 0.1 * rng.standard_normal(8000), 16000)
    roots = {}
    for dev in ("cpu", None):
        root = tmp_path / str(dev)
        shutil.copytree(tmp_path / "src", root)
        before = stft_ops.stft_kernel.launches
        pg = PostGenerator(1, 2, "random", "ssn", [0, 6], str(root),
                           rng=np.random.default_rng(7), device=dev)
        assert pg.post_process() == [1, 2]
        torch.cuda.synchronize()
        assert stft_ops.stft_kernel.launches - before == (0 if dev == "cpu" else 6)
        roots[str(dev)] = root
    files = sorted(str(p.relative_to(roots["cpu"])) for p in roots["cpu"].rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(roots["None"])) for p in roots["None"].rglob("*")
                           if p.is_file())
    for f in files:
        a, b = roots["None"] / f, roots["cpu"] / f
        if f.endswith(".wav") or "/snrs/" in f:
            assert a.read_bytes() == b.read_bytes(), f
        elif "mask_processed" in f:
            rir, ch = f.split("/")[-1].split("_ssn_Ch-")
            raw = roots["None"] / "random" / "train" / "stft_processed" / "raw" / "0-6"
            s = torch.from_numpy(np.load(raw / "target" / f"{rir}_Ch-{ch}"))
            n = torch.from_numpy(np.load(raw / "noise" / f"{rir}_ssn_Ch-{ch}"))
            assert np.abs(np.load(a) - tf_mask(s, n).numpy()).max() <= 1e-6, f
        else:
            x, y = np.load(a), np.load(b)
            assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max(), f


def test_ism_on_card_matches_host_and_golden_fixture(cuda):
    """The order-20 RIRs of ``tests/data/golden_rir_order20.npz``'s room on
    the card: within the JAX package's 5e-4 of the float64 fixture, within
    1e-6 of the host's run (relative L2 a RIR), and a second card run bit
    for bit the first; chunked rows bit for bit the unchunked ones."""
    from pathlib import Path

    from disco_tpu_torch.sim import ism

    g = np.load(Path(__file__).parent / "data" / "golden_rir_order20.npz")
    args = (g["room_dim"].astype(np.float32), g["sources"].astype(np.float32),
            g["mics"].astype(np.float32), float(g["alpha"]))
    kw = dict(max_order=int(g["max_order"]), rir_len=int(g["rir_len"]))
    first, second = (ism.shoebox_rirs(*args, **kw) for _ in range(2))
    host = ism.shoebox_rirs(*args, **kw, device="cpu")
    assert first.device.type == "cuda" and torch.equal(first, second)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max()

    assert rel(first.cpu().numpy(), g["rirs"]) < 5e-4
    assert rel(first.cpu().numpy(), host.numpy()) <= 1e-6
    dims = torch.as_tensor(np.repeat(args[0][None], 8, 0), device=cuda)
    srcs = torch.as_tensor(args[1][[0, 1] * 4], device=cuda)
    mics = torch.as_tensor(args[2][[0, 1, 2, 3] * 2], device=cuda)
    alphas = torch.full((8,), args[3], device=cuda)
    whole = ism._rir_rows(dims, srcs, mics, alphas, 20, 12288, 16000, budget=1 << 40)
    assert torch.equal(ism._rir_rows(dims, srcs, mics, alphas, 20, 12288, 16000, budget=1), whole)


def test_scene_batch_launches_one_stft_on_card(cuda):
    """One scene batch on the card: one launch of the STFT kernel, its
    magnitudes within 1e-5 (relative L2) of ``stft_matmul`` of the batch's
    own noisy reference-mic signals, the masks in [0, 1]."""
    from disco_tpu_torch.ops import stft_ops
    from disco_tpu_torch.scenes import draw_scene_batch, simulate_scene_batch

    batch = draw_scene_batch(np.random.default_rng(3), 4, duration_s=0.5)
    before = stft_ops.stft_kernel.launches
    out = simulate_scene_batch(batch, max_order=8)
    torch.cuda.synchronize()
    assert stft_ops.stft_kernel.launches - before == 1
    want = stft_ops.stft_matmul(torch.as_tensor(out["noisy"][:, 0], device=cuda), with_mag=True)[1]
    assert rel_l2(torch.as_tensor(out["mag_noisy"], device=cuda), want) <= TOL
    assert out["mask"].min() >= 0 and out["mask"].max() <= 1
    host = simulate_scene_batch(batch, max_order=8, device="cpu")
    assert max_rel(out["rirs"], host["rirs"]) <= 1e-5 and max_rel(out["noisy"], host["noisy"]) <= 1e-5


def test_batched_generation_crash_and_resume_on_card(cuda, tmp_path):
    """``generate_disco_rirs_batched`` of 2 RIRs in chunks of 1 on the card,
    crashed at ``between_scene_batches`` after the first and resumed: the
    tree byte-identical to an uninterrupted run's."""
    from disco_tpu_torch.datagen.disco import generate_disco_rirs_batched
    from disco_tpu_torch.io.audio import write_wav
    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.sim import SpeechAndNoiseSetup

    rng = np.random.default_rng(0)
    speech = []
    for spk in ("7", "8"):
        f = tmp_path / "talkers" / spk / "1" / f"{spk}-1-0001.wav"
        f.parent.mkdir(parents=True)
        t = np.arange(4 * 16000) / 16000
        env = (np.sin(2 * np.pi * 1.1 * t + float(spk)) > -0.2).astype(np.float64)
        write_wav(f, 0.3 * env * rng.standard_normal(len(t)), 16000)
        speech.append(str(f))

    def run(root, rng_seed):
        setup = SpeechAndNoiseSetup(speech, speech, {}, duration_range=(1, 2),
                                    var_tar=10 ** (-23 / 10), snr_dry_range=[[0, 0]],
                                    snr_cnv_range=(-60, 60), min_delta_snr=-1,
                                    rng=np.random.default_rng(3))
        return generate_disco_rirs_batched(
            "random", "test", 1, 2, setup, DatasetLayout(str(root / "dataset"), "random", "test"),
            rng=np.random.default_rng(rng_seed), max_order=20, ledger=str(root / "l.jsonl"),
            resume=True, batch=1, seed=17)

    assert run(tmp_path / "a", 5) == [1, 2]
    chaos.configure("between_scene_batches", after=1)
    try:
        with pytest.raises(chaos.ChaosCrash):
            run(tmp_path / "b", 5)
    finally:
        chaos.disable()
    assert run(tmp_path / "b", 999) == [2]
    trees = [{str(p.relative_to(r)): p.read_bytes() for p in sorted(r.rglob("*")) if p.is_file()}
             for r in (tmp_path / "a" / "dataset", tmp_path / "b" / "dataset")]
    assert len(trees[0]) == 2 * (2 + 2 * 16 + 1) and trees[0] == trees[1]


def _serve_specs(dev, seconds=4.0):
    """Serving's sessions at the north-star width (K=8 x C=4, F=257,
    64-frame blocks): three STFT-domain sessions with their whole-clip
    references (bit-identical to the per-block calls) and a time-domain
    one; and the launches of their offline per-block calls."""
    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops
    from disco_tpu_torch.serve import check as sc

    counters = [(stft_ops.stft_kernel, "launches"), (mwf_ops.fused_mwf_kernel, "launches"),
                (eigh_ops.eigh_jacobi_kernel, "launches"), (cov_ops.masked_cov_kernel, "launches")]
    y, s, n = scene(8, 4, int(seconds * 16000), seed=3, noise_scale=0.5)
    spec, mag = stft_ops.stft_kernel(torch.from_numpy(np.stack([y, s, n])).to(dev), with_mag=True)
    Y, m = to_host([spec[0], tf_mask_mag(mag[1][:, 0], mag[2][:, 0], "irm1")])
    cfg = dict(n_nodes=8, n_mics=4, block_frames=64, update_every=4)
    zm = np.ones(8, np.float32)
    zm[2] = 0.0
    specs, launches = [], [0] * len(counters)
    for kw, z in (({"solver": "jacobi-pallas"}, None), ({"solver": "fused", "mu": 1.2}, None),
                  ({"solver": "eigh"}, zm)):
        okw = dict(kw, **({} if z is None else {"z_avail": z}))
        ref = sc.offline_stream(Y, m, device=dev, **okw)
        before = [getattr(f, a) for f, a in counters]
        pb = sc.per_block_stream(Y, m, block=64, device=dev, **okw)
        launches = [n + getattr(f, a) - b for n, (f, a), b in zip(launches, counters, before)]
        np.testing.assert_array_equal(pb, ref)
        specs.append({"Y": Y, "m": m, "ref": ref, "z_mask": z,
                      "config": sc.session_config(257, **cfg, **kw)})
    wins = [y[..., w * 16128:(w + 1) * 16128] for w in range(3)]
    masks = [m[..., 63 * w:63 * w + 64] for w in range(3)]
    before = [getattr(f, a) for f, a in counters]
    refs = sc.chained_windows(wins, masks, device=dev, solver="jacobi-pallas")
    launches = [n + getattr(f, a) - b for n, (f, a), b in zip(launches, counters, before)]
    specs.append({"windows": wins, "masks": masks, "ref": np.concatenate(refs, axis=-1),
                  "config": sc.session_config(257, **cfg, solver="jacobi-pallas",
                                              domain="time")})
    return specs, counters, launches


@pytest.mark.parametrize("super_ticks", [False, True])
def test_serve_parity_at_north_star_width(cuda, super_ticks):
    """Four concurrent full-width sessions on a CUDA server (the eigensolver,
    fused-solve and STFT kernels): each served stream bit-identical to its
    offline reference, one batched readback a tick with work, and the
    launches of the offline per-block calls."""
    from disco_tpu_torch.serve import check as sc

    specs, counters, launches = _serve_specs(cuda)
    before = [getattr(f, a) for f, a in counters]
    failures = []
    res = sc.check_parity(failures, specs, device=cuda,
                          server_kw={"blocks_per_super_tick": 2, "max_queue_blocks": 8}
                          if super_ticks else None)
    torch.cuda.synchronize()
    assert not failures, failures
    assert res["batched_readbacks"] == res["ticks"] >= 1
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == launches
    assert launches[0] == 3 and launches[1] == 4 * 2 and launches[2] == (4 + 3) * 2


@pytest.mark.parametrize("solver", ["eigh", "jacobi-pallas", "fused"])
@pytest.mark.parametrize("block", [8, 64])
def test_whole_clip_stream_equals_its_blocks_at_north_star_width(cuda, solver, block):
    """A 10-s north-star stream equals the same stream in blocks of 8 and
    64 frames bit for bit on the card (every library call on the path sees
    a batch of a fixed shape: ``filters._eigh_batches``, the per-block
    filter product of ``streaming._stream_filter``); ``eigh`` at this width
    also shows cuSOLVER's batch limit is kept."""
    from disco_tpu_torch.serve import check as sc

    rng = np.random.default_rng(1)
    Y = complex_normal(rng, (8, 4, 257, 626))
    m = rng.uniform(0.05, 0.95, (8, 257, 626)).astype(np.float32)
    ref = sc.offline_stream(Y, m, device=cuda, solver=solver)
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(sc.per_block_stream(Y, m, block=block, device=cuda,
                                                      solver=solver), ref)


def test_fused_xla_session_evicted_on_a_cuda_server(cuda):
    """'fused-xla' names the fused solve's plain version, which never runs
    on a CUDA tensor: the session is admitted and evicted with a clean
    error frame at its first dispatch, and the server keeps serving."""
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, ServeError
    from disco_tpu_torch.serve import check as sc

    Y, m = sc.scene(3, device=cuda)
    srv = EnhanceServer(max_sessions=2, device=cuda)
    try:
        addr = srv.start()
        cl = ServeClient(addr, reattach_retries=0)
        try:
            cl.open(sc.session_config(Y.shape[-2], solver="fused-xla"))
            cl.send_block(Y[..., :sc.BLOCK], m[..., :sc.BLOCK], m[..., :sc.BLOCK])
            with pytest.raises(ServeError) as err:
                cl.recv_enhanced(0)
        finally:
            cl.shutdown()
        assert err.value.code == "evicted" and "ValueError" in str(err.value)
        good = ServeClient(addr)
        try:
            good.open(sc.session_config(Y.shape[-2], solver="fused"))
            np.testing.assert_array_equal(good.enhance_clip(Y, m, m),
                                          sc.offline_stream(Y, m, device=cuda, solver="fused"))
            good.close()
        finally:
            good.shutdown()
    finally:
        srv.stop()
    assert srv.crashed is None


def test_to_host_counts_one_readback_on_the_card(cuda):
    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.obs.accounting import device_get_count

    a = torch.arange(12, dtype=torch.float32, device=cuda).reshape(3, 4)
    b = torch.complex(a, -a)
    before = device_get_count()
    ha, hb = to_host([a, b])
    assert device_get_count() - before == 1
    np.testing.assert_array_equal(ha, a.cpu().numpy())
    np.testing.assert_array_equal(hb, b.cpu().numpy())


# ----------------------------------------------------- the flywheel on the card
def _flywheel_setup(n_blocks=14, n=2, solvers=("jacobi-pallas", "fused")):
    from disco_tpu_torch.promote import check as pc

    F = 257
    arch = pc.tiny_arch(F)
    clips = [pc.scene(500 + i, n_blocks, device="cuda") for i in range(n)]
    configs = [pc.model_config(F, solver=solvers[i % len(solvers)]) for i in range(n)]
    return pc, arch, pc.seeded_variables(arch, 7), clips, configs


def test_model_mask_sessions_bit_identical_across_a_swap_on_card(cuda, tmp_path):
    """A promotion on a CUDA server: each stream, through the canary swap
    and the promotion, bit-identical to its per-generation oracle replayed
    on the card."""
    pc, arch, variables, clips, configs = _flywheel_setup()
    failures = []
    st = pc.check_promote(failures, tmp_path, clips, configs, arch, variables, device=cuda)
    assert not failures, failures
    assert st["store"].active() == st["candidate"]
    assert all(len(set(g.values())) == 2 for _, g in st["streams"])


def test_block_masks_bit_identical_between_runs_on_card(cuda):
    from disco_tpu_torch.promote.lane import block_masks
    from disco_tpu_torch.promote.store import GenerationStore

    import tempfile

    pc, arch, variables, clips, _ = _flywheel_setup(n_blocks=2, n=1)
    with tempfile.TemporaryDirectory() as tmp:
        store = GenerationStore(tmp)
        g = store.stage_variables(variables, arch=arch)
        model = store.load(g.gen_id, device=cuda)[0]
        host = store.load(g.gen_id)[0]
    Y = clips[0][..., :8]
    a, b = block_masks(Y, model), block_masks(Y, model)
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert float((a.cpu() - block_masks(Y, host)).abs().max()) <= 1e-4


def test_generation_staged_on_card_has_the_host_id(cuda, tmp_path):
    """A module on the card staged through its state dict lands on the id
    the host store gives the same numpy weights, and the host store loads
    it."""
    from disco_tpu_torch.promote.store import GenerationStore

    pc, arch, variables, _, _ = _flywheel_setup(n_blocks=1, n=1)
    host = GenerationStore(tmp_path / "h").stage_variables(variables, arch=arch)
    model = GenerationStore(tmp_path / "h").load(host.gen_id, device=cuda)[0]
    assert next(model.parameters()).device.type == "cuda"
    g = GenerationStore(tmp_path / "c").stage_module(model, arch=arch)
    assert g.gen_id == host.gen_id
    assert g.weights_path.read_bytes() == host.weights_path.read_bytes()
    back, _ = GenerationStore(tmp_path / "c").load(g.gen_id)
    assert next(back.parameters()).device.type == "cpu"


# ------------------------------------------------------------ observability
def test_sentinel_reads_a_card_tensor_back_without_a_batched_readback(cuda, tmp_path):
    """A NaN in a complex card tensor trips one sentinel with its stats and
    one flight dump; the copy ticks two fences (the JAX package's count for
    a complex leaf) and leaves ``device_get_batches`` alone."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.obs import flight, sentinels
    from disco_tpu_torch.obs.accounting import device_get_count, fence_count

    Y = torch.ones((2, 3, 5), dtype=torch.complex64, device=cuda)
    Y[1, 2, 4] = complex(float("nan"), 0.0)
    g0, f0 = device_get_count(), fence_count()
    flight.enable(dump_dir=tmp_path / "flight")
    try:
        with obs.recording(tmp_path / "log.jsonl"):
            assert sentinels.check_finite("stft_Y", Y, stage="stft") is False
    finally:
        flight.disable()
    assert (device_get_count() - g0, fence_count() - f0) == (0, 2)
    (ev,) = [e for e in obs.read_events(tmp_path / "log.jsonl") if e["kind"] == "sentinel"]
    assert ev["attrs"]["shape"] == [2, 3, 5] and ev["attrs"]["dtype"] == "complex64"
    assert (ev["attrs"]["n_nonfinite"], ev["attrs"]["n_nan"]) == (1, 1)
    assert len(list((tmp_path / "flight").glob("flight-*-sentinel.json"))) == 1


def test_disabled_seams_add_no_fence_on_the_card(cuda):
    """With no event sink live the stage spans and sentinels touch no card
    tensor: no fence, no batched readback, the check passes unread."""
    from disco_tpu_torch.obs import events, sentinels
    from disco_tpu_torch.obs.accounting import device_get_count, fence_count

    assert not events.active()
    Y = torch.full((4, 257, 9), float("nan"), device=cuda)
    g0, f0 = device_get_count(), fence_count()
    with events.stage("stft", rir=1):
        assert sentinels.check_finite("stft_Y", Y, stage="stft") is True
        assert sentinels.check_finite("masks", (Y, Y), stage="masks") is True
    assert (device_get_count(), fence_count()) == (g0, f0)


def test_tango_gives_a_clip_the_same_bits_in_any_chunk(cuda, rng):
    """A clip alone and the same clip second in a chunk of two: the same
    bits from ``tango`` (ROADMAP Queue 3, fault 5: a batched filter product
    picks its kernel by the batch), so a resumed corpus run rewrites the
    same files."""
    from disco_tpu_torch.enhance.tango import oracle_masks, tango
    from disco_tpu_torch.ops.stft_ops import stft_fused

    x = torch.from_numpy(rng.standard_normal((3, 2, 4, 2, 32768)).astype(np.float32)).to(cuda)
    spec2, spec1 = stft_fused(x), stft_fused(x[:, 1:].contiguous())
    m2, m1 = oracle_masks(spec2[1], spec2[2]), oracle_masks(spec1[1], spec1[2])
    for solver in ("power", "fused"):
        r2 = tango(spec2[0], spec2[1], spec2[2], m2, m2, solver=solver)
        r1 = tango(spec1[0], spec1[1], spec1[2], m1, m1, solver=solver)
        for key in ("yf", "sf", "nf", "z_y"):
            assert torch.equal(getattr(r2, key)[1:], getattr(r1, key)), (solver, key)


def test_tango_cli_fused_equals_the_direct_call_on_card(cuda, tmp_path):
    """``disco-tango --rirs 11001 2 --solver fused`` on the card writes the
    artifacts of the direct ``enhance_rirs_batched`` call with the CLI's
    defaults, byte for byte, with the same kernel launches."""
    from disco_tpu_torch.cli import tango as tango_cli
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops
    from disco_tpu_torch.runs.check import NOISE, _mini_corpus

    counters = [(stft_ops.stft_kernel, "launches"), (cov_ops.masked_cov_kernel, "launches"),
                (mwf_ops.fused_mwf_kernel, "launches"), (eigh_ops.eigh_jacobi_kernel, "launches")]
    root = _mini_corpus(tmp_path / "corpus", mics_per_node=4)

    def launches(fn):
        before = [getattr(f, a) for f, a in counters]
        fn()
        torch.cuda.synchronize()
        return [getattr(f, a) - b for (f, a), b in zip(counters, before)]

    cli = launches(lambda: tango_cli.main([
        "--rirs", "11001", "2", "--noise", NOISE, "--dataset", str(root),
        "--solver", "fused", "--out_root", str(tmp_path / "cli")]))
    direct = launches(lambda: enhance_rirs_batched(
        str(root), "living", range(11001, 11003), NOISE, out_root=str(tmp_path / "direct"),
        solver="fused", bucket=8192, max_batch=16))
    assert cli == direct and cli[0] >= 1 and cli[2] >= 2

    def tree(r):
        return {str(p.relative_to(r)): p.read_bytes() for p in sorted(r.rglob("*")) if p.is_file()}

    ours, want = tree(tmp_path / "cli"), tree(tmp_path / "direct")
    assert len(want) > 40 and ours == want
