"""The port's bf16 lane against the JAX package's, on the same numpy inputs:
the STFT, the masked covariances, the folded einsum, the streaming tail
accumulator, the fused solve, two-step TANGO, the offline clip and
streaming.

The JAX package has no single bf16 arithmetic (its interpret-mode kernels
and its XLA formulations round at different points), so the port defines
its rounding points once (``disco_tpu_torch/ops/resolve.py``) and is held
to the JAX package at the lane tolerances of
``doc/source/performance.rst``:

* STFT within 1e-2 max-rel;
* covariances within 3e-2 max-rel (and against the float64 oracle);
* step-1 streams within 1e-2 rel-l2;
* the bf16 solve within 2e-2 rel-l2 of ``intern_filter_np``;
* SI-SDR within 0.1 dB of the f32 lane.

Inside the port the plain versions follow the rounding points exactly:
a numpy model of ``csrc/stft_bf16.cu``'s tiles, phases, chunk table and
``wgmma`` operand layout reproduces the plain STFT, and the solve's bf16 lane is its f32 chain on the rounded
pencils, bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu.enhance import fused as jfused
from disco_tpu.enhance import streaming as jstream
from disco_tpu.ops import cov_ops as jcov
from disco_tpu.ops import mwf_ops as jmwf
from disco_tpu.ops import stft_ops as jstft
from disco_tpu_torch.core.dsp import istft as t_istft
from disco_tpu_torch.enhance import fused as tfused
from disco_tpu_torch.enhance import streaming as tstream
from disco_tpu_torch.enhance import tango as ttango
from disco_tpu_torch.enhance.stream_check import per_block_reference
from disco_tpu_torch.ops import cov_ops as tcov
from disco_tpu_torch.ops import mwf_ops as tmwf
from disco_tpu_torch.ops import stft_ops as tstft
from disco_tpu_torch.ops.resolve import bf16_round
from tests.reference_impls import covariances_np, intern_filter_np, si_sdr_np, tango_np
from tests.torch_port_helpers import complex_normal, max_rel, pencils, rel_l2, scene, to_np

jtango = importlib.import_module("disco_tpu.enhance.tango")

TOL_STFT, TOL_COV, TOL_STREAM, TOL_SOLVE, TOL_SDR_DB = 1e-2, 3e-2, 1e-2, 2e-2, 0.1
K, C, L = 3, 2, 10000


@pytest.fixture(scope="module")
def clip():
    return scene(K, C, L, seed=1, noise_scale=0.5)


@pytest.fixture(scope="module")
def spectra(clip):
    """(K, C, F, T) STFTs and two soft oracle masks of the clip (see
    tests/test_torch_port_tango.py on binary step-2 masks)."""
    Y, S, N = (np.array(jdsp.stft(a)) for a in clip)
    mz = np.array(jtango.oracle_masks(S, N, "irm1"))
    mw = np.array(jtango.oracle_masks(S, N, "irm2"))
    return Y, S, N, mz, mw


# ------------------------------------------------------------------ STFT
@pytest.mark.parametrize("length", [300, 9000])
def test_stft_bf16_matches_jax(rng, length):
    x = rng.standard_normal((3, length)).astype(np.float32)
    spec, mag = tstft.stft_with_mag(torch.from_numpy(x), precision="bf16")
    j_spec, j_mag = jstft.stft_pallas(x, interpret=True, precision="bf16", with_mag=True)
    j_mm = jstft.stft_matmul(x, precision="bf16")
    assert spec.shape == j_spec.shape == (3, 257, 1 + length // 256)
    assert max_rel(spec, j_spec) <= TOL_STFT, max_rel(spec, j_spec)
    assert max_rel(mag, j_mag) <= TOL_STFT, max_rel(mag, j_mag)
    assert max_rel(spec, j_mm) <= TOL_STFT, max_rel(spec, j_mm)
    # the lane is a lane: bf16 rounding shows against the f32 STFT
    assert 1e-5 < max_rel(spec, tstft.stft_matmul(torch.from_numpy(x))) <= TOL_STFT


def _reflect(L: int, s: np.ndarray) -> np.ndarray:
    s = np.where(s < 0, -s, s)
    return np.where(s >= L, 2 * (L - 1) - s, s)


def _core(m, k):
    """The bf16 index of element (m, k) of the kernel's core-matrix tiles
    (32 samples a row: 512 bytes between row groups of 8, 128 between
    sample groups of 8)."""
    return ((m >> 3) * 512 + (k >> 3) * 128 + (m & 7) * 16 + (k & 7) * 2) // 2


def _model_build(x: np.ndarray, win: np.ndarray, f0: int, p: int):
    """``csrc/stft_bf16.cu``'s raw rows and ``convert(p)`` for each warpgroup
    of the tile at frame ``f0``: four (LO, HI) pairs of flat (2048,) float64 core-matrix
    tiles of bf16 values.  Chunk row l is HI of frame l - 1 (chunk t of its
    row) and LO of frame l (chunk t - 1: the same samples in one row, else
    the reflected head of frame l's row)."""
    B, L = x.shape
    T = 1 + L // 256
    n = 32 * p + np.arange(32)

    def chunk(b, j):
        return x[b][_reflect(L, 256 * j + n)]

    def window(v, w0):
        prod = (v * win[w0 + n]).astype(np.float32)
        return bf16_round(torch.from_numpy(prod)).numpy()
    k = np.arange(32)
    out = []
    for wg in range(4):
        info = [(B, 0) if f < 0 else divmod(f, T) for f in range(f0 + 64 * wg - 1, f0 + 64 * wg + 64)]
        lo, hi = np.zeros(2048), np.zeros(2048)
        for l in range(65):
            b, t = info[1] if l == 0 else info[l]
            xs = chunk(b, t - 1 if l == 0 else t) if b < B else np.zeros(32)
            if l > 0 and info[l][0] < B:
                hi[_core(l - 1, k)] = window(xs, 256)
            if l < 64:
                b1, t1 = info[l + 1]
                if b1 < B:
                    lo[_core(l, k)] = window(chunk(b1, -1) if (l > 0 and t1 == 0) else xs, 0)
        out.append((lo, hi))
    return out


def _model_stft_bf16(x: np.ndarray) -> np.ndarray:
    """A numpy model of ``csrc/stft_bf16.cu`` on (B, L) rows: the tiles of
    256 frames numbered across rows, each of the 4 slabs of 8 bin groups
    (bins 0 .. 255; bin 256 is summed on the CUDA cores), each warpgroup's
    64 frames in the eight phases' core-matrix tiles as its raw rows and
    ``convert`` fill them, the ``wgmma`` operands read from those tiles and
    from the ring's chunks (:func:`dft_fragments`) by the kernel's
    descriptors (512 bytes between row groups, 128 between sample groups,
    the k-step 256 bytes on), and the accumulators through the epilogue's staging to the
    spectrum.  Returns the (B, 257, T) spectrum."""
    frag = tstft.dft_fragments(512).to(torch.float64).numpy().reshape(4, 16, -1)  # (s, c, 4096)
    nyq = tstft.nyquist_table(512).numpy().astype(np.float64)         # (2, 512)
    win = tstft.hann_periodic(512).numpy()
    B, L = x.shape
    T = 1 + L // 256
    n_frames = B * T
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    r = np.arange(64)[:, None]
    kk = np.arange(16)[None, :]
    q32 = np.arange(32)
    out = np.zeros((B, 257, T), np.complex128)
    for f0 in range(0, n_frames, 256):
        bufs = [_model_build(x, win, f0, p) for p in range(8)]   # [p][wg] -> (lo, hi)
        f = f0 + np.arange(256)
        keep = f < n_frames
        b, t = np.divmod(f[keep], T)
        # bin 256 on the CUDA cores: LO and HI rows of each phase against its table
        rows = np.zeros((256, 512))
        for p in range(8):
            for wg in range(4):
                for h in range(2):
                    rows[64 * wg:64 * wg + 64, 256 * h + 32 * p + q32] = \
                        bufs[p][wg][h][_core(r, q32[None, :])]
        out[b, 256, t] = (rows @ (nyq[0] + 1j * nyq[1]))[keep]
        for slab in range(4):
            stage = np.zeros((64, 256), np.complex128)
            for wg in range(4):
                acc = np.zeros((64, 128))                # the warpgroup's D: frames x columns
                for c in range(16):
                    tile = bufs[c >> 1][wg][c & 1]       # phase c // 2: LO, then HI
                    for ks in range(2):
                        A = tile[_core(r, 16 * ks + kk)]                       # (64, 16)
                        Bm = frag[slab, c][_core(np.arange(128)[:, None], 16 * ks + kk)]
                        acc += A @ Bm.T
                # the epilogue: acc[4 j + h] of lane (g, q) of warp ww is D at frame
                # 16 ww + g + 8 (h >> 1), column 8 j + 2 q + (h & 1); staged as bin
                # 8 gg + 2 q + (h & 1) with re = column group 2 gg, im = 2 gg + 1
                for ww in range(4):
                    for gg in range(8):
                        for h in range(4):
                            fr = 16 * ww + g + 8 * (h >> 1)
                            col = 2 * q + (h & 1)
                            re = acc[fr, 8 * (2 * gg) + col]
                            im = acc[fr, 8 * (2 * gg + 1) + col]
                            stage[8 * gg + col, 64 * wg + fr] = re + 1j * im
            for k in range(64):
                out[b, 64 * slab + k, t] = stage[k, keep]
    return out


@pytest.mark.parametrize("shape", [(1, 5000), (3, 23000)])
def test_stft_bf16_kernel_layout_model_reproduces_the_plain_version(rng, shape):
    """The kernel's tiles, phase builds, core-matrix operands, descriptors,
    ring chunks and epilogue indexing, modelled in float64 on its own table, meets the
    plain version within float32 roundoff: a misplaced lane, register,
    tile, chunk, bin or frame would be off by O(1).  One ragged tile (20 frames), and two tiles of 3
    rows of 90 frames (the first across all three rows, the second ragged)."""
    x = rng.standard_normal(shape).astype(np.float32)
    want = tstft.stft_matmul(torch.from_numpy(x), precision="bf16")
    assert max_rel(_model_stft_bf16(x), want) <= 1e-5


def test_stft_bf16_tables():
    """The chunk table holds the bf16-rounded DFT tables of bins 0 .. 255 as
    core matrices: column group 2j the cos, 2j + 1 the sin of bin group
    8 s + j, each chunk the samples its phase and buffer consume; the
    bin-256 table holds the last
    column, with period 2 in the sample (the kernel sums bin 256 from each
    frame's even and odd sums)."""
    frag = tstft.dft_fragments(512)
    assert frag.dtype == torch.bfloat16 and tuple(frag.shape) == (4, 16, 16, 4, 8, 8)
    np.testing.assert_array_equal(tstft.chunk_starts(512),
                                  [0, 256, 32, 288, 64, 320, 96, 352, 128, 384, 160, 416, 192,
                                   448, 224, 480])
    dre, dim = (bf16_round(torch.from_numpy(d)) for d in tstft.dft_matrices(512))
    f = frag.to(torch.float32)
    # slab s, chunk c, column group j, sample group kg, row r, sample kk: sample
    # chunk_starts[c] + 8 kg + kk of bin 8 (8 s + j // 2) + r
    for s, c, j, kg, r, kk in [(0, 0, 0, 0, 0, 0), (1, 2, 5, 3, 3, 7),
                               (3, 15, 15, 3, 7, 2), (2, 9, 0, 1, 4, 1)]:
        n = tstft.chunk_starts(512)[c] + 8 * kg + kk
        k = 8 * (8 * s + j // 2) + r
        want = (dre if j % 2 == 0 else dim)[n, k]
        assert f[s, c, j, kg, r, kk] == want
    nyq = tstft.nyquist_table(512)
    assert nyq.dtype == torch.float32 and torch.equal(nyq, torch.stack([dre[:, 256], dim[:, 256]]))
    # the kernel's premise for bin 256: its angle is -pi n, so the table has period 2
    assert torch.equal(nyq[:, 2:], nyq[:, :-2])


# ----------------------------------------------------------- covariances
@pytest.mark.parametrize("per_channel", [False, True])
def test_masked_cov_bf16_matches_jax(rng, per_channel):
    y = complex_normal(rng, (2, 3, 257, 45))
    m = rng.random((2,) + ((3,) if per_channel else ()) + (257, 45)).astype(np.float32)
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    ours = tcov.masked_covariances_fused(yt, mt, precision="bf16")
    ref = jcov.masked_cov_pallas(y, m, interpret=True, precision="bf16")
    folded = jcov.masked_covariances_folded(y, m, precision="bf16")
    mm = m if per_channel else np.broadcast_to(m[:, None], y.shape)
    for i, (o, r, fo) in enumerate(zip(ours, ref, folded)):
        assert o.dtype == torch.complex64 and o.shape == (2, 257, 3, 3)
        assert max_rel(o, r) <= TOL_COV, max_rel(o, r)
        assert max_rel(o, fo) <= TOL_COV, max_rel(o, fo)
        w = mm.astype(np.float64) if i == 0 else 1.0 - mm.astype(np.float64)
        for b in range(2):
            oracle = covariances_np(w[b] * y[b].astype(np.complex128))
            assert max_rel(o[b], oracle) <= TOL_COV
    # the plain version of the kernel's bf16 instance sums in the kernel's
    # order the float32 fold of the rounded spectra, its weights float32
    yr = torch.complex(bf16_round(yt.real), bf16_round(yt.imag))
    for o, r in zip(ours, tcov.masked_covariances_folded(yr, mt)):
        assert max_rel(o, r) <= 1e-5
        assert torch.equal(o, o.mH)


def test_masked_cov_bf16_plain_version_sums_in_the_kernels_slices():
    """The bf16 plain version's frame slices are ``csrc/cov.cu``'s."""
    import re
    from pathlib import Path

    src = (Path(tcov.__file__).resolve().parent.parent / "csrc" / "cov.cu").read_text()
    assert int(re.search(r"constexpr int kSlices = (\d+);", src).group(1)) == tcov.KERNEL_SLICES


@pytest.mark.parametrize("per_channel", [False, True])
def test_weighted_cov_folded_bf16_matches_jax(rng, per_channel):
    y = complex_normal(rng, (3, 257, 33))
    m = rng.random(((3,) if per_channel else ()) + (257, 33)).astype(np.float32)
    ours = tcov.weighted_cov_folded(torch.from_numpy(y), torch.from_numpy(m), "bf16")
    ref = jcov.weighted_cov_folded(y, m, "bf16")
    assert max_rel(ours, ref) <= TOL_COV, max_rel(ours, ref)
    mm = m if per_channel else np.broadcast_to(m, y.shape)
    assert max_rel(ours, covariances_np(mm.astype(np.float64) * y)) <= TOL_COV
    # its operands rounded, the weights included: not the f32 fold
    f32 = tcov.weighted_cov_folded(torch.from_numpy(y), torch.from_numpy(m))
    assert max_rel(ours, f32) > 1e-5


def test_outer_acc_bf16_matches_jax(rng):
    x = complex_normal(rng, (3, 257, 4))
    w = (0.99 ** np.arange(2, -1, -1)).astype(np.float32)
    ours = tcov.outer_acc_bf16(torch.from_numpy(w), torch.from_numpy(x))
    ref = jcov.outer_acc_bf16(w, x)
    assert ours.shape == (257, 4, 4)
    assert max_rel(ours, ref) <= TOL_COV, max_rel(ours, ref)
    exact = np.einsum("t,tfc,tfd->fcd", w.astype(np.float64), x, np.conj(x))
    assert max_rel(ours, exact) <= TOL_COV


# ----------------------------------------------------------------- solve
@pytest.mark.parametrize("C_", [2, 3, 4])
def test_fused_solve_bf16_matches_oracle_and_jax(rng, C_):
    Rss, Rnn = pencils(rng, C_, F=24)
    R64 = (Rss.astype(np.complex64), Rnn.astype(np.complex64))
    W, t1 = tmwf.rank1_gevd_fused(*(torch.from_numpy(a) for a in R64), precision="bf16")
    oracle = np.stack([intern_filter_np(Rss[f], Rnn[f], mu=1.0, ftype="gevd", rank=1)[0]
                       for f in range(24)])
    assert rel_l2(W, oracle) <= TOL_SOLVE, rel_l2(W, oracle)
    j_W, j_t1 = jmwf.fused_mwf_xla(*R64, precision="bf16")
    assert rel_l2(W, j_W) <= TOL_SOLVE and rel_l2(t1, j_t1) <= TOL_SOLVE


def test_fused_solve_bf16_is_the_f32_chain_on_rounded_pencils(rng):
    """The lane's one rounding step is at load: on the rounded pencils the
    f32 chain gives the same bits."""
    Rss, Rnn = (torch.from_numpy(a.astype(np.complex64)) for a in pencils(rng, 3, F=40))
    rounded = [torch.complex(bf16_round(a.real), bf16_round(a.imag)) for a in (Rss, Rnn)]
    got = tmwf.fused_mwf_kernel(Rss, Rnn, mu=1.3, precision="bf16")
    want = tmwf.fused_mwf_plain(*rounded, mu=1.3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], tmwf.fused_mwf_plain(Rss, Rnn, mu=1.3)[0])


# ---------------------------------------------------------- TANGO, clip
def _sdr(s_ref, spec, length):
    """SI-SDR in dB of the ISTFT of ``spec`` (F, T) against ``s_ref``."""
    est = to_np(t_istft(torch.as_tensor(to_np(spec)), length=length)).astype(np.float64)
    return si_sdr_np(s_ref.astype(np.float64), est)


@pytest.fixture(scope="module")
def oracles(clip):
    """The float64 two-step oracle (``tango_np``, oracle irm1 masks in both
    steps) under the policies it takes."""
    y, s, n = (a.astype(np.float64) for a in clip)
    return {p: tango_np(y, s, n, mask_for_z=p) for p in ("local", None)}


@pytest.mark.parametrize("policy", ["local", None, "distant"])
@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_tango_bf16_matches_jax(clip, spectra, oracles, policy, solver):
    """The bf16 covariance lane (``solver='eigh'``, as the JAX package gates
    it): the step-1 streams within 1e-2 rel-l2 of the JAX lane and of the
    float64 oracle, yf within the f32 lane's 1e-1 of the oracle.  With
    ``solver='fused'`` the pencils are rounded too, and the streams are held
    to the bf16 solve's 2e-2 (the JAX lane itself is ~1.9e-2 from the oracle
    on zn there).  SI-SDR within 0.1 dB of the f32 lane and of the JAX lane,
    at every node."""
    _, s, _ = clip
    Y, S, N, mz, _ = spectra
    ours = ttango.tango(Y, S, N, mz, mz, policy=policy, solver=solver, precision="bf16",
                        device="cpu")
    ref = jtango.tango(Y, S, N, mz, mz, policy=policy, solver=solver, precision="bf16")
    f32 = ttango.tango(Y, S, N, mz, mz, policy=policy, solver=solver, device="cpu")
    tol = TOL_STREAM if solver == "eigh" else TOL_SOLVE
    for key in ("z_y", "zn"):
        assert rel_l2(getattr(ours, key), getattr(ref, key)) <= tol, key
        if solver == "eigh":
            assert rel_l2(getattr(ours, key), oracles["local"][key]) <= tol, key
    if policy in oracles:
        assert rel_l2(ours.yf, oracles[policy]["yf"]) <= 1e-1
    for k in range(K):
        sdr_bf16 = _sdr(s[k, 0], ours.yf[k], L)
        assert abs(sdr_bf16 - _sdr(s[k, 0], f32.yf[k], L)) <= TOL_SDR_DB, k
        assert abs(sdr_bf16 - _sdr(s[k, 0], ref.yf[k], L)) <= TOL_SDR_DB, k


def test_tango_clip_fused_bf16_matches_jax(clip):
    """The whole clip in the bf16 lane (the STFT, both covariances and,
    under the default ``solver='fused'``, the solve): within the bf16
    solve's 2e-2 rel-l2 of the JAX lane, SI-SDR within 0.1 dB of the f32
    lane and of the JAX lane."""
    y, s, n = clip
    ours = tfused.tango_clip_fused(y, s, n, precision="bf16", device="cpu")
    ref = jfused.tango_clip_fused(y, s, n, precision="bf16")
    f32 = tfused.tango_clip_fused(y, s, n, device="cpu")
    assert ours.shape == (K, L) and torch.isfinite(ours).all()
    assert rel_l2(ours, ref) <= TOL_SOLVE, rel_l2(ours, ref)
    for k in range(K):
        sdr = si_sdr_np(s[k, 0], to_np(ours[k]))
        assert abs(sdr - si_sdr_np(s[k, 0], to_np(f32[k]))) <= TOL_SDR_DB
        assert abs(sdr - si_sdr_np(s[k, 0], np.asarray(ref[k]))) <= TOL_SDR_DB


# -------------------------------------------------------------- streaming
QUIET, U = 1e-3, 4


def test_streaming_bf16_scan_is_the_per_block_loop_bit_for_bit(spectra):
    Y, _, _, m, _ = (a[..., :32] for a in spectra)
    state = tstream.initial_stream_state(K, C, 257)
    ref, ref_state = per_block_reference(Y, m, block=8, update_every=U, state=state,
                                         precision="bf16", device="cpu")
    st, parts = state, []
    for w in range(2):
        sl = slice(16 * w, 16 * (w + 1))
        o = tstream.streaming_tango_scan(Y[..., sl], m[..., sl], m[..., sl], state=st,
                                         z_avail=np.ones((K, 4)), blocks_per_dispatch=2,
                                         precision="bf16", device="cpu")
        st = o["state"]
        parts.append(o["yf"])
    assert torch.equal(torch.cat(parts, dim=-1), ref)
    for a, b in zip(tstream.state_leaves(st), tstream.state_leaves(ref_state)):
        assert torch.equal(a, b)
    f32, _ = per_block_reference(Y, m, block=8, update_every=U, state=state, device="cpu")
    assert not torch.equal(f32, ref)


@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_streaming_tango_bf16_matches_jax(spectra, solver):
    """From the warm start on the quiet scene, step 2's first refresh block
    skipped (tests/test_torch_port_streaming.py says why); the step-1
    streams within 1e-2 rel-l2 of the JAX lane, 2e-2 where the solve is
    bf16 too (as in :func:`test_tango_bf16_matches_jax`)."""
    Y, _, _, mz, mw = (a[..., :32] for a in spectra)
    kw = dict(solver=solver, precision="bf16")
    ours = tstream.streaming_tango(Y * QUIET, mz, mw, device="cpu", **kw)
    ref = jstream.streaming_tango(Y * QUIET, mz, mw, **kw)
    f32 = tstream.streaming_tango(Y * QUIET, mz, mw, solver=solver, device="cpu")
    tol = TOL_STREAM if solver == "eigh" else TOL_SOLVE
    for key in ("z_y", "zn"):
        assert rel_l2(ours[key], ref[key]) <= tol, key
    assert rel_l2(ours["yf"][..., U:], np.asarray(ref["yf"])[..., U:]) <= tol
    assert rel_l2(ours["yf"][..., U:], f32["yf"][..., U:]) <= tol


def test_streaming_clip_fused_bf16_matches_jax():
    Lw = 256 * 15
    y, s, n = (a * QUIET for a in scene(K, C, 2 * Lw, seed=4, noise_scale=0.5))
    st0 = {k: v for k, v in tstream.initial_stream_state(K, C, 257, update_every=U).items()
           if k != "hold"}
    j_state, t_state, j_out, t_out = st0, st0, [], []
    for w in range(2):
        sl = slice(w * Lw, (w + 1) * Lw)
        kw = dict(blocks_per_dispatch=4, solver="jacobi-pallas", precision="bf16")
        ref = jfused.streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=j_state,
                                          **kw)
        ours = tfused.streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=t_state,
                                           device="cpu", **kw)
        j_state, t_state = ref["state"], ours["state"]
        j_out.append(np.asarray(ref["yf"]))
        t_out.append(to_np(ours["yf"]))
    a, b = np.concatenate(t_out, -1), np.concatenate(j_out, -1)
    skip = 2 * U * 256
    assert a.shape == (K, 2 * Lw) and np.isfinite(a).all()
    assert rel_l2(a[:, skip:], b[:, skip:]) <= TOL_STREAM, rel_l2(a[:, skip:], b[:, skip:])


def test_bf16_kernels_count_their_own_launches_only_on_the_card(rng):
    """On CPU tensors the wrappers run their plain versions and count
    nothing, in either lane."""
    before = (tstft.stft_bf16_kernel.launches, tcov.masked_cov_kernel.launches_bf16,
              tmwf.fused_mwf_kernel.launches_bf16)
    tstft.stft_bf16_kernel(torch.zeros(2, 4000))
    tcov.masked_cov_kernel(torch.zeros(2, 257, 5, dtype=torch.complex64),
                           torch.zeros(257, 5), precision="bf16")
    eye = torch.eye(2, dtype=torch.complex64).expand(3, 2, 2)
    tmwf.fused_mwf_kernel(eye, eye, precision="bf16")
    assert (tstft.stft_bf16_kernel.launches, tcov.masked_cov_kernel.launches_bf16,
            tmwf.fused_mwf_kernel.launches_bf16) == before
