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
a numpy model of ``csrc/stft_bf16.cu``'s fragment layout reproduces the
plain STFT, and the solve's bf16 lane is its f32 chain on the rounded
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


def _model_stft_bf16(x: np.ndarray) -> np.ndarray:
    """A numpy model of ``csrc/stft_bf16.cu`` on (B, L) rows: the block's
    windowed bf16 frames, the A tiles as ``ldmatrix.x4`` hands them to the
    ``m16n8k16`` A fragment, the B tiles as the kernel reads them from
    :func:`dft_fragments` into the B fragment, and the accumulators stored by
    the kernel's epilogue.  Returns the (B, 257, T) spectrum."""
    frag = tstft.dft_fragments(512).to(torch.float32).numpy()       # (66, 32, 32, 4)
    win = tstft.hann_periodic(512).numpy()
    B, L = x.shape
    T = 1 + L // 256
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    # ldmatrix: lane l addresses row (l & 7) + 8 ((l >> 3) & 1), column 8 (l >> 4)
    # of the tile; register j of lane l holds two values of the row that lane
    # 8 j + l // 4 addressed, at columns 2 (l % 4) + (0, 1)
    src = 8 * np.arange(4)[None, :] + (lane // 4)[:, None]           # (lane, j)
    a_row = ((src & 7) + 8 * ((src >> 3) & 1))[..., None] + 0 * np.arange(2)
    a_col = (8 * (src >> 4))[..., None] + 2 * q[:, None, None] + np.arange(2)
    # the mma A fragment: register j of lane (g, q) is A[g + 8 (j & 1)][2q + 8 (j >> 1) + e]
    f_row = g[:, None, None] + 8 * (np.arange(4) & 1)[None, :, None] + 0 * np.arange(2)
    f_col = 2 * q[:, None, None] + 8 * (np.arange(4) >> 1)[None, :, None] + np.arange(2)
    out = np.zeros((B, 257, T), np.complex128)
    for b in range(B):
        for t0 in range(0, T, 64):
            n = np.arange(512)
            s = (t0 + np.arange(64))[:, None] * 256 + n[None, :] - 256
            s = np.where(s < 0, -s, s)
            s = np.where(s >= L, 2 * (L - 1) - s, s)
            ok = (s >= 0) & (s < L)
            frames = np.where(ok, x[b][np.clip(s, 0, L - 1)] * win, 0.0).astype(np.float32)
            frames = bf16_round(torch.from_numpy(frames)).numpy().astype(np.float64)
            for p in range(33):
                acc = np.zeros((4, 2, 16, 8))
                for i in range(4):
                    for st in range(32):
                        tile = frames[16 * i:16 * i + 16, 16 * st:16 * st + 16]
                        A = np.zeros((16, 16))
                        A[f_row, f_col] = tile[a_row, a_col]
                        for c in range(2):
                            Bt = np.zeros((16, 8))
                            v = frag[2 * p + c, st]                    # (lane, 4)
                            Bt[2 * q + 0, g], Bt[2 * q + 1, g] = v[:, 0], v[:, 1]
                            Bt[2 * q + 8, g], Bt[2 * q + 9, g] = v[:, 2], v[:, 3]
                            acc[i, c] += A @ Bt
                # the epilogue: accumulator h of lane (g, q) at frame 16 i + g + 8 (h >> 1),
                # bin 8 p + 2 q + (h & 1), read from the C fragment
                for i in range(4):
                    for h in range(4):
                        row, col = g + 8 * (h >> 1), 2 * q + (h & 1)
                        k, t = 8 * p + col, t0 + 16 * i + row
                        keep = (k < 257) & (t < T)
                        out[b, k[keep], t[keep]] = (acc[i, 0][row, col]
                                                    + 1j * acc[i, 1][row, col])[keep]
    return out


def test_stft_bf16_kernel_layout_model_reproduces_the_plain_version(rng):
    """The kernel's fragment and ldmatrix indexing, modelled in float64 on
    its own table, meets the plain version within float32 roundoff: a
    misplaced lane, register, tile or bin would be off by O(1)."""
    x = rng.standard_normal((1, 5000)).astype(np.float32)     # 20 frames, ragged tile
    want = tstft.stft_matmul(torch.from_numpy(x), precision="bf16")
    assert max_rel(_model_stft_bf16(x), want) <= 1e-5


def test_stft_bf16_tables():
    """The fragment table holds the bf16-rounded DFT tables: tile 2p the
    cos, 2p + 1 the sin of bins 8p .. 8p + 7, the padded bins zero."""
    frag = tstft.dft_fragments(512)
    assert frag.dtype == torch.bfloat16 and tuple(frag.shape) == (66, 32, 32, 4)
    dre, dim = (bf16_round(torch.from_numpy(d)) for d in tstft.dft_matrices(512))
    f = frag.to(torch.float32)
    # lane 4 g + q, value 0: sample 16 s + 2 q of bin 8 p + g
    for p, g, q, s in [(0, 0, 0, 0), (3, 5, 2, 7), (31, 7, 3, 31), (32, 0, 1, 9)]:
        k, n = 8 * p + g, 16 * s + 2 * q
        assert f[2 * p, s, 4 * g + q, 0] == dre[n, k]
        assert f[2 * p + 1, s, 4 * g + q, 3] == dim[n + 9, k]
    assert not f[64:, :, 4:].any()        # bins 257..263


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
