"""The port's CRNN inference path against the JAX package's, on the same
numpy inputs and the same weights (drawn for a JAX ``init`` and carried
across by ``disco_tpu_torch.nn.convert``): the host helpers and
normalizations of ``enhance.inference``, the oracle VAD, the batched mask
routes, the step-1 z export, the driver's mask stage and, as a whole,
STFT → CRNN masks → ``tango(solver='fused')``.

Tolerances: masks 2e-5 absolute on the same inputs (the CRNN's,
tests/test_torch_port_crnn.py); normalized features 1e-6 of their scale; z
streams and the enhanced spectra 1e-4 of the output scale
(tests/test_torch_port_tango.py); in the bf16 lane SI-SDR within 0.1 dB
of the JAX package's bf16 lane, and its streams within the lane's
1e-2 / 2e-2 rel-l2 (tests/test_torch_port_bf16.py).
A step-2 CRNN reads the step-1 z streams, which the two packages compute
within 1e-4 of their scale (4e-5 to 7e-5 with the 'power' solver here,
held at 1e-4 wherever a step-2 CRNN runs), and carries that difference
into its masks: so step-2 masks computed from each package's own z are
held at 1e-4, and the port's step-2 CRNN fed the JAX package's z at 2e-5.
"""
import importlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu.core import masks as jmasks
from disco_tpu.enhance import driver as jdriver
from disco_tpu.enhance import inference as jinf
from disco_tpu.enhance import zexport as jzexport
from disco_tpu.nn import crnn as jcrnn
from disco_tpu.ops import stft_ops as jstft
from disco_tpu_torch.core import masks as tmasks
from disco_tpu_torch.core.dsp import istft
from disco_tpu_torch.core.mathx import quantile_linear
from disco_tpu_torch.enhance import driver as tdriver
from disco_tpu_torch.enhance import inference as tinf
from disco_tpu_torch.enhance import tango as ttango
from disco_tpu_torch.enhance import zexport as tzexport
from disco_tpu_torch.nn import crnn as tcrnn
from disco_tpu_torch.nn.convert import state_dict_from_flax
from disco_tpu_torch.ops import stft_ops as tstft
from tests.test_torch_port_crnn import randomized
from tests.reference_impls import si_sdr_np
from tests.torch_port_helpers import max_rel, rel_l2, scene, to_np

jtango = importlib.import_module("disco_tpu.enhance.tango")

TOL_MASK, TOL_NORM, TOL, TOL_SDR_DB = 2e-5, 1e-6, 1e-4, 0.1
TOL_BF16_STREAM, TOL_BF16_OUT = 1e-2, 2e-2
K, C, L = 3, 2, 10000
NARROW = dict(cnn_filters=(4, 8), pool_kernels=((1, 4), (1, 4)), conv_padding=((0, 1), (0, 1)),
              rnn_units=(16,), ff_units=(257,))
TIME_PADDED = dict(cnn_filters=(3,), conv_padding=1, pool_kernels=((2, 4),),
                   pool_strides=((1, 4),), rnn_units=(8,), ff_units=(257,))


def models_for(n_ch, seed, cfg=NARROW, arch="crnn"):
    """(JAX module, its variables, the port's module with them) at 257
    bins, window 21."""
    if arch == "crnn":
        jm = jcrnn.CRNN(input_shape=(n_ch, 21, 257), **cfg)
        tm = tcrnn.CRNN(input_shape=(n_ch, 21, 257), **cfg)
        x0 = np.zeros((1, n_ch, 21, 257), np.float32)
    else:
        jm, _ = jcrnn.build_rnn(n_ch=n_ch, rnn_units=(8,))
        tm = tcrnn.build_rnn(n_ch=n_ch, rnn_units=(8,))
        x0 = np.zeros((1, 21, n_ch * 257), np.float32)
    variables = randomized(jm.init(jax.random.PRNGKey(0), x0), seed)
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def clip():
    return scene(K, C, L, seed=1, noise_scale=0.5)


@pytest.fixture(scope="module")
def spectra(clip):
    return tuple(np.array(jdsp.stft(a)) for a in clip)  # (K, C, 257, 40) each


@pytest.fixture(scope="module")
def step_models():
    """Step-1 (one channel) and step-2 CRNNs for each ``z_sigs``."""
    return {"z": models_for(1, 21), "zs_hat": models_for(K, 22), "zn_hat": models_for(K, 23),
            "zs_zn": models_for(1 + 2 * (K - 1), 24)}


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("args", [(21, "last", 15), (21, "last", None), (21, "mid", 15),
                                  (20, "mid", None), (21, "all", 15), (7, "last", 5)])
def test_get_frames_to_pad_matches_jax(args):
    assert tinf.get_frames_to_pad(*args) == jinf.get_frames_to_pad(*args)
    assert tinf.get_frames_to_pad(21, "last", 15) == (17, 3)
    with pytest.raises(ValueError):
        tinf.get_frames_to_pad(21, "first")


@pytest.mark.parametrize("norm", [None, "scale_to_unit_norm", "scale_to_1", "center_and_scale",
                                  "pcen"])
def test_normalization_matches_jax(spectra, norm):
    Y = spectra[0][1, 0]
    ref, ours = jinf.normalization(Y, norm, axis=1), tinf.normalization(Y, norm, axis=1)
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
    ref_p = jinf.pcen(np.abs(Y), time_constant=0.2)
    np.testing.assert_allclose(tinf.pcen(np.abs(Y), time_constant=0.2), ref_p, rtol=1e-12)


@pytest.mark.parametrize("norm", [None, "scale_to_unit_norm", "scale_to_1", "center_and_scale"])
def test_normalization_device_matches_jax(spectra, norm):
    x = spectra[0][:, :1]  # (K, 1, F, T) complex
    ref = np.asarray(jinf.normalization_device(x, norm))
    ours = tinf.normalization_device(torch.from_numpy(x), norm)
    assert ours.dtype == torch.float32
    assert max_rel(ours, ref) <= TOL_NORM


def test_normalization_device_q99_with_ties_and_nan():
    """Streams whose q99 falls among tied values, a constant stream and a
    stream holding a NaN (NaN from the q99 on, as ``jnp.quantile``)."""
    rng = np.random.default_rng(2)
    x = np.round(np.abs(rng.standard_normal((4, 5, 101))) * 4).astype(np.float32) / 4 + 0.25
    x[1] = 2.0
    x[2, 3, 17] = np.nan
    ref = np.asarray(jinf.normalization_device(x, "scale_to_1"))
    ours = to_np(tinf.normalization_device(torch.from_numpy(x), "scale_to_1"))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(ours[ok], ref[ok], rtol=1e-6)
    with pytest.raises(ValueError, match="pcen"):
        tinf.normalization_device(torch.from_numpy(x), "pcen")


@pytest.mark.parametrize("shape,dim", [((7, 626), -1), ((626,), 0), ((3, 40, 5), 1),
                                       ((26_900, 626), -1)])
def test_quantile_linear_matches_jnp_quantile(shape, dim):
    """Including one input above 2^24 elements, which ``torch.quantile``
    refuses."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.numpy.quantile(x, 0.99, axis=dim, keepdims=True))
    ours = to_np(quantile_linear(torch.from_numpy(x), 0.99, dim=dim, keepdim=True))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert quantile_linear(torch.from_numpy(x), 0.5, dim=dim).shape == np.median(x, dim).shape


@pytest.mark.parametrize("three_d", [True, False])
@pytest.mark.parametrize("norm", [None, "scale_to_1"])
@pytest.mark.parametrize("with_z", [False, True])
def test_prepare_data_matches_jax(spectra, three_d, norm, with_z):
    Y = spectra[0][0, 0]
    z = [spectra[0][1, 0], spectra[0][2, 1]] if with_z else None
    kw = dict(z_data=z, win_len=21, win_hop=2, frame_to_pred="last", norm_type=norm, frames_lost=6)
    ref = jinf.prepare_data(Y, three_d, **kw)
    ours = tinf.prepare_data(Y, three_d, **kw)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_reshape_mask_and_get_z_for_mask_match_jax():
    stack = np.random.default_rng(4).random((40, 15, 257)).astype(np.float32)
    for frame in ("last", "mid"):
        np.testing.assert_array_equal(tinf.reshape_mask(stack, frame), jinf.reshape_mask(stack, frame))
    with pytest.raises(NotImplementedError):
        tinf.reshape_mask(stack, "all")
    zs, zn = (np.random.default_rng(s).standard_normal((4, 5, 6)) for s in (5, 6))
    for k in range(4):
        for kind in ("zs_hat", "zn_hat", "zs_zn"):
            np.testing.assert_array_equal(tinf.get_z_for_mask(zs, zn, k, 4, kind),
                                          jinf.get_z_for_mask(zs, zn, k, 4, kind))


# ------------------------------------------------------------- VAD masks
@pytest.mark.parametrize("length", [10000, 4000, 300, 256, 200])
def test_vad_matches_jax(clip, length):
    """Including signals shorter than one window: 300 samples still make
    one (partial) window; 256 and fewer make none and give the zero VAD."""
    x = clip[1][0, 0, :length] * np.where(np.arange(length) < length // 2, 1.0, 1e-3)
    x = x.astype(np.float32)
    ref = np.asarray(jmasks.vad_oracle_batch(x))
    ours = tmasks.vad_oracle_batch(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(to_np(ours), ref)
    if length <= 256:
        assert not ref.any()
    n_frames = 1 + length // 256
    np.testing.assert_array_equal(to_np(tinf.vad_mask(x, 257, n_frames)),
                                  jinf.vad_mask(x, 257, n_frames))
    np.testing.assert_array_equal(to_np(tmasks.vad_to_mask(ours, 9, n_frames + 3)),
                                  np.asarray(jmasks.vad_to_mask(ref, 9, n_frames + 3)))


# ----------------------------------------------------------- mask routes
def test_crnn_mask_matches_jax(spectra):
    jm, v, tm = models_for(3, 31)
    Y = spectra[0]
    z = [Y[1, 0], Y[2, 0]]
    ref = jinf.crnn_mask(Y[0, 0], jm, v, z=z, norm_type="scale_to_1")
    ours = tinf.crnn_mask(Y[0, 0], tm, z=z, norm_type="scale_to_1", device="cpu")
    assert ours.shape == ref.shape == (257, 40)
    np.testing.assert_allclose(ours, ref, atol=TOL_MASK)


@pytest.mark.parametrize("route", ["stream", "window", "rnn", "pcen"])
@pytest.mark.parametrize("B", [3, 10])
def test_crnn_masks_batched_matches_jax(spectra, route, B):
    """The stream route (canonical structure), the per-window route (time
    padding and pooling), the 2-D RNN, and the host PCEN route; B = 3 and
    B = 10 (one group of 3; a group of 8 and one filled by repeating the
    last stream)."""
    rng = np.random.default_rng(B)
    Ys = spectra[0].reshape(-1, 257, 40)[rng.integers(0, K * C, B)]
    zs = spectra[2].reshape(-1, 257, 40)[rng.integers(0, K * C, (B, 2))]
    cfg = TIME_PADDED if route == "window" else NARROW
    jm, v, tm = models_for(3, 40 + B, cfg, arch="rnn" if route == "rnn" else "crnn")
    assert tinf._conv_stream_safe(tm) == (route not in ("window", "rnn"))
    norm = "pcen" if route == "pcen" else "center_and_scale"
    ref = np.asarray(jinf.crnn_masks_batched(Ys, jm, v, zs=zs, norm_type=norm))
    ours = tinf.crnn_masks_batched(Ys, tm, zs=zs, norm_type=norm, device="cpu")
    assert ours.shape == ref.shape == (B, 257, 40) and ours.dtype == torch.float32
    np.testing.assert_allclose(to_np(ours), ref, atol=TOL_MASK)


def test_stream_route_equals_the_per_window_route(spectra, step_models):
    """The hoisted convs give what every window through the whole model
    gives, for the canonical structure (forced onto the per-window route)."""
    _, _, tm = step_models["zs_hat"]
    Ys = spectra[0][:, 0]
    zs = tdriver._z_for_mask_device(torch.from_numpy(spectra[0][:, 1]),
                                    torch.from_numpy(spectra[1][:, 1]), K, "zs_hat")
    stream = tinf.crnn_masks_batched(Ys, tm, zs=zs, device="cpu")
    with mock.patch.object(tinf, "_conv_stream_safe", lambda model: False):
        window = tinf.crnn_masks_batched(Ys, tm, zs=zs, device="cpu")
    assert float((stream - window).abs().max()) <= 1e-5


def test_mask_entry_points_check_the_model_device(spectra):
    _, _, tm = models_for(1, 50)
    Ys = spectra[0][:, 0]
    with pytest.raises(ValueError, match="lies on meta"):
        tinf.crnn_masks_batched(Ys, tm.to("meta"), device="cpu")
    with pytest.raises(NotImplementedError):
        tinf.crnn_masks_batched(Ys, tm, frame_to_pred="all", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinf.crnn_masks_batched(Ys, tm)


# --------------------------------------------------- z export, mask stage
@pytest.mark.parametrize("solver", ["power", "fused"])
def test_compute_z_signals_matches_jax(clip, solver):
    y, s, n = clip
    ref = jzexport.compute_z_signals(y, s, n, mask_type="irm2", solver=solver)
    ours = tzexport.compute_z_signals(y, s, n, mask_type="irm2", solver=solver, device="cpu")
    for key in ("z_y", "z_s", "z_n", "zn", "z_t1_s", "z_t1_n"):
        assert ours[key].shape == (K, 257, 40)
        assert max_rel(ours[key], ref[key]) <= TOL, key
    # oracle masks of each package's own STFT of the signals
    np.testing.assert_allclose(to_np(ours["masks_z"]), np.asarray(ref["masks_z"]), atol=TOL_MASK)


def test_compute_z_signals_with_explicit_masks_matches_jax(spectra):
    Y, S, N = spectra
    m = np.random.default_rng(7).random((K, 257, 40)).astype(np.float32)
    ref = jzexport.compute_z_signals(None, None, None, masks_z=m, Y=Y)
    ours = tzexport.compute_z_signals(None, None, None, masks_z=m, Y=Y, device="cpu")
    for key in ("z_y", "zn"):
        assert max_rel(ours[key], ref[key]) <= TOL, key
    assert not ours["z_s"].abs().any()
    with pytest.raises(ValueError, match="masks_z"):
        tzexport.compute_z_signals(None, None, None, Y=Y, device="cpu")


def _pair_models(step_models, z_sigs):
    j1, v1, t1 = step_models["z"]
    j2, v2, t2 = step_models[z_sigs]
    return [(j1, v1), (j2, v2)], [t1, t2]


def check_masks(ours, ref, Y, jmodels, tmodel, z_sigs="zs_hat"):
    """Step-1 masks within 2e-5; where step 2 is a CRNN, the z streams each
    package computes from its own step-1 masks within 1e-4 of their scale
    (the z export's tolerance), step-2 masks within 1e-4 (each package's
    own z), and the port's step-2 CRNN fed the JAX package's z streams
    within 2e-5 of the JAX step-2 masks."""
    np.testing.assert_allclose(to_np(ours[0]), np.asarray(ref[0]), atol=TOL_MASK)
    np.testing.assert_allclose(to_np(ours[1]), np.asarray(ref[1]), atol=TOL)
    if jmodels[1] is None:
        return
    j_out = jzexport.compute_z_signals(None, None, None, Y=Y, masks_z=np.asarray(ref[0]))
    t_out = tzexport.compute_z_signals(None, None, None, Y=np.asarray(Y), masks_z=ours[0],
                                       device="cpu")
    for key in ("z_y", "zn"):
        assert max_rel(t_out[key], j_out[key]) <= TOL, key
    zs = jdriver._z_for_mask_device(j_out["z_y"], j_out["zn"], K, z_sigs)
    same_z = tinf.crnn_masks_batched(np.asarray(Y)[:, 0], tmodel, zs=np.asarray(zs), device="cpu")
    np.testing.assert_allclose(to_np(same_z), np.asarray(ref[1]), atol=TOL_MASK)


@pytest.mark.parametrize("z_sigs", ["zs_hat", "zn_hat", "zs_zn"])
def test_estimate_masks_matches_jax(spectra, step_models, z_sigs):
    Y, S, N = spectra
    jmodels, tmodels = _pair_models(step_models, z_sigs)
    ref = jdriver.estimate_masks(Y, S, N, jmodels, "irm1", K, z_sigs=z_sigs)
    ours = tdriver.estimate_masks(Y, S, N, tmodels, "irm1", K, z_sigs=z_sigs, device="cpu")
    assert ours[0].shape == ours[1].shape == (K, 257, 40)
    check_masks(ours, ref, Y, jmodels, tmodels[1], z_sigs)


@pytest.mark.parametrize("which", [(True, False), (False, True), (False, False)])
def test_estimate_masks_oracle_halves_match_jax(spectra, step_models, which):
    """Either step oracle (the irm shortcut through the STFT's magnitudes
    when both are), the other a CRNN."""
    Y, S, N = spectra
    jmodels, tmodels = _pair_models(step_models, "zs_hat")
    jm = [m if use else None for m, use in zip(jmodels, which)]
    tm = [m if use else None for m, use in zip(tmodels, which)]
    mags = (np.abs(S), np.abs(N)) if not any(which) else None
    ref = jdriver.estimate_masks(Y, S, N, jm, "irm2", K, mags=mags)
    ours = tdriver.estimate_masks(Y, S, N, tm, "irm2", K, mags=mags, device="cpu")
    check_masks(ours, ref, Y, jm, tm[1])


@pytest.mark.parametrize("z_sigs", ["zs_hat", "zs_zn"])
def test_batched_masks_match_jax_and_the_per_clip_masks(clip, step_models, z_sigs):
    """Two distinct clips (the second the first circularly shifted), B K =
    6 streams a CRNN step."""
    y, s, n = clip
    specs = [np.stack([np.array(jdsp.stft(np.roll(a, sh, -1))) for sh in (0, 1237)])
             for a in (y, s, n)]
    jmodels, tmodels = _pair_models(step_models, z_sigs)
    ref = jdriver._batched_masks(*specs, jmodels, "irm1", 1.0, K, z_sigs)
    ours = tdriver._batched_masks(*specs, tmodels, "irm1", 1.0, K, z_sigs, device="cpu")
    for a, b, tol in zip(ours, ref, (TOL_MASK, TOL)):
        assert a.shape == (2, K, 257, 40)
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=tol)
    for b in range(2):
        one = tdriver.estimate_masks(*(sp[b] for sp in specs), tmodels, "irm1", K, z_sigs=z_sigs,
                                     device="cpu")
        for a, c in zip(ours, one):
            assert float((a[b] - c).abs().max()) <= 1e-5


# ----------------------------------------------------------- the slice
def test_crnn_masked_tango_matches_jax(clip, step_models):
    """The slice as a whole: ``stft_with_mag`` of the [y, s, n] stack →
    CRNN masks (step 1 from the reference mic, step 2 with the exchanged
    z_y) → ``tango(solver='fused')``."""
    y, s, n = clip
    jmodels, tmodels = _pair_models(step_models, "zs_hat")
    x = np.stack([y, s, n])
    j_spec, j_mag = jstft.stft_with_mag(x)
    t_spec, t_mag = tstft.stft_with_mag(torch.from_numpy(x))
    jm_z, jm_w = jdriver.estimate_masks(j_spec[0], j_spec[1], j_spec[2], jmodels, "irm1", K,
                                        mags=(j_mag[1], j_mag[2]))
    tm_z, tm_w = tdriver.estimate_masks(t_spec[0], t_spec[1], t_spec[2], tmodels, "irm1", K,
                                        mags=(t_mag[1], t_mag[2]), device="cpu")
    check_masks((tm_z, tm_w), (jm_z, jm_w), j_spec[0], jmodels, tmodels[1])
    assert 0.02 < float(tm_w.mean()) < 0.98  # soft masks: a well-posed step 2
    ref = jtango.tango(j_spec[0], j_spec[1], j_spec[2], jm_z, jm_w, solver="fused")
    ours = ttango.tango(t_spec[0], t_spec[1], t_spec[2], tm_z, tm_w, solver="fused", device="cpu")
    for f in ("yf", "z_y", "zn"):
        assert max_rel(getattr(ours, f), getattr(ref, f)) <= TOL, f


def test_crnn_masked_tango_bf16_lane_matches_jax(clip, step_models):
    """The same in the bf16 lane, both packages fed the port's bf16
    spectra (the two bf16 STFTs round apart, tests/test_torch_port_bf16.py):
    the masks as above (they run in float32), and SI-SDR at every node
    within 0.1 dB of the JAX package's bf16 lane, the lane's gate.  The
    masks of untrained CRNNs are uninformative (mean ~0.50, std ~0.17), so
    the pencils are near-degenerate and the fused solve's rounding of them
    to bf16 moves each package's spectra ~0.1 rel-l2 from its own f32 lane,
    and from the other package's bf16 lane: element-wise, the lane is held
    where the pencils stay float32, its STFT and covariances
    (``solver='eigh'``), with the step-1 streams within the lane's 1e-2
    rel-l2 and yf within its 2e-2 (tests/test_torch_port_bf16.py)."""
    y, s, n = clip
    jmodels, tmodels = _pair_models(step_models, "zs_hat")
    spec, mag = tstft.stft_with_mag(torch.from_numpy(np.stack([y, s, n])), precision="bf16")
    spec_np, mag_np = to_np(spec), to_np(mag)
    jm_z, jm_w = jdriver.estimate_masks(*spec_np, jmodels, "irm1", K, mags=tuple(mag_np[1:]))
    tm_z, tm_w = tdriver.estimate_masks(*spec, tmodels, "irm1", K, mags=tuple(mag[1:]),
                                        device="cpu")
    check_masks((tm_z, tm_w), (jm_z, jm_w), spec_np[0], jmodels, tmodels[1])
    ref = jtango.tango(*spec_np, jm_z, jm_w, solver="fused", precision="bf16")
    ours = ttango.tango(*spec, tm_z, tm_w, solver="fused", precision="bf16", device="cpu")
    assert torch.isfinite(ours.yf).all()
    for k in range(K):
        sdr = si_sdr_np(s[k, 0], to_np(istft(ours.yf[k], L)))
        ref_sdr = si_sdr_np(s[k, 0], to_np(istft(torch.from_numpy(np.asarray(ref.yf[k])), L)))
        assert abs(sdr - ref_sdr) <= TOL_SDR_DB, (k, sdr, ref_sdr)
    ref = jtango.tango(*spec_np, jm_z, jm_w, solver="eigh", precision="bf16")
    ours = ttango.tango(*spec, tm_z, tm_w, solver="eigh", precision="bf16", device="cpu")
    for f, tol in (("z_y", TOL_BF16_STREAM), ("zn", TOL_BF16_STREAM), ("yf", TOL_BF16_OUT)):
        assert rel_l2(getattr(ours, f), getattr(ref, f)) <= tol, f
