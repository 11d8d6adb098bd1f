"""The port's scoring (``disco_tpu_torch.core.metrics``, ``core.bss``,
``core.sigproc``, ``core.miscx`` and the driver's ``_node_metrics_pair``)
against the JAX package's on the same seeded numpy inputs.

These are copies of the same float64 numpy code, so they are held equal
(``assert_array_equal``); ``si_sdr_torch`` against ``si_sdr_jax`` within
1e-4 dB (float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco_tpu.core import bss as jbss
from disco_tpu.core import metrics as jm
from disco_tpu.core import miscx as jmisc
from disco_tpu.core import sigproc as jsig
from disco_tpu.enhance import driver as jdriver
from disco_tpu_torch.core import bss as tbss
from disco_tpu_torch.core import metrics as tm
from disco_tpu_torch.core import miscx as tmisc
from disco_tpu_torch.core import sigproc as tsig
from disco_tpu_torch.enhance import driver as tdriver

FS = 16000


def _signals(seed, L=3 * FS):
    """A target through a short filter, noise, their mixture and an
    enhanced estimate, float64."""
    rng = np.random.default_rng(seed)
    s_dry = rng.standard_normal(L)
    n_dry = rng.standard_normal(L)
    s = np.convolve(s_dry, rng.standard_normal(8) * 0.5, mode="same")
    n = 0.5 * rng.standard_normal(L)
    est = s + 0.1 * rng.standard_normal(L)
    return s_dry, n_dry, s, n, s + n, est


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["snr", "sd", "delta_snr", "fw_snr", "fw_sd", "si_sdr", "si_bss",
                                  "seg_snr", "seg_snr_vad", "stoi", "stoi_extended", "ci_wp"])
def test_metric_equals_jax(name, seed):
    s_dry, n_dry, s, n, y, est = _signals(seed)
    calls = {
        "snr": lambda m: m.snr(s, n),
        "sd": lambda m: m.sd(est, s),
        "delta_snr": lambda m: m.delta_snr(est, n * 0.3, s, n),
        "fw_snr": lambda m: m.fw_snr(s, n, FS),
        "fw_sd": lambda m: m.fw_sd(est, s, FS),
        "si_sdr": lambda m: m.si_sdr(np.stack([s, n]), np.stack([est, y])),
        "si_bss": lambda m: m.si_bss(est, np.stack((s_dry, n_dry), axis=1), 0),
        "seg_snr": lambda m: m.seg_snr(s, n, 512, 256),
        "seg_snr_vad": lambda m: m.seg_snr(s, n[:-100], 512, 256, vad=np.abs(s) > 0.3),
        "stoi": lambda m: m.stoi(s, est, FS),
        "stoi_extended": lambda m: m.stoi(s, y, FS, extended=True),
        "ci_wp": lambda m: m.ci_wp(np.stack([s[:100], n[:100]])),
    }
    ours, ref = calls[name](tm), calls[name](jm)
    for a, b in zip(ours if isinstance(ours, tuple) else (ours,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _equal(a, b)


@pytest.mark.parametrize("n_src,perm", [(2, False), (2, True), (3, True)])
def test_bss_eval_sources_equals_jax(n_src, perm):
    rng = np.random.default_rng(n_src)
    refs = rng.standard_normal((n_src, 6000))
    mix = rng.standard_normal((n_src, n_src)) * 0.3 + np.eye(n_src)
    ests = (mix @ refs)[::-1] + 0.05 * rng.standard_normal((n_src, 6000))
    ours = tbss.bss_eval_sources(refs, ests, compute_permutation=perm, filt_len=64)
    ref = jbss.bss_eval_sources(refs, ests, compute_permutation=perm, filt_len=64)
    for a, b in zip(ours, ref):
        _equal(a, b)


@pytest.mark.parametrize("j", [0, 1])
def test_bss_eval_one_and_bss_eval_equal_jax(j):
    s_dry, n_dry, s, n, y, est = _signals(2, L=FS)
    refs = np.stack((s_dry, n_dry))
    _equal(tbss.bss_eval_one(refs, est, j, filt_len=512), jbss.bss_eval_one(refs, est, j, 512))
    ours, ref = tbss.BssEval(refs, 512), jbss.BssEval(refs, 512)
    for x in (est, y, s):
        _equal(ours.score(x, j), ref.score(x, j))


@pytest.mark.parametrize("degraded", [False, True])
def test_node_metrics_pair_equals_jax(degraded):
    """The driver's per-node scoring: both outputs, every key; a NaN
    output (degraded mode) scores as NaN in both."""
    s_dry, n_dry, s, n, y, est = _signals(3, L=2 * FS)
    mid = est + 0.05 * np.sin(np.arange(len(est)))
    if degraded:
        mid[FS + 10] = np.nan
    sl = slice(FS, len(y))
    args = (y, s, n, est, mid, s_dry, n_dry, s * 0.9, n * 0.2, s * 0.8, n * 0.4, FS, sl)
    ours = tdriver._node_metrics_pair(*args, tbss.BssEval(np.stack((s_dry[sl], n_dry[sl])), 512))
    ref = jdriver._node_metrics_pair(*args, jbss.BssEval(np.stack((s_dry[sl], n_dry[sl])), 512))
    for o, r in zip(ours, ref):
        assert set(o) == set(r) == set(jdriver._NODE_METRIC_KEYS)
        for k in r:
            _equal(o[k], r[k])
    assert tdriver._NODE_METRIC_KEYS == jdriver._NODE_METRIC_KEYS


@pytest.mark.parametrize("shape", [(4000,), (3, 4000), (2, 5, 700)])
def test_si_sdr_torch_matches_si_sdr_jax(shape):
    rng = np.random.default_rng(len(shape))
    ref = rng.standard_normal(shape).astype(np.float32)
    est = (ref + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    ours = tm.si_sdr_torch(torch.from_numpy(ref), torch.from_numpy(est)).numpy()
    theirs = np.asarray(jm.si_sdr_jax(jnp.asarray(ref), jnp.asarray(est)))
    assert ours.shape == theirs.shape == shape[:-1]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours, tm.si_sdr(ref, est), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["band_importance", "band_importance_narrow", "third_octave_band",
                                  "third_octave_filterbank", "sliding_window", "frame_vad",
                                  "increase_to_snr", "increase_to_snr_weighted",
                                  "noise_from_signal"])
def test_sigproc_equals_jax(name):
    rng_data = np.random.default_rng(5)
    x = rng_data.standard_normal(3000)
    n = 0.3 * rng_data.standard_normal(3000)
    calls = {
        "band_importance": lambda m: m.band_importance(16000),
        "band_importance_narrow": lambda m: m.band_importance(8000),
        "third_octave_band": lambda m: m.third_octave_band(1000, n_band=18),
        "third_octave_filterbank": lambda m: m.third_octave_filterbank([250, 1000, 4000], FS),
        "sliding_window": lambda m: m.sliding_window(x, 256, 128),
        "frame_vad": lambda m: m.frame_vad(np.abs(x) > 0.5, 256, 128),
        "increase_to_snr": lambda m: m.increase_to_snr(x, n, 5.0),
        "increase_to_snr_weighted": lambda m: m.increase_to_snr(x, n, 5.0, weight=True, fs=FS),
        "noise_from_signal": lambda m: m.noise_from_signal(x, rng=np.random.default_rng(9)),
    }
    ours, ref = calls[name](tsig), calls[name](jsig)
    for a, b in zip(ours if isinstance(ours, tuple) else (ours,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _equal(a, b)


def test_concatenate_dicts_equals_jax():
    rng = np.random.default_rng(6)
    dicts = [{"a": rng.standard_normal(4), "b": rng.standard_normal((2, 3 + i))}
             for i in range(3)]
    ours, ref = tmisc.concatenate_dicts(dicts), jmisc.concatenate_dicts(dicts)
    assert set(ours) == set(ref)
    for k in ref:
        _equal(ours[k], ref[k])
