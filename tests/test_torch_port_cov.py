"""The port's masked covariances (``disco_tpu_torch.ops.cov_ops``,
``beam.covariance``) against the JAX package.

Tolerances: float32 sums over T frames in another order than the
interpret-mode Pallas kernel, so 1e-5 of the output scale (max-rel)
against it and against the JAX folded einsums; 1e-4 against the float64
``covariances_np`` oracle, whose inputs are the float32 spectra.
"""
import numpy as np
import pytest
import torch

from disco_tpu.beam import covariance as jcov
from disco_tpu.ops import cov_ops as jops
from disco_tpu_torch.beam import covariance as tcov
from disco_tpu_torch.ops import cov_ops as tops
from tests.reference_impls import covariances_np
from tests.torch_port_helpers import complex_normal, max_rel, to_np

TOL, TOL_ORACLE = 1e-5, 1e-4


def _inputs(rng, lead, C, T, per_channel):
    y = complex_normal(rng, lead + (C, 257, T))
    m = rng.random(lead + ((C,) if per_channel else ()) + (257, T)).astype(np.float32)
    return y, m


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("T", [37, 53])
def test_masked_cov_pair_matches_pallas_interpret(rng, per_channel, T):
    """Shared and per-channel masks, a ragged frame count (no multiple of
    the Pallas kernel's frame tile), two leading batch axes."""
    y, m = _inputs(rng, (2, 2), 3, T, per_channel)
    Rss, Rnn = tops.masked_covariances_fused(torch.from_numpy(y), torch.from_numpy(m))
    j_ss, j_nn = jops.masked_cov_pallas(y, m, interpret=True)
    assert Rss.shape == Rnn.shape == (2, 2, 257, 3, 3) and Rss.dtype == torch.complex64
    assert max_rel(Rss, j_ss) <= TOL, max_rel(Rss, j_ss)
    assert max_rel(Rnn, j_nn) <= TOL, max_rel(Rnn, j_nn)

    mm = m if per_channel else np.broadcast_to(m[..., None, :, :], y.shape)
    for b in np.ndindex(2, 2):
        ys = y[b].astype(np.complex128)
        w = mm[b].astype(np.float64)
        assert max_rel(Rss[b], covariances_np(w * ys)) <= TOL_ORACLE
        assert max_rel(Rnn[b], covariances_np((1.0 - w) * ys)) <= TOL_ORACLE


@pytest.mark.parametrize("per_channel", [False, True])
def test_folded_covariances_match_jax(rng, per_channel):
    y, m = _inputs(rng, (3,), 4, 41, per_channel)
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    assert max_rel(tops.weighted_cov_folded(yt, mt), jops.weighted_cov_folded(y, m)) <= TOL
    for ours, ref in zip(tops.masked_covariances_folded(yt, mt),
                         jops.masked_covariances_folded(y, m)):
        assert max_rel(ours, ref) <= TOL


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_cov_impl_seam_on_cpu_is_the_plain_version(rng, impl):
    y, m = _inputs(rng, (2,), 3, 30, False)
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    before = tops.masked_cov_kernel.launches
    ours = tops.masked_covariances_fused(yt, mt, impl=impl)
    plain = tops.masked_covariances_folded(yt, mt)
    for a, b in zip(ours, plain):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert tops.masked_cov_kernel.launches == before


def test_cov_seam_validates(rng):
    y, m = _inputs(rng, (), 2, 10, False)
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.masked_covariances_fused(yt, mt, impl="triton")
    with pytest.raises(ValueError, match="unknown precision"):
        tops.masked_covariances_fused(yt, mt, precision="fp8")


def test_frame_mean_and_materialized_covariances_match_jax(rng):
    a = complex_normal(rng, (2, 3, 257, 29))
    b = complex_normal(rng, (2, 3, 257, 29))
    m = rng.random((2, 257, 29)).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert max_rel(tcov.frame_mean_covariance(at), jcov.frame_mean_covariance(a)) <= TOL
    assert max_rel(tcov.frame_mean_covariance(at, bt), jcov.frame_mean_covariance(a, b)) <= TOL
    ours = tcov.masked_covariances(at, torch.from_numpy(m))
    ref = jax_masked = jcov.masked_covariances(a, m)
    for o, r in zip(ours, jax_masked):
        assert max_rel(o, r) <= TOL
    # the materializing form and the folded one are the same function
    for o, r in zip(tops.masked_covariances_folded(at, torch.from_numpy(m)), ref):
        assert max_rel(o, r) <= TOL
