"""The port's small helpers (``core.dsp.bucket_length``, ``core.mathx``,
``beam.covariance.smoothed_covariance``, the filter helpers of
``beam.filters``, the ``dtype`` of ``enhance.streaming.initial_stream_state``)
and the mask-driven separation of ``enhance.separation`` against the JAX
package on the same numpy inputs, the filters also against the float64
oracle ``intern_filter_np``.

Tolerances: exact where the arithmetic is one rounding (integers, the
state); 1e-6 relative for float32 element-wise math; 1e-5 rel-l2 for the
filters against JAX (float32 eigensolves and solves in other orders) and
1e-3 against the float64 oracle; the separated sources 1e-4 of the output
scale, as two-step TANGO (tests/test_torch_port_tango.py).
"""
import numpy as np
import pytest
import torch

from disco_tpu.beam import covariance as jcov
from disco_tpu.beam import filters as jfilt
from disco_tpu.core import dsp as jdsp
from disco_tpu.core import masks as jmasks
from disco_tpu.core import mathx as jmathx
from disco_tpu.enhance import separation as jsep
from disco_tpu.enhance import streaming as jstream
from disco_tpu_torch.beam import covariance as tcov
from disco_tpu_torch.beam import filters as tfilt
from disco_tpu_torch.core import dsp as tdsp
from disco_tpu_torch.core import mathx as tmathx
from disco_tpu_torch.enhance import separation as tsep
from disco_tpu_torch.enhance import streaming as tstream
from tests.reference_impls import intern_filter_np
from tests.torch_port_helpers import complex_normal, max_rel, pencils, rel_l2, scene, to_np

TOL_EW, TOL_FILT, TOL_ORACLE, TOL = 1e-6, 1e-5, 1e-3, 1e-4


@pytest.mark.parametrize("length,bucket", [(1, 8192), (8192, 8192), (8193, 8192), (160000, 8192),
                                           (1000, 256)])
def test_bucket_length_matches_jax(length, bucket):
    assert tdsp.bucket_length(length, bucket) == jdsp.bucket_length(length, bucket)


def test_scalar_math_matches_jax():
    for num, div in ((17, 5), (20, 5), (7.5, 2)):
        assert tmathx.floor_to_multiple(num, div) == jmathx.floor_to_multiple(num, div)
    for x in (1, 3, 1000, 1025):
        assert tmathx.next_pow_2(x) == jmathx.next_pow_2(x)


def test_array_math_matches_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((2, 3, 50)).astype(np.float32)
    x[0, :3] = (-2.5, 0.5, 1.5)  # halves round to even in both
    pairs = [
        (tmathx.round_to_base(torch.from_numpy(x), 0.5), jmathx.round_to_base(x, 0.5)),
        (tmathx.lin2db(torch.from_numpy(np.abs(x))), jmathx.lin2db(np.abs(x))),
        (tmathx.db2lin(torch.from_numpy(x), 2), jmathx.db2lin(x, 2)),
        (tmathx.my_mse(torch.from_numpy(x), torch.from_numpy(y)), jmathx.my_mse(x, y)),
        *zip(tmathx.cart2pol(torch.from_numpy(x), torch.from_numpy(y)), jmathx.cart2pol(x, y)),
        *zip(tmathx.pol2cart(torch.from_numpy(x), torch.from_numpy(y)), jmathx.pol2cart(x, y)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=TOL_EW, atol=1e-7)
    # both denormal: the angle falls back to 0 in both packages
    tiny = np.full(3, 1e-45, np.float32)
    np.testing.assert_array_equal(to_np(tmathx.cart2pol(torch.from_numpy(tiny),
                                                        torch.from_numpy(tiny))[1]),
                                  np.asarray(jmathx.cart2pol(tiny, tiny)[1]))


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    chunks = [rng.standard_normal((4, n)).astype(np.float32) for n in (7, 1, 30)]
    ours, ref = tmathx.WelfordsOnlineAlgorithm(4), jmathx.WelfordsOnlineAlgorithm(4)
    for c in chunks:
        ours.update_stats(c)
        ref.update_stats(c)
    assert ours.count == ref.count == 38
    for a in ("mean", "std", "m2"):
        np.testing.assert_allclose(to_np(getattr(ours, a)), np.asarray(getattr(ref, a)),
                                   rtol=1e-5, atol=1e-6)
    allx = np.concatenate(chunks, axis=1).astype(np.float64)
    np.testing.assert_allclose(to_np(ours.std), allx.std(axis=1), rtol=1e-5)
    with pytest.raises(ValueError, match="features"):
        ours.quick_update(np.zeros((3, 2), np.float32))
    st = tmathx.welford_update(tmathx.welford_init(4), torch.from_numpy(chunks[0]))
    jst = jmathx.welford_update(jmathx.welford_init(4), chunks[0])
    np.testing.assert_allclose(to_np(st.std), np.asarray(jst.std), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_smoothed_covariance_matches_jax(masked):
    rng = np.random.default_rng(2)
    R = np.einsum("fcd->fcd", complex_normal(rng, (5, 3, 3)))
    x = complex_normal(rng, (5, 3))
    m = rng.random(5).astype(np.float32) if masked else None
    ref = np.asarray(jcov.smoothed_covariance(R, x, 0.9, mask=m))
    ours = tcov.smoothed_covariance(torch.from_numpy(R), torch.from_numpy(x), 0.9,
                                    mask=None if m is None else torch.from_numpy(m))
    assert max_rel(ours, ref) <= TOL_EW


@pytest.mark.parametrize("name", ["gevd", "rank2-gevd", "rank12-gevd", "gevd-power", "r1-mwf",
                                  "mwf"])
def test_get_filter_type_matches_jax(name):
    assert tfilt.get_filter_type(name) == jfilt.get_filter_type(name)


def test_get_filter_type_rejects_malformed():
    with pytest.raises(ValueError, match="malformed"):
        tfilt.get_filter_type("rankx-gevd")


@pytest.mark.parametrize("spec", ["eigh", "power", "power:6", "jacobi", "jacobi-pallas:4", "fused",
                                  "fused-xla", "fused-pallas:5"])
def test_solver_lane_info(spec):
    """Spec, base and N as the JAX package parses them; the port's ``impl``
    on the CPU: the plain versions for the kernel specs, torch.linalg for
    'eigh'/'power'."""
    ours, ref = tfilt.solver_lane_info(spec, device="cpu"), jfilt.solver_lane_info(spec)
    assert {k: ours[k] for k in ("spec", "base", "n")} == {k: ref[k] for k in ("spec", "base", "n")}
    assert ours["impl"] == ("torch" if spec.split(":")[0] in ("eigh", "power") else "plain")


@pytest.mark.parametrize("ftype,rank", [("r1-mwf", "full"), ("mwf", "full"), ("gevd", "full"),
                                        ("gevd", 2), ("gevd-power", 1)])
def test_intern_filter_matches_jax_and_the_oracle(ftype, rank):
    rng = np.random.default_rng(4)
    Rss, Rnn = pencils(rng, 4, F=12)
    W, t1 = tfilt.intern_filter(torch.from_numpy(Rss.astype(np.complex64)),
                                torch.from_numpy(Rnn.astype(np.complex64)), mu=1.5, ftype=ftype,
                                rank=rank)
    jW, jt1 = jfilt.intern_filter(Rss.astype(np.complex64), Rnn.astype(np.complex64), mu=1.5,
                                  ftype=ftype, rank=rank)
    assert rel_l2(W, jW) <= TOL_FILT and rel_l2(t1, jt1) <= TOL_FILT
    if ftype in ("r1-mwf", "mwf"):
        ref = np.stack([intern_filter_np(Rss[f], Rnn[f], mu=1.5, ftype=ftype)[0] for f in range(12)])
        assert rel_l2(W, ref) <= TOL_ORACLE
        np.testing.assert_array_equal(to_np(t1), np.asarray(jt1))


def test_intern_filter_rejects_what_jax_rejects():
    R = torch.eye(2, dtype=torch.complex64)[None]
    with pytest.raises(ValueError, match="rank-1 only"):
        tfilt.intern_filter(R, R, ftype="gevd-power", rank=2)
    with pytest.raises(AttributeError):
        tfilt.intern_filter(R, R, ftype="wiener")


@pytest.mark.parametrize("dtype", [None, np.complex64, np.complex128])
def test_initial_stream_state_dtype_matches_jax(dtype):
    ours = tstream.initial_stream_state(2, 3, 9, update_every=4, dtype=dtype)
    ref = jstream.initial_stream_state(2, 3, 9, update_every=4, dtype=dtype)
    for a, b in zip(tstream.state_leaves(ours), tstream.state_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- separation
K, C, L = 3, 2, 8000


@pytest.fixture(scope="module")
def two_sources():
    """(Y, S_imgs): two broadband sources at every node, plus noise."""
    y1, s1, n = scene(K, C, L, seed=5, noise_scale=0.3)
    _, s2, _ = scene(K, C, L, seed=6, noise_scale=0.3)
    Y = np.array(jdsp.stft(s1 + 0.7 * s2 + n))
    S = np.stack([np.array(jdsp.stft(s1)), np.array(jdsp.stft(0.7 * s2))])
    return Y, S


@pytest.mark.parametrize("policy", ["distant", "local"])
def test_separate_sources_matches_jax(two_sources, policy):
    Y, S = two_sources
    ref = np.asarray(jsep.separate_sources(Y, S, policy=policy))
    ours = tsep.separate_sources(Y, S, policy=policy, device="cpu")
    assert ours.shape == ref.shape == (2, K, 257, Y.shape[-1])
    assert max_rel(ours, ref) <= TOL


@pytest.mark.parametrize("policy", ["distant", "none"])
def test_separate_with_masks_matches_jax(two_sources, policy):
    Y, S = two_sources
    masks = np.asarray(jmasks.tf_mask(S[:, :, 0], Y[None, :, 0] - S[:, :, 0], "irm1"))  # (2, K, F, T)
    ref = np.asarray(jsep.separate_with_masks(Y, masks, policy=policy))
    ours = tsep.separate_with_masks(Y, masks, policy=policy, device="cpu")
    assert ours.shape == ref.shape
    assert max_rel(ours, ref) <= TOL
    with pytest.raises(ValueError, match="supports policies"):
        tsep.separate_with_masks(Y, masks, policy="use_oracle_zs", device="cpu")
