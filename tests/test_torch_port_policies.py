"""The port's remaining mask-for-z policies ('compressed', 'use_oracle_refs',
'use_oracle_zs') and the z-exchange fault seam (``z_mask``, ``z_nan``,
``z_avail``) against the JAX package's ``tango`` / ``tango_step2`` on the
same numpy inputs, the all-links-down case against the local MWF, and
the port's ``tango`` against the float64 oracle ``tango_np`` by SI-SDR.

Tolerances: 1e-4 of the output scale (max |a - b| / max |b|), the f32
tolerance of tests/test_torch_port_tango.py (two float32 pipelines in
different summation orders); SI-SDR within 0.1 dB of the float64 oracle
(the 0.1 dB SDR bound of ``doc/source/performance.rst``).
"""
import importlib

import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu_torch.beam.filters import rank1_gevd
from disco_tpu_torch.core import dsp as tdsp
from disco_tpu_torch.enhance import tango as ttango
from disco_tpu_torch.ops.cov_ops import masked_covariances_plain
from tests.reference_impls import istft_np, si_sdr_np, tango_np
from tests.torch_port_helpers import max_rel, rel_l2, scene, to_np

jtango = importlib.import_module("disco_tpu.enhance.tango")

TOL, TOL_SDR_DB = 1e-4, 0.1
K, C, L = 3, 2, 10000
FIELDS = ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn")
NEW_POLICIES = ("compressed", "use_oracle_refs", "use_oracle_zs")


@pytest.fixture(scope="module")
def clip():
    return scene(K, C, L, seed=1, noise_scale=0.5)


@pytest.fixture(scope="module")
def spectra(clip):
    """(K, C, F, T) STFTs and two soft oracle masks (a binary step-2 mask
    leaves the step-2 noise covariances rank-deficient)."""
    Y, S, N = (np.array(jdsp.stft(a)) for a in clip)
    mz = np.array(jtango.oracle_masks(S, N, "irm1"))
    mw = np.array(jtango.oracle_masks(S, N, "irm2"))
    return Y, S, N, mz, mw


def _close(ours, ref, fields=FIELDS):
    for f in fields:
        a, b = to_np(getattr(ours, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert max_rel(a, b) <= TOL, (f, max_rel(a, b))


@pytest.mark.parametrize("policy", NEW_POLICIES)
@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_new_policies_match_jax(spectra, policy, solver):
    Y, S, N, mz, mw = spectra
    ours = ttango.tango(Y, S, N, mz, mw, policy=policy, solver=solver, device="cpu")
    ref = jtango.tango(Y, S, N, mz, mw, policy=policy, solver=solver)
    _close(ours, ref)


@pytest.mark.parametrize("policy", NEW_POLICIES + ("local", "none", "distant"))
def test_single_node_step2_with_availability_matches_jax(spectra, policy):
    """The per-node form at an integer node index with a (K,) availability
    of the exchanged streams, against ``tango_step2`` of the JAX package."""
    Y, S, N, mz, mw = spectra
    res = jtango.tango(Y, S, N, mz, mw, solver="eigh")
    z = {f: np.asarray(getattr(res, f)) for f in ("z_y", "z_s", "z_n", "zn")}
    z_avail = np.array([1.0, 1.0, 0.0], np.float32)
    ref = jtango.tango_step2(Y[1], S[1], N[1], mw[1], 1, z, mw, S[:, 0], N[:, 0],
                             policy=policy, solver="eigh", z_avail=z_avail)
    Yt, St, Nt, mwt = (torch.from_numpy(a) for a in (Y, S, N, mw))
    zt = {f: torch.from_numpy(v) for f, v in z.items()}
    ours = ttango.tango_step2(Yt[1], St[1], Nt[1], mwt[1], 1, zt, mwt, St[:, 0], Nt[:, 0],
                              policy=policy, solver="eigh", z_avail=z_avail)
    for a, b in zip(ours, ref):
        assert max_rel(a, b) <= TOL, policy


def _link_down(K_):
    zm = np.ones((K_, K_), np.float32)
    zm[0, 1] = 0.0      # only node 0's inbound link from node 1
    zm[2, 0] = 0.0      # and node 2's from node 0
    return zm


FAULTS = {
    "source down": dict(z_mask=np.array([1.0, 0.0, 1.0], np.float32)),
    "links down (K, K)": dict(z_mask=_link_down(K)),
    "NaN node": dict(z_nan=np.array([0, 1, 0])),
    "NaN node and links down": dict(z_nan=np.array([0, 0, 1]), z_mask=_link_down(K)),
    "all links down": dict(z_mask=np.zeros(K, np.float32)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_fault_seam_matches_jax(spectra, fault, solver):
    """Each fault against the JAX package under the 'local' policy: the
    filtered outputs of every node finite and within the f32 tolerance; the
    exchanged streams NaN exactly where a node was corrupted."""
    Y, S, N, mz, mw = spectra
    kw = dict(policy="local", solver=solver, **FAULTS[fault])
    ours = ttango.tango(Y, S, N, mz, mw, device="cpu", **kw)
    ref = jtango.tango(Y, S, N, mz, mw, **kw)
    for f in ("yf", "sf", "nf"):
        assert torch.isfinite(getattr(ours, f)).all(), f
    _close(ours, ref, ("yf", "sf", "nf"))
    for f in ("z_y", "z_s", "z_n", "zn"):
        a, b = to_np(getattr(ours, f)), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        assert max_rel(a[ok], b[ok]) <= TOL, f


@pytest.mark.parametrize("policy", ("none", "distant") + NEW_POLICIES)
def test_fault_seam_other_policies_match_jax(spectra, policy):
    """A corrupted node and two dead links under every other policy: the
    NaN streams are zeroed before any covariance sees them."""
    Y, S, N, mz, mw = spectra
    kw = dict(policy=policy, solver="eigh", **FAULTS["NaN node and links down"])
    ours = ttango.tango(Y, S, N, mz, mw, device="cpu", **kw)
    ref = jtango.tango(Y, S, N, mz, mw, **kw)
    assert torch.isfinite(ours.yf).all()
    _close(ours, ref, ("yf", "sf", "nf"))


def test_fault_seam_bf16_matches_jax(spectra):
    """The fault seam in the bf16 lane (the fused solve's pencils rounded
    too): finite outputs at every node, within the bf16 solve's documented
    2e-2 rel-l2 of the JAX package's lane."""
    Y, S, N, mz, mw = spectra
    kw = dict(policy="local", solver="fused", precision="bf16",
              **FAULTS["NaN node and links down"])
    ours = ttango.tango(Y, S, N, mz, mw, device="cpu", **kw)
    ref = jtango.tango(Y, S, N, mz, mw, **kw)
    assert torch.isfinite(ours.yf).all()
    for f in ("yf", "sf", "nf"):
        assert rel_l2(getattr(ours, f), getattr(ref, f)) <= 2e-2, f


def test_nan_node_is_the_masked_node(spectra):
    """A node corrupted to NaN is excluded exactly as a node masked out:
    the other nodes' outputs agree (tests/test_fault.py:206-220)."""
    Y, S, N, mz, mw = spectra
    nan = ttango.tango(Y, S, N, mz, mw, solver="eigh", z_nan=np.array([0, 1, 0]),
                       device="cpu")
    masked = ttango.tango(Y, S, N, mz, mw, solver="eigh", z_mask=np.array([1.0, 0.0, 1.0]),
                          device="cpu")
    for k in (0, 2):
        assert max_rel(nan.yf[k], masked.yf[k]) <= TOL


@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_all_links_down_is_the_local_mwf(spectra, solver):
    """With no stream delivered, each node's step 2 is the rank-1 MWF of its
    own mics alone (under the 'local' policy: its step-2 mask on them)."""
    Y, S, N, mz, mw = spectra
    res = ttango.tango(Y, S, N, mz, mw, solver=solver, z_mask=np.zeros(K, np.float32),
                       device="cpu")
    Yt, mwt = torch.from_numpy(Y), torch.from_numpy(mw)
    Rss, Rnn = masked_covariances_plain(Yt, mwt)
    w, _ = rank1_gevd(Rss, Rnn, solver=solver)
    local = torch.einsum("kfc,kcft->kft", w.conj(), Yt)
    assert torch.isfinite(res.yf).all()
    assert max_rel(res.yf, local) <= TOL, max_rel(res.yf, local)


@pytest.mark.parametrize("policy", ["local", None])
@pytest.mark.parametrize("solver", ["eigh", "fused"])
def test_tango_sdr_matches_the_float64_oracle(clip, policy, solver):
    """The port's ``tango`` on its own STFTs and oracle irm1 masks (both
    steps) against ``tango_np``: SI-SDR of every node's enhanced signal
    within 0.1 dB."""
    y, s, n = clip
    Y, S, N = (tdsp.stft(torch.from_numpy(a)) for a in (y, s, n))
    masks = ttango.oracle_masks(S, N, "irm1")
    res = ttango.tango(Y, S, N, masks, masks, policy=policy, solver=solver, device="cpu")
    want = tango_np(*(a.astype(np.float64) for a in (y, s, n)), mask_for_z=policy)
    for k in range(K):
        ours = si_sdr_np(s[k, 0], to_np(tdsp.istft(res.yf[k], length=L)))
        oracle = si_sdr_np(s[k, 0], istft_np(want["yf"][k], L))
        assert abs(ours - oracle) <= TOL_SDR_DB, (k, ours, oracle)
