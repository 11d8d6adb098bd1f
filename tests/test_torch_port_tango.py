"""The slice as a whole: the port's two-step TANGO (``enhance.tango``) and
the offline clip (``enhance.fused.tango_clip_fused``) against the JAX
package, on the same numpy inputs.

Tolerance: 1e-4 of the output scale (max |a - b| / max |b|), the
chained-clip tolerance of ``doc/source/performance.rst``: two float32
pipelines of covariances, eigensolves and filter products in different
summation orders.
"""
import importlib

import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu.enhance import fused as jfused
from disco_tpu_torch import device as tdevice
from disco_tpu_torch.enhance import fused as tfused
from disco_tpu_torch.enhance import tango as ttango
from tests.torch_port_helpers import max_rel, scene, to_np

# ``disco_tpu.enhance`` re-exports the function ``tango`` under its module's name
jtango = importlib.import_module("disco_tpu.enhance.tango")

TOL = 1e-4
K, C, L = 3, 2, 10000
FIELDS = ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn")


@pytest.fixture(scope="module")
def clip():
    return scene(K, C, L, seed=1, noise_scale=0.5)


@pytest.fixture(scope="module")
def spectra(clip):
    """Shared (K, C, F, T) STFTs and two different soft oracle masks of
    the clip.  (A binary step-2 mask is 1 on nearly every frame of this
    scene, which leaves the step-2 noise covariances rank-deficient and
    their filters set by roundoff in either framework.)"""
    Y, S, N = (np.array(jdsp.stft(a)) for a in clip)
    mz = np.array(jtango.oracle_masks(S, N, "irm1"))
    mw = np.array(jtango.oracle_masks(S, N, "irm2"))
    return Y, S, N, mz, mw


@pytest.mark.parametrize("policy", ["local", "none", "distant"])
@pytest.mark.parametrize("solver", ["fused", "power", "eigh"])
def test_tango_matches_jax(spectra, solver, policy):
    Y, S, N, mz, mw = spectra
    ref = jtango.tango(Y, S, N, mz, mw, policy=policy, solver=solver)
    ours = ttango.tango(Y, S, N, mz, mw, policy=policy, solver=solver, device="cpu")
    for f in FIELDS:
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.shape == b.shape == (K, 257, Y.shape[-1]), f
        assert max_rel(a, b) <= TOL, (f, max_rel(a, b))
    np.testing.assert_array_equal(to_np(ours.masks_z), mz)
    np.testing.assert_array_equal(to_np(ours.mask_w), mw)


def test_tango_oracle_step1_stats_matches_jax(spectra):
    Y, S, N, mz, mw = spectra
    ref = jtango.tango(Y, S, N, mz, mw, oracle_step1_stats=True, solver="eigh")
    ours = ttango.tango(Y, S, N, mz, mw, oracle_step1_stats=True, solver="eigh", device="cpu")
    for f in FIELDS:
        assert max_rel(getattr(ours, f), getattr(ref, f)) <= TOL, f


def test_single_node_steps_match_jax(spectra):
    """The per-node forms: step 1 on one node's (C, F, T) stack, step 2 at
    an integer node index against the exchanged streams of all nodes."""
    Y, S, N, mz, mw = spectra
    z1 = ttango.tango_step1(*(torch.from_numpy(a[1]) for a in (Y, S, N, mz)), solver="fused")
    j_z1 = jtango.tango_step1(Y[1], S[1], N[1], mz[1], solver="fused")
    for key in ("z_y", "z_s", "z_n", "zn", "z_t1_s", "z_t1_n"):
        assert max_rel(z1[key], j_z1[key]) <= TOL, key
    all_z = ttango.tango(Y, S, N, mz, mw, solver="eigh", device="cpu")
    j_all = jtango.tango(Y, S, N, mz, mw, solver="eigh")
    z = {f: getattr(all_z, f) for f in ("z_y", "z_s", "z_n", "zn")}
    j_z = {f: getattr(j_all, f) for f in ("z_y", "z_s", "z_n", "zn")}
    Yt, St, Nt, mwt = (torch.from_numpy(a) for a in (Y, S, N, mw))
    for policy in ("local", "distant", "none"):
        ours = ttango.tango_step2(Yt[2], St[2], Nt[2], mwt[2], 2, z, mwt, St[:, 0], Nt[:, 0],
                                  policy=policy, solver="eigh")
        ref = jtango.tango_step2(Y[2], S[2], N[2], mw[2], 2, j_z, mw, S[:, 0], N[:, 0],
                                 policy=policy, solver="eigh")
        for a, b in zip(ours, ref):
            assert max_rel(a, b) <= TOL, policy


@pytest.mark.parametrize("export", [False, True])
def test_tango_clip_fused_matches_jax(clip, export):
    y, s, n = clip
    ref = jfused.tango_clip_fused(y, s, n, export=export)
    ours = tfused.tango_clip_fused(y, s, n, export=export, device="cpu")
    if not export:
        assert ours.shape == (K, L) and ours.dtype == torch.float32
        assert max_rel(ours, ref) <= TOL, max_rel(ours, ref)
        return
    assert len(ours["td"]) == 6
    for a, b in zip(ours["td"], ref["td"]):
        assert a.shape == (K, L)
        assert max_rel(a, b) <= TOL, max_rel(a, b)
    for key in ("masks_z", "mask_w", "z_y"):
        assert max_rel(ours[key], ref[key]) <= TOL, key


def test_tango_clip_fused_options_match_jax(clip, spectra):
    """The iam mask family (masks from the complex spectra), explicit
    masks, another mu and policy, a non-fused solver, another reference
    mic with oracle step-1 statistics."""
    y, s, n = clip
    _, _, _, mz, mw = spectra
    cases = (
        dict(mask_type="iam1", solver="fused", policy="distant"),
        dict(masks_z=mz, mask_w=mw, mu=2.0, solver="power:8", policy="none"),
        dict(ref_mic=1, mask_type="irm2", oracle_step1_stats=True, solver="fused:3"),
    )
    for kw in cases:
        ref = jfused.tango_clip_fused(y, s, n, **kw)
        ours = tfused.tango_clip_fused(y, s, n, device="cpu", **kw)
        assert max_rel(ours, ref) <= TOL, (kw.get("mask_type"), max_rel(ours, ref))


def test_clip_batch_axis_is_clip_by_clip(clip):
    """A leading clip axis batches whole clips: each clip of the batch is
    the clip enhanced alone."""
    y, s, n = clip
    y2, s2, n2 = scene(K, C, L, seed=2, noise_scale=0.5)
    batch = tfused.tango_clip_fused(np.stack([y, y2]), np.stack([s, s2]), np.stack([n, n2]),
                                    device="cpu")
    assert batch.shape == (2, K, L)
    for i, (a, b, c) in enumerate(((y, s, n), (y2, s2, n2))):
        alone = tfused.tango_clip_fused(a, b, c, device="cpu")
        assert max_rel(batch[i], alone) <= 1e-5


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, clip, spectra):
    """Without a CUDA device, the entry points raise instead of moving to
    the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, s, n = clip
    Y, S, N, mz, mw = spectra
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.tango_clip_fused(y, s, n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttango.tango(Y, S, N, mz, mw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert not tdevice.is_hopper()
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_unported_options_raise(spectra):
    """Every policy, the fault seam and the bf16 lane are ported
    (tests/test_torch_port_policies.py, tests/test_torch_port_bf16.py); what
    the reference refuses is refused: an unknown policy, a precision token
    that is not canonical."""
    Y, S, N, mz, mw = spectra
    with pytest.raises(ValueError, match="unknown mask_for_z policy"):
        ttango.tango(Y, S, N, mz, mw, policy="far", device="cpu")
    with pytest.raises(ValueError, match="not canonical"):
        ttango.tango(Y, S, N, mz, mw, precision="BF16", device="cpu")


def test_others_index_matches_jax():
    for k in (2, 3, 8):
        np.testing.assert_array_equal(ttango.others_index(k), jtango.others_index(k))
