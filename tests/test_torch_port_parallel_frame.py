"""The port's frame- and batch-sharded TANGO (``disco_tpu_torch.parallel``)
on four gloo ranks against the JAX package's ``tango_frame_sharded`` and
``tango_batch_sharded`` on its virtual CPU devices, and against the port's
one-process ``tango``, on the same numpy spectra; with the fault-mask
contracts of ``tests/test_fault.py:310-370``.

Tolerances: the reference's own — 1e-4 of the output scale (max |a - b| /
max |b|) on the frame path, whose covariance sums are split over the
ranks and ``all_reduce``d, and 1e-5 relative L2 on the batch path and on
the fault masks.
"""
import importlib

import numpy as np
import pytest

from disco_tpu.core import dsp as jdsp
from disco_tpu.parallel import make_mesh as jmake_mesh
from disco_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from disco_tpu.parallel import tango_batch_sharded as jtango_batch_sharded
from disco_tpu.parallel import tango_frame_sharded as jtango_frame_sharded
from tests.torch_port_helpers import max_rel, rel_l2, scene
from tests.torch_port_parallel_ranks import FIELDS, FRAME_POLICIES, Z_MASK, spawn

jtango = importlib.import_module("disco_tpu.enhance.tango")

K, C, L = 4, 2, 8192
FRAME_TOL, TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def spectra():
    """One clip (frames cut to an even count for the frame dim) and a
    batch of two distinct clips."""
    y, s, n = scene(K, C, L, seed=11)
    Y, S, N = (np.asarray(jdsp.stft(a)) for a in (y, s, n))
    T = Y.shape[-1] // 2 * 2
    Y, S, N = (a[..., :T] for a in (Y, S, N))
    m = np.asarray(jtango.oracle_masks(S, N, "irm1"))
    clips = [scene(K, C, L, seed=100 + b) for b in range(2)]
    Yb, Sb, Nb = (np.asarray(jdsp.stft(np.stack([c[i] for c in clips]))) for i in range(3))
    mb = np.asarray(jtango.oracle_masks(Sb.reshape(-1, *Sb.shape[2:]),
                                        Nb.reshape(-1, *Nb.shape[2:]), "irm1"))
    mb = mb.reshape(Yb.shape[:2] + mb.shape[1:])
    return {"Y": Y, "S": S, "N": N, "m": m, "Yb": Yb, "Sb": Sb, "Nb": Nb, "mb": mb}


@pytest.fixture(scope="module")
def ranks(spectra, tmp_path_factory):
    io = tmp_path_factory.mktemp("parallel_frame")
    np.savez(io / "inputs.npz", **spectra)
    return spawn(4, "frame_and_batch", io)


@pytest.mark.parametrize("policy", FRAME_POLICIES)
def test_frame_sharded_matches_jax_and_the_one_process_port(spectra, ranks, policy):
    Y, S, N, m = (spectra[k] for k in ("Y", "S", "N", "m"))
    want = jtango_frame_sharded(Y, S, N, m, m, jmake_mesh_2d(n_node=2, n_frame=2),
                                policy=policy)
    for f in FIELDS:
        ours = ranks[f"frame/{policy}/{f}"]
        theirs = np.asarray(getattr(want, f))
        assert ours.shape == theirs.shape, f
        assert max_rel(ours, theirs) < FRAME_TOL, (f, max_rel(ours, theirs))
        assert max_rel(ours, ranks[f"one/{policy}/{f}"]) < FRAME_TOL, f


def test_frame_sharded_fault_mask_matches_one_process(ranks):
    """The finiteness verdict is combined over the frame shards
    (``all_reduce(MIN)``): the dropped node is excluded on every shard."""
    got, want = ranks["frame_fault/yf"], ranks["frame_fault_one/yf"]
    assert np.isfinite(got).all()
    assert rel_l2(got, want) < TOL, rel_l2(got, want)


def test_batch_sharded_matches_jax_and_the_batched_port(spectra, ranks):
    Yb, Sb, Nb, mb = (spectra[k] for k in ("Yb", "Sb", "Nb", "mb"))
    want = jtango_batch_sharded(Yb, Sb, Nb, mb, mb, jmake_mesh(n_node=2, n_batch=2),
                                policy="local")
    for f in FIELDS:
        ours = ranks[f"batch/{f}"]
        assert ours.shape == np.asarray(getattr(want, f)).shape, f
        assert rel_l2(ours, np.asarray(getattr(want, f))) < TOL, f
        assert rel_l2(ours, ranks[f"batch_one/{f}"]) < TOL, f
    print("batch-sharded: bit for bit the batched port:",
          all(np.array_equal(ranks[f"batch/{f}"], ranks[f"batch_one/{f}"]) for f in FIELDS))


def test_batch_sharded_fault_masks_match_each_clip_alone(spectra, ranks):
    """Per-clip (B, K) masks and NaN flags (tests/test_fault.py:343-370):
    each clip equals its one-process degraded run, and the NaN'd clip
    stays finite; JAX's batch-sharded run agrees."""
    got = ranks["batch_fault/yf"]
    assert np.isfinite(got).all()
    for b in range(2):
        assert rel_l2(got[b], ranks["batch_fault_one/yf"][b]) < TOL, b
    Y, S, N, m = (spectra[k] for k in ("Y", "S", "N", "m"))
    zmb = np.stack([Z_MASK, np.ones(4, np.float32)])
    znb = np.zeros((2, 4), bool)
    znb[1, 2] = True
    want = jtango_batch_sharded(np.stack([Y, Y * 0.5]), np.stack([S, S * 0.5]),
                                np.stack([N, N * 0.5]), np.stack([m, m]), np.stack([m, m]),
                                jmake_mesh(n_node=2, n_batch=2), policy="local",
                                solver="eigh", z_mask_b=zmb, z_nan_b=znb)
    assert rel_l2(got, np.asarray(want.yf)) < TOL


@pytest.mark.parametrize("mesh", ["frame", "batch"])
def test_gather_result_to_one_rank_is_the_all_gather(ranks, mesh):
    """``gather_result(..., dst=r)`` gives rank r the all-gathered result,
    bit for bit, and every other rank None: on the (node 2, frame 2) mesh
    to the last rank, on the (batch 2, node 2) mesh to rank 0."""
    assert int(ranks[f"dst/{mesh}"][0]) == 1
