"""The port's node-sharded TANGO (``disco_tpu_torch.parallel``) on gloo ranks
against the JAX package's ``tango_sharded`` on its 8 virtual CPU devices,
and against the port's one-process ``tango``, on the same numpy spectra.

Ranks are spawned processes (``tests/torch_port_parallel_ranks.py``), one
spawn a world size: 4 ranks (one node each) and 2 ranks (two nodes each).

Tolerances: the reference's own, 1e-5 relative L2 (``tests/test_parallel.
py``) against JAX and against the one-process port.  On the CPU the
sharded port is bit for bit its one-process run at 2 ranks and not at 4
(one node a rank): the plain versions' complex products take a vectorized
or a scalar loop by the shapes and memory layout of their operands, so the
compressed streams can differ in their last bits and step 2 carries that
(:func:`test_sharded_matches_jax_and_the_one_process_port` prints which).
On the card ``chip_smoke.py`` phase 3m holds the 1-rank paths bit for bit.
The ring exchange is bit for bit the ``all_gather`` one on any host.
"""
import importlib

import jax
import numpy as np
import pytest
import torch.distributed as dist

from disco_tpu.core import dsp as jdsp
from disco_tpu.parallel import make_mesh as jmake_mesh
from disco_tpu.parallel import tango_sharded as jtango_sharded
from tests.torch_port_helpers import rel_l2, scene
from tests.torch_port_parallel_ranks import FIELDS, POLICIES, Z_MASK, spawn

jtango = importlib.import_module("disco_tpu.enhance.tango")

K, C, L = 4, 2, 8192
TOL = 1e-5
WORLDS = (4, 2)


@pytest.fixture(scope="module")
def spectra():
    y, s, n = scene(K, C, L, seed=3)
    Y, S, N = (np.asarray(jdsp.stft(a)) for a in (y, s, n))
    m = np.asarray(jtango.oracle_masks(S, N, "irm1"))
    return {"Y": Y, "S": S, "N": N, "m": m}


@pytest.fixture(scope="module")
def ranks(spectra, tmp_path_factory):
    """{world: rank 0's assembled outputs} — one spawn a world size."""
    io = tmp_path_factory.mktemp("parallel")
    np.savez(io / "inputs.npz", **spectra)
    return {w: spawn(w, "node_sharded", io) for w in WORLDS}


@pytest.fixture(scope="module")
def jax_sharded(spectra):
    """JAX ``tango_sharded`` on a (batch 2, node 4) mesh of the 8 virtual
    devices, every policy, and its ring and fault-mask runs."""
    Y, S, N, m = (spectra[k] for k in ("Y", "S", "N", "m"))
    mesh = jmake_mesh(n_node=K, n_batch=2)
    out = {p: jtango_sharded(Y, S, N, m, m, mesh, policy=p) for p in POLICIES}
    out["fault"] = jtango_sharded(Y, S, N, m, m, mesh, policy="local", solver="eigh",
                                  z_mask=Z_MASK)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_matches_jax_and_the_one_process_port(ranks, jax_sharded, world, policy):
    out = ranks[world]
    for f in FIELDS:
        ours, one = out[f"sharded/{policy}/{f}"], out[f"one/{policy}/{f}"]
        theirs = np.asarray(getattr(jax_sharded[policy], f))
        assert ours.shape == theirs.shape == (K, 257, theirs.shape[-1]), f
        assert rel_l2(ours, theirs) < TOL, (f, rel_l2(ours, theirs))
        assert rel_l2(ours, one) < TOL, (f, rel_l2(ours, one))
    bitwise = all(np.array_equal(out[f"sharded/{policy}/{f}"], out[f"one/{policy}/{f}"])
                  for f in FIELDS)
    print(f"world {world} policy {policy}: bit for bit the one-process port: {bitwise}")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_exchange_is_bit_for_bit_the_all_gather(ranks, world):
    out = ranks[world]
    for f in FIELDS:
        np.testing.assert_array_equal(out[f"ring/local/{f}"], out[f"sharded/local/{f}"])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_all_gather_keeps_node_order_with_two_rows_a_shard(ranks, world):
    out = ranks[world]
    np.testing.assert_array_equal(out["order/ring"], out["order/all_gather"])
    np.testing.assert_array_equal(out["order/ring"][:, 0], np.arange(2 * world))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fault_mask_matches_one_process_and_jax(ranks, jax_sharded, world):
    """The (K,) availability rides the z-exchange (tests/test_fault.py:
    310-325): a dropped node gives the one-process ``tango(z_mask=...)``
    result, finite, and JAX's sharded one."""
    got = ranks[world]["fault/yf"]
    assert np.isfinite(got).all()
    assert rel_l2(got, ranks[world]["fault_one/yf"]) < TOL
    assert rel_l2(got, np.asarray(jax_sharded["fault"].yf)) < TOL
    print(f"world {world} fault mask: bit for bit the one-process port: "
          f"{np.array_equal(got, ranks[world]['fault_one/yf'])}")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(ranks, world):
    shapes = ranks[world]["json"]
    half = world // 2
    assert shapes["make_mesh"] == {"batch": 1, "node": world}
    assert shapes["make_mesh_b2"] == {"batch": 2, "node": half}
    assert shapes["make_mesh_2d"] == {"node": half, "frame": 2}
    assert shapes["hybrid"] == {"batch": half, "node": 1, "frame": 2}
    assert shapes["hybrid_b1"] == {"batch": 1, "node": half, "frame": 2}
    assert shapes["config_node"] == {"batch": 1, "node": world}
    assert shapes["config_frame"] == {"node": half, "frame": 2}
    want = ({"batch": half, "node": 1, "frame": 2} if half > 1 else {"node": 1, "frame": 2})
    assert shapes["config_batch"] == want


def test_distributed_init_is_a_no_op_in_a_single_process(monkeypatch):
    from disco_tpu_torch.parallel import distributed_init
    from disco_tpu_torch.parallel import multihost

    for var in multihost._ADDRESS_ENV + multihost._COUNT_ENV + multihost._HOSTLIST_ENV + (
            "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert distributed_init() is False
    assert distributed_init(device="cpu") is False
    assert not dist.is_initialized()


def test_a_mesh_needs_the_world_it_names():
    """No mesh without a world, no mesh of another size than the world,
    no CUDA mesh without a card: the one-process function never runs in
    their place."""
    from disco_tpu_torch.parallel import make_mesh, single_rank_world

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(n_node=1, device="cpu")
    with single_rank_world("cpu"):
        with pytest.raises(ValueError, match="names 2 rank"):
            make_mesh(n_node=2, device="cpu")
        mesh = make_mesh(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("batch", "node")
    assert not dist.is_initialized()
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh(n_node=1)
        with pytest.raises(RuntimeError, match="CUDA device"):
            with single_rank_world():
                pass
    assert jax.device_count() == 8
