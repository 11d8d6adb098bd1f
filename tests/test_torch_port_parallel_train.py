"""The port's data-parallel training step (``nn.training.make_step_fns(
mesh=...)``) at 1, 2 and 4 gloo ranks against its meshless step, and
against the JAX package's mesh step at the same number of devices, on the
flywheel gate's tiny CRNN with batches of 8 (disco_tpu/flywheel/check.py:
54-66) and a global-norm clip.

Tolerances: the flywheel gate's ``MESH_LOSS_RTOL`` = 2e-4 on the losses
of six steps and on the BatchNorm running statistics after them (the
ranks' shares of the batch mean, of the BatchNorm statistics and of the
gradients are summed across ranks, which reorders the sums), 1e-4
absolute on the parameters; one rank is bit for bit the meshless step.
A 2-layer twin with dropout between its GRU layers holds the global-mask
draw: each rank applies its rows of the global batch's mask, so N ranks
stay within the same tolerance of the meshless step (JAX's dropout draws
from another generator and is not compared).
"""
import jax
import numpy as np
import optax
import pytest

from disco_tpu.nn import crnn as jcrnn
from disco_tpu.nn import training as jtr
from disco_tpu.parallel import make_mesh as jmake_mesh
from disco_tpu_torch.flywheel.check import MESH_LOSS_RTOL
from disco_tpu_torch.nn.convert import state_dict_from_flax
from tests.test_torch_port_training import randomized
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)
from tests.torch_port_parallel_ranks import CLIP, DROPOUT, NF, STEPS, TINY, WIN, run_steps, spawn

pytestmark = pytest.mark.usefixtures("one_host_thread")

B = 8
WORLDS = (2, 4)


def _jax_model(kw):
    kw = dict(kw)
    return jcrnn.build_crnn(**kw)


@pytest.fixture(scope="module")
def setup():
    """Seeded batches, each model's randomized JAX variables and the same
    weights as port state dicts."""
    rng = np.random.default_rng(7)
    batches = [(rng.random((B, 1, WIN, NF), np.float32) + 0.05,
                rng.random((B, WIN, NF), np.float32)) for _ in range(STEPS)]
    out = {"batches": batches, "jax": {}, "sd": {}}
    from disco_tpu_torch.nn.crnn import build_crnn

    for kind, kw in (("tiny", TINY), ("dropout", DROPOUT)):
        model, _ = _jax_model(kw)
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.rmsprop(1e-3, decay=0.99,
                                                                        eps=1e-8))
        state = jtr.create_train_state(model, tx, batches[0][0][:1])
        variables = randomized({"params": state.params, "batch_stats": state.batch_stats}, 3)
        out["jax"][kind] = (model, tx, variables)
        sd = state_dict_from_flax(variables, build_crnn(**kw))
        out["sd"][kind] = {k: np.asarray(v) for k, v in sd.items()}
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    io = tmp_path_factory.mktemp("parallel_train")
    arrays = {f"{k}{i}": b[j] for i, b in enumerate(setup["batches"])
              for j, k in enumerate("xy")}
    for kind, sd in setup["sd"].items():
        arrays.update({f"{kind}/sd/{k}": v for k, v in sd.items()})
    np.savez(io / "inputs.npz", **arrays)
    return {w: spawn(w, "train_steps", io) for w in WORLDS}


@pytest.fixture(scope="module")
def jax_losses(setup):
    """The JAX tiny model's losses meshless and on (batch N, node 1)
    meshes of the virtual devices."""
    model, tx, variables = setup["jax"]["tiny"]
    out = {}
    for n in (None,) + WORLDS:
        mesh = None if n is None else jmake_mesh(n_node=1, n_batch=n)
        step, _ = jtr.make_step_fns(model, "all", mesh=mesh)
        state = jtr.create_train_state(model, tx, setup["batches"][0][0][:1], seed=5)
        state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
        if mesh is not None:
            state = jtr.replicate_to_mesh(state, mesh)
        losses = []
        for x, y in setup["batches"]:
            state, loss = step(state, x, y)
            losses.append(float(loss))
        out[n] = np.asarray(losses)
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("kind", ["tiny", "dropout"])
def test_one_rank_is_bit_for_bit_the_meshless_step(setup, kind):
    from disco_tpu_torch.parallel import make_mesh, single_rank_world

    oracle = run_steps(kind, setup["sd"][kind], setup["batches"])
    with single_rank_world("cpu"):
        one = run_steps(kind, setup["sd"][kind], setup["batches"],
                        make_mesh(n_node=1, n_batch=1, device="cpu"))
    assert set(one) == set(oracle)
    for k in oracle:
        np.testing.assert_array_equal(one[k], oracle[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["tiny", "dropout"])
def test_n_ranks_within_mesh_loss_rtol_of_the_meshless_step(ranks, world, kind):
    out = ranks[world]
    mesh, oracle = f"{kind}/mesh", f"{kind}/meshless"
    assert _rel(out[f"{mesh}/losses"], out[f"{oracle}/losses"]) <= MESH_LOSS_RTOL
    assert _rel(out[f"{mesh}/eval"], out[f"{oracle}/eval"]) <= MESH_LOSS_RTOL
    for key in out:
        if key.startswith(f"{oracle}/sd/"):
            name = key[len(f"{oracle}/sd/"):]
            got = out[f"{mesh}/sd/{name}"]
            if "running" in name:
                assert _rel(got, out[key]) <= MESH_LOSS_RTOL, name
            elif "num_batches" not in name:
                np.testing.assert_allclose(got, out[key], rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_n_ranks_within_mesh_loss_rtol_of_jax_mesh_step(ranks, jax_losses, world):
    ours = ranks[world]["tiny/mesh/losses"]
    assert _rel(ours, jax_losses[world]) <= MESH_LOSS_RTOL, (ours, jax_losses[world])
    assert _rel(ranks[world]["tiny/meshless/losses"], jax_losses[None]) <= MESH_LOSS_RTOL
    assert jax.device_count() == 8
