"""The port's training path (``disco_tpu_torch.nn``: ``losses``, ``optim``,
``training``, ``serialization``, the flax ↔ torch converter) against the
JAX package on the same numpy inputs.

The models are small (n_ch 2, 9-frame windows, 33 bins, conv filters
(4, 8), GRU 16); every flax variable is redrawn from a seeded generator and
carried to the port by ``nn.convert.state_dict_from_flax``.  Tolerances:
losses within 1e-5 relative over three steps, parameters within 1e-5
absolute, ``nu`` and the BatchNorm statistics within 1e-5 relative (a
running variance updated with the unbiased batch variance, as
``torch.nn.BatchNorm2d`` does, is off by n/(n-1) and fails that), an eval
loss within 1e-6 relative, the optimizer within 1e-6 relative of optax,
and the bf16 lane's loss within 2e-2 of the JAX bf16 lane's (the JAX
package's own bound, tests/test_flywheel.py:323).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from disco_tpu.nn import crnn as jcrnn
from disco_tpu.nn import losses as jlosses
from disco_tpu.nn import training as jtr
from disco_tpu_torch.nn import crnn as tcrnn
from disco_tpu_torch.nn import losses as tlosses
from disco_tpu_torch.nn import serialization as tser
from disco_tpu_torch.nn import training as ttr
from disco_tpu_torch.nn.convert import flax_from_state_dict, params_from_flax, state_dict_from_flax
from disco_tpu_torch.nn.optim import RMSprop, build_optimizer
from disco_tpu_torch.runs import chaos
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

N_CH, WIN, F, B = 2, 9, 33, 8
CRNN_KW = dict(input_shape=(N_CH, WIN, F), cnn_filters=(4, 8), pool_kernels=((1, 2), (1, 2)),
               conv_padding=((0, 1), (0, 1)), rnn_units=(16,), ff_units=(F,))
RNN_KW = dict(input_shape=(WIN, N_CH * F), rnn_units=(16, 16), ff_units=(F,))
LR = 1e-3


def randomized(variables, seed=0):
    """Every leaf of a flax variable tree redrawn (kernels at variance
    1/fan_in, biases N(0, 0.1), scales 1 + N(0, 0.1), running variances in
    [0.5, 1.5)): flax's zero biases and 0/1 statistics would hide a wrong
    mapping."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        name, shape = path[-1].key, np.shape(v)
        if name == "kernel":
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            out = 0.5 + rng.random(shape)
        else:
            out = 0.1 * rng.standard_normal(shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def batch(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.random((n, N_CH, WIN, F)).astype(np.float32) + 0.05
    y = rng.random((n, WIN, F)).astype(np.float32)
    return x, y


def pair(kind, clip=None, seed=0):
    """(JAX model, JAX state, port model, port state) with the same
    randomized variables."""
    jmodel = jcrnn.CRNN(**CRNN_KW) if kind == "crnn" else jcrnn.RNNMask(**RNN_KW)
    tmodel = tcrnn.CRNN(**CRNN_KW) if kind == "crnn" else tcrnn.RNNMask(**RNN_KW)
    tx = optax.rmsprop(LR, decay=0.99, eps=1e-8)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    x, _ = batch(99)
    jstate = jtr.create_train_state(jmodel, tx, x[:1])
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, seed)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    tstate = ttr.create_train_state(tmodel, build_optimizer(tmodel, LR, clip), x[:1])
    return jmodel, jstate, tmodel, tstate


def port_tree(tstate):
    """The port state's params, batch stats and nu as flax trees."""
    variables = flax_from_state_dict(tstate.model.state_dict(), tstate.model)
    nu = {n: tstate.optimizer.state[p]["nu"] for n, p in tstate.model.named_parameters()}
    return variables["params"], variables["batch_stats"], \
        flax_from_state_dict(nu, tstate.model)["params"]


def jax_nu(jstate):
    opt = jstate.opt_state
    rms = opt[1] if len(opt) == 2 else opt
    return jax.device_get(rms[0].nu)


def assert_trees(a, b, rtol, atol):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, u), (_, v) in zip(la, lb):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def sort_tree(t):
    return {k: sort_tree(v) for k, v in sorted(t.items())} if isinstance(t, dict) else t


# ------------------------------------------------------------------ losses
def test_nanmean_and_reconstruction_loss_match_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((5, 7)).astype(np.float32)
    v[1, 2] = v[3, 0] = np.nan
    np.testing.assert_allclose(float(tlosses.nanmean(torch.from_numpy(v))),
                               float(jlosses.nanmean(v)), rtol=1e-6)
    yt, yp, yi = (rng.random((4, 6, 33)).astype(np.float32) for _ in range(3))
    yi[0, 0, 0] = np.nan
    ours = tlosses.reconstruction_loss(*(torch.from_numpy(a) for a in (yt, yp, yi)))
    np.testing.assert_allclose(float(ours), float(jlosses.reconstruction_loss(yt, yp, yi)),
                               rtol=1e-6)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [None, 0.05])
def test_rmsprop_matches_optax_over_five_steps(clip):
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.rmsprop(1e-3, decay=0.99, eps=1e-8)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp, jopt = dict(params), tx.init(params)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = RMSprop(tp.values(), lr=1e-3, decay=0.99, eps=1e-8, clip_norm=clip)
    clipped = []
    for step, scale in enumerate((1.0, 1e-5, 1e-3, 1e-4, 1e-5)):
        # of order 1e-5 a gradient moves its parameter ~100 times further
        # with eps outside the square root (torch's RMSprop) than inside
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jopt = tx.update(grads, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        opt.step()
        clipped.append(clip is not None and float(optax.global_norm(grads)) > clip)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} {k}")
        nu = (jopt[1] if clip else jopt)[0].nu
        for k, t in tp.items():
            np.testing.assert_allclose(opt.state[t]["nu"].numpy(), np.asarray(nu[k]), rtol=1e-6,
                                       atol=0, err_msg=f"step {step} nu {k}")
    if clip:
        assert any(clipped) and not all(clipped)


# ------------------------------------------------------------ train steps
CASES = [("crnn", "all"), ("crnn", "mid"), ("crnn", "last"),
         ("rnn", "all"), ("rnn", "mid"), ("rnn", "last"), ("rnn", 3)]


@pytest.mark.parametrize("kind,frames", CASES)
def test_three_train_steps_match_jax(kind, frames):
    jmodel, jstate, tmodel, tstate = pair(kind)
    jtrain, jeval = jtr.make_step_fns(jmodel, frames, n_freq=F)
    ttrain, teval = ttr.make_step_fns(tmodel, frames, n_freq=F)
    for step in range(3):
        x, y = batch(step)
        jstate, jl = jtrain(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tl = ttrain(tstate, x, y)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"loss, step {step}")
    params, stats, nu = port_tree(tstate)
    assert_trees(params, jax.device_get(jstate.params), rtol=0, atol=1e-5)
    assert_trees(sort_tree(stats), sort_tree(jax.device_get(jstate.batch_stats)),
                 rtol=1e-5, atol=1e-6)
    assert_trees(sort_tree(nu), sort_tree(jax_nu(jstate)), rtol=1e-5, atol=1e-12)
    assert tstate.step == int(jstate.step) == 3
    x, y = batch(7)
    np.testing.assert_allclose(float(teval(tstate, x, y)),
                               float(jeval(jstate, jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def test_train_step_with_clipping_matches_jax():
    jmodel, jstate, tmodel, tstate = pair("crnn", clip=0.05)
    jtrain, _ = jtr.make_step_fns(jmodel, "all", n_freq=F)
    ttrain, _ = ttr.make_step_fns(tmodel, "all", n_freq=F)
    for step in range(3):
        x, y = batch(step)
        jstate, jl = jtrain(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tl = ttrain(tstate, x, y)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    params, _, nu = port_tree(tstate)
    assert_trees(params, jax.device_get(jstate.params), rtol=0, atol=1e-5)
    assert_trees(sort_tree(nu), sort_tree(jax_nu(jstate)), rtol=1e-5, atol=1e-12)


def test_gru_rows_flax_lacks_stay_zero():
    _, _, tmodel, tstate = pair("crnn")
    ttrain, _ = ttr.make_step_fns(tmodel, "all", n_freq=F)
    tstate, _ = ttrain(tstate, *batch(0))
    bias_hh = tmodel.rnn.layers[0].bias_hh_l0
    assert torch.all(bias_hh[:32] == 0) and torch.any(bias_hh[32:] != 0)


def test_bf16_lane_keeps_f32_masters_and_matches_jax():
    jmodel, jstate, tmodel, tstate = pair("crnn")
    jtrain, _ = jtr.make_step_fns(jmodel, "all", n_freq=F, precision="bf16")
    ttrain, _ = ttr.make_step_fns(tmodel, "all", n_freq=F, precision="bf16")
    for step in range(2):
        x, y = batch(step)
        jstate, jl = jtrain(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tl = ttrain(tstate, x, y)
        assert abs(float(tl) - float(jl)) <= 2e-2 * abs(float(jl)), (step, float(tl), float(jl))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert all(b.dtype == torch.float32 for n, b in tmodel.named_buffers() if "running" in n)
    assert all(s["nu"].dtype == torch.float32 for s in tstate.optimizer.state.values())


def test_steps_refuse_a_mesh():
    """The data-parallel lane takes a DeviceMesh with a 'batch' dim of the
    world it runs in, nothing else."""
    from disco_tpu_torch.parallel import make_mesh_2d, single_rank_world

    _, _, tmodel, _ = pair("crnn")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttr.make_step_fns(tmodel, "all", mesh=object())
    with single_rank_world("cpu"):
        with pytest.raises(ValueError, match="'batch' axis"):
            ttr.make_step_fns(tmodel, "all", mesh=make_mesh_2d(1, 1, device="cpu"))


# -------------------------------------------------- gate and names
def test_save_and_stop_and_model_names_match_jax():
    values = [1.0, 1.5, 1.4, 0.9, 0.95, 0.95, 0.94, 2.0]
    for kw in ({"patience": 2}, {"patience": 1, "mode": "max"}, {"delta": 0.05}):
        jg, tg = jtr.SaveAndStop(**kw), ttr.SaveAndStop(**kw)
        for v in values:
            assert tg.save_model_query(v) == jg.save_model_query(v)
            assert tg.early_stop_query() == jg.early_stop_query()
    with pytest.raises(ValueError):
        ttr.SaveAndStop(mode="other")
    for name in ("models/ab3X_model.msgpack", "x/run_model.msgpack", "plain"):
        assert ttr.get_model_name(name) == jtr.get_model_name(name)
    assert len(ttr.get_model_name()) == 4


# ---------------------------------------------------------- checkpoints
@pytest.mark.parametrize("clip", [None, 0.05])
def test_jax_checkpoint_loads_in_the_port(tmp_path, clip):
    jmodel, jstate, tmodel, tstate = pair("crnn", clip=clip)
    jtrain, _ = jtr.make_step_fns(jmodel, "all", n_freq=F)
    for step in range(2):
        x, y = batch(step)
        jstate, _ = jtrain(jstate, jnp.asarray(x), jnp.asarray(y))
    path = tmp_path / "j_model.msgpack"
    jtr.save_checkpoint(path, jstate, [0.5, 0.4, 0.0, 0.0], [0.6, 0.5, 0.0, 0.0], epochs_done=2)
    raw = path.read_bytes()
    assert tser.packb(tser.unpackb(raw)) == raw  # the encoder writes flax's bytes
    tstate, tr, va = ttr.load_checkpoint(path, tstate)
    assert list(tr) == [0.5, 0.4] and list(va) == [0.6, 0.5] and tstate.step == 2
    params, stats, nu = port_tree(tstate)
    assert_trees(params, jax.device_get(jstate.params), rtol=0, atol=0)
    assert_trees(sort_tree(stats), sort_tree(jax.device_get(jstate.batch_stats)), rtol=0, atol=0)
    assert_trees(sort_tree(nu), sort_tree(jax_nu(jstate)), rtol=0, atol=0)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_port_checkpoint_loads_in_jax(tmp_path, clip):
    jmodel, jstate0, tmodel, tstate = pair("crnn", clip=clip)
    ttrain, _ = ttr.make_step_fns(tmodel, "all", n_freq=F)
    for step in range(2):
        tstate, _ = ttrain(tstate, *batch(step))
    path = tmp_path / "t_model.msgpack"
    ttr.save_checkpoint(path, tstate, [0.5, 0.0], [0.7, 0.0], epochs_done=2)
    jstate, tr, va = jtr.load_checkpoint(path, jstate0)
    assert list(tr) == [0.5, 0.0] and list(va) == [0.7, 0.0] and int(jstate.step) == 2
    params, stats, nu = port_tree(tstate)
    assert_trees(params, jax.device_get(jstate.params), rtol=0, atol=0)
    assert_trees(sort_tree(stats), sort_tree(jax.device_get(jstate.batch_stats)), rtol=0, atol=0)
    assert_trees(sort_tree(nu), sort_tree(jax_nu(jstate)), rtol=0, atol=0)
    # and the JAX state trains on from it
    jtrain, _ = jtr.make_step_fns(jmodel, "all", n_freq=F)
    jstate, loss = jtrain(jstate, *(jnp.asarray(a) for a in batch(5)))
    assert np.isfinite(float(loss))


def test_legacy_checkpoint_without_epoch_count(tmp_path):
    jmodel, jstate, tmodel, tstate = pair("crnn")
    payload = {"params": jstate.params, "batch_stats": jstate.batch_stats,
               "opt_state": jstate.opt_state, "step": jstate.step,
               "train_loss": np.array([0.5, 0.4, 0.0]), "val_loss": np.array([0.6, 0.0, 0.0])}
    path = tmp_path / "legacy_model.msgpack"
    path.write_bytes(serialization.to_bytes(payload))
    _, tr, va = ttr.load_checkpoint(path, tstate)
    _, jtr_hist, jva_hist = jtr.load_checkpoint(path, jstate)
    assert list(tr) == list(jtr_hist) == [0.5, 0.4] and list(va) == list(jva_hist) == [0.6]


def test_bad_checkpoints_raise_checkpoint_error_naming_the_path(tmp_path):
    _, _, tmodel, tstate = pair("crnn")
    path = tmp_path / "c_model.msgpack"
    ttr.save_checkpoint(path, tstate, [0.5], [0.5])
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ttr.CheckpointError, match=str(path)):
        ttr.load_checkpoint(path, tstate)
    with pytest.raises(ttr.CheckpointError, match="cannot read"):
        ttr.load_checkpoint(tmp_path / "missing.msgpack", tstate)
    path.write_bytes(raw)
    clipped = ttr.create_train_state(tmodel, build_optimizer(tmodel, LR, 1.0))
    with pytest.raises(ttr.CheckpointError, match="clip"):
        ttr.load_checkpoint(path, clipped)
    other = tcrnn.CRNN(**{**CRNN_KW, "rnn_units": (8,)})
    with pytest.raises(ttr.CheckpointError, match=str(path)):
        ttr.load_checkpoint(path, ttr.create_train_state(other, build_optimizer(other)))


def test_serialization_round_trips_the_msgpack_subset():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.int32(7),
            "d": "x" * 40, "e": b"\x00\x01", "f": [1, -5, 300, -70000, 2 ** 40],
            "g": 1.5, "h": None, "i": True, "j": {}}, "k": complex(1, -2),
            "l": np.zeros((0,), np.float64)}
    import msgpack

    want = msgpack.packb(serialization._np_convert_in_place(dict(tree)),
                         default=serialization._msgpack_ext_pack, strict_types=True)
    assert tser.packb(tree) == want
    back = tser.unpackb(want)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["f"] == tree["b"]["f"] and back["k"] == tree["k"]
    assert back["b"]["c"] == 7 and back["b"]["e"] == b"\x00\x01" and back["b"]["j"] == {}
    with pytest.raises(tser.DecodeError):
        tser.unpackb(want[:-3])
    chunked = serialization.msgpack_restore(want)
    assert chunked["b"]["d"] == back["b"]["d"]


def test_params_from_flax_inverts_flax_from_state_dict():
    _, _, tmodel, _ = pair("rnn")
    named = dict(tmodel.named_parameters())
    back = params_from_flax(flax_from_state_dict(named, tmodel)["params"], tmodel)
    assert set(back) == set(named)
    for k, v in back.items():  # the rows flax lacks are 0 from construction
        assert torch.equal(v, named[k].detach()), k


# ------------------------------------------------------------------ fit
class EpochBatches:
    """Deterministic (x, y) batches per epoch: epoch e draws from seed
    (seed, e), so a resumed run sees the batches of its epochs."""

    def __init__(self, seed, n_batches=2):
        self.seed, self.n, self.epoch = seed, n_batches, 0

    def set_start_epoch(self, epoch):
        self.epoch = epoch

    def __call__(self):
        e, self.epoch = self.epoch, self.epoch + 1
        for i in range(self.n):
            yield batch(self.seed * 1000 + e * 10 + i)


def read_ledger(path):
    import json

    return [json.loads(line) for line in path.read_text().splitlines()]


def port_fit(tmp, name, n_epochs, **kw):
    _, _, tmodel, tstate = pair("crnn")
    return ttr.fit(tmodel, tstate, EpochBatches(1), EpochBatches(2), n_epochs,
                   save_path=tmp, run_name=name, verbose=False, device="cpu", **kw)


def test_fit_matches_jax(tmp_path):
    jmodel, jstate, _, _ = pair("crnn")
    _, jtrain_l, jval_l, _ = jtr.fit(jmodel, jstate, EpochBatches(1), EpochBatches(2), 3,
                                     save_path=tmp_path / "j", run_name="par", verbose=False,
                                     ledger=tmp_path / "j.jsonl")
    _, ttrain_l, tval_l, name = port_fit(tmp_path / "t", "par", 3, ledger=tmp_path / "t.jsonl")
    np.testing.assert_allclose(ttrain_l, jtrain_l, rtol=1e-5)
    np.testing.assert_allclose(tval_l, jval_l, rtol=1e-5)
    flags = [[(r["unit"], r["state"], r["attrs"].get("improved")) for r in read_ledger(p)]
             for p in (tmp_path / "j.jsonl", tmp_path / "t.jsonl")]
    assert flags[0] == flags[1]
    names = [sorted(p.name for p in (tmp_path / d).iterdir()) for d in ("j", "t")]
    assert names[0] == names[1] == ["par_losses.npz", "par_model.msgpack"]
    best = max(i for i, (_, _, improved) in enumerate(flags[1]) if improved == "True") // 2 + 1
    assert tser.unpackb((tmp_path / "t" / "par_model.msgpack").read_bytes())["epochs_done"] == best


def test_fit_resume_continues_an_uninterrupted_run_bit_for_bit(tmp_path):
    full_state, full_tr, full_va, _ = port_fit(tmp_path, "full", 3)
    port_fit(tmp_path, "half", 2)
    state, tr, va, name = port_fit(tmp_path, "half", 1,
                                   resume_from=tmp_path / "half_model.msgpack")
    assert name == "half" and np.array_equal(tr, full_tr) and np.array_equal(va, full_va)
    for (k, a), b in zip(full_state.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_fit_mid_epoch_crash_then_resume_redoes_the_epoch(tmp_path):
    _, full_tr, full_va, _ = port_fit(tmp_path, "full", 3)
    chaos.configure("mid_epoch", after=2)
    try:
        with pytest.raises(chaos.ChaosCrash):
            port_fit(tmp_path, "crash", 3, ledger=tmp_path / "crash.jsonl")
    finally:
        chaos._reset_for_tests()
    states = [(r["unit"], r["state"]) for r in read_ledger(tmp_path / "crash.jsonl")]
    assert states == [("epoch:0", "in_flight"), ("epoch:0", "done"), ("epoch:1", "in_flight")]
    ck = tser.unpackb((tmp_path / "crash_model.msgpack").read_bytes())
    assert int(ck["epochs_done"]) == 1
    _, tr, va, _ = port_fit(tmp_path, "crash", 2, resume_from=tmp_path / "crash_model.msgpack",
                            ledger=tmp_path / "crash.jsonl")
    assert np.array_equal(tr, full_tr) and np.array_equal(va, full_va)
    done = {r["unit"] for r in read_ledger(tmp_path / "crash.jsonl") if r["state"] == "done"}
    assert done == {"epoch:0", "epoch:1", "epoch:2"}


def test_fit_device_rule_and_unported_options(tmp_path):
    _, _, tmodel, tstate = pair("crnn")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttr.fit(tmodel, tstate, EpochBatches(1), EpochBatches(2), 1, save_path=tmp_path)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttr.fit(tmodel, tstate, EpochBatches(1), EpochBatches(2), 1, save_path=tmp_path,
                device="cpu", mesh=object())


def test_fit_zero_batch_epoch_warns(tmp_path, capsys):
    _, _, tmodel, tstate = pair("crnn")
    empty = lambda: iter(())  # noqa: E731
    _, tr, _, _ = ttr.fit(tmodel, tstate, empty, EpochBatches(2), 1, save_path=tmp_path,
                          run_name="e", device="cpu")
    assert "zero training batches" in capsys.readouterr().out and tr[0] == 0.0


def test_msgpack_probe_matches_jax(tmp_path):
    from disco_tpu.io import atomic as jatomic
    from disco_tpu_torch.io import atomic as tatomic

    _, _, tmodel, tstate = pair("crnn")
    path = tmp_path / "p_model.msgpack"
    ttr.save_checkpoint(path, tstate, [0.5], [0.5])
    raw = path.read_bytes()
    for data, want in ((raw, True), (raw[:-7], False), (b"", False)):
        path.write_bytes(data)
        assert tatomic.probe_artifact(path) is jatomic.probe_artifact(path) is want


def test_train_config_matches_jax():
    import dataclasses

    from disco_tpu.config import TrainConfig as JTrainConfig
    from disco_tpu_torch.config import TrainConfig

    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert ours == {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    assert (ours["batch_size"], ours["lr"], ours["win_len"], ours["win_hop"]) == (500, 1e-3, 21, 8)


def test_prefetch_to_device_keeps_order_and_raises_at_the_consumer():
    from disco_tpu_torch.device import prefetch_to_device

    batches = [(np.full((2, 3), i, np.float32), {"y": np.arange(i + 1)}) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(got) == 5
    for i, (x, rest) in enumerate(got):
        assert isinstance(x, torch.Tensor) and torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(rest["y"], torch.arange(i + 1))

    def failing():
        yield batches[0]
        raise OSError("a shard went missing")

    it = prefetch_to_device(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="shard went missing"):
        next(it)


def test_host_batch_feed_records_its_overlap():
    from disco_tpu_torch.obs.metrics import REGISTRY

    n0 = REGISTRY.counter("chunks_pipelined").value
    h0 = REGISTRY.histogram("prefetch_stall_ms").count
    got = list(ttr._prefetch_host_batches(lambda: iter([batch(i) for i in range(3)])))
    assert len(got) == 3 and REGISTRY.counter("chunks_pipelined").value - n0 == 3
    assert REGISTRY.histogram("prefetch_stall_ms").count - h0 == 3
    assert 0.0 <= REGISTRY.gauge("overlap_efficiency").value <= 1.0
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(got, (batch(i) for i in range(3))))


def test_fit_stops_gracefully_between_epochs(tmp_path):
    from disco_tpu_torch.runs import interrupt

    calls = []

    class StopAfterOne(EpochBatches):
        def __call__(self):
            calls.append(self.epoch)
            if len(calls) == 1:
                interrupt.request_stop("test")
            return super().__call__()

    _, _, tmodel, tstate = pair("crnn")
    with interrupt.GracefulInterrupt():
        _, tr, _, _ = ttr.fit(tmodel, tstate, StopAfterOne(1), EpochBatches(2), 3,
                              save_path=tmp_path, run_name="g", verbose=False, device="cpu")
    assert calls == [0] and tr[0] > 0 and list(tr[1:]) == [0.0, 0.0]
    assert ttr.load_checkpoint(tmp_path / "g_model.msgpack", tstate)[1].size == 1


def test_steps_restore_the_cudnn_settings():
    _, _, tmodel, tstate = pair("crnn")
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        ttrain, teval = ttr.make_step_fns(tmodel, "all", n_freq=F)
        ttrain(tstate, *batch(0))
        teval(tstate, *batch(1))
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def test_dropout_draws_from_the_state_generator():
    model_kw = {**RNN_KW, "rnn_dropouts": 0.5}

    def losses(seed):
        torch.manual_seed(0)
        tmodel = tcrnn.RNNMask(**model_kw)
        state = ttr.create_train_state(tmodel, build_optimizer(tmodel), seed=seed)
        train_step, _ = ttr.make_step_fns(tmodel, "all", n_freq=F)
        torch.manual_seed(123)  # the global generator plays no part
        out = [float(train_step(state, *batch(i))[1]) for i in range(2)]
        return out, torch.rand(1)

    (a, ga), (b, gb), (c, _) = losses(0), losses(0), losses(1)
    assert a == b and a != c and torch.equal(ga, gb)


def _epoch_events(events):
    return [(e["stage"], e["attrs"]["epoch"], e["attrs"]["steps"], e["attrs"]["val_batches"],
             e["attrs"]["recompiles"]) for e in events if e["kind"] == "epoch"]


def test_fit_events_match_jax(tmp_path):
    """A two-epoch fit in each package under its own recorder: the same
    epoch events (steps, val_batches, new signatures: train_step and
    eval_step once each on epoch 0, none after), losses within the bound of
    test_fit_matches_jax, the same training counters; an empty epoch
    records its warning in both.  JAX traces ``train_step`` once more on
    epoch 0, when its own committed output state first comes back in: the
    same shapes and dtypes, so not a signature the port counts.  With
    recording off, an epoch reads nothing back through the batched copy and
    ticks no fence."""
    import disco_tpu.obs as jobs
    import disco_tpu_torch.obs as tobs
    from tests.torch_port_helpers import recorded

    jtr._STEP_FNS.clear()  # fresh jitted steps: epoch 0 traces both
    jmodel, jstate, _, _ = pair("crnn")
    _, jev = recorded(jobs, tmp_path / "j.jsonl", lambda: jtr.fit(
        jmodel, jstate, EpochBatches(1), EpochBatches(2), 2, save_path=tmp_path / "j",
        run_name="ev", verbose=False))
    _, tev = recorded(tobs, tmp_path / "t.jsonl", lambda: port_fit(tmp_path / "t", "ev", 2))
    assert _epoch_events(tev) == [("train", 0, 2, 2, 2), ("train", 1, 2, 2, 0)]
    assert _epoch_events(jev) == [("train", 0, 2, 2, 3), ("train", 1, 2, 2, 0)]
    assert [(e["stage"], e["attrs"]["n_new_programs"]) for e in tev if e["kind"] == "jit_trace"] \
        == [("train_step", 1), ("eval_step", 1)]
    assert (jobs.recompile_count("train_step"), jobs.recompile_count("eval_step")) == (2, 1)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([e["attrs"][key] for e in tev if e["kind"] == "epoch"],
                                   [e["attrs"][key] for e in jev if e["kind"] == "epoch"],
                                   rtol=1e-5)
    counters = [obs.REGISTRY.snapshot()["counters"] for obs in (tobs, jobs)]
    assert [c["train_steps"] for c in counters] == [4, 4]

    empty = lambda: iter(())  # noqa: E731
    _, _, tmodel, tstate = pair("crnn")
    warnings = []
    for name, obs, run in (
            ("j", jobs, lambda: jtr.fit(jmodel, jstate, empty, EpochBatches(2), 1,
                                        save_path=tmp_path / "je", run_name="e", verbose=False)),
            ("t", tobs, lambda: ttr.fit(tmodel, tstate, empty, EpochBatches(2), 1,
                                        save_path=tmp_path / "te", run_name="e", verbose=False,
                                        device="cpu"))):
        _, ev = recorded(obs, tmp_path / f"{name}e.jsonl", run)
        warnings.append([(e["stage"], e["attrs"]["epoch"], e["attrs"]["reason"]) for e in ev
                         if e["kind"] == "warning"])
        assert obs.REGISTRY.snapshot()["counters"]["train_empty_epochs"] == 1
    assert warnings[0] == warnings[1] and len(warnings[0]) == 1

    from disco_tpu_torch.obs.accounting import device_get_count, fence_count

    g0, f0 = device_get_count(), fence_count()
    port_fit(tmp_path / "off", "off", 1)
    assert (device_get_count(), fence_count()) == (g0, f0)
