"""The port's NN bricks, CRNN and 2-D RNN (``disco_tpu_torch.nn``) against
the JAX package's flax modules, with the weights carried across by
``disco_tpu_torch.nn.convert.state_dict_from_flax``.

Every variable of a JAX ``init`` is redrawn from a seeded numpy generator
(flax initializes biases to 0 and BatchNorm statistics to 0/1, which would
hide a wrong bias or statistic mapping); the same numpy inputs go through
``model.apply(..., train=False)`` and the port's module in eval mode.
Tolerance: 2e-5 absolute, as the flax-vs-torch-twin test of the JAX
package (tests/test_torch_parity.py): float32 convolutions, recurrences
and products in different summation orders.
"""
import jax
import numpy as np
import pytest
import torch

from disco_tpu.nn import bricks as jbricks
from disco_tpu.nn import crnn as jcrnn
from disco_tpu_torch.nn import bricks as tbricks
from disco_tpu_torch.nn import crnn as tcrnn
from disco_tpu_torch.nn.convert import _cnn, state_dict_from_flax

TOL = 2e-5


def randomized(variables, seed=0):
    """Every leaf of a flax variable tree redrawn: kernels at the scale of
    flax's default initializer (variance 1/fan_in), biases and BatchNorm
    shifts N(0, 0.1), scales 1 + N(0, 0.1), running variances in [0.5,
    1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        name = path[-1].key
        shape = np.shape(v)
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


def pair(jmodel, tmodel, x, seed=0, **kw):
    """(JAX output, port output) of the two modules on ``x`` with the same
    (randomized) weights."""
    variables = randomized(jmodel.init(jax.random.PRNGKey(0), x, **kw), seed)
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    ref = np.asarray(jmodel.apply(variables, x, train=False, **kw))
    with torch.no_grad():
        ours = tmodel.eval()(torch.from_numpy(x), **kw).numpy()
    return ref, ours


# ------------------------------------------------------------ pure helpers
@pytest.mark.parametrize("name", ["sigmoid", "relu", "tanh", "elu", "softplus", "identity",
                                  "linear", None, "Sigmoid", "silu", "gelu"])
def test_activation_by_name_matches_jax(name):
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    ref = np.asarray(jbricks.activation_by_name(name)(x))
    ours = tbricks.activation_by_name(name)(torch.from_numpy(x)).numpy()
    if name == "gelu":  # jax.nn.gelu defaults to the tanh approximation
        ours = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_activation_by_name_rejects_unknown():
    with pytest.raises(ValueError, match="Unknown activation"):
        tbricks.activation_by_name("nope")


@pytest.mark.parametrize("arg", [3, (1, 4), [2], [1, 2, 3], ((0, 1), (0, 1), (0, 1)),
                                 (None, (1, 4), None), "max", None])
def test_spec_helpers_match_jax(arg):
    assert tbricks.broadcast_arg(arg, 3) == jbricks.broadcast_arg(arg, 3)
    if not isinstance(arg, str):
        ok = not isinstance(arg, (tuple, list)) or len(arg) == 3
        if ok:
            assert tbricks.spec_per_layer(arg, 3) == jbricks.spec_per_layer(arg, 3)
    for v in (arg if isinstance(arg, (tuple, list)) else [arg]):
        if not isinstance(v, str):
            assert tbricks._pair(v) == jbricks._pair(v)


@pytest.mark.parametrize("cfg", [
    dict(input_hw=(21, 257), conv_kernels=3, conv_strides=1, pool_kernels=((1, 4),) * 3,
         pool_strides=None, conv_padding=((0, 1),) * 3, n_layers=3),
    dict(input_hw=(21, 257), conv_kernels=(3, 5), conv_strides=((1, 2), (2, 1)),
         pool_kernels=((2, 2), None), pool_strides=((1, 2), None), conv_padding=1, n_layers=2),
    dict(input_hw=(11, 64), conv_kernels=(5,), conv_strides=None, pool_kernels=None,
         pool_strides=None, conv_padding=((2, 0),), n_layers=None),
    dict(input_hw=(40, 129), conv_kernels=((3, 1), (1, 3), 3), conv_strides=(1, 1, 2),
         pool_kernels=((1, 2), (1, 2), (2, 2)), pool_strides=(None, (1, 3), None),
         conv_padding=0, n_layers=3),
])
def test_cnn_output_dim_matches_jax(cfg):
    assert tbricks.cnn_output_dim(**cfg) == jbricks.cnn_output_dim(**cfg)


def test_loss_frame_bounds_match_jax():
    for win in (1, 15, 21):
        for part in ("all", "mid", "last", 0, 7):
            assert tcrnn.loss_frame_bounds(win, part) == jcrnn.loss_frame_bounds(win, part)
    with pytest.raises(ValueError):
        tcrnn.loss_frame_bounds(21, "first")


# ------------------------------------------------------------------ bricks
@pytest.mark.parametrize("cfg", [
    dict(features=(4, 8), conv_kernels=3, pool_kernels=((1, 4), (1, 2)),
         conv_padding=((0, 1), (0, 1))),
    dict(features=(3, 5), conv_kernels=(3, (1, 5)), conv_strides=((1, 2), 1),
         pool_kernels=((2, 2), None), pool_strides=((1, 2), None), conv_padding=1,
         pool_types="avg", conv_bias=[True, False]),
])
def test_cnn2d_matches_jax(cfg):
    x = np.random.default_rng(1).standard_normal((2, 13, 37, 2)).astype(np.float32)  # NHWC
    jm = jbricks.CNN2d(**cfg)
    variables = randomized(jm.init(jax.random.PRNGKey(0), x), seed=2)
    tm = tbricks.CNN2d(2, **cfg).eval()
    sd = _cnn(variables["params"], variables["batch_stats"], tm, "")
    tm.load_state_dict(sd)
    ref = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm", "rnn"])
@pytest.mark.parametrize("bidi", [False, True])
def test_rnn_mask_matches_jax(cell, bidi):
    """A 2-layer ``RNNMask`` (the ``RNN`` and ``FF`` bricks) of each cell,
    one- and bidirectional, on (B, C, T, F) windows (channels freq-stacked)."""
    x = np.random.default_rng(3).standard_normal((3, 2, 7, 9)).astype(np.float32)
    kw = dict(rnn_units=(6, 5), rnn_cell=cell, rnn_bi=bidi, ff_units=(9, 9),
              ff_activation=["relu", "sigmoid"], rnn_dropouts=0.3)
    ref, ours = pair(jcrnn.RNNMask(input_shape=(7, 18), **kw),
                     tcrnn.RNNMask(input_shape=(7, 18), **kw), x, seed=4)
    assert ours.shape == ref.shape == (3, 7, 9)
    np.testing.assert_allclose(ours, ref, atol=TOL)


def test_rnn_per_layer_bidirectional_spec_reads_as_the_jax_module_reads_it():
    """A per-layer list reaches the JAX brick as a tuple, which
    ``broadcast_arg`` repeats for every layer: both layers are
    bidirectional there, and in the port."""
    x = np.random.default_rng(5).standard_normal((2, 6, 8)).astype(np.float32)
    kw = dict(rnn_units=(4, 3), rnn_bi=[True, False], ff_units=(5,))
    tm = tcrnn.RNNMask(input_shape=(6, 8), **kw)
    assert tm.rnn.bidirectional == [True, True]
    ref, ours = pair(jcrnn.RNNMask(input_shape=(6, 8), **kw), tm, x)
    np.testing.assert_allclose(ours, ref, atol=TOL)


# -------------------------------------------------------------------- CRNN
CRNN_CFGS = {
    "canonical-narrow": dict(cnn_filters=(4, 8), pool_kernels=((1, 4), (1, 4)),
                             conv_padding=((0, 1), (0, 1)), rnn_units=(16,), ff_units=(33,)),
    "time-padded": dict(cnn_filters=(3, 4), conv_kernels=3, conv_strides=((1, 1), (2, 1)),
                        pool_kernels=((2, 2), None), conv_padding=1, pool_types="avg",
                        rnn_units=(8,), ff_units=(33,)),
    "lstm-bidi-2": dict(cnn_filters=(4,), pool_kernels=((1, 4),), conv_padding=((0, 1),),
                        rnn_units=(6, 5), rnn_cell="lstm", rnn_bi=True, ff_units=(20, 33),
                        ff_activation=("tanh", "sigmoid")),
}


@pytest.mark.parametrize("name,n_ch", [("canonical-narrow", 2), ("time-padded", 1),
                                       ("lstm-bidi-2", 3)])
def test_crnn_windowed_matches_jax(name, n_ch):
    cfg = CRNN_CFGS[name]
    x = np.random.default_rng(6).standard_normal((3, n_ch, 21, 33)).astype(np.float32)
    jm = jcrnn.CRNN(input_shape=(n_ch, 21, 33), **cfg)
    tm = tcrnn.CRNN(input_shape=(n_ch, 21, 33), **cfg)
    assert tm.conv_output_hw() == jm.conv_output_hw()
    for part in ("last", "mid", "all"):
        assert tm.loss_frames(part) == jm.loss_frames(part)
    ref, ours = pair(jm, tm, x, seed=7)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=TOL)


def test_crnn_three_d_input_gets_a_channel_axis():
    cfg = CRNN_CFGS["canonical-narrow"]
    x = np.random.default_rng(8).standard_normal((2, 21, 33)).astype(np.float32)
    ref, ours = pair(jcrnn.CRNN(input_shape=(1, 21, 33), **cfg),
                     tcrnn.CRNN(input_shape=(1, 21, 33), **cfg), x, seed=9)
    np.testing.assert_allclose(ours, ref, atol=TOL)


def test_crnn_stream_mode_matches_jax_and_the_windows():
    """Stream mode on (B, C, F, Tp) full streams against the JAX package's
    stream mode, and against the windowed mode on every window."""
    cfg = CRNN_CFGS["canonical-narrow"]
    x = np.abs(np.random.default_rng(10).standard_normal((2, 2, 33, 30))).astype(np.float32)
    jm, tm = jcrnn.CRNN(input_shape=(2, 21, 33), **cfg), tcrnn.CRNN(input_shape=(2, 21, 33), **cfg)
    ref, ours = pair(jm, tm, x, seed=11, stream=True)
    assert ours.shape == ref.shape == (2, 10, 17, 33)
    np.testing.assert_allclose(ours, ref, atol=TOL)
    wins = np.stack([x[..., t:t + 21] for t in range(10)], 1)             # (B, T, C, F, win)
    wins = wins.transpose(0, 1, 2, 4, 3).reshape(20, 2, 21, 33)
    with torch.no_grad():
        per_window = tm(torch.from_numpy(wins)).numpy().reshape(2, 10, 17, 33)
    np.testing.assert_allclose(ours, per_window, atol=TOL)


def test_canonical_width_crnn_matches_jax():
    """The canonical DISCO CRNN at full width — (8, 21, 257), conv (32, 64,
    64), GRU 256, FF 257 — on a short stream, in stream mode."""
    x = np.abs(np.random.default_rng(12).standard_normal((1, 8, 257, 24))).astype(np.float32)
    jm = jcrnn.CRNN(input_shape=(8, 21, 257))
    tm = tcrnn.build_crnn(n_ch=8)
    ref, ours = pair(jm, tm, x, seed=13, stream=True)
    assert ours.shape == ref.shape == (1, 4, 15, 257)
    np.testing.assert_allclose(ours, ref, atol=TOL)


def test_build_functions_match_jax_configurations():
    jm, _ = jcrnn.build_crnn(n_ch=3)
    tm = tcrnn.build_crnn(n_ch=3)
    assert tm.input_shape == tuple(jm.input_shape) == (3, 21, 257)
    assert tm.conv_output_hw() == jm.conv_output_hw() == (15, 4)
    assert tm.rnn.layers[0].hidden_size == 256 and tm.ff.out_features == 257
    jr, _ = jcrnn.build_rnn(n_ch=2, win_len=11, n_freq=33)
    tr = tcrnn.build_rnn(n_ch=2, win_len=11, n_freq=33)
    assert tr.input_shape == tuple(jr.input_shape) == (11, 66)
    assert tr.conv_output_hw() == jr.conv_output_hw()
    assert tr.loss_frames("mid") == jr.loss_frames("mid")
    x = np.random.default_rng(14).standard_normal((2, 2, 11, 33)).astype(np.float32)
    ref, ours = pair(jr, tr, x, seed=15)
    np.testing.assert_allclose(ours, ref, atol=TOL)


def test_converter_rejects_a_mismatched_configuration():
    jm = jcrnn.CRNN(input_shape=(1, 21, 33), **CRNN_CFGS["canonical-narrow"])
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, 1, 21, 33), np.float32)))
    wider = tcrnn.CRNN(input_shape=(1, 21, 33), **{**CRNN_CFGS["canonical-narrow"],
                                                   "rnn_units": (12,)})
    with pytest.raises(ValueError, match="rnn.layers.0"):
        state_dict_from_flax(variables, wider)
    bidi = tcrnn.CRNN(input_shape=(1, 21, 33), **{**CRNN_CFGS["canonical-narrow"],
                                                  "rnn_bi": True})
    with pytest.raises((ValueError, KeyError)):
        state_dict_from_flax(variables, bidi)
