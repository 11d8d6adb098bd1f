"""The port's CRNNs start from weights drawn as the JAX package draws them:
flax's default initializers (ROADMAP Queue 3, fault 7).

The port draws from torch's generator, the JAX package from its PRNG key,
so the values differ; the scheme is held instead, leaf by leaf in the JAX
package's layout (``nn.convert.flax_from_state_dict``): every kernel of
fan-in ``n`` a truncated normal of standard deviation ``1 / sqrt(n)``
(lecun-normal), every recurrent kernel orthogonal gate by
gate, every bias 0, BatchNorm's scale 1.  Under torch's default scheme
(uniform kernels of a third of that variance, uniform biases) the trained
canonical CRNNs gain ~1 dB less SI-SDR than the JAX package's
(``exp/crnn_milestone_parity.py``).
"""
import jax
import numpy as np
import pytest
import torch

from disco_tpu.nn import crnn as jcrnn
from disco_tpu_torch.nn import crnn as tcrnn
from disco_tpu_torch.nn.convert import flax_from_state_dict

#: name -> (architecture, n_ch, extra build kwargs)
CASES = {
    "crnn n_ch 4": ("crnn", 4, {}),
    "rnn n_ch 2": ("rnn", 2, {}),
    "rnn lstm bidirectional": ("rnn", 1, {"rnn_cell": "lstm", "rnn_bi": True,
                                          "rnn_units": (32,)}),
}


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield "/".join(path + (key,)), value


def _check_scheme(name, w):
    """The flax default of the leaf ``name``; returns what was checked."""
    if name.endswith("bias"):
        assert not w.any(), name
        return "zero bias"
    if name.endswith("scale"):
        assert (w == 1).all(), name
        return "unit scale"
    gate = name.split("/")[-2]
    if gate.startswith("h"):  # a recurrent cell's hidden-side kernel
        np.testing.assert_allclose(w.T @ w, np.eye(w.shape[1]), atol=2e-5, err_msg=name)
        return "orthogonal"
    sigma = 1.0 / np.sqrt(np.prod(w.shape[:-1]))
    assert abs(w.std() / sigma - 1) < 0.15, (name, w.std(), sigma)
    assert abs(w.mean()) < 0.15 * sigma, (name, w.mean(), sigma)
    # truncated at two standard deviations of the normal before truncation,
    # which flax widens by 1 / 0.8796 so that the variance stays 1 / n
    assert np.abs(w).max() <= 2 * sigma / 0.87962566103423978 * (1 + 1e-6), (name, sigma)
    return "lecun-normal"


@pytest.mark.parametrize("case", list(CASES))
def test_initial_weights_follow_the_jax_package(case):
    archi, n_ch, kw = CASES[case]
    jbuild, tbuild = ((jcrnn.build_crnn, tcrnn.build_crnn) if archi == "crnn"
                      else (jcrnn.build_rnn, tcrnn.build_rnn))
    x = np.zeros((1, n_ch, 21, 257) if archi == "crnn" else (1, 21, n_ch * 257), np.float32)
    jmodel, _ = jbuild(n_ch=n_ch, **kw)
    # jitted: one compile (~3 s), where flax's eager init compiles op by op
    keys = dict(zip(("params", "dropout"), jax.random.split(jax.random.PRNGKey(0))))
    theirs = dict(_leaves(jax.jit(jmodel.init)(keys, x)["params"]))
    torch.manual_seed(0)
    model = tbuild(n_ch=n_ch, **kw)
    ours = dict(_leaves(flax_from_state_dict(model.state_dict(), model)["params"]))
    assert ours.keys() == theirs.keys()
    kinds = {}
    for name, ref in theirs.items():
        assert ours[name].shape == ref.shape, name
        kind = _check_scheme(name, np.asarray(ref, np.float64))  # the reference's own scheme
        assert _check_scheme(name, np.asarray(ours[name], np.float64)) == kind
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds["lecun-normal"] >= 2 and kinds["zero bias"] >= 2 and kinds["orthogonal"] >= 3
