"""The JAX package's weights carried across to the port's modules.

:func:`state_dict_from_flax` takes the variables of a ``disco_tpu.nn``
module — ``{'params': …, 'batch_stats': …}`` as nested dicts of numpy
arrays, what ``jax.device_get(variables)`` returns — and the port's module
of the same configuration, and returns that module's ``state_dict``.
The conventions, each pinned by a parity test against the JAX package:

* Conv kernels ``(kh, kw, in, out)`` → ``(out, in, kh, kw)``; Dense
  kernels ``(in, out)`` → ``(out, in)``; BatchNorm ``scale``/``bias`` →
  ``weight``/``bias``, ``mean``/``var`` → ``running_mean``/``running_var``.
* Recurrent cells are numbered ``<Cell>_0, <Cell>_1, …`` in creation
  order: per layer the forward cell, then the backward one if the layer is
  bidirectional (torch's ``_reverse`` weights).
* ``GRUCell``: rows ``[r, z, n]``; flax has no hidden-side r/z bias, so
  those rows of ``bias_hh`` are 0 and ``hn``'s bias is their n row.
* ``OptimizedLSTMCell``: rows ``[i, f, g, o]``; the input kernels carry no
  bias (``bias_ih`` is 0), the hidden ones do (``bias_hh``).
* ``SimpleCell``: ``i`` (with bias) → ``*_ih``, ``h`` (no bias) →
  ``*_hh`` with a zero ``bias_hh``.

:func:`flax_from_state_dict` is the way back: a module's ``state_dict``
(or any name → tensor map over its parameters, such as the optimizer's
``nu``) as the flax variable tree, for checkpoints the JAX package reads.
Rows that flax does not have — a GRU's hidden-side r/z biases, an LSTM's
input-side biases, a simple cell's hidden-side bias — are left out; they
are held at 0 in training (:func:`flax_absent`).  The msgpack files of the
JAX package (``nn/training.py`` checkpoints, ``promote/store.py``
generations) decode with :mod:`.serialization`, which needs neither
``msgpack`` nor ``flax``.
"""
# disco-torch-lint: file-disable=DL002 -- the flax-to-torch weight converter reads host numpy params (msgpack-decoded variables); no tensor reaches its np.asarray calls
from __future__ import annotations

import numpy as np
import torch

from disco_tpu_torch.nn.bricks import CNN2d, FF, RNN

_CELL_NAMES = {"gru": "GRUCell", "lstm": "OptimizedLSTMCell", "rnn": "SimpleCell"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cnn(params, stats, cnn: CNN2d, prefix: str) -> dict:
    out = {}
    for i, conv in enumerate(cnn.convs):
        p = params[f"Conv_{i}"]
        out[f"{prefix}convs.{i}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        if conv.bias is not None:
            out[f"{prefix}convs.{i}.bias"] = _t(p["bias"])
        bn_p, bn_s = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
        out[f"{prefix}bns.{i}.weight"] = _t(bn_p["scale"])
        out[f"{prefix}bns.{i}.bias"] = _t(bn_p["bias"])
        out[f"{prefix}bns.{i}.running_mean"] = _t(bn_s["mean"])
        out[f"{prefix}bns.{i}.running_var"] = _t(bn_s["var"])
        out[f"{prefix}bns.{i}.num_batches_tracked"] = torch.tensor(0)
    return out


def _cell(p, cell_type: str) -> dict:
    """One flax cell's params as torch's (weight_ih, weight_hh, bias_ih,
    bias_hh) of one direction of one layer."""
    def k(name):
        return np.asarray(p[name]["kernel"]).T

    if cell_type == "gru":
        hid = np.asarray(p["hn"]["bias"]).shape[0]
        return {
            "weight_ih": np.concatenate([k("ir"), k("iz"), k("in")]),
            "weight_hh": np.concatenate([k("hr"), k("hz"), k("hn")]),
            "bias_ih": np.concatenate([np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")]),
            "bias_hh": np.concatenate([np.zeros(2 * hid, np.float32), np.asarray(p["hn"]["bias"])]),
        }
    if cell_type == "lstm":
        gates = ("i", "f", "g", "o")
        bias_hh = np.concatenate([np.asarray(p["h" + g]["bias"]) for g in gates])
        return {
            "weight_ih": np.concatenate([k("i" + g) for g in gates]),
            "weight_hh": np.concatenate([k("h" + g) for g in gates]),
            "bias_ih": np.zeros_like(bias_hh),
            "bias_hh": bias_hh,
        }
    bias = np.asarray(p["i"]["bias"])
    return {"weight_ih": k("i"), "weight_hh": k("h"), "bias_ih": bias,
            "bias_hh": np.zeros_like(bias)}


def _rnn(params, rnn: RNN, prefix: str) -> dict:
    out, cell_no = {}, 0
    name = _CELL_NAMES[rnn.cell_type]
    for i, bidi in enumerate(rnn.bidirectional):
        for suffix in ("", "_reverse") if bidi else ("",):
            for key, v in _cell(params[f"{name}_{cell_no}"], rnn.cell_type).items():
                out[f"{prefix}layers.{i}.{key}_l0{suffix}"] = _t(v)
            cell_no += 1
    return out


def _ff(params, ff: FF, prefix: str) -> dict:
    out = {}
    for i in range(len(ff.layers)):
        p = params[f"Dense_{i}"]
        out[f"{prefix}layers.{i}.weight"] = _t(np.asarray(p["kernel"]).T)
        out[f"{prefix}layers.{i}.bias"] = _t(p["bias"])
    return out


def state_dict_from_flax(variables, model: torch.nn.Module) -> dict:
    """The ``state_dict`` of ``model`` (a port :class:`~.crnn.CRNN` or
    :class:`~.crnn.RNNMask`) holding the JAX package's ``variables`` for
    the module of the same configuration.  Load it with
    ``model.load_state_dict(sd)``.

    Raises ValueError when a tensor's shape or the set of names does not
    match the model's (a configuration mismatch).
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {}
    if hasattr(model, "cnn"):
        out.update(_cnn(params["CNN2d_0"], stats.get("CNN2d_0", {}), model.cnn, "cnn."))
    out.update(_rnn(params["RNN_0"], model.rnn, "rnn."))
    out.update(_ff(params["FF_0"], model.ff, "ff."))
    want = model.state_dict()
    if set(out) != set(want):
        raise ValueError(f"flax variables do not match the model: missing {sorted(set(want) - set(out))}, "
                         f"unexpected {sorted(set(out) - set(want))}")
    for key, v in out.items():
        if v.shape != want[key].shape:
            raise ValueError(f"{key}: flax gives {tuple(v.shape)}, the model holds "
                             f"{tuple(want[key].shape)}")
    return out


# ---------------------------------------------------------------- way back
def flax_absent(model: torch.nn.Module) -> list:
    """``(parameter name, row slice)`` of every block of the port's
    parameters that the flax module does not have: the r and z rows of a
    GRU's ``bias_hh``, an LSTM's ``bias_ih`` and a simple cell's
    ``bias_hh``.  They are 0 in a converted model; training zeroes their
    gradients so they stay 0 and the model stays the flax module's."""
    out = []
    rnn = getattr(model, "rnn", None)
    if rnn is None:
        return out
    for i, bidi in enumerate(rnn.bidirectional):
        layer = rnn.layers[i]
        for suffix in ("", "_reverse") if bidi else ("",):
            if rnn.cell_type == "gru":
                out.append((f"rnn.layers.{i}.bias_hh_l0{suffix}", slice(0, 2 * layer.hidden_size)))
            elif rnn.cell_type == "lstm":
                out.append((f"rnn.layers.{i}.bias_ih_l0{suffix}", slice(None)))
            else:
                out.append((f"rnn.layers.{i}.bias_hh_l0{suffix}", slice(None)))
    return out


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy()) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cnn_back(sd, cnn: CNN2d, prefix: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for i, conv in enumerate(cnn.convs):
        p = {"kernel": np.ascontiguousarray(np.transpose(_np(sd[f"{prefix}convs.{i}.weight"]),
                                                         (2, 3, 1, 0)))}
        if conv.bias is not None:
            p["bias"] = _np(sd[f"{prefix}convs.{i}.bias"])
        params[f"Conv_{i}"] = p
        params[f"BatchNorm_{i}"] = {"bias": _np(sd[f"{prefix}bns.{i}.bias"]),
                                    "scale": _np(sd[f"{prefix}bns.{i}.weight"])}
        key = f"{prefix}bns.{i}.running_mean"
        if key in sd:
            stats[f"BatchNorm_{i}"] = {"mean": _np(sd[key]),
                                       "var": _np(sd[f"{prefix}bns.{i}.running_var"])}
    return params, stats


def _cell_back(w: dict, cell_type: str) -> dict:
    """torch's (weight_ih, weight_hh, bias_ih, bias_hh) of one direction of
    one layer as one flax cell's params."""
    def dense(mat, bias=None):
        d = {"kernel": np.ascontiguousarray(mat.T)}
        if bias is not None:
            d["bias"] = bias
        return d

    wi, wh, bi, bh = (_np(w[k]) for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    if cell_type == "gru":
        h = wh.shape[1]
        rows = {g: slice(j * h, (j + 1) * h) for j, g in enumerate("rzn")}
        out = {f"i{g}": dense(wi[rows[g]], bi[rows[g]]) for g in "rzn"}
        out.update({f"h{g}": dense(wh[rows[g]]) for g in "rz"})
        out["hn"] = dense(wh[rows["n"]], bh[rows["n"]])
        return out
    if cell_type == "lstm":
        h = wh.shape[1]
        out = {}
        for j, g in enumerate("ifgo"):
            rows = slice(j * h, (j + 1) * h)
            out[f"i{g}"] = dense(wi[rows])
            out[f"h{g}"] = dense(wh[rows], bh[rows])
        return out
    return {"i": dense(wi, bi), "h": dense(wh)}


def _rnn_back(sd, rnn: RNN, prefix: str) -> dict:
    out, cell_no = {}, 0
    name = _CELL_NAMES[rnn.cell_type]
    for i, bidi in enumerate(rnn.bidirectional):
        for suffix in ("", "_reverse") if bidi else ("",):
            w = {k: sd[f"{prefix}layers.{i}.{k}_l0{suffix}"]
                 for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            out[f"{name}_{cell_no}"] = _cell_back(w, rnn.cell_type)
            cell_no += 1
    return out


def _ff_back(sd, ff: FF, prefix: str) -> dict:
    return {f"Dense_{i}": {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}layers.{i}.weight"]).T),
                           "bias": _np(sd[f"{prefix}layers.{i}.bias"])}
            for i in range(len(ff.layers))}


def flax_from_state_dict(state_dict, model: torch.nn.Module) -> dict:
    """The inverse of :func:`state_dict_from_flax`: ``{'params': …,
    'batch_stats': …}`` as nested dicts of float32 numpy arrays, in the
    layout of the JAX package's module of ``model``'s configuration.
    ``state_dict`` may hold the parameters only (a map over
    ``model.named_parameters()``, e.g. the optimizer's ``nu``): then
    ``batch_stats`` is empty.  The rows of :func:`flax_absent` are dropped."""
    sd = dict(state_dict)
    params, stats = {}, {}
    if hasattr(model, "cnn"):
        params["CNN2d_0"], cnn_stats = _cnn_back(sd, model.cnn, "cnn.")
        if cnn_stats:
            stats["CNN2d_0"] = cnn_stats
    params["RNN_0"] = _rnn_back(sd, model.rnn, "rnn.")
    params["FF_0"] = _ff_back(sd, model.ff, "ff.")
    return {"params": params, "batch_stats": stats}


def params_from_flax(params, model: torch.nn.Module) -> dict:
    """``{parameter name: tensor}`` over ``model.named_parameters()`` from
    a flax params tree (the ``params`` of a checkpoint, or optax's ``nu``,
    which has the same layout).  The rows of :func:`flax_absent` are 0."""
    stats = flax_from_state_dict(model.state_dict(), model)["batch_stats"]
    sd = state_dict_from_flax({"params": params, "batch_stats": stats}, model)
    names = dict(model.named_parameters())
    return {k: v for k, v in sd.items() if k in names}
