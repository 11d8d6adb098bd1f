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

Weights saved as msgpack by the JAX package's generation store are not
read here yet (the card has neither ``msgpack`` nor ``flax``).
"""
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
