"""The port's configuration tree (``disco_tpu_torch.config``) against the
JAX package's (``disco_tpu.config``): the same dataclasses, fields and
defaults, and ``config_from_dict``/``load_config`` giving equal field
values on the same YAML and JSON files, with the same errors."""
import dataclasses
import json

import pytest

from disco_tpu import config as jcfg
from disco_tpu_torch import config as tcfg

SECTIONS = ("stft", "array", "enhance", "train", "corpus", "mesh", "room", "signal")
#: a file that touches every section (lists where the dataclasses hold tuples)
CONFIG = {
    "root": "corpora/disco",
    "stft": {"n_fft": 1024, "hop": 512},
    "array": {"mics_per_node": [2, 2, 3], "ref_mics": [0, 1, 0], "radius_m": 0.07},
    "enhance": {"solver": "jacobi:6", "mu": 1.5, "snr_range": [[0, 6], [6, 12]]},
    "train": {"batch_size": 64, "filters": [16, 32], "grad_clip": 1.0},
    "corpus": {"n_train": 20, "scenario": "meeting", "noise": "fs"},
    "mesh": {"n_node": 2, "n_batch": 2},
    "room": {"n_sources": 3},
    "signal": {"duration_range": [4, 8]},
}


def _plain(cfg):
    return jcfg._to_plain(cfg)


def test_dataclasses_and_defaults_match_jax():
    for name in SECTIONS:
        ours, theirs = tcfg._SECTIONS[name], jcfg._SECTIONS[name]
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)], name
    assert _plain(tcfg.DiscoConfig()) == _plain(jcfg.DiscoConfig())
    assert tcfg.StftConfig().n_freq == 257 and tcfg.ArrayConfig().n_channels == 16
    assert tcfg.CorpusConfig().splits == jcfg.CorpusConfig().splits


def test_config_from_dict_matches_jax():
    ours, theirs = tcfg.config_from_dict(CONFIG), jcfg.config_from_dict(CONFIG)
    assert _plain(ours) == _plain(theirs)
    assert ours.array.mics_per_node == (2, 2, 3) and ours.enhance.snr_range == ((0, 6), (6, 12))
    assert ours.array.n_nodes == theirs.array.n_nodes == 3


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_load_config_matches_jax_on_the_same_file(tmp_path, suffix):
    path = tmp_path / f"cfg{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(CONFIG))
    else:
        jcfg.save_config(jcfg.config_from_dict(CONFIG), path)
    ours = tcfg.load_config(path)
    assert _plain(ours) == _plain(jcfg.config_from_dict(CONFIG))
    assert _plain(ours) == _plain(jcfg.load_config(path))  # the JAX loader reads YAML


def test_save_config_round_trips_through_both_loaders(tmp_path):
    cfg = tcfg.config_from_dict(CONFIG)
    path = tcfg.save_config(cfg, tmp_path / "sub" / "saved.yaml")
    assert path.read_text() == jcfg.save_config(jcfg.config_from_dict(CONFIG),
                                                tmp_path / "jax.yaml").read_text()
    assert _plain(tcfg.load_config(path)) == _plain(cfg)
    assert _plain(jcfg.load_config(path)) == _plain(cfg)


def test_empty_file_is_the_defaults(tmp_path):
    (tmp_path / "empty.yaml").write_text("")
    assert _plain(tcfg.load_config(tmp_path / "empty.yaml")) == _plain(tcfg.DiscoConfig())


@pytest.mark.parametrize("bad", [{"garden": {}}, {"enhance": {"sovler": "eigh"}},
                                 {"room": {"radius": 1}}])
def test_errors_match_jax(bad):
    msgs = []
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError) as e:
            mod.config_from_dict(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
