"""The port's corpus milestones (``disco_tpu_torch.milestones_corpus``) and
its ``disco-torch-milestones`` CLI against the JAX package's, on the CPU
(``device="cpu"``), one torch and one BLAS thread for the module
(``torch_port_helpers.one_host_thread``).

* ``synth_speech_tree``: the same WAV bytes as the JAX package's from a
  seed (host numpy and scipy, draw for draw).
* ``meetit_corpus_milestone(n_rirs=1, n_src=2, max_order=4)``: both
  packages generate their own corpus from the same seed; the scores within
  ``TOL_DB`` of the JAX package's and through ``tests/
  test_corpus_milestone.py``'s gates.
* ``corpus_milestone(n_rirs=2, n_epochs=1, max_order=4)``: the whole
  gen → mix → z → train → tango workflow through the port's CLIs, held to
  the JAX test's assertions (its JAX twin is marked slow and is not run
  here).
* the CLI: the JAX parser's flags plus ``--device``, and the JSON lines.
"""
import json

import numpy as np
import pytest
import torch

from disco_tpu_torch import milestones_corpus
from disco_tpu_torch.cli import bench_milestones
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

#: the MEETIT milestone's scores, port vs JAX package, in dB
TOL_DB = 0.05


def test_synth_speech_tree_is_byte_identical(tmp_path):
    from disco_tpu import milestones_corpus as jmc

    ours = milestones_corpus.synth_speech_tree(tmp_path / "port", n_speakers=2, dur_s=1.5, seed=3)
    theirs = jmc.synth_speech_tree(tmp_path / "jax", n_speakers=2, dur_s=1.5, seed=3)
    files = sorted(p.relative_to(ours) for p in ours.rglob("*.wav"))
    assert files == sorted(p.relative_to(theirs) for p in theirs.rglob("*.wav"))
    assert len(files) == 6
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f


def test_delta_from_results_matches_jax():
    from disco_tpu import milestones_corpus as jmc

    rng = np.random.default_rng(5)
    res = {k: rng.standard_normal(8) for k in
           ("sdr_cnv", "sdr_in_cnv", "si_sdr_cnv", "si_sdr_in_cnv", "delta_stoi_cnv")}
    assert milestones_corpus._delta_from_results(res) == jmc._delta_from_results(res)


@pytest.fixture(scope="module")
def meetit(tmp_path_factory):
    from disco_tpu import milestones_corpus as jmc

    kw = dict(n_rirs=1, n_src=2, max_order=4)
    return (milestones_corpus.meetit_corpus_milestone(tmp_path_factory.mktemp("port"), **kw,
                                                      device="cpu"),
            jmc.meetit_corpus_milestone(tmp_path_factory.mktemp("jax"), **kw))


def test_meetit_corpus_milestone_passes_the_jax_gates(meetit):
    out = meetit[0]
    assert out["config"] == "meetit_corpus_separation"
    assert out["pairs_scored"] == 2
    assert out["delta_si_sir_min"] > 3.0, out
    assert out["delta_si_sdr_mean"] > 1.0, out


def test_meetit_corpus_milestone_matches_jax(meetit):
    ours, theirs = meetit
    assert ours.keys() == theirs.keys()
    for key, want in theirs.items():
        if isinstance(want, float):
            assert abs(ours[key] - want) < TOL_DB, (key, ours[key], want)
        else:
            assert ours[key] == want, key


def test_corpus_milestone_tiny(tmp_path):
    out = milestones_corpus.corpus_milestone(tmp_path, n_rirs=2, n_epochs=1, max_order=4,
                                             device="cpu")
    assert out["config"] == "corpus_pipeline"
    assert set(out) >= {"tango_4node_oracle", "tango_4node_crnn"}
    for entry in (out["tango_4node_oracle"], out["tango_4node_crnn"]):
        for key in ("delta_sdr_512tap", "delta_si_sdr", "delta_stoi"):
            assert np.isfinite(entry[key]), (entry, key)
    assert out["tango_4node_oracle"]["delta_sdr_512tap"] > 2.0
    assert len(list((tmp_path / "models").glob("*_model.msgpack"))) == 2


# -------------------------------------------------------------------- CLI
def test_bench_parser_is_the_jax_parser_plus_device():
    from disco_tpu.cli import bench_milestones as jbench
    from tests.test_torch_port_cli import _actions

    theirs = _actions(jbench.build_parser())
    ours = _actions(bench_milestones.build_parser())
    assert {k: ours[k] for k in theirs} == theirs
    extra = {k: v for k, v in ours.items() if k not in theirs}
    assert list(extra) == [(("--device",),)]
    assert extra[(("--device",),)][:4] == ("device", "cuda", ["cuda", "cpu"], None)


def test_corpus_parser_is_the_jax_flags_plus_device():
    from tests.test_torch_port_cli import _actions

    ours = _actions(milestones_corpus.build_parser())
    assert sorted(k[0][0] for k in ours) == ["--device", "--epochs", "--meetit", "--noise",
                                          "--rirs", "--scenario", "--workdir"]
    args = milestones_corpus.build_parser().parse_args([])
    assert (args.rirs, args.epochs, args.scenario, args.noise, args.device) == (
        4, 8, "random", "ssn", "cuda")


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_bench_main_prints_the_jax_keys(capsys):
    from disco_tpu.cli import bench_milestones as jbench

    results = bench_milestones.main(["--tiny", "--configs", "1", "2", "--device", "cpu"])
    ours = _json_lines(capsys.readouterr().out)
    jbench.main(["--tiny", "--configs", "1", "2"])
    theirs = _json_lines(capsys.readouterr().out)
    assert ours == results and len(ours) == 2
    assert [r["config"] for r in ours] == ["mvdr_single_clip", "disco_mwf_4node"]
    assert [set(r) for r in ours] == [set(r) for r in theirs]


@pytest.mark.parametrize("call", [
    lambda tmp: milestones_corpus.corpus_milestone(tmp),
    lambda tmp: milestones_corpus.meetit_corpus_milestone(tmp),
    lambda tmp: milestones_corpus.main(["--workdir", str(tmp)]),
    lambda tmp: bench_milestones.main(["--tiny", "--configs", "1"]),
], ids=["corpus", "meetit", "corpus-main", "bench-main"])
def test_refuses_without_cuda(call, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(tmp_path)
    assert not (tmp_path / "libri").exists()
