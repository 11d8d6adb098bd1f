"""The port's single-clip corpus entry point ``enhance_rir`` — the staged
lane (length-bucketed, under a fault scenario), the streaming lane and its
fault seam — and the
batched driver under a fault scenario, against the JAX package on its
miniature corpus (4 nodes x 2 mics, 2-s clips, two RIRs), the port with
``device="cpu"``; the bounds of tests/test_torch_port_driver.py.

The streaming lane runs on the corpus scaled by 1e-3, and its files are
compared after the first refresh block (``update_every`` = 4 frames), the
well-posed comparison of tests/test_torch_port_streaming.py: from the warm
start ``R0 = 1e-6 I`` at the corpus's natural level the first refresh's
generalized eigenvalue is degenerate, so its filter is set by roundoff in
either framework and the difference decays only as 0.99^t (on this corpus
at its natural level ``si_sir_dry`` of a 60-dB node moves by 0.03 dB).
Scoring skips the first second, so every metric is compared in full.  The
streaming fault case drops a node and corrupts another (both held from
the first block on); per-block link loss is left out here, because a lost
block holds the first block's roundoff-set z past the skipped frames.
Each case's runs are recorded, each package under its own recorder, and
the two event logs are held to each other.
"""
import pickle

import numpy as np
import pytest

import disco_tpu.obs as jobs
import disco_tpu_torch.obs as tobs
from disco_tpu.enhance import driver as jdriver
from disco_tpu.runs import check as jcheck
from disco_tpu_torch.enhance import driver as tdriver
from disco_tpu_torch.enhance.streaming import DEFAULT_UPDATE_EVERY
from disco_tpu_torch.io.audio import read_wav, write_wav
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread: a fixture)
    artifact_errors, artifact_paths, assert_counters_match, assert_events_match,
    assert_results_close, one_host_thread, recorded)

TOL = 1e-4
QUIET = 1e-3
RIRS, NOISE, SNR, K, C = jcheck.RIRS, jcheck.NOISE, jcheck.SNR_RANGE, jcheck.K, jcheck.C
FAULT = {"seed": 3, "node_dropout": [1], "nan_z": [2]}
STREAM_FAULT = {"seed": 7, "node_dropout": [1], "nan_z": [3]}
#: lane -> (corpus, enhance_rir keyword arguments, STFT frames left out)
CASES = {
    "staged_fault": ("natural", {"fault_spec": FAULT, "bucket": 8192}, 0),
    "streaming": ("quiet", {"streaming": True}, DEFAULT_UPDATE_EVERY),
    "streaming_fault": ("quiet", {"streaming": True, "fault_spec": STREAM_FAULT},
                        DEFAULT_UPDATE_EVERY),
}
pytestmark = pytest.mark.usefixtures("one_host_thread")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    natural = jcheck._mini_corpus(tmp_path_factory.mktemp("natural"))
    quiet = jcheck._mini_corpus(tmp_path_factory.mktemp("quiet"))
    for p in quiet.rglob("*.wav"):
        x, fs = read_wav(p)
        write_wav(p, x * QUIET, fs)
    return {"natural": natural, "quiet": quiet}


@pytest.fixture(scope="module")
def logged_runs(corpora, tmp_path_factory):
    """{case: (port results, JAX results, port tree, JAX tree, port events,
    JAX events)}, each package's clips under its own recorder."""
    out = {}
    for case, (corpus, kw, _) in CASES.items():
        trees = tmp_path_factory.mktemp(case)
        res, ev = {}, {}
        for name, mod, obs, extra in (("port", tdriver, tobs, {"device": "cpu"}),
                                      ("jax", jdriver, jobs, {"save_fig": False})):
            res[name], ev[name] = recorded(obs, trees / f"{name}.jsonl", lambda: {
                rir: mod.enhance_rir(str(corpora[corpus]), "living", rir, NOISE,
                                     snr_range=SNR, out_root=str(trees / name), n_nodes=K,
                                     mics_per_node=C, **kw, **extra)
                for rir in RIRS})
        out[case] = (res["port"], res["jax"], trees / "port", trees / "jax", ev["port"],
                     ev["jax"])
    return out


@pytest.fixture(scope="module")
def runs(logged_runs):
    """{case: (port results, JAX results, port tree, JAX tree)}."""
    return {case: r[:4] for case, r in logged_runs.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_enhance_rir_matches_jax(runs, case):
    ours, theirs, ours_tree, theirs_tree = runs[case]
    assert_results_close(ours, theirs)
    assert artifact_paths(ours_tree) == artifact_paths(theirs_tree)
    errs = artifact_errors(ours_tree, theirs_tree, skip_frames=CASES[case][2])
    assert len(errs) == len(RIRS) * 10 * K
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda pe: pe[1])


def test_fault_case_is_degraded(runs):
    """The injected faults reached the pipeline: the NaN node's step-1
    output is NaN and scores as NaN, the others are finite."""
    tree = runs["staged_fault"][2]
    for rir in RIRS:
        assert np.isfinite(runs["staged_fault"][0][rir]["sdr_cnv"]).all()
        with open(tree / "OIM" / f"results_mwf_{rir}_{NOISE}.p", "rb") as fh:
            mwf = pickle.load(fh)["sdr_cnv"]
        assert np.isnan(mwf[2]) and np.isfinite(np.delete(mwf, 2)).all()
    mid = read_wav(tree / "WAV" / str(RIRS[0]) / f"mid_z-{NOISE}_Node-3.wav")[0]
    assert np.isnan(mid).all()


def test_batched_fault_scenario_matches_jax(corpora, tmp_path):
    res, trees = {}, {}
    for name, mod, extra in (("port", tdriver, {"device": "cpu"}),
                             ("jax", jdriver, {"save_fig": False})):
        trees[name] = tmp_path / name
        res[name] = mod.enhance_rirs_batched(str(corpora["natural"]), "living", list(RIRS), NOISE,
                                             snr_range=SNR, out_root=str(trees[name]), n_nodes=K,
                                             mics_per_node=C, max_batch=2, score_workers=2,
                                             fault_spec=FAULT, **extra)
    assert_results_close(res["port"], res["jax"])
    errs = artifact_errors(trees["port"], trees["jax"])
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda pe: pe[1])


#: the counters both packages count the same on these runs (the signature
#: counts of the module-level streaming entry point depend on what the
#: process ran before; tests/test_torch_port_sentinels.py holds them)
LANE_COUNTERS = ("clips_enhanced", "device_get_batches", "fences", "sentinel_checks",
                 "sentinel_trips", "faults_injected", "fault_blocks_lost", "degraded_clips")


@pytest.mark.parametrize("case", list(CASES))
def test_events_match_jax(logged_runs, case):
    """Every clip's stage spans (load_input, stft, masks, mwf, istft,
    score_persist), sentinels, fault and degraded events, and the
    counters: the same in both packages but timings.  A ``jit_trace`` of
    the streaming entry point depends on what the process ran before, so
    it is left out here."""
    ours, theirs = ([e for e in events if e["kind"] != "jit_trace"]
                    for events in logged_runs[case][4:])
    stages = [e["stage"] for e in ours if e["kind"] == "stage_end"]
    assert stages == ["load_input", "stft", "masks", "mwf", "istft", "score_persist"] * len(RIRS)
    if "fault_spec" in CASES[case][1]:
        assert {e["attrs"]["fault"] for e in ours if e["kind"] == "fault"} == {
            "node_dropout", "nan_z"}
        assert sum(e["kind"] == "degraded" for e in ours) == len(RIRS)
    assert_events_match(ours, theirs)
    assert_counters_match(ours, theirs, LANE_COUNTERS)
