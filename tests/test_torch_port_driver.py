"""The port's corpus driver (``disco_tpu_torch.enhance.driver``) against the
JAX package's on the JAX package's miniature corpus (``runs.check.
_mini_corpus``: 4 nodes x 2 mics, 2-s clips, two RIRs), the port with
``device="cpu"``: the staged and the chained lane of
``enhance_rirs_batched``, ``aggregate_results`` across packages and
``export_z``.

Bounds: the same set of relative artifact paths; every metric key within
``rtol=2e-4, atol=1e-3`` dB (the bound of tests/test_driver.py:342) and the
STOI deltas within 1e-4; every WAV, mask and z file within 1e-4 of its
output scale.  Each JAX driver run is a module-scoped fixture, recorded:
each package's run writes its own event log (``obs.recording``, the
registry reset first), and the two logs are held to each other — the same
events but timings, the same deterministic counters.
"""
import pickle

import numpy as np
import pytest

import disco_tpu.obs as jobs
import disco_tpu_torch.obs as tobs
from disco_tpu.enhance import driver as jdriver
from disco_tpu.enhance import zexport as jzexport
from disco_tpu.runs import check as jcheck
from disco_tpu_torch.enhance import driver as tdriver
from disco_tpu_torch.enhance import zexport as tzexport
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread: a fixture)
    artifact_errors, artifact_paths, assert_counters_match, assert_events_match,
    assert_results_close, one_host_thread, recorded)

TOL = 1e-4
RIRS, NOISE, SNR, K, C = jcheck.RIRS, jcheck.NOISE, jcheck.SNR_RANGE, jcheck.K, jcheck.C
LANES = {"staged": {}, "chained": {"chained": True}}
pytestmark = pytest.mark.usefixtures("one_host_thread")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return jcheck._mini_corpus(tmp_path_factory.mktemp("corpus"))


def _run(driver, corpus, out, **kw):
    if driver is jdriver:
        kw["save_fig"] = False
    else:
        kw["device"] = "cpu"
    return driver.enhance_rirs_batched(str(corpus), "living", list(RIRS), NOISE, snr_range=SNR,
                                       out_root=str(out), n_nodes=K, mics_per_node=C,
                                       max_batch=2, score_workers=2, **kw)


@pytest.fixture(scope="module")
def logged_runs(corpus, tmp_path_factory):
    """{lane: (port results, JAX results, port tree, JAX tree, port events,
    JAX events)}, each run under its own package's recorder."""
    out = {}
    for lane, kw in LANES.items():
        trees = tmp_path_factory.mktemp(lane)
        ours, ev_ours = recorded(tobs, trees / "port.jsonl",
                                 lambda: _run(tdriver, corpus, trees / "port", **kw))
        theirs, ev_theirs = recorded(jobs, trees / "jax.jsonl",
                                     lambda: _run(jdriver, corpus, trees / "jax", **kw))
        out[lane] = (ours, theirs, trees / "port", trees / "jax", ev_ours, ev_theirs)
    return out


@pytest.fixture(scope="module")
def runs(logged_runs):
    """{lane: (port results, JAX results, port tree, JAX tree)}."""
    return {lane: r[:4] for lane, r in logged_runs.items()}


@pytest.mark.parametrize("lane", list(LANES))
def test_same_artifact_paths(runs, lane):
    _, _, ours, theirs = runs[lane]
    paths = artifact_paths(theirs)
    assert len(paths) == len(RIRS) * (2 + 10 * K)
    assert artifact_paths(ours) == paths


@pytest.mark.parametrize("lane", list(LANES))
def test_metrics_match_jax(runs, lane):
    ours, theirs, _, _ = runs[lane]
    assert set(theirs) == set(RIRS)
    assert_results_close(ours, theirs)
    for rir in RIRS:  # the returned dict is what was pickled
        with open(runs[lane][2] / "OIM" / f"results_tango_{rir}_{NOISE}.p", "rb") as fh:
            saved = pickle.load(fh)
        assert set(saved) == set(ours[rir])
        for k in saved:
            np.testing.assert_array_equal(saved[k], ours[rir][k])


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("kind", ["WAV/", "MASK/", "STFT/z/"])
def test_artifacts_match_jax(runs, lane, kind):
    _, _, ours, theirs = runs[lane]
    errs = {p: e for p, e in artifact_errors(ours, theirs).items() if p.startswith(kind)}
    assert errs and max(errs.values()) <= TOL, max(errs.items(), key=lambda pe: pe[1])
    for p, e in errs.items():  # the inputs are written back untouched
        if "/in_" in p:
            assert e == 0.0, p


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("kind", ["tango", "mwf"])
def test_aggregate_results_across_packages(runs, lane, kind):
    """The JAX package's ``aggregate_results`` reads the port's pickles, and
    the port's aggregates the JAX package's the same way."""
    _, _, ours, theirs = runs[lane]
    jax_of_port = jdriver.aggregate_results(ours / "OIM", kind, noise=NOISE)
    port_of_port = tdriver.aggregate_results(ours / "OIM", kind, noise=NOISE)
    port_of_jax = tdriver.aggregate_results(theirs / "OIM", kind, noise=NOISE)
    jax_of_jax = jdriver.aggregate_results(theirs / "OIM", kind, noise=NOISE)
    assert set(jax_of_port) == set(jax_of_jax) == set(port_of_port) == set(port_of_jax)
    for k in jax_of_jax:
        assert jax_of_port[k].shape == (len(RIRS) * K,)
        np.testing.assert_array_equal(port_of_port[k], jax_of_port[k])
        np.testing.assert_array_equal(port_of_jax[k], jax_of_jax[k])
    assert tdriver.aggregate_results(ours / "OIM", kind, noise="other") == {}


def test_export_z_matches_jax(corpus, tmp_path):
    """``export_z`` writes the same files (raw complex64 and |.| float32)
    within 1e-4 of scale, and a second call is a no-op."""
    import shutil

    trees = {}
    for name, mod, kw in (("port", tzexport, {"device": "cpu"}), ("jax", jzexport, {})):
        root = tmp_path / name
        shutil.copytree(corpus, root)
        assert mod.export_z(str(root), "living", RIRS[0], NOISE, snr_range=SNR, n_nodes=K,
                            mics_per_node=C, **kw)
        assert not mod.export_z(str(root), "living", RIRS[0], NOISE, snr_range=SNR, n_nodes=K,
                                mics_per_node=C, **kw)
        trees[name] = root / "living" / "test" / "stft_z"
    paths = artifact_paths(trees["jax"])
    assert len(paths) == 2 * 2 * K and artifact_paths(trees["port"]) == paths
    errs = artifact_errors(trees["port"], trees["jax"])
    assert max(errs.values()) <= TOL, errs
    for p in paths:
        a = np.load(trees["port"] / p)
        assert a.dtype == (np.float32 if "normed" in p else np.complex64)
        assert np.isfinite(a).all()


def test_node_signals_equal_jax(corpus):
    from disco_tpu.io import layout as jlayout
    from disco_tpu_torch.io import layout as tlayout

    args = (RIRS[1], NOISE, SNR, K, C)
    ours = tzexport.load_node_signals(tlayout.DatasetLayout(str(corpus), "living", "test"), *args)
    theirs = jzexport.load_node_signals(jlayout.DatasetLayout(str(corpus), "living", "test"), *args)
    for a, b in zip(ours, theirs):
        assert a.shape == (K, C, 32000)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tzexport.load_mixture_signals(tlayout.DatasetLayout(str(corpus), "living", "test"), *args),
        theirs[0])


#: the counters both packages count the same on one corpus run
DRIVER_COUNTERS = ("clips_enhanced", "chunk_readbacks", "chunks_pipelined",
                   "device_get_batches", "fences", "sentinel_checks", "sentinel_trips",
                   "jit_recompiles")


@pytest.mark.parametrize("lane", list(LANES))
def test_events_match_jax(logged_runs, lane):
    """The stage spans (load, enhance, readback, pipeline, score), the
    clip, jit_trace and counters events of both drivers: the same
    attributes but timings, main-thread events in order, each clip's as a
    multiset."""
    ours, theirs = logged_runs[lane][4:]
    stages = {e["stage"] for e in ours if e["kind"] == "stage_end"}
    assert {"chunk_load", "chunk_enhance", "chunk_readback", "chunk_pipeline",
            "score_persist"} <= stages
    assert sum(e["kind"] == "clip" for e in ours) == len(RIRS)
    assert_events_match(ours, theirs)
    assert_counters_match(ours, theirs, DRIVER_COUNTERS)


def test_recording_changes_no_artifact(corpus, runs, tmp_path):
    """The staged lane with recording and the sentinels off writes the
    recorded run's tree byte for byte, reads each chunk back once and
    ticks no sentinel fence."""
    from disco_tpu_torch.obs.accounting import device_get_count, fence_count

    g0, f0 = device_get_count(), fence_count()
    checks0 = tobs.REGISTRY.counter("sentinel_checks").value
    _run(tdriver, corpus, tmp_path)
    assert (device_get_count() - g0, fence_count() - f0) == (1, 1)
    assert tobs.REGISTRY.counter("sentinel_checks").value == checks0
    tree = runs["staged"][2]
    assert artifact_paths(tmp_path) == artifact_paths(tree)
    for rel in artifact_paths(tree):
        assert (tmp_path / rel).read_bytes() == (tree / rel).read_bytes(), rel
