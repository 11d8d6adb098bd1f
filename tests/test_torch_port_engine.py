"""Contracts of the port's corpus engine (``disco_tpu_torch.enhance.driver``
and ``enhance.pipeline``), within the port, on the CPU: the pipelined and
sequential engines and any number of scoring workers write byte-identical
trees; a finished run is not redone; a crash and a verified resume give the
uninterrupted tree; damage behind the ledger's back is requeued; the
refusals and the device rule."""
import numpy as np
import pytest
import torch

from disco_tpu.enhance import driver as jdriver
from disco_tpu_torch.enhance import driver as tdriver
from disco_tpu_torch.enhance import pipeline as tpipeline
from disco_tpu_torch.enhance import streaming as tstream
from disco_tpu_torch.enhance import zexport as tzexport
from disco_tpu_torch.obs.metrics import REGISTRY
from disco_tpu_torch.runs import chaos, check, interrupt
from disco_tpu_torch.runs.ledger import RunLedger, unit_rir
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

RIRS = (11001, 11002, 11003)
NOISE, SNR, K, C = check.NOISE, check.SNR_RANGE, check.K, check.C
pytestmark = pytest.mark.usefixtures("one_host_thread")


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return check._mini_corpus(tmp_path_factory.mktemp("corpus"), rirs=RIRS, seconds=1.5)


def _run(corpus, out, rirs=RIRS, **kw):
    kw = {"max_batch": 2, "score_workers": 1, "device": "cpu", **kw}
    return tdriver.enhance_rirs_batched(str(corpus), "living", list(rirs), NOISE, snr_range=SNR,
                                        out_root=str(out), n_nodes=K, mics_per_node=C, **kw)


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """The sequential engine, inline scoring: (results, tree)."""
    out = tmp_path_factory.mktemp("reference")
    res = _run(corpus, out, pipeline=False)
    return res, _tree(out)


@pytest.mark.parametrize("pipeline,workers", [(True, 1), (True, 2), (False, 2)])
def test_engines_write_byte_identical_trees(corpus, reference, tmp_path, pipeline, workers):
    """Two chunks (2 + a remainder of 1): prefetch overlap, one copy per
    chunk vs one per clip, scoring inline vs on workers."""
    n0 = REGISTRY.counter("chunks_pipelined").value
    res = _run(corpus, tmp_path, pipeline=pipeline, score_workers=workers)
    assert set(res) == set(RIRS)
    assert _tree(tmp_path) == reference[1]
    assert REGISTRY.counter("chunks_pipelined").value - n0 == (2 if pipeline else 0)
    for rir in RIRS:
        for k, v in reference[0][rir].items():
            np.testing.assert_array_equal(res[rir][k], v)


def test_chained_engines_write_byte_identical_trees(corpus, tmp_path):
    _run(corpus, tmp_path / "a", rirs=RIRS[:2], chained=True, pipeline=False)
    _run(corpus, tmp_path / "b", rirs=RIRS[:2], chained=True, score_workers=2)
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")


def test_second_call_returns_nothing(corpus, reference, tmp_path):
    assert set(_run(corpus, tmp_path, rirs=RIRS[:1])) == {RIRS[0]}
    assert _run(corpus, tmp_path, rirs=RIRS[:1]) == {}
    assert tdriver.enhance_rir(str(corpus), "living", RIRS[0], NOISE, snr_range=SNR,
                               out_root=str(tmp_path), n_nodes=K, mics_per_node=C,
                               device="cpu") is None


@pytest.mark.parametrize("seam,after", [("between_clips", 1), ("chunk_load", 2),
                                        ("pre_dispatch", 2), ("mid_write", 40)])
def test_crash_then_resume_is_byte_identical(corpus, reference, tmp_path, seam, after):
    """A crash at a seam (on the prefetch thread for ``chunk_load``), then
    ``resume=True`` with the ledger, gives the uninterrupted run's tree."""
    out, ledger = tmp_path / "out", tmp_path / "ledger.jsonl"
    chaos.configure(seam, after=after)
    try:
        with pytest.raises(chaos.ChaosCrash):
            _run(corpus, out, ledger=ledger)
    finally:
        chaos.disable()
    assert _tree(out) != reference[1]
    _run(corpus, out, ledger=ledger, resume=True)
    assert _tree(out) == reference[1]
    done, requeued = RunLedger(ledger).verified_done()
    assert done == {unit_rir(r, NOISE) for r in RIRS} and not requeued


def test_verified_resume_requeues_a_deleted_wav(corpus, reference, tmp_path):
    out, ledger = tmp_path / "out", tmp_path / "ledger.jsonl"
    _run(corpus, out, ledger=ledger)
    victim = out / "WAV" / str(RIRS[1]) / f"out_mix-{NOISE}_Node-2.wav"
    victim.unlink()
    assert _run(corpus, out, ledger=ledger) == {}  # trusted without resume
    assert set(_run(corpus, out, ledger=ledger, resume=True)) == {RIRS[1]}
    assert _tree(out) == reference[1]


def test_graceful_stop_returns_partial_results(corpus, reference, tmp_path):
    """A stop requested during the first chunk's scoring: that chunk
    finishes, nothing more is dispatched, and a resume completes the run."""
    real = tdriver._persist_and_score

    def stop_then_score(*args, **kw):
        interrupt.request_stop("test")
        return real(*args, **kw)

    with interrupt.GracefulInterrupt():
        tdriver._persist_and_score = stop_then_score
        try:
            partial = _run(corpus, tmp_path)
        finally:
            tdriver._persist_and_score = real
    assert set(partial) == set(RIRS[:2])
    assert set(_run(corpus, tmp_path, resume=True)) == {RIRS[2]}
    assert _tree(tmp_path) == reference[1]


@pytest.mark.parametrize("n_clips,max_batch,width", [(3, 4, 4), (3, 8, 4), (1, 8, 1), (5, 4, 1)])
def test_remainder_chunk_pads_to_a_power_of_two(corpus, tmp_path, monkeypatch, n_clips,
                                                max_batch, width):
    """The last chunk pads to the next power of two (repeating its first
    clip), never to ``max_batch``; pad clips are never scored."""
    rirs = tuple(range(11001, 11001 + n_clips))
    check._mini_corpus(tmp_path / "c", rirs=rirs, seconds=1.25)
    widths = []
    real = tpipeline.fetch_chunk_host

    def spy(res_b, lengths, n_real):
        widths.append((res_b.yf.shape[0], n_real))
        return real(res_b, lengths, n_real)

    monkeypatch.setattr(tdriver, "fetch_chunk_host", spy)
    assert set(_run(tmp_path / "c", tmp_path / "o", rirs=rirs, max_batch=max_batch)) == set(rirs)
    assert widths[-1] == (width, (n_clips - 1) % max_batch + 1)


def test_prefetcher_redelivers_a_crash_on_its_thread():
    def load(i):
        if i == 1:
            raise chaos.ChaosCrash("chunk_load", 1)
        return i

    pf = tpipeline.ChunkPrefetcher([(0,), (1,), (2,)], load)
    got = []
    with pytest.raises(chaos.ChaosCrash):
        for item, stall in pf:
            got.append(item)
            assert stall >= 0
    assert got == [0] and pf.close()
    with pytest.raises(ValueError):
        tpipeline.ChunkPrefetcher([], load, depth=1)


def test_between_blocks_seam_fires_on_continuation_calls():
    rng = np.random.default_rng(0)
    Y = (rng.standard_normal((2, 2, 257, 8)) + 1j * rng.standard_normal((2, 2, 257, 8)))
    m = rng.uniform(0.2, 0.8, (2, 257, 8))
    out = tstream.streaming_tango(Y, m, m, device="cpu")
    for entry in (tstream.streaming_tango, tstream.streaming_tango_scan):
        chaos.configure("between_blocks")
        try:
            entry(Y, m, m, device="cpu")  # no state: not a continuation
            with pytest.raises(chaos.ChaosCrash):
                entry(Y, m, m, state=out["state"], device="cpu")
        finally:
            chaos.disable()


def _refusals():
    return {
        "streaming": ({"chained": True, "streaming": True}, True),
        "models": ({"chained": True, "models": (object(), None)}, False),
        "fault_spec": ({"chained": True, "fault_spec": {"node_dropout": [1]}}, False),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_chained_refusals_match_jax(corpus, tmp_path, case):
    kw, single_only = _refusals()[case]
    for entry in (("enhance_rir",) if single_only else ("enhance_rir", "enhance_rirs_batched")):
        msgs = []
        for mod, extra in ((tdriver, {"device": "cpu"}), (jdriver, {"save_fig": False})):
            first = RIRS[0] if entry == "enhance_rir" else [RIRS[0]]
            with pytest.raises(ValueError) as e:
                getattr(mod, entry)(str(corpus), "living", first, NOISE,
                                    out_root=str(tmp_path), **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("entry", ["enhance_rir", "enhance_rirs_batched"])
def test_save_fig_raises(corpus, tmp_path, entry):
    """``save_fig=True``, the default as in the JAX package, no longer
    raises: each clip's figure is drawn best-effort from its validated
    generation infos — ``FIG/<rir>.png`` where infos exist, nothing where
    they do not (this corpus has none) — and stays out of the ledger's
    artifacts."""
    import shutil

    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.sim import make_setup

    root = shutil.copytree(corpus, tmp_path / "corpus")
    room = make_setup("living", rng=np.random.default_rng(2)).create_room_setup()
    infos = {"room": {"length": room.length, "width": room.width}, "mics": room.mic_positions,
             "sources": room.source_positions}
    layout = DatasetLayout(str(root), "living", "test")
    np.save(layout.ensure_dir(layout.infos(RIRS[0])), infos, allow_pickle=True)
    first = RIRS[0] if entry == "enhance_rir" else [RIRS[0], RIRS[1]]
    out = tmp_path / "out"
    getattr(tdriver, entry)(str(root), "living", first, NOISE, snr_range=SNR, out_root=str(out),
                            n_nodes=K, mics_per_node=C, device="cpu")
    assert sorted(p.name for p in (out / "FIG").iterdir()) == [f"{RIRS[0]}.png"]
    assert (out / "FIG" / f"{RIRS[0]}.png").read_bytes()[:4] == b"\x89PNG"
    assert not any("FIG" in str(p) for p in tdriver.clip_artifacts(out, RIRS[0], NOISE, SNR, K))


@pytest.mark.parametrize("entry", ["enhance_rir", "enhance_rirs_batched", "export_z",
                                   "make_batch_runners"])
def test_entry_points_need_cuda_unless_cpu(corpus, tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA device")
    calls = {
        "enhance_rir": lambda: tdriver.enhance_rir(str(corpus), "living", RIRS[0], NOISE,
                                                   out_root=str(tmp_path)),
        "enhance_rirs_batched": lambda: tdriver.enhance_rirs_batched(
            str(corpus), "living", [RIRS[0]], NOISE, out_root=str(tmp_path)),
        "export_z": lambda: tzexport.export_z(str(corpus), "living", RIRS[0], NOISE),
        "make_batch_runners": lambda: tdriver.make_batch_runners(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not any(tmp_path.iterdir())
