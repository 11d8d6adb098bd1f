"""The port's corpus-side gates, each leg called on ``device="cpu"`` at the
JAX gate's size: the chaos gate (``runs.check``: crash, resume and requeue
byte-identical, one ``chaos_crash`` event a crash, the requeue warning),
the corpus-engine gate (``enhance.check``: legs 1-3 and 5) and the fault
gate (``fault.check``); the telemetry of the chaos seam, the graceful
interrupt and the verified resume against the JAX package's; and every
gate's ``main`` refusing to run without a CUDA device unless asked for the
CPU.
"""
import importlib

import numpy as np
import pytest
import torch

import disco_tpu.obs as jobs
import disco_tpu_torch.obs as tobs
from disco_tpu.runs import chaos as jchaos
from disco_tpu.runs import interrupt as jinterrupt
from disco_tpu.runs import ledger as jledger
from disco_tpu_torch.runs import chaos as tchaos
from disco_tpu_torch.runs import interrupt as tinterrupt
from disco_tpu_torch.runs import ledger as tledger
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread: a fixture)
    assert_events_match, one_host_thread, recorded)

pytestmark = pytest.mark.usefixtures("one_host_thread")


def test_chaos_gate_passes_on_cpu(tmp_path):
    from disco_tpu_torch.runs import check

    failures = []
    with tobs.recording(tmp_path / "log.jsonl"):
        out = check.check_chaos(failures, tmp_path, device="cpu")
    out.update(check.check_chaos_events(failures, tobs.read_events(tmp_path / "log.jsonl"),
                                        out["crashes_injected"]))
    assert failures == []
    assert out["crashes_injected"] == out["chaos_crash_events"] == 2
    assert out["requeue_warnings"] >= 1


def test_corpus_engine_gate_passes_on_cpu(tmp_path):
    from disco_tpu_torch.enhance import check

    failures = []
    with tobs.recording(tmp_path / "log.jsonl"):
        out = check.check_engine(failures, tmp_path, device="cpu")
    check.check_engine_events(failures, tobs.read_events(tmp_path / "log.jsonl"))
    parity = check.check_fused_parity(failures, device="cpu")
    assert failures == []
    assert (out["device_get_batches"], out["chunk_readbacks"]) == (1, 1)
    assert set(parity) == {"stft_with_mag", "cov_folded", "cov_fused", "rank1_gevd", "step1_z"}


def test_fault_gate_passes_on_cpu(tmp_path):
    from disco_tpu_torch.fault import check

    failures = []
    out = check.check_faults(failures, tmp_path, device="cpu")
    assert failures == []
    assert (out["n_fault_events"], out["excluded_nodes"], out["nan_nodes"]) == (2, [1], [2])


def _chaos_and_resume_events(pkg, tmp_path):
    """A fired chaos seam (with the flight ring armed), a graceful stop and
    a verified resume that requeues a truncated artifact, under one
    package's recorder: (events, flight dumps, counters)."""
    chaos, interrupt, ledger, obs = {
        "jax": (jchaos, jinterrupt, jledger, jobs),
        "port": (tchaos, tinterrupt, tledger, tobs)}[pkg]
    root = tmp_path / pkg
    root.mkdir()
    art = root / "a.npy"
    np.save(art, np.arange(4.0))

    def run():
        obs.flight.enable(dump_dir=root / "flight")
        try:
            chaos.configure("between_clips", after=2)
            try:
                chaos.tick("between_clips", rir=11001)
                with pytest.raises(chaos.ChaosCrash):
                    chaos.tick("between_clips", rir=11002)
            finally:
                chaos.disable()
        finally:
            obs.flight.disable()
        with interrupt.GracefulInterrupt() as stop:
            assert interrupt.request_stop("test")
            assert stop() and interrupt.stop_requested()
        led = ledger.RunLedger(root / "ledger.jsonl")
        led.mark_done("rir:1:ssn", [art])
        art.write_bytes(art.read_bytes()[:10])
        done, requeued = led.verified_done()
        assert not done and list(requeued) == ["rir:1:ssn"]

    _, events = recorded(obs, root / "log.jsonl", run)
    counters = obs.REGISTRY.snapshot()["counters"]
    return (events, len(list((root / "flight").glob("flight-*-chaos_crash.json"))),
            {k: counters.get(k) for k in ("chaos_crashes", "interrupts", "units_requeued")})


def test_chaos_interrupt_and_requeue_events_match_jax(tmp_path):
    ours = _chaos_and_resume_events("port", tmp_path)
    theirs = _chaos_and_resume_events("jax", tmp_path)
    kinds = [(e["kind"], e["stage"]) for e in ours[0] if e["kind"] != "flight"]
    assert kinds == [("fault", "between_clips"), ("interrupted", None), ("warning", "resume")]
    assert ours[1:] == theirs[1:] == (1, {"chaos_crashes": 1, "interrupts": 1,
                                          "units_requeued": 1})
    assert_events_match(ours[0], theirs[0], ignore=("path", "reason"))
    assert ours[0][0]["attrs"] == {"fault": "chaos_crash", "hit": 2, "rir": 11002}


@pytest.mark.parametrize("module", ["disco_tpu_torch.runs.check", "disco_tpu_torch.enhance.check",
                                    "disco_tpu_torch.fault.check", "disco_tpu_torch.scenes.check",
                                    "disco_tpu_torch.obs.scope", "disco_tpu_torch.runs.soak"])
def test_gate_main_runs_on_the_card_unless_asked_for_the_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main([])
