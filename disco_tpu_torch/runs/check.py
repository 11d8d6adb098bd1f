"""The crash-safety gate (the port's counterpart of
``disco_tpu/runs/check.py``) and the miniature processed corpus it, the
tests and ``chip_smoke.py`` drive the corpus driver with.

:func:`check_chaos` interrupts a miniature corpus run at injected crash
seams (``runs.chaos``), resumes it, and asserts the crash-safe runs
layer's contract:

1. **mid_write crash**: a run killed inside an artifact write leaves no
   truncated file at any final path and no temp litter; the resumed run's
   tree is byte-identical to an uninterrupted run's.
2. **between_clips crash**: a run killed between clips resumes to a
   byte-identical tree.
3. **corrupt partial requeue**: a done artifact truncated behind the
   ledger's back is requeued on resume (digest mismatch) and regenerated
   byte-identical.

:func:`check_chaos_events` then reads the run's event log: one
``chaos_crash`` ``fault`` event per injected crash, and the verified
resume's requeue ``warning`` (stage ``resume``).

Each leg is a function of a device: the CPU tests call it on
``device="cpu"``, ``chip_smoke.py`` on the card.  ``python -m
disco_tpu_torch.runs.check`` runs the gate on ``cuda`` (``--device cpu``
for the host).  All crashes are simulated in-process; nothing is signalled
or killed.  At the JAX helper's defaults (4 nodes × 2 mics, 2-s clips) the
corpus files are byte-identical to that helper's.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from disco_tpu_torch.io.atomic import save_npy_atomic, write_wav_atomic
from disco_tpu_torch.io.layout import DatasetLayout

FS = 16000
K, C = 4, 2  # nodes x mics-per-node
RIRS = (11001, 11002)  # test-split ids
NOISE = "ssn"
SNR_RANGE = (0, 6)


def _mini_corpus(root: Path, rirs=RIRS, n_nodes: int = K, mics_per_node: int = C,
                 seconds: float = 2.0):
    """Write a synthetic processed corpus under ``root``: per RIR, a white
    source through a random 8-tap filter per mic plus white noise, the
    target/noise/mixture channel WAVs, the dry target and noise and the SNR
    sidecar, in the layout of ``living/test``.  ``seconds``: clip length
    (scoring skips the first second, the lead silence of real clips)."""
    rng = np.random.default_rng(7)
    layout = DatasetLayout(str(root), "living", "test")
    for rir in rirs:
        L = int(round(seconds * FS))
        src = 0.2 * rng.standard_normal(L)
        for ch in range(1, n_nodes * mics_per_node + 1):
            s = np.convolve(src, rng.standard_normal(8) * 0.5, mode="same")
            n = 0.1 * rng.standard_normal(L)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "target", rir, ch), s, FS)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "noise", rir, ch, noise=NOISE), n, FS)
            write_wav_atomic(layout.wav_processed(SNR_RANGE, "mixture", rir, ch, noise=NOISE),
                             s + n, FS)
        write_wav_atomic(layout.dry_source("target", rir, 1), src, FS)
        write_wav_atomic(layout.dry_source("noise", rir, 2, noise=NOISE),
                         0.1 * rng.standard_normal(L), FS)
        save_npy_atomic(layout.snr_log(SNR_RANGE, rir, NOISE), np.full(n_nodes, 3.0))
    return root


def _enhance(corpus, out_root, *, device=None, ledger=None, resume=False):
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched

    return enhance_rirs_batched(
        str(corpus), "living", list(RIRS), NOISE, snr_range=SNR_RANGE,
        out_root=str(out_root), bucket=8192, max_batch=2, n_nodes=K, mics_per_node=C,
        score_workers=1, ledger=ledger, resume=resume, device=device,
    )


def _tree(root: Path) -> dict:
    """{relative path: bytes} of every artifact under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _trees_identical(a: Path, b: Path, failures: list, label: str) -> None:
    ta, tb = _tree(a), _tree(b)
    if set(ta) != set(tb):
        failures.append(
            f"{label}: tree mismatch — only in uninterrupted: "
            f"{sorted(set(ta) - set(tb))}; only in resumed: {sorted(set(tb) - set(ta))}"
        )
        return
    diff = [k for k in ta if ta[k] != tb[k]]
    if diff:
        failures.append(f"{label}: {len(diff)} file(s) differ byte-wise: {diff[:5]}")


def check_chaos(failures: list, tmp, *, device=None) -> dict:
    """Experiments 1-3 on a fresh mini corpus under ``tmp``; the caller
    records the event log around it (:func:`check_chaos_events` reads it).
    Returns ``{"crashes_injected": n}``."""
    from disco_tpu_torch.io.atomic import TMP_SUFFIX, probe_artifact
    from disco_tpu_torch.runs import RunLedger, chaos
    from disco_tpu_torch.runs.ledger import unit_rir

    tmp = Path(tmp)
    corpus = _mini_corpus(tmp / "dataset")
    kw = {"device": device}
    n_crashes = 0

    # reference: the uninterrupted run
    ref = tmp / "ref"
    res_ref = _enhance(corpus, ref, **kw)
    if set(res_ref) != set(RIRS):
        failures.append(f"reference run incomplete: {sorted(res_ref)}")

    # experiment 1: crash INSIDE an artifact write
    out1, led1 = tmp / "midwrite", tmp / "led_midwrite.jsonl"
    chaos.configure("mid_write", after=5)
    try:
        _enhance(corpus, out1, ledger=str(led1), **kw)
        failures.append("mid_write: injected crash never fired")
    except chaos.ChaosCrash:
        n_crashes += 1
    finally:
        chaos.disable()
    bad = [str(p) for p in out1.rglob("*") if p.is_file() and not probe_artifact(p)]
    if bad:
        failures.append(f"mid_write: truncated final artifact(s) survived the crash: {bad}")
    litter = [str(p) for p in out1.rglob(f"*{TMP_SUFFIX}.*")]
    if litter:
        failures.append(f"mid_write: temp litter not cleaned on unwind: {litter}")
    _enhance(corpus, out1, ledger=str(led1), resume=True, **kw)
    _trees_identical(ref, out1, failures, "mid_write resume")

    # experiment 2: crash BETWEEN clips
    out2, led2 = tmp / "betweenclips", tmp / "led_betweenclips.jsonl"
    chaos.configure("between_clips", after=1)
    try:
        _enhance(corpus, out2, ledger=str(led2), **kw)
        failures.append("between_clips: injected crash never fired")
    except chaos.ChaosCrash:
        n_crashes += 1
    finally:
        chaos.disable()
    _enhance(corpus, out2, ledger=str(led2), resume=True, **kw)
    _trees_identical(ref, out2, failures, "between_clips resume")

    # experiment 3: a corrupt done artifact is requeued
    victim = out2 / "OIM" / f"results_mwf_{RIRS[0]}_{NOISE}.p"
    data = victim.read_bytes()
    victim.write_bytes(data[: len(data) // 2])  # disco-torch-lint: disable=DL004 -- chaos harness corrupting an artifact ON PURPOSE to prove verified-resume requeues it
    ledger2 = RunLedger(led2)
    done_before, _ = ledger2.verified_done(requeue=False)
    if unit_rir(RIRS[0], NOISE) in done_before:
        failures.append("requeue: corrupted artifact still verified as done")
    res3 = _enhance(corpus, out2, ledger=ledger2, resume=True, **kw)
    if RIRS[0] not in res3:
        failures.append(f"requeue: corrupt clip {RIRS[0]} was not re-enhanced: {sorted(res3)}")
    _trees_identical(ref, out2, failures, "requeue resume")
    done_after, requeued_after = ledger2.verified_done(requeue=False)
    if unit_rir(RIRS[0], NOISE) not in done_after or requeued_after:
        failures.append(f"requeue: ledger not clean after regeneration "
                        f"(done={sorted(done_after)}, requeued={requeued_after})")
    return {"crashes_injected": n_crashes}


def check_chaos_events(failures: list, events: list, n_crashes: int) -> dict:
    """The gate's event legs: one ``chaos_crash`` ``fault`` event per
    injected crash and the verified resume's requeue warning."""
    chaos_events = [e for e in events if e["kind"] == "fault"
                    and e["attrs"].get("fault") == "chaos_crash"]
    if len(chaos_events) != n_crashes:
        failures.append(f"event log carries {len(chaos_events)} chaos_crash fault events, "
                        f"expected {n_crashes}")
    warn_requeue = [e for e in events if e["kind"] == "warning" and e["stage"] == "resume"]
    if not warn_requeue:
        failures.append("event log missing the requeue warning from verified resume")
    return {"chaos_crash_events": len(chaos_events), "requeue_warnings": len(warn_requeue)}


def main(argv=None) -> int:
    """Run the crash-safety gate; exit 1 on failure.  Runs on ``cuda``
    unless ``--device cpu`` (RuntimeError without a CUDA device)."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.runs.check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        obs_log = Path(tmp) / "chaos_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="chaos-check")
            out = check_chaos(failures, tmp, device=device)
            obs.record("counters", **obs.REGISTRY.snapshot())
        out.update(check_chaos_events(failures, obs.read_events(obs_log),
                                      out["crashes_injected"]))
    if failures:
        for f in failures:
            print(f"chaos-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"chaos_check": "ok", **out, "sigkills_issued": 0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
