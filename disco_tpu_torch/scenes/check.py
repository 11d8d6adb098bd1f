"""The batched scene-factory gate (the port's counterpart of
``disco_tpu/scenes/check.py``).

1. **Oracle parity**: the batched image-source engine
   (:func:`~disco_tpu_torch.sim.ism.shoebox_rirs_batched`) against an
   independent loop-based float64 NumPy Allen & Berkley oracle (inlined
   below), per (scene, source, mic), at relative error < 2e-4.
2. **Batched = per-scene**: the batched RIRs match B independent
   :func:`~disco_tpu_torch.sim.ism.shoebox_rirs` calls in the same
   ``(max_order, rir_len)`` bucket within 1e-6.
3. **Dispatch budget**: a B=8 scene batch is exactly ONE batched readback,
   and the ``scene_batch`` label counts exactly one new call signature per
   distinct bucket (``obs.accounting.counted_jit``) — a second same-bucket
   batch adds none.
4. **Dynamic continuity**: crossfade weights sum to one, and on a sine dry
   signal the crossfaded boundary jump is under half the hard switch's.
5. **Datagen crash-and-resume**: a ``ChaosCrash`` at the
   ``between_scenes`` seam of the batched DISCO generator; the resumed run
   completes the corpus byte-identical to an uninterrupted one.
6. **SceneStream**: the (seed, epoch) batch stream is deterministic, a
   ledger-armed epoch replays to zero duplicate batches, a crash at the
   ``between_scene_batches`` seam resumes to exactly the missing batches;
   and the log holds SceneStream's and the generator's ``scene`` events and
   the generator's ``run_resume``.

Each leg is a function of a device: the CPU tests call them on
``device="cpu"``, ``chip_smoke.py`` on the card.  ``python -m
disco_tpu_torch.scenes.check`` runs the gate on ``cuda`` (``--device cpu``
for the host).

No reference counterpart: the reference pre-generates its corpus to disk
with per-scene pyroomacoustics loops and has no on-line scene factory.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

FS = 16000

#: oracle-parity bound: float32 engine vs the float64 loop oracle, relative
#: l2 error per RIR (the JAX gate's)
ORACLE_RTOL = 2e-4

#: dynamic-continuity bound: the crossfaded boundary jump must be under
#: this fraction of the hard-switch jump on the same sine-dry scene
CROSSFADE_JUMP_RATIO = 0.5


def _oracle_rir_np(room_dim, source, mic, alpha, max_order, rir_len,
                   fs=FS, c=343.0, fdl=81):
    """Loop-based float64 Allen & Berkley shoebox ISM oracle — independent
    of disco_tpu_torch.sim (no torch, no shared helpers; the same physics as the
    tests/reference_impls.py oracle that pins the per-scene kernel):
    sum-order truncation, uniform sqrt(1-alpha) wall reflection,
    1/(4 pi d) spreading, windowed-sinc fractional delays.

    Reference counterpart: pyroomacoustics libroom conventions as used by
    gen_disco/convolve_signals.py:84-99 (SURVEY.md §L1)."""
    import numpy as np

    room_dim = np.asarray(room_dim, np.float64)
    source = np.asarray(source, np.float64)
    mic = np.asarray(mic, np.float64)
    beta = np.sqrt(max(1.0 - float(alpha), 0.0))
    half = fdl // 2
    rir = np.zeros(rir_len)
    N = max_order
    for n in range(-N, N + 1):
        for l in range(-N, N + 1):  # noqa: E741 — ISM lattice convention
            for m in range(-N, N + 1):
                for u in (0, 1):
                    for v in (0, 1):
                        for w in (0, 1):
                            n_refl = (abs(n - u) + abs(n) + abs(l - v)
                                      + abs(l) + abs(m - w) + abs(m))
                            if n_refl > N:
                                continue
                            img = np.array([
                                (1 - 2 * u) * source[0] + 2 * n * room_dim[0],
                                (1 - 2 * v) * source[1] + 2 * l * room_dim[1],
                                (1 - 2 * w) * source[2] + 2 * m * room_dim[2],
                            ])
                            d = max(np.linalg.norm(img - mic), 1e-3)
                            amp = beta ** n_refl / (4 * np.pi * d)
                            delay = d * fs / c
                            t0 = int(np.floor(delay))
                            frac = delay - t0
                            for tap in range(-half, half + 1):
                                t = t0 + tap
                                if 0 <= t < rir_len:
                                    arg = tap - frac
                                    win = 0.5 * (1 + np.cos(np.pi * arg / (half + 1)))
                                    rir[t] += amp * np.sinc(arg) * win
    return rir


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def check_oracle_parity(failures: list, *, device=None) -> dict:
    """Leg 1: the batched engine against the inlined float64 oracle."""
    from disco_tpu_torch.sim import shoebox_rirs_batched

    max_order, rir_len = 2, 1024
    dims = np.array([[4.0, 3.0, 2.5], [5.5, 4.0, 3.0]], np.float32)
    srcs = np.array([[[1.0, 1.2, 1.1]], [[1.5, 2.0, 1.4]]], np.float32)
    mics = np.array([[[2.5, 2.0, 1.3], [3.0, 1.0, 1.2]],
                     [[3.5, 2.5, 1.5], [4.0, 3.0, 1.8]]], np.float32)
    alphas = np.array([0.35, 0.5], np.float32)
    got = _host(shoebox_rirs_batched(dims, srcs, mics, alphas, max_order=max_order,
                                     rir_len=rir_len, device=device))
    worst = 0.0
    for b in range(2):
        for mi in range(2):
            want = _oracle_rir_np(dims[b], srcs[b, 0], mics[b, mi], alphas[b], max_order,
                                  rir_len)
            err = float(np.linalg.norm(got[b, 0, mi] - want) / np.linalg.norm(want))
            worst = max(worst, err)
            if err > ORACLE_RTOL:
                failures.append(f"oracle: batched RIR (scene {b}, mic {mi}) off the float64 "
                                f"oracle by rel {err:g} > {ORACLE_RTOL:g}")
    return {"oracle_rel_err": worst}


def check_batched_equals_per_scene(failures: list, *, device=None) -> dict:
    """Leg 2: batched RIRs == per-scene RIRs in the same bucket."""
    from disco_tpu_torch.scenes import draw_scene_batch, scene_batch_bucket, simulate_scene_batch
    from disco_tpu_torch.sim import shoebox_rirs

    rng = np.random.default_rng(41)
    batch = draw_scene_batch(rng, 3, duration_s=0.5,
                             setup_overrides={"n_sensors_per_node": (2, 2)})
    max_order, rir_len = scene_batch_bucket(batch, max_order=4)
    out = simulate_scene_batch(batch, max_order=4, device=device)
    worst = 0.0
    for b in range(batch.n_scenes):
        single = _host(shoebox_rirs(batch.room_dims[b], batch.sources[b], batch.mics[b],
                                    float(batch.alphas[b]), max_order=max_order,
                                    rir_len=rir_len, device=device))
        err = float(np.abs(out["rirs"][b] - single).max())
        worst = max(worst, err)
        if err > 1e-6:
            failures.append(f"vmap-parity: scene {b} batched RIRs differ from the per-scene "
                            f"call by {err:g} > 1e-6")
    for k in ("noisy", "clean", "mag_noisy"):
        if not np.isfinite(out[k]).all():
            failures.append(f"vmap-parity: non-finite values in {k!r}")
    if not (np.all(out["mask"] >= 0) and np.all(out["mask"] <= 1)):
        failures.append("vmap-parity: IRM mask left [0, 1]")
    return {"vmap_max_abs_err": worst, "bucket_rir_len": rir_len}


def check_dispatch_budget(failures: list, *, device=None) -> dict:
    """Leg 3: one readback a batch, one new ``scene_batch`` signature a
    bucket."""
    from disco_tpu_torch.obs.accounting import device_get_count, recompile_count
    from disco_tpu_torch.scenes import draw_scene_batch, simulate_scene_batch

    def simulate(batch):
        return simulate_scene_batch(batch, max_order=2, device=device)

    rng = np.random.default_rng(43)
    overrides = {"n_sensors_per_node": (2, 2)}

    g0, r0 = device_get_count(), recompile_count("scene_batch")
    simulate(draw_scene_batch(rng, 8, duration_s=0.5, setup_overrides=overrides))
    gets_first = device_get_count() - g0
    if gets_first != 1:
        failures.append(f"dispatch: a B=8 scene batch cost {gets_first} batched readbacks — "
                        "the criterion is exactly ONE")
    retraces_first = recompile_count("scene_batch") - r0
    if retraces_first != 1:
        failures.append(f"dispatch: first B=8 batch counted {retraces_first} new signatures, "
                        "expected exactly 1 (a fresh bucket)")
    g1, r1 = device_get_count(), recompile_count("scene_batch")
    simulate(draw_scene_batch(rng, 8, duration_s=0.5, setup_overrides=overrides))
    if recompile_count("scene_batch") - r1 != 0:
        failures.append(f"dispatch: a same-bucket batch counted "
                        f"{recompile_count('scene_batch') - r1} new signatures — the bucket "
                        "policy failed to reuse the program")
    if device_get_count() - g1 != 1:
        failures.append("dispatch: second batch broke the one-readback rule")
    r2 = recompile_count("scene_batch")
    simulate(draw_scene_batch(rng, 4, duration_s=0.5, setup_overrides=overrides))
    if recompile_count("scene_batch") - r2 != 1:
        failures.append(f"dispatch: a new (B=4) bucket counted "
                        f"{recompile_count('scene_batch') - r2} new signatures, expected 1")
    return {"readbacks_per_batch": gets_first,
            "retraces_total": recompile_count("scene_batch") - r0}


def check_dynamic_continuity(failures: list, *, device=None) -> dict:
    """Leg 4: crossfade weights and boundary continuity on a sine dry."""
    from disco_tpu_torch.scenes import (
        boundary_jumps,
        dynamic_scene_mixture,
        piecewise_trajectory,
        segment_weights,
    )

    n_seg, L = 5, FS // 2
    w = segment_weights(L, n_seg, crossfade=512)
    colsum = np.abs(w.sum(axis=0) - 1.0).max()
    if colsum > 1e-6:
        failures.append(f"dynamic: crossfade weights sum off unity by {colsum:g}")
    hard = segment_weights(L, n_seg, crossfade=0)
    if not np.array_equal(np.unique(hard), [0.0, 1.0]):
        failures.append("dynamic: crossfade=0 weights are not a hard switch")

    t = np.arange(L) / FS
    dry = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    path = piecewise_trajectory([1.0, 1.0, 1.5], [3.0, 2.0, 1.5], n_seg)
    mics = np.asarray([[2.0, 1.5, 1.0], [2.2, 1.5, 1.0]], np.float32)
    room = [4.0, 3.0, 2.5]

    def jump(crossfade):
        out = dynamic_scene_mixture(room, path, mics, 0.3, dry, crossfade=crossfade,
                                    max_order=2, rir_len=2048, device=device)
        if not np.isfinite(out["mixture"]).all():
            failures.append(f"dynamic: non-finite mixture at crossfade={crossfade}")
        return float(boundary_jumps(out["mixture"], n_seg).max())

    j_cross, j_hard = jump(512), jump(0)
    if j_cross > CROSSFADE_JUMP_RATIO * j_hard:
        failures.append(f"dynamic: crossfaded boundary jump {j_cross:g} is not under "
                        f"{CROSSFADE_JUMP_RATIO} x the hard-switch jump {j_hard:g}")
    return {"jump_crossfade": j_cross, "jump_hard_switch": j_hard}


def _raw_corpus(root: Path):
    """Tiny synthetic LibriSpeech-shaped raw corpus (the JAX gate's): two 6-s
    envelope-gated 'speech' files and one 8-s noise file."""
    from disco_tpu_torch.io.atomic import write_wav_atomic

    rng = np.random.default_rng(0)
    speech = []
    for spk in ("7", "8"):
        f = root / "LibriSpeech" / spk / "1" / f"{spk}-1-0001.wav"
        t = np.arange(6 * FS) / FS
        env = (np.sin(2 * np.pi * 1.1 * t + float(spk)) > -0.2).astype(np.float64)
        write_wav_atomic(f, 0.3 * env * rng.standard_normal(len(t)), FS)
        speech.append(str(f))
    nf = root / "noises" / "n0.wav"
    write_wav_atomic(nf, 0.2 * rng.standard_normal(8 * FS), FS)
    return speech, [str(nf)]


def _signal_setup(speech, noise):
    from disco_tpu_torch.sim import SpeechAndNoiseSetup

    return SpeechAndNoiseSetup(
        target_list=speech, talkers_list=speech, noises_dict={"fs": noise},
        duration_range=(5, 10), var_tar=10 ** (-23 / 10),
        snr_dry_range=[[0, 0]],
        snr_cnv_range=(-60, 60),  # wide gate: the tiny corpus must not redraw forever
        min_delta_snr=-1,
        rng=np.random.default_rng(3),
    )


def _run_batched_gen(out_root: Path, speech, noise, crash_after=None, device=None) -> list:
    """One batched DISCO generation against the mini corpus; optionally
    chaos-crashed at the between_scenes seam, then resumed."""
    from disco_tpu_torch.datagen import generate_disco_rirs_batched
    from disco_tpu_torch.io import DatasetLayout
    from disco_tpu_torch.runs import chaos

    layout = DatasetLayout(str(out_root / "dataset"), "random", "test")
    kw = dict(max_order=2, batch=2, ledger=str(out_root / "ledger.jsonl"), resume=True,
              seed=17, device=device)
    if crash_after is not None:
        chaos.configure("between_scenes", after=crash_after)
        try:
            generate_disco_rirs_batched("random", "test", 1, 4, _signal_setup(speech, noise),
                                        layout, rng=np.random.default_rng(5), **kw)
            return ["CRASH-NEVER-FIRED"]
        except chaos.ChaosCrash:
            pass
        finally:
            chaos.disable()
    return generate_disco_rirs_batched(
        "random", "test", 1, 4, _signal_setup(speech, noise), layout,
        rng=np.random.default_rng(5 if crash_after is None else 999), **kw)


def check_datagen_chaos_resume(failures: list, scratch, *, device=None) -> dict:
    """Leg 5: byte-identical crash-and-resume of the batched generator."""
    from disco_tpu_torch.runs.check import _trees_identical

    scratch = Path(scratch)
    speech, noise = _raw_corpus(scratch / "corpus")
    a, b = scratch / "uninterrupted", scratch / "crashed"
    a.mkdir()
    b.mkdir()
    done_plain = _run_batched_gen(a, speech, noise, device=device)
    if done_plain != [1, 2, 3, 4]:
        failures.append(f"datagen: uninterrupted run generated {done_plain}, expected "
                        "[1, 2, 3, 4]")
    done_resumed = _run_batched_gen(b, speech, noise, crash_after=2, device=device)
    if done_resumed == ["CRASH-NEVER-FIRED"]:
        failures.append("datagen: the between_scenes chaos crash never fired")
    elif set(done_resumed) & {1, 2}:
        failures.append(f"datagen: the resumed run regenerated ledger-done scenes "
                        f"{sorted(set(done_resumed) & {1, 2})} — verified resume broken")
    _trees_identical(a / "dataset", b / "dataset", failures, "datagen")
    return {"scenes_resumed": len(done_resumed)}


def check_stream(failures: list, scratch, *, device=None) -> dict:
    """Leg 6: SceneStream determinism, ledger resume and the chaos seam."""
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.scenes import SceneStream

    scratch = Path(scratch)

    def stream():
        return SceneStream(seed=7, scenes_per_batch=2, batches_per_epoch=2, duration_s=0.5,
                           max_order=2, win_len=4,
                           setup_overrides={"n_sensors_per_node": (2, 2)}, device=device)

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(xa, xb) and np.array_equal(ya, yb)
                                        for (xa, ya), (xb, yb) in zip(a, b))

    full = list(stream().batches(8, epoch=0))
    twin = list(stream().batches(8, epoch=0))
    if not full:
        failures.append("stream: the feed yielded no training batches")
    if not same(full, twin):
        failures.append("stream: the (seed, epoch) batch stream is not deterministic")
    geom = stream().peek_geometry()
    if full and full[0][0].shape[-1] != geom["n_freq"]:
        failures.append(f"stream: batch feature dim {full[0][0].shape[-1]} != peek_geometry "
                        f"n_freq {geom['n_freq']}")

    led = scratch / "stream_ledger.jsonl"
    first = list(stream().batches(8, epoch=0, ledger=led))
    if len(first) != len(full):
        failures.append("stream: the ledger-armed epoch differs from the bare one")
    again = list(stream().batches(8, epoch=0, ledger=led))
    if again:
        failures.append(f"stream: a completed epoch replayed {len(again)} batches — verified "
                        "resume must skip every consumed scene batch")

    led2 = scratch / "stream_ledger_chaos.jsonl"
    chaos.configure("between_scene_batches", after=1)
    got: list = []
    try:
        for xy in stream().batches(8, epoch=0, ledger=led2):
            got.append(xy)
        failures.append("stream: the between_scene_batches crash never fired")
    except chaos.ChaosCrash:
        pass
    finally:
        chaos.disable()
    rest = list(stream().batches(8, epoch=0, ledger=led2))
    if not same(got + rest, full):
        failures.append(f"stream: crashed ({len(got)}) + resumed ({len(rest)}) batches != the "
                        f"uninterrupted epoch ({len(full)})")
    return {"batches_per_epoch": len(full), "batches_after_crash": len(rest)}


def check_scene_events(failures: list, events: list, *, datagen: bool = True) -> dict:
    """The log legs: SceneStream's ``scene`` events (stage ``scenes``) and,
    with ``datagen``, the generator's (stage ``datagen``) and its
    ``run_resume``."""
    stages = [e.get("stage") for e in events if e["kind"] == "scene"]
    if "scenes" not in stages:
        failures.append("event log missing SceneStream scene events (stage='scenes')")
    if datagen:
        if "datagen" not in stages:
            failures.append("event log missing batched-datagen scene events (stage='datagen')")
        if not any(e["kind"] == "run_resume" for e in events):
            failures.append("event log missing the datagen run_resume event")
    return {"scene_events": len(stages)}


def main(argv=None) -> int:
    """Run the scene-factory gate; exit 1 on failure.  Runs on ``cuda``
    unless ``--device cpu`` (RuntimeError without a CUDA device)."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.scenes.check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: list[str] = []
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        obs_log = Path(tmp) / "scene_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="scene-check")
            out.update(check_oracle_parity(failures, device=device))
            out.update(check_batched_equals_per_scene(failures, device=device))
            out.update(check_dispatch_budget(failures, device=device))
            out.update(check_dynamic_continuity(failures, device=device))
            out.update(check_datagen_chaos_resume(failures, tmp, device=device))
            out.update(check_stream(failures, tmp, device=device))
            obs.record("counters", **obs.REGISTRY.snapshot())
        out.update(check_scene_events(failures, obs.read_events(obs_log)))
    if failures:
        for f in failures:
            print(f"scene-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"scene_check": "ok", **out, "sigkills_issued": 0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
