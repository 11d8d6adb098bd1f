"""The corpus-engine gate (the port's counterpart of
``disco_tpu/enhance/check.py``).

Runs the chaos gate's miniature corpus through both corpus engines and
asserts the overlapped prefetch / dispatch / readback engine's contract
(``enhance.pipeline``):

1. **Byte-identical artifacts**: the pipelined engine's artifact tree is
   byte for byte the sequential engine's.
2. **Ledger equivalence**: a pipelined run with a ledger replays to every
   unit ``done``, verified against its artifact digests.
3. **One batched readback a chunk**: ``device_get_batches`` and
   ``chunk_readbacks`` advance once per chunk, the overlap gauges
   (``prefetch_stall_ms``, ``readback_ms``, ``overlap_efficiency``) are
   recorded, and the log holds the ``chunk_pipeline`` stage event.
5. **Default path against the unfused formulations**: the fused STFT with
   magnitude, the covariances and the fused rank-1 solve (alone and through
   step 1), on the caller's device, against independent formulations on the
   host — the rFFT STFT plus ``abs``, the materializing covariance einsum and
   the ``eigh`` solve — at the JAX gate's tolerances.  On the CPU the
   default path is the plain versions; on the card, the kernels.

The JAX gate's leg 4 checks ``bench.py``'s one JSON line; it waits for the
port's benchmark.

Each leg is a function of a device: the CPU tests call them on
``device="cpu"``, ``chip_smoke.py`` on the card.  ``python -m
disco_tpu_torch.enhance.check`` runs the gate on ``cuda`` (``--device cpu``
for the host).

No reference counterpart: the reference has no corpus engine and no CI.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def _enhance(corpus, out_root, *, device=None, **kw):
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched
    from disco_tpu_torch.runs import check as mini

    return enhance_rirs_batched(
        str(corpus), "living", list(mini.RIRS), mini.NOISE, snr_range=mini.SNR_RANGE,
        out_root=str(out_root), bucket=8192, max_batch=2, n_nodes=mini.K,
        mics_per_node=mini.C, score_workers=2, device=device, **kw,
    )


def check_engine(failures: list, tmp, *, device=None) -> dict:
    """Legs 1-3 on a fresh mini corpus under ``tmp`` (two clips, one chunk);
    the caller records the event log around it (:func:`check_engine_events`
    reads it)."""
    from disco_tpu_torch.obs.accounting import device_get_count
    from disco_tpu_torch.obs.metrics import REGISTRY
    from disco_tpu_torch.runs import RunLedger
    from disco_tpu_torch.runs import check as mini

    tmp = Path(tmp)
    corpus = mini._mini_corpus(tmp / "dataset")
    seq = tmp / "sequential"
    res_seq = _enhance(corpus, seq, pipeline=False, device=device)

    pipe, led = tmp / "pipelined", tmp / "ledger.jsonl"
    gets0, reads0 = device_get_count(), REGISTRY.counter("chunk_readbacks").value
    res_pipe = _enhance(corpus, pipe, pipeline=True, ledger=str(led), device=device)
    n_gets = device_get_count() - gets0
    n_reads = REGISTRY.counter("chunk_readbacks").value - reads0

    if set(res_seq) != set(res_pipe):
        failures.append(f"result keys differ: sequential={sorted(res_seq)} "
                        f"pipelined={sorted(res_pipe)}")
    mini._trees_identical(seq, pipe, failures, "pipelined parity")
    # two clips at max_batch=2 = exactly one chunk: one batched readback
    if n_gets != 1 or n_reads != 1:
        failures.append(f"expected ONE batched readback for the single chunk, counted "
                        f"device_get_batches {n_gets}, chunk_readbacks {n_reads}")
    gauges = REGISTRY.snapshot()["gauges"]
    for g in ("prefetch_stall_ms", "readback_ms", "overlap_efficiency"):
        if gauges.get(g) is None:
            failures.append(f"overlap gauge {g!r} was not recorded")
    done, requeued = RunLedger(led).verified_done(requeue=False)
    if len(done) != len(res_pipe) or requeued:
        failures.append(f"ledger not clean after pipelined run: done={sorted(done)} "
                        f"requeued={requeued}")
    return {"clips": len(res_pipe), "device_get_batches": n_gets, "chunk_readbacks": n_reads,
            "overlap_efficiency": gauges.get("overlap_efficiency")}


def check_engine_events(failures: list, events: list) -> None:
    """Leg 3's log half: the ``chunk_pipeline`` stage event."""
    if not any(e["kind"] == "stage_end" and e["stage"] == "chunk_pipeline" for e in events):
        failures.append("event log missing the chunk_pipeline stage event")


def check_fused_parity(failures: list, *, device=None) -> dict:
    """Leg 5: the default path on ``device`` against the unfused
    formulations on the host, on a fixed random case."""
    import torch

    from disco_tpu_torch.beam.covariance import masked_covariances
    from disco_tpu_torch.beam.filters import rank1_gevd
    from disco_tpu_torch.core.dsp import _stft_rfft
    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.enhance.zexport import compute_z_signals
    from disco_tpu_torch.ops.cov_ops import masked_covariances_folded, masked_covariances_fused
    from disco_tpu_torch.ops.stft_ops import stft_with_mag

    dev = resolve_device(device)
    errs = {}

    def host(t):
        return t.detach().cpu().numpy()

    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 3, 12000)).astype("float32")
    spec_ref = host(_stft_rfft(torch.from_numpy(x), 512, 256))
    mag_ref = np.abs(spec_ref)
    scale = np.max(mag_ref)
    spec, mag = (host(t) for t in stft_with_mag(torch.from_numpy(x).to(dev)))
    errs["stft_with_mag"] = max(np.max(np.abs(spec - spec_ref)),
                                np.max(np.abs(mag - mag_ref))) / scale
    if errs["stft_with_mag"] > 1e-5:
        failures.append(f"fused parity: stft_with_mag drifted from the rFFT STFT + abs "
                        f"({errs['stft_with_mag']:.2e} > 1e-5)")

    C, F, T = 4, 33, 50
    y = (rng.standard_normal((C, F, T))
         + 1j * rng.standard_normal((C, F, T))).astype(np.complex64)
    m = rng.random((F, T)).astype(np.float32)
    Rss_ref, Rnn_ref = (host(t) for t in masked_covariances(torch.from_numpy(y),
                                                            torch.from_numpy(m)))
    scale_r = max(np.max(np.abs(Rss_ref)), np.max(np.abs(Rnn_ref)))
    yd, md = torch.from_numpy(y).to(dev), torch.from_numpy(m).to(dev)
    for name, fn in (("folded", masked_covariances_folded), ("fused", masked_covariances_fused)):
        Rss, Rnn = (host(t) for t in fn(yd, md))
        errs[f"cov_{name}"] = max(np.max(np.abs(Rss - Rss_ref)),
                                  np.max(np.abs(Rnn - Rnn_ref))) / scale_r
        if errs[f"cov_{name}"] > 1e-4:
            failures.append(f"fused parity: masked covariance [{name}] drifted from the "
                            f"materializing einsum ({errs[f'cov_{name}']:.2e} > 1e-4 max rel)")

    Rnn_pd = Rnn_ref + 0.05 * scale_r * np.eye(C, dtype=np.complex64)
    w_ref, t1_ref = (host(t) for t in rank1_gevd(torch.from_numpy(Rss_ref),
                                                 torch.from_numpy(Rnn_pd), solver="eigh"))
    w, t1 = (host(t) for t in rank1_gevd(torch.from_numpy(Rss_ref).to(dev),
                                         torch.from_numpy(Rnn_pd).to(dev), solver="fused"))
    errs["rank1_gevd"] = max(np.linalg.norm(w - w_ref),
                             np.linalg.norm(t1 - t1_ref)) / np.linalg.norm(w_ref)
    if errs["rank1_gevd"] > 1e-3:
        failures.append(f"fused parity: rank1_gevd[fused] drifted from the eigh solve "
                        f"({errs['rank1_gevd']:.2e} > 1e-3 rel l2)")

    y1, s1, n1 = (rng.standard_normal((2, 3, 12000)).astype(np.float32) for _ in range(3))
    z_ref = host(compute_z_signals(y1, s1, n1, solver="eigh", device="cpu")["z_y"])
    z = host(compute_z_signals(y1, s1, n1, solver="fused", device=dev)["z_y"])
    errs["step1_z"] = np.max(np.abs(z - z_ref)) / np.max(np.abs(z_ref))
    if errs["step1_z"] > 1e-3:
        failures.append(f"fused parity: compute_z_signals[fused] step-1 z_y drifted from the "
                        f"eigh solve ({errs['step1_z']:.2e} > 1e-3 max rel)")
    return {k: float(v) for k, v in errs.items()}


def main(argv=None) -> int:
    """Run the corpus-engine gate; exit 1 on failure.  Runs on ``cuda``
    unless ``--device cpu`` (RuntimeError without a CUDA device)."""
    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.enhance.check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        obs_log = Path(tmp) / "perf_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="perf-check")
            engine = check_engine(failures, tmp, device=device)
            obs.record("counters", **obs.REGISTRY.snapshot())
        check_engine_events(failures, obs.read_events(obs_log))
    parity = check_fused_parity(failures, device=device)
    if failures:
        for f in failures:
            print(f"perf-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"perf_check": "ok", **engine, "parity": parity}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
