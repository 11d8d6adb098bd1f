#!/usr/bin/env python3
"""Does a clip come out of ``tango`` in the same bits in a corpus chunk as
alone, on the card, and what does it cost?

The corpus driver enhances clips in chunks; a crashed run resumes with the
clips it did not finish, in smaller chunks, and its contract (the chaos
gate, ``disco_tpu_torch.runs.check``) is that the resumed tree is byte for
byte the uninterrupted one.  On the CPU that holds; on the card cuBLAS and
cuSOLVER pick their kernels by the batch.  This script compares a clip
alone with the same clip second in a chunk of two (the gates' mini-corpus
shapes: 4 nodes x 2 mics, 129 frames) stage by stage and under every
solver, then times, at the north-star 16-clip batch (K=8, 257 bins, 626
frames), the filter application as one batched ``einsum``, as one
``einsum`` a clip and as a product and a channel sum, and the power solver
unbatched and in fixed batches of 16,384 and 65,536 pencils.

    PYTHONPATH=. python3 exp/batch_invariance_probe.py    # on the card, ~30 s
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from disco_tpu_torch.beam import filters as bf  # noqa: E402
from disco_tpu_torch.enhance import tango as tg  # noqa: E402
from disco_tpu_torch.ops.cov_ops import masked_covariances_fused  # noqa: E402
from disco_tpu_torch.ops.stft_ops import stft_fused  # noqa: E402


def same(name, a2, a1) -> None:
    eq = torch.equal(a2, a1)
    diff = 0.0 if eq else (a2 - a1).abs().nan_to_num().max().item()
    print(f"{name}: equal {eq} max diff {diff:.3e}", flush=True)


def ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def chunk_vs_alone(dev) -> None:
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 2, 4, 2, 32768)).astype(np.float32)).to(dev)
    spec2, spec1 = stft_fused(x), stft_fused(x[:, 1:].contiguous())
    same("stft", spec2[:, 1:], spec1)
    m2, m1 = tg.oracle_masks(spec2[1], spec2[2]), tg.oracle_masks(spec1[1], spec1[2])
    same("masks", m2[1:], m1)
    R2, R1 = masked_covariances_fused(spec2[0], m2), masked_covariances_fused(spec1[0], m1)
    same("covariances", R2[0][1:], R1[0])
    A = torch.randn(2, 4, 257, 5, 5, dtype=torch.complex64, device=dev)
    Rs = A @ A.conj().transpose(-1, -2)
    B = torch.randn(2, 4, 257, 5, 5, dtype=torch.complex64, device=dev)
    Rn = B @ B.conj().transpose(-1, -2) + 0.1 * torch.eye(5, device=dev)
    for solver in ("power", "eigh", "fused", "jacobi-pallas"):
        w2, _ = bf.rank1_gevd(Rs, Rn, solver=solver)
        w1, _ = bf.rank1_gevd(Rs[1:].clone(), Rn[1:].clone(), solver=solver)
        same(f"rank1_gevd {solver}, 5 x 5", w2[1:], w1)
        r2 = tg.tango(spec2[0], spec2[1], spec2[2], m2, m2, solver=solver)
        r1 = tg.tango(spec1[0], spec1[1], spec1[2], m1, m1, solver=solver)
        for key in ("yf", "sf", "nf", "z_y"):
            same(f"tango {solver} {key}", getattr(r2, key)[1:], getattr(r1, key))


def costs(dev) -> None:
    torch.manual_seed(0)
    for D in (4, 11):
        X = torch.randn(16, 8, D, 257, 626, dtype=torch.complex64, device=dev)
        w = torch.randn(16, 8, 257, D, dtype=torch.complex64, device=dev)

        def per_clip():
            return torch.stack([torch.einsum("...fc,...cft->...ft", wi, xi)
                                for wi, xi in zip(w, X)])

        print(f"apply, D={D}: batched einsum "
              f"{ms(lambda: torch.einsum('...fc,...cft->...ft', w, X)):.3f} ms, one einsum a "
              f"clip {ms(per_clip):.3f} ms, product and sum {ms(lambda: tg._apply(w, X)):.3f} ms",
              flush=True)
        same(f"  product and sum, clip 3 of 16 vs alone", tg._apply(w, X)[3:4],
             tg._apply(w[3:4], X[3:4]))
    for C in (4, 11):
        A = torch.randn(16, 8, 257, C, C, dtype=torch.complex64, device=dev)
        Rs = A @ A.conj().transpose(-1, -2)
        B = torch.randn(16, 8, 257, C, C, dtype=torch.complex64, device=dev)
        Rn = B @ B.conj().transpose(-1, -2) + 0.1 * torch.eye(C, device=dev)
        row = {"unbatched": ms(lambda: bf._gevd_mwf_power(Rs, Rn, 1.0, 12, True))}
        for size in (16384, 65536):
            row[size] = ms(lambda: bf._fixed_batches(
                lambda a, b: bf._gevd_mwf_power(a, b, 1.0, 12, True), Rs, Rn, size=size))
        print(f"power solver, C={C}, 16 x 8 x 257 pencils (ms): {row}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    chunk_vs_alone(dev)
    costs(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
