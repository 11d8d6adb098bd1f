#!/usr/bin/env python3
"""Whole-clip streaming against the per-block loop on the card, and the host
syncs one block's dispatch makes.

Serving delivers a stream block by block (``streaming_tango`` with the state
carried), and its contract is that the stitched output equals one
``streaming_tango`` call on the whole clip, bit for bit.  On the CPU that
holds; on the card the library calls on the path (cuSOLVER's batched
eigensolver and Cholesky, cuBLAS's batched products) see a different batch
for one block than for the whole clip.  This script drives the north-star
scene (K=8 nodes x C=4 mics, 10 s, 626 frames) both ways under each serving
solver and reports, per solver, whether the two agree and where they first
part; then it runs one 64-frame block of each solver under
``torch.cuda.set_sync_debug_mode("warn")`` and prints the host syncs it
makes.

    PYTHONPATH=. python3 exp/serve_parity_probe.py       # on the card, ~1 min
"""
from __future__ import annotations

import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from disco_tpu_torch.core.masks import tf_mask_mag  # noqa: E402
from disco_tpu_torch.enhance.streaming import initial_stream_state, streaming_tango  # noqa: E402
from disco_tpu_torch.ops import _build, stft_ops  # noqa: E402

K, C, BLOCK, U = 8, 4, 64, 4


def per_block(Y, m, block, **kw):
    """streaming_tango block by block (the last block ragged), state carried."""
    T = Y.shape[-1]
    state = initial_stream_state(K, C, Y.shape[-2], update_every=U)
    outs = []
    z = kw.pop("z_avail", None)
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        n_ref = -(-(hi - lo) // U)
        za = (torch.ones((K, n_ref)) if z is None
              else torch.as_tensor(z)[:, None].expand(K, n_ref).contiguous())
        o = streaming_tango(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi], update_every=U,
                            state=state, z_avail=za, **kw)
        state = o["state"]
        outs.append(o["yf"])
    return torch.cat(outs, dim=-1)


def batch_invariance(Y, m) -> dict:
    """Each library call of a jacobi-pallas refresh on the whole clip's
    step-1 batch (8 x 157 x 257 pencils) against the same call on its first
    two blocks alone (8 x 2 x 257, the batch of an 8-frame block): True
    where the first two blocks come out bit-identical."""
    from disco_tpu_torch.beam import filters as fl
    from disco_tpu_torch.enhance import streaming as st
    from disco_tpu_torch.ops.eigh_ops import eigh_jacobi_pallas

    T, F = Y.shape[-1], Y.shape[-2]
    X = st._tfc(Y)
    M = m.transpose(-1, -2)[..., None]
    pad = (-T) % U
    B = (T + pad) // U

    def blocks(a):
        a = torch.cat([a, a.new_zeros(a.shape[:-3] + (pad, F, C))], dim=-3)
        return a.contiguous().reshape(a.shape[:-3] + (B, U, F, C))

    R0 = st.state_from_numpy(st.initial_stream_state(K, C, F), Y.device)["step1"]
    _, (Rs, Rn) = st._block_covariances(blocks(M * X), blocks((1 - M) * X), 0.99, R0[0], R0[1])
    L, A = fl._whitened(Rs, Rn)
    lam, Uv = eigh_jacobi_pallas(A)
    xb = blocks(X)
    ops = {
        "cholesky_ex": lambda R: fl._cholesky(fl._load_diag(R)),
        "whitened": lambda R: fl._whitened(R, Rn if R.shape == Rn.shape else
                                           Rn[:, :2].contiguous())[1],
        "eigh kernel": lambda A_: eigh_jacobi_pallas(A_)[1],
        "solve_triangular": lambda L_: torch.linalg.solve_triangular(
            fl._herm(L_), Uv if L_.shape == L.shape else Uv[:, :2].contiguous(), upper=True),
        "gevd_mwf": lambda R: fl.rank1_gevd(R, Rn if R.shape == Rn.shape else
                                            Rn[:, :2].contiguous(), solver="jacobi-pallas",
                                            sanitize=False)[0],
        "apply einsum": lambda w: torch.einsum("...bfd,...bufd->...buf", w,
                                               xb if w.shape[1] == B else
                                               xb[:, :2].contiguous()),
    }
    args = {"cholesky_ex": Rn, "whitened": Rs, "eigh kernel": A, "solve_triangular": L,
            "gevd_mwf": Rs, "apply einsum": Uv[..., 0].conj()}
    out = {}
    for name, fn in ops.items():
        a = args[name]
        whole = fn(a)[:, :2]
        part = fn(a[:, :2].contiguous())
        out[name] = bool(torch.equal(whole, part))
    return out


def main() -> int:
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.load()
    L = int(chip_smoke.DUR_S * chip_smoke.FS)
    y, s, n = chip_smoke.scene(K, C, L, noise_scale=chip_smoke.NOISE_SCALE)
    x = torch.from_numpy(np.stack([y, s, n])).cuda()
    spec, mag = stft_ops.stft_kernel(x, with_mag=True)
    Y = spec[0]
    m = tf_mask_mag(mag[1][:, 0], mag[2][:, 0], "irm1")
    torch.cuda.synchronize()
    cases = {
        "jacobi-pallas": {"solver": "jacobi-pallas"},
        "jacobi-pallas mu=1.2": {"solver": "jacobi-pallas", "mu": 1.2},
        "fused": {"solver": "fused"},
        "eigh": {"solver": "eigh"},
        "eigh z_avail": {"solver": "eigh", "z_avail": np.array([1, 0, 1, 1, 1, 1, 1, 1],
                                                                np.float32)},
    }
    report = {}
    for label, kw in cases.items():
        t0 = time.perf_counter()
        whole = streaming_tango(Y, m, m, update_every=U, **kw)["yf"]
        blocks = {}
        for block in (BLOCK, 128, 8):
            pb = per_block(Y, m, block, **dict(kw))
            blocks[block] = {"equal": bool(torch.equal(whole, pb)),
                             "max_abs": float((whole - pb).abs().max()),
                             "first_frame": (int(torch.nonzero((whole != pb).any(0).any(0))[0])
                                             if not torch.equal(whole, pb) else None)}
        torch.cuda.synchronize()
        report[label] = {"blocks": blocks, "s": round(time.perf_counter() - t0, 2),
                         "scale": float(whole.abs().max())}
        print(f"{label}: " + json.dumps(report[label]), flush=True)

    print("batch invariance, whole clip vs an 8-frame block's batch: "
          + json.dumps(batch_invariance(Y, m)), flush=True)

    # the host syncs of one block's dispatch (warm, state carried from block 0)
    for label, kw in cases.items():
        state = streaming_tango(Y[..., :BLOCK], m[..., :BLOCK], m[..., :BLOCK], update_every=U,
                                z_avail=torch.ones((K, BLOCK // U)),
                                **{k: v for k, v in kw.items() if k != "z_avail"})["state"]
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                streaming_tango(Y[..., BLOCK:2 * BLOCK], m[..., BLOCK:2 * BLOCK],
                                m[..., BLOCK:2 * BLOCK], update_every=U, state=state,
                                z_avail=torch.ones((K, BLOCK // U)),
                                **{k: v for k, v in kw.items() if k != "z_avail"})
                t_host = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        msgs = {}
        for w in seen:
            key = f"{Path(w.filename).name}:{w.lineno}"
            msgs[key] = msgs.get(key, 0) + 1
        print(f"sync debug, one block, {label}: {len(seen)} syncs, host {t_host * 1e3:.1f} ms: "
              + json.dumps(msgs), flush=True)
    print(json.dumps({"probe": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
