"""What the bf16 lane costs in SI-SDR, rounding point by rounding point, on
a 3.1-s cut of ``chip_smoke.py``'s north-star scene (K=8 nodes x C=4 mics,
so an 11-channel step 2), with the port's plain versions on the CPU and,
beside them, the JAX package's f32 and bf16 lanes on the same clip.

Each row is the SI-SDR in dB of every node's enhanced signal
(``tango_clip_fused``, oracle irm1 masks, ``solver='fused'`` unless the
row says otherwise): the f32 lane; the whole bf16 lane; the bf16 lane with
only one of its rounding points (the STFT, the covariances, the fused
solve's pencils) and the others float32; the bf16 lane with the eigh
solver (whose solve stays float32)::

    JAX_PLATFORMS=cpu python exp/bf16_sdr_cost.py     # ~3 min
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from disco_tpu_torch.enhance import fused  # noqa: E402
from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops  # noqa: E402

L = int(3.1 * cs.FS)


def main() -> None:
    y, s, n = cs.scene(cs.K, cs.C, L, noise_scale=cs.NOISE_SCALE)

    def sdr(out):
        return [cs.si_sdr(s[k, 0], np.asarray(out[k])) for k in range(cs.K)]

    def port(precision, solver="fused"):
        return sdr(fused.tango_clip_fused(y, s, n, precision=precision, solver=solver,
                                          device="cpu"))

    rows = {"f32": port("f32"), "bf16": port("bf16")}
    kernels = stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel

    def f32_stft(x, n_fft=512, hop=256, with_mag=False):
        return stft_ops.stft_matmul(x, n_fft, hop, with_mag)

    def f32_cov(y_, m, precision="f32"):
        return kernels[1](y_, m, "f32")

    def f32_mwf(a, b, mu=1.0, sweeps=None, precision="f32"):
        return kernels[2](a, b, mu, sweeps, "f32")

    for only, keep in (("STFT", 0), ("covariances", 1), ("solve", 2)):
        swapped = [f32_stft, f32_cov, f32_mwf]
        swapped[keep] = kernels[keep]
        stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = swapped
        rows[f"bf16, {only} only"] = port("bf16")
    stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = kernels
    rows["f32, solver='eigh'"] = port("f32", "eigh")
    rows["bf16, solver='eigh'"] = port("bf16", "eigh")
    try:
        from disco_tpu.enhance import fused as jfused
    except ImportError:
        jfused = None
    if jfused is not None:
        for p in ("f32", "bf16"):
            rows[f"JAX package, {p}"] = sdr(jfused.tango_clip_fused(y, s, n, precision=p))
    print(f"{'lane':28s} " + " ".join(f"node {k:<3d}" for k in range(cs.K)) + "    mean")
    for label, v in rows.items():
        print(f"{label:28s} " + " ".join(f"{x:8.3f}" for x in v) + f" {np.mean(v):8.3f}")


if __name__ == "__main__":
    main()
