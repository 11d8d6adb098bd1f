"""How far the port's bf16 lane moves when the float32 sums before its
rounding points move by roundoff (CPU, plain versions, a small scene).

The bf16 lane rounds the covariances' spectra and the fused solve's
pencils to bf16.  Two implementations that sum in other orders before
such a point differ there by float32 roundoff, and a value near a rounding
boundary then lands one bf16 step (2^-8) apart.  This script perturbs (a)
the STFT by Gaussian noise of ``amp`` times its scale and (b) the
covariances by a relative 5e-7, and prints how far the enhanced clip
moves, in the bf16 and the f32 lane::

    python exp/bf16_flip_probe.py
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from disco_tpu_torch.enhance import fused  # noqa: E402
from disco_tpu_torch.ops import cov_ops, stft_ops  # noqa: E402
from tests.torch_port_helpers import max_rel, rel_l2, scene  # noqa: E402


def main() -> None:
    y, s, n = scene(3, 2, 10000, seed=3, noise_scale=0.5)

    def clip(precision):
        return fused.tango_clip_fused(y, s, n, precision=precision, device="cpu")

    base = {p: clip(p) for p in ("f32", "bf16")}
    plain_stft = stft_ops.stft_matmul
    for amp in (2e-8, 2e-7):
        def perturbed(x, n_fft=512, hop=256, with_mag=False, precision="f32"):
            out = plain_stft(x, n_fft, hop, with_mag, precision)
            spec = out[0] if with_mag else out
            g = torch.Generator().manual_seed(1)
            noise = torch.complex(torch.randn(spec.shape, generator=g),
                                  torch.randn(spec.shape, generator=g))
            spec = spec + amp * spec.abs().max() * noise
            return (spec, out[1]) if with_mag else spec

        stft_ops.stft_matmul = perturbed
        moved = {p: clip(p) for p in ("f32", "bf16")}
        stft_ops.stft_matmul = plain_stft
        for p in ("f32", "bf16"):
            print(f"STFT + {amp:g} x scale: {p} clip moves {max_rel(moved[p], base[p]):.3e} of "
                  f"output scale, rel-l2 {rel_l2(moved[p], base[p]):.3e}")

    plain_cov = cov_ops.masked_cov_kernel

    def perturbed_cov(y_, m, precision="f32"):
        g = torch.Generator().manual_seed(2)
        return tuple(t * (1 + 5e-7 * torch.randn(t.shape, generator=g))
                     for t in plain_cov(y_, m, precision))

    cov_ops.masked_cov_kernel = perturbed_cov
    moved = {p: clip(p) for p in ("f32", "bf16")}
    cov_ops.masked_cov_kernel = plain_cov
    for p in ("f32", "bf16"):
        print(f"covariances x (1 + 5e-7 noise): {p} clip moves {max_rel(moved[p], base[p]):.3e} "
              f"of output scale, rel-l2 {rel_l2(moved[p], base[p]):.3e}")


if __name__ == "__main__":
    main()
