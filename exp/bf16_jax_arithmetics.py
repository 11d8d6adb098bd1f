"""The JAX package's two bf16 arithmetics, on the CPU: its interpret-mode
Pallas kernels and its XLA formulations round at different points, so the
bf16 lane has no one set of bits to port.

(a) the STFT of two 16000-sample rows: ``stft_pallas(interpret=True,
    precision='bf16')`` (the frame, the window and their product rounded)
    against ``stft_matmul(precision='bf16')`` (the f32 windowed frame
    rounded once), each against the f32 STFT, max |a - b| / max |b|;
(b) the masked covariances at C=3, F=257, T=64: ``masked_cov_pallas(
    interpret=True, precision='bf16')`` (its pair products rounded) against
    ``masked_covariances_folded(precision='bf16')`` (its weights rounded)::

    JAX_PLATFORMS=cpu python exp/bf16_jax_arithmetics.py
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from disco_tpu.ops import cov_ops, stft_ops  # noqa: E402


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> None:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    kernel = stft_ops.stft_pallas(x, interpret=True, precision="bf16")
    folded = stft_ops.stft_matmul(x, precision="bf16")
    f32 = stft_ops.stft_matmul(x)
    print(f"(a) STFT: interpret kernel vs stft_matmul, bf16: {max_rel(kernel, folded):.3e}; "
          f"kernel vs f32 {max_rel(kernel, f32):.3e}; stft_matmul vs f32 "
          f"{max_rel(folded, f32):.3e} of the output scale")
    y = (rng.standard_normal((3, 257, 64)) + 1j * rng.standard_normal((3, 257, 64)))
    y = y.astype(np.complex64)
    m = rng.random((257, 64)).astype(np.float32)
    k = cov_ops.masked_cov_pallas(y, m, interpret=True, precision="bf16")
    f = cov_ops.masked_covariances_folded(y, m, precision="bf16")
    print("(b) covariances: interpret kernel vs folded einsum, bf16: "
          + ", ".join(f"{name} {max_rel(a, b):.3e}" for name, a, b in
                      (("Rss", k[0], f[0]), ("Rnn", k[1], f[1]))) + " of the output scale")


if __name__ == "__main__":
    main()
