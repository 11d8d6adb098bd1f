"""How far float32 roundoff alone moves the per-node gains of the MEETIT
separation milestone at its BASELINE scale (``milestones.meetit_separation``:
8 nodes x 4 mics, 2 sources, 5 s, no noise), on the host.

The configuration has no noise, so each source's interference covariance is
the other source's image alone and near rank-deficient; a node's gain then
depends on the covariances' last bits.  Each line is one run of
``disco_tpu_torch.milestones.meetit_separation(device="cpu")`` (its timing
stubbed, one run):

* ``f32``: the covariances as the port computes them on the host (float32
  sums, the covariance kernel's plain version);
* ``f64_cov``: the same covariances summed in float64 and rounded to
  float32 once;
* ``jax`` (with ``--jax``): the JAX package's ``meetit_separation`` on the
  CPU (``JAX_PLATFORMS=cpu``).

Run from the repo root::

    python exp/separation_roundoff.py [--jax]
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")


def stub_timing(module):
    """The milestone runs its pipeline once (its times are not read)."""
    module._time_queued = lambda fn, *args, k=1, iters=5: float(k)


def main() -> None:
    from disco_tpu_torch import milestones
    from disco_tpu_torch.ops import cov_ops

    stub_timing(milestones)
    gains = {"f32": milestones.meetit_separation(device="cpu")["delta_si_sdr"]}
    real = cov_ops.masked_cov_kernel

    def f64_cov(y, mask, precision="f32"):
        Rss, Rnn = real(y.to(torch.complex128), mask.to(torch.float64), precision)
        return Rss.to(torch.complex64), Rnn.to(torch.complex64)

    cov_ops.masked_cov_kernel = f64_cov
    try:
        gains["f64_cov"] = milestones.meetit_separation(device="cpu")["delta_si_sdr"]
    finally:
        cov_ops.masked_cov_kernel = real
    if "--jax" in sys.argv:
        from disco_tpu import milestones as jax_milestones

        stub_timing(jax_milestones)
        gains["jax"] = jax_milestones.meetit_separation()["delta_si_sdr"]
    for name, g in gains.items():
        print(json.dumps({"run": name, "delta_si_sdr": g}))
    for name, g in gains.items():
        if name != "f32":
            print(f"largest gap {name} vs f32: "
                  f"{float(np.max(np.abs(np.subtract(g, gains['f32'])))):.4f} dB")


if __name__ == "__main__":
    main()
