"""The offline oracle-mask path: a batch of clips through the port's one call,
``enhance.fused.tango_clip_fused`` (STFT of mixture, speech and noise in one
launch, oracle masks from its magnitudes, both TANGO steps with the
configured solver, ISTFT of the enhanced spectra).

Its reference: the plain STFT, ideal ratio masks at each node's reference
mic, both steps with the exact rank-1 GEVD filter, and the plain ISTFT
(``benchmark/reference``), in the dtype it is handed.
"""
from __future__ import annotations

import torch

from benchmark import costs
from benchmark.reference import dsp, tango as ref_tango


class Pipeline:
    """One cell's program call, its reference and its need."""

    def __init__(self, cfg: dict, mix: dict, device, gen: torch.Generator):
        from disco_tpu_torch.enhance.fused import tango_clip_fused

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self._fn = tango_clip_fused

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """(3, B, K, C, L) -> (B, K, L) enhanced signals, enqueued."""
        c = self.cfg
        return self._fn(x[0], x[1], x[2], mu=c["mu"], policy=c["policy"], ref_mic=c["ref_mic"],
                        mask_type=c["mask_type"], solver=c["solver"],
                        precision=self.mix["precision"], device=self.device)

    def reference(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """The plain pipeline on (3, B, K, C, L) in ``dtype``."""
        c = self.cfg
        x = x.to(dtype)
        L = x.shape[-1]
        spec = dsp.stft(x, c["n_fft"], c["hop"])                           # (3, B, K, C, F, T)
        Y, S, N = spec[0], spec[1], spec[2]
        r = c["ref_mic"]
        mask = ref_tango.irm1(S[..., r, :, :], N[..., r, :, :])
        yf = ref_tango.tango(Y, mask, mask, c["mu"])
        return dsp.istft(yf, L, c["n_fft"], c["hop"])

    def need(self, B: int, K: int, C: int, L: int) -> tuple[float, float]:
        return costs.oracle_batch_need(B, K, C, L, self.cfg["n_fft"], self.cfg["hop"])

    def span_hooks(self):
        """Modules whose forwards get a span in a traced run: none here."""
        return []

    def release(self) -> None:
        self._fn = None
