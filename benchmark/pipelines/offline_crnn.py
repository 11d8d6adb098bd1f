"""The offline CRNN-mask path, as the corpus driver runs a chunk
(``enhance/driver.py``, the staged lane with models): the STFT of the
mixture, speech and noise stack in one launch (``ops.stft_ops.stft_fused``),
``enhance.driver._batched_masks`` (the step-1 CRNN on each node's reference
mic, step 1 by ``compute_z_signals`` for the exchanged z, the step-2 CRNN on
the reference mic and the other nodes' z), ``enhance.tango.tango`` with the
configured solver, and ``core.dsp.istft`` of the enhanced spectra.  The port
has no public entry for this chain; these are the calls the driver makes, in
its order.

Both CRNNs are ``nn.crnn.build_crnn``'s modules on the device with weights
drawn from the seed (``benchmark/weights.py``); the reference gets the same
draws, not the modules.
"""
from __future__ import annotations

import torch

from benchmark import costs, weights
from benchmark.harness import span
from benchmark.reference import crnn as ref_crnn, dsp, tango as ref_tango


class Pipeline:
    """One cell's program call, its reference and its need."""

    def __init__(self, cfg: dict, mix: dict, device, gen: torch.Generator):
        from disco_tpu_torch.core.dsp import istft
        from disco_tpu_torch.enhance.driver import _batched_masks
        from disco_tpu_torch.enhance.tango import tango
        from disco_tpu_torch.nn.crnn import build_crnn
        from disco_tpu_torch.ops.stft_ops import stft_fused

        self._calls = (stft_fused, _batched_masks, tango, istft)
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        K = cfg["nodes"]
        net = cfg["crnn"]
        self.params = [weights.draw_crnn(1, gen, self.device), weights.draw_crnn(K, gen, self.device)]
        self.models = []
        for n_ch, p in zip((1, K), self.params):
            m = build_crnn(n_ch=n_ch, win_len=net["win_len"], n_freq=cfg["n_fft"] // 2 + 1,
                           cnn_filters=tuple(net["cnn_filters"]), rnn_units=(net["rnn_units"],),
                           ff_units=(cfg["n_fft"] // 2 + 1,)).to(self.device)
            weights.load_into(m, p)
            m.eval()
            self.models.append(m)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """(3, B, K, C, L) -> (B, K, L) enhanced signals, enqueued."""
        stft_fused, _batched_masks, tango, istft = self._calls
        c, prec = self.cfg, self.mix["precision"]
        spec = stft_fused(x, precision=prec)
        with span("bench.masks"):
            Mz, Mw = _batched_masks(spec[0], spec[1], spec[2], self.models, c["mask_type"],
                                    c["mu"], c["nodes"], c["z_signals"], device=self.device)
        res = tango(spec[0], spec[1], spec[2], Mz, Mw, mu=c["mu"], policy=c["policy"],
                    mask_type=c["mask_type"], solver=c["solver"], precision=prec,
                    device=self.device)
        return istft(res.yf, length=x.shape[-1])

    def reference(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """The plain pipeline on (3, B, K, C, L) in ``dtype``."""
        c = self.cfg
        p1, p2 = ({k: v.to(dtype) for k, v in p.items()} for p in self.params)
        y = x[0].to(dtype)
        B, K, C, L = y.shape
        Y = dsp.stft(y, c["n_fft"], c["hop"])                              # (B, K, C, F, T)
        F, T = Y.shape[-2:]
        ref = Y[:, :, c["ref_mic"]]                                        # (B, K, F, T)
        Mz = ref_crnn.masks(ref.reshape(B * K, 1, F, T), p1).reshape(B, K, F, T)
        z = ref_tango.step1(Y, Mz, c["mu"], solver=c["z_solver"])
        idx = torch.tensor(ref_tango.others(K), device=y.device)
        z_in = torch.cat([ref[:, :, None], z[:, idx]], dim=2)               # (B, K, K, F, T)
        Mw = ref_crnn.masks(z_in.reshape(B * K, K, F, T), p2).reshape(B, K, F, T)
        yf = ref_tango.tango(Y, Mz, Mw, c["mu"])
        return dsp.istft(yf, L, c["n_fft"], c["hop"])

    def need(self, B: int, K: int, C: int, L: int) -> tuple[float, float]:
        return costs.crnn_batch_need(B, K, C, L, 12, self.cfg["n_fft"], self.cfg["hop"])

    def span_hooks(self):
        """Modules whose forwards get the ``bench.crnn`` span in a traced run."""
        return [("bench.crnn", m) for m in self.models]

    def release(self) -> None:
        self.models, self._calls = [], None
