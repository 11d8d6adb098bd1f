"""The frozen costs against what they count: the CRNN's layer shapes, the
kernel ops' boundary tensors at a small size, and the program's own formulas
and peaks as they stand today."""
from __future__ import annotations

import math

import pytest
import torch

from benchmark import costs


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("n_ch", [1, 4])
def test_crnn_cost_counts_the_layers_shapes(n_ch):
    """Operations of the convolutions from their output shapes, of the GRU
    from its input windows, of the output layer from its input, over a
    stream forward of the port's CRNN at the published widths."""
    from disco_tpu_torch.enhance.inference import get_frames_to_pad
    from disco_tpu_torch.nn.crnn import build_crnn

    m = build_crnn(n_ch=n_ch).eval()
    n_streams, T = 2, 7
    seen = {"conv": 0, "gru": 0, "ff": 0}

    def conv_hook(mod, inp, out):
        seen["conv"] += 2 * out.numel() * mod.weight[0].numel()

    def gru_hook(mod, inp, out):
        b, steps, _ = inp[0].shape
        seen["gru"] += b * steps * 2 * 3 * mod.hidden_size * (mod.input_size + mod.hidden_size)

    def ff_hook(mod, inp, out):
        seen["ff"] += 2 * out.numel() * mod.in_features

    for conv in m.cnn.convs:
        conv.register_forward_hook(conv_hook)
    m.rnn.layers[0].register_forward_hook(gru_hook)
    m.ff.layers[0].register_forward_hook(ff_hook)
    pad = sum(get_frames_to_pad(21, "last", out_len=15))
    with torch.no_grad():
        m(torch.rand(n_streams, n_ch, 257, T + pad), stream=True)
    assert sum(seen.values()) == costs.crnn_cost(n_streams, n_ch, T)


def test_kernel_bytes_are_the_ops_boundary_tensors():
    from disco_tpu_torch.ops import cov_ops, mwf_ops, stft_ops

    x = torch.randn(2, 3, 1000)
    for with_mag in (False, True):
        out = torch.ops.disco_torch.stft(x, 512, 256, with_mag)
        assert _nbytes(x, *out) == costs.stft_bytes(6, 1000, with_mag=with_mag)
    y = torch.randn(5, 3, 257, 9, dtype=torch.complex64)
    for mask in (torch.rand(5, 257, 9), torch.rand(5, 3, 257, 9)):
        rss, rnn = cov_ops.masked_covariances_plain(y, mask)
        chan = mask.ndim == y.ndim
        assert _nbytes(y, mask, rss, rnn) == costs.cov_bytes(5, 3, 257, 9, chan)
    A = torch.randn(7, 4, 4, dtype=torch.complex64)
    R = A @ A.mH + torch.eye(4)
    w, t1 = mwf_ops.fused_mwf_plain(R, R + torch.eye(4))
    assert _nbytes(R, R, w, t1) == costs.mwf_bytes(7, 4)
    assert stft_ops.KERNEL_N_FFT == 512 and stft_ops.KERNEL_HOP == 256


def test_frozen_formulas_equal_the_programs_today():
    from disco_tpu_torch.analysis.meter import costmodel
    from disco_tpu_torch.obs import roofline
    from disco_tpu_torch.ops.eigh_ops import default_sweeps

    for rows, L, mag in ((3, 1000, True), (96, 160000, False)):
        assert costs.stft_flops(rows, L, with_mag=mag) == costmodel.stft_flops(rows, L,
                                                                               with_mag=mag)
    for D, chan in ((4, False), (11, True)):
        assert costs.cov_flops(7, D, 257, 626, chan) == costmodel.cov_flops(7, D, 257, 626, chan)
    for C in (2, 4, 5, 6, 11, 12, 13):
        assert costs.default_sweeps(C) == default_sweeps(C)
        assert costs.mwf_flops(9, C) == costmodel.mwf_flops(9, C, default_sweeps(C))
    assert (costs.PEAK_FP32, costs.PEAK_BF16, costs.PEAK_BYTES) == (
        roofline.PEAK_FP32, roofline.PEAK_BF16, roofline.PEAK_BYTES)


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert costs.bound_s(67e12, 0) == (1.0, "operations")
    assert costs.bound_s(0, 3.35e12) == (1.0, "bytes")
    t, by = costs.bound_s(*costs.oracle_batch_need(16, 8, 4, 160000))
    assert by == "operations" and 0.5e-3 < t < 1e-3


def test_batch_needs_scale_with_the_batch_and_count_boundaries_once():
    f1, b1 = costs.oracle_batch_need(1, 8, 4, 160000)
    f16, b16 = costs.oracle_batch_need(16, 8, 4, 160000)
    assert math.isclose(f16, 16 * f1) and math.isclose(b16, 16 * b1)
    assert b1 == (3 * 8 * 4 + 8) * 160000 * 4
    f, b = costs.crnn_batch_need(16, 4, 4, 160000)
    assert f > costs.crnn_cost(64, 1, 626) + costs.crnn_cost(64, 4, 626)
    assert b == (64 * 4 + 64) * 160000 * 4 + costs.crnn_param_bytes(1) + costs.crnn_param_bytes(4)


@pytest.mark.parametrize("n_ch", [1, 4])
def test_crnn_param_bytes_are_the_modules(n_ch):
    from disco_tpu_torch.nn.crnn import build_crnn

    m = build_crnn(n_ch=n_ch)
    state = {k: v for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert _nbytes(*state.values()) == costs.crnn_param_bytes(n_ch)
