"""The trace reduction and the per-layer readers on a hand-made Chrome trace
of the shape ``torch.profiler`` exports: kernels linked to their launches by
correlation id, the launches to the named kernel op and the benchmark's
spans around them."""
from __future__ import annotations

import json
import types

import pytest

from benchmark import costs, spec, trace as trace_mod


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


EVENTS = [
    _x("user_annotation", "bench.batch", 90, 220),
    _x("cpu_op", "disco_torch::stft", 100, 50, **{
        "External id": 7, "Input Dims": [[3, 2, 1000], [], [], []],
        "Concrete Inputs": ["", "512", "256", "True"]}),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=1),
    _x("user_annotation", "bench.masks", 200, 50),
    _x("user_annotation", "bench.crnn", 205, 20),
    _x("cpu_op", "aten::convolution", 206, 10, **{"External id": 8}),
    _x("cuda_runtime", "cudaLaunchKernel", 210, 2, correlation=2),
    _x("cpu_op", "aten::mul", 295, 10, **{"External id": 9}),
    _x("cuda_runtime", "cudaLaunchKernel", 300, 2, correlation=3),
    _x("user_annotation", "bench.readback", 320, 130),
    _x("cuda_runtime", "cudaMemcpyAsync", 400, 2, correlation=4),
    _x("kernel", "stft_rfft_kernel(float const*)", 120, 10, tid=7, correlation=1),
    _x("kernel", "cudnn::conv_kernel", 220, 20, tid=7, correlation=2),
    _x("kernel", "vectorized_elementwise_kernel", 305, 5, tid=7, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 410, 30, tid=7, correlation=4),
]


@pytest.fixture
def parsed(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace_mod.parse(str(p))


def test_kernels_are_linked_to_their_op_and_spans(parsed):
    k = {d.name.split("(")[0]: d for d in parsed.device}
    assert k["stft_rfft_kernel"].op["name"] == "disco_torch::stft"
    assert k["stft_rfft_kernel"].spans == {"bench.batch"}
    assert k["cudnn::conv_kernel"].op is None
    assert k["cudnn::conv_kernel"].spans == {"bench.batch", "bench.masks", "bench.crnn"}
    assert k["Memcpy DtoH "].spans == {"bench.readback"}
    assert [c["name"] for c in parsed.ops] == ["disco_torch::stft"]
    assert parsed.busy_s == pytest.approx(65e-6) and parsed.window_s == pytest.approx(320e-6)
    gaps = dict(parsed.breakdown["idle_gaps"])
    assert gaps["bench.readback / python"] == pytest.approx(100e-6)
    assert gaps["bench.batch / python"] == pytest.approx(155e-6)
    assert parsed.breakdown["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", 30e-6]


def _read(name, parsed, **window):
    ctx = types.SimpleNamespace(trace=parsed, n_traced=1, costs=costs,
                                window=window or {"batches": 2, "seconds": 1.0,
                                                  "dispatch_s": [0.002, 0.004, 0.003]},
                                need=(67e9, 0.0))
    return spec.metric_reader(name)(ctx)


def test_the_readers(parsed):
    bound = costs.bound_s(costs.stft_flops(6, 1000), costs.stft_bytes(6, 1000))[0]
    assert _read("stft_roofline", parsed) == pytest.approx(100 * bound / 10e-6)
    assert _read("fused_mwf_roofline", parsed) is None
    assert _read("glue_ms", parsed) == pytest.approx(0.005)
    assert _read("crnn_ms", parsed) == pytest.approx(0.020)
    assert _read("launches_per_batch", parsed) == 3
    assert _read("readback_ms", parsed) == pytest.approx(0.030)
    assert _read("idle_share", parsed) == pytest.approx(100 * (1 - 65 / 320))
    assert _read("dispatch_ms", parsed) == pytest.approx(3.0)
    assert _read("mfu", parsed) == pytest.approx(100 * 1e-3 / 0.5)


def test_an_empty_trace_gives_nothing_to_read(tmp_path):
    p = tmp_path / "e.json"
    p.write_text(json.dumps({"traceEvents": [_x("cpu_op", "aten::add", 1, 1)]}))
    empty = trace_mod.parse(str(p))
    for name in ("stft_roofline", "fused_mwf_roofline", "glue_ms", "crnn_ms",
                 "launches_per_batch", "readback_ms", "idle_share"):
        assert _read(name, empty) is None
