"""The harness on the CPU at a tiny size, with the port's plain versions:
a run's result object, the pieces found by file name, and the check failing
under each planted fault."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import faults, harness, spec
from benchmark.tests.tiny import ROOT, write_tiny

SEED = 2 ** 33 + 12345


def _run(root, cell_name, trace=False, variant=None, seed=SEED, seconds=0.3):
    cell = spec.load_cell(root, cell_name)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", variant=variant)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contract_keys(tiny, cells, trace):
    for name in cells:
        res = _run(tiny, name, trace=trace)
        assert list(res)[:3] == ["correct", "attempted", "failed"]
        assert list(res)[-1] == "checks"
        assert res["correct"] is True and res["failed"] == 0
        assert res["attempted"] % 2 == 0 and res["attempted"] >= 2
        assert res["device"]["count"] == 1
        n = res["checks"]["err_worst"]
        assert 0 < n["value"] < 1e-4 and n["limit"] == 1e-3
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        if not trace:
            assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}
            assert all(m["value"] > 0 for k, m in res["metrics"].items() if k != "peak_mem_gib")
        else:
            # no device here: only the host-clock readers find something to read
            assert set(res["metrics"]) == {"mfu", "dispatch_ms"}
            assert "breakdown" in res and "busy_s" in res["device"]


def test_the_same_seed_gives_the_same_inputs_and_weights(tiny):
    import torch

    from benchmark import scenes

    cell = spec.load_cell(tiny, "offline-crnn.taslp21-4x4")
    a, b, c = (scenes.make_pool(cell.cfg, cell.mix, scenes.generator(s, "cpu"), "cpu")
               for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 2, 2, 2, 4000)
    y, s, n = a[0]
    assert torch.allclose(y, s + n)
    snr = 10 * torch.log10(s.pow(2).mean((1, 2, 3)) / n.pow(2).mean((1, 2, 3)))
    assert ((snr > -1e-3) & (snr < 6 + 1e-3)).all()


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_planted_fault_makes_the_run_incorrect(tiny, cells, fault):
    for name in cells:
        res = _run(tiny, name, variant=faults.FAULTS[fault])
        assert res["correct"] is False, (name, fault, res["checks"])
        assert res["failed"] > 0


def test_the_bf16_lane_fails_the_f32_limit(tmp_path):
    root = write_tiny(tmp_path, mix={"precision": "bf16"})
    res = _run(root, "offline-oracle.north-8x4")
    assert res["correct"] is False and res["checks"]["err_worst"]["value"] > 1e-3


def test_mixes_cells_and_metrics_are_found_by_file_name(tiny, monkeypatch, tmp_path):
    # a new mix and a new cell: data files and entries only
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    mix = json.loads((tiny / "benchmark/traffic/offline-oracle.json").read_text())
    mix["batch_clips"] = 4
    (tiny / "benchmark/traffic/offline-oracle-wide.json").write_text(json.dumps(mix))
    (tiny / "benchmark/cells/offline-oracle-wide.taslp21-4x4.json").write_text(
        json.dumps({"limits": {"err_worst": 1e-3}}))
    bench["workloads"].append({"name": "offline-oracle-wide.taslp21-4x4", "config": "taslp21-4x4",
                               "traffic": "offline-oracle-wide", "chips": 1, "why": "test"})
    # a new per-layer metric: its reader's file and its entry
    code = tmp_path / "code"
    shutil.copytree(ROOT / "benchmark" / "metrics", code / "metrics")
    shutil.copytree(ROOT / "benchmark" / "pipelines", code / "pipelines")
    (code / "metrics" / "batches_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.n_traced)\n")
    bench["per_layer"].append({"name": "batches_traced", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "clip_audio_s_per_s",
                               "workloads": ["offline-oracle-wide.taslp21-4x4"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", code)
    res = _run(tiny, "offline-oracle-wide.taslp21-4x4", trace=True)
    assert res["metrics"]["batches_traced"]["value"] == 2.0
    assert res["attempted"] % 4 == 0 and res["correct"] is True
    with pytest.raises(KeyError):
        spec.load_cell(tiny, "offline-oracle.nowhere")


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: exit code 2, nothing on standard output."""
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "offline-oracle.north-8x4", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode == 2 and out.stdout == "", out.stderr[-2000:]


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/: no program, no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "offline-oracle.north-8x4", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
