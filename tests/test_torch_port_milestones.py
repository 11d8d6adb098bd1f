"""The port's milestone configurations (``disco_tpu_torch.milestones``)
against the JAX package's (``disco_tpu.milestones``), on the CPU.

Both packages run ``run_all(tiny=True)`` once (module fixtures) on the same
numpy-drawn scenes.  Each configuration is one case: the same keys, the
non-timing fields equal (``config``, ``frames``, ``update_every``,
``frame_budget_ms``, ``rooms``), ``si_sdr_in`` within 1e-3 dB (the same
arrays scored by the same metric), and the quality fields that the
pipelines make (``si_sdr_out``, each ``delta_si_sdr``,
``mean_si_sdr_out``) within ``TOL_DB``.  The largest gap measured on this
host is 5.9e-4 dB (configuration 4's per-node deltas), so the bound is
5e-3 dB, not the 0.05 dB first asked.

The port runs on one torch and one BLAS thread
(``torch_port_helpers.one_host_thread``), as the other multi-module
port tests do, so the module does not crowd the runner's other workers.

Then the timing arithmetic (the k-queued slope, patched as
``tests/test_bench_timing.py`` patches the JAX package's), the fence's
counter and chaos seam, and the refusal without a CUDA device.
"""
import numpy as np
import pytest
import torch

from disco_tpu_torch import milestones
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

#: the quality fields' bound in dB (largest measured gap: 5.9e-4 dB)
TOL_DB = 5e-3
#: ``si_sdr_in``: the same arrays through the same metric
TOL_IN_DB = 1e-3
TIMING = frozenset({"rtf", "rtf_single_dispatch", "dispatch_ms", "per_frame_ms"})
QUALITY = frozenset({"si_sdr_out", "delta_si_sdr", "mean_si_sdr_out"})
NAMES = ["mvdr_single_clip", "disco_mwf_4node", "tango_4node", "meetit_separation",
         "batched_meetit_end_to_end", "streaming_latency"]


@pytest.fixture(scope="module")
def jax_results():
    from disco_tpu import milestones as jm

    return jm.run_all(tiny=True)


@pytest.fixture(scope="module")
def port_results():
    return milestones.run_all(tiny=True, device="cpu")


def _keys(d, prefix=()):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _keys(v, prefix + (k,))
    return out


@pytest.mark.parametrize("i", range(6), ids=NAMES)
def test_config_matches_jax(i, jax_results, port_results):
    ours, theirs = port_results[i], jax_results[i]
    assert ours["config"] == theirs["config"] == NAMES[i]
    assert _keys(ours) == _keys(theirs)
    for key, want in theirs.items():
        have = ours[key]
        if key in TIMING:
            assert have > 0 if key != "dispatch_ms" else have >= 0, (key, have)
        elif key == "policies":
            assert all(p["per_frame_ms"] > 0 and p["rtf"] > 0 for p in have.values()), have
        elif key == "si_sdr_in":
            assert abs(have - want) < TOL_IN_DB, (key, have, want)
        elif key in QUALITY:
            np.testing.assert_allclose(have, want, rtol=0, atol=TOL_DB, err_msg=key)
        else:
            assert have == want, (key, have, want)


def test_the_gates_of_the_jax_tests_hold(port_results):
    """``tests/test_milestones.py``'s gates on the port's results."""
    mvdr, mwf, tng, sep, batched, _ = port_results
    assert all(r["rtf"] > 0 for r in port_results[:5])
    assert mvdr["si_sdr_out"] > mvdr["si_sdr_in"] + 3
    assert all(d > 1 for r in (mwf, tng) for d in r["delta_si_sdr"])
    assert all(d > 0 for d in sep["delta_si_sdr"])
    assert np.isfinite(batched["mean_si_sdr_out"]) and batched["rooms"] == 2


# ------------------------------------------------------------------ timing
def _slope_recovered(monkeypatch):
    calls = {}

    def fake_time_queued(fn, *args, k=1, iters=5):
        calls[k] = calls.get(k, 0) + 1
        return 0.080 + k * 0.012  # 80 ms fixed cost + 12 ms a run

    monkeypatch.setattr(milestones, "_time_queued", fake_time_queued)
    slope, t1 = milestones._slope_time(lambda: None, k=6, iters=3)
    assert abs(slope - 0.012) < 1e-12
    assert abs(t1 - 0.092) < 1e-12
    assert set(calls) == {1, 6}


def _slope_falls_back(monkeypatch):
    """Jitter can make t_k <= t_1: the estimator then reports t_k / k."""
    monkeypatch.setattr(milestones, "_time_queued",
                        lambda fn, *args, k=1, iters=5: 0.100 if k == 1 else 0.090)
    slope, _ = milestones._slope_time(lambda: None, k=6, iters=3)
    assert abs(slope - 0.090 / 6) < 1e-12


def _median_used(monkeypatch):
    import time as _time

    seq = iter([0.0, 0.5, 1.0, 1.1, 2.0, 2.9, 4.0, 4.2, 6.0, 6.25])
    monkeypatch.setattr(_time, "perf_counter", lambda: next(seq))
    monkeypatch.setattr(milestones, "_fence", lambda x: 0.0)
    monkeypatch.setattr(milestones, "_leaf", lambda x: x)
    # deltas 0.5, 0.1, 0.9, 0.2, 0.25 -> median 0.25
    assert abs(milestones._time_queued(lambda: 0, k=1, iters=5) - 0.25) < 1e-12


@pytest.mark.parametrize("case", [_slope_recovered, _slope_falls_back, _median_used],
                         ids=["slope", "fallback", "median"])
def test_slope_arithmetic(case, monkeypatch):
    case(monkeypatch)


def test_rtf_fields_and_leaf():
    assert milestones._rtf_fields(10.0, 0.5, 0.75) == {
        "rtf": 20.0, "rtf_single_dispatch": 10.0 / 0.75, "dispatch_ms": 250.0}
    assert milestones._rtf_fields(1.0, 0.5, 0.25)["dispatch_ms"] == 0.0
    a, b = torch.zeros(2), torch.ones(2)
    assert milestones._leaf((a, b)) is a
    assert milestones._leaf({"z": b, "a": a}) is a
    assert milestones._leaf(b) is b


# ------------------------------------------------------------------- fence
class _Flaky:
    """A stand-in tensor whose one-element readback drops the first
    ``fail`` times with a transport error."""

    def __init__(self, fail):
        self.fail, self.reads = fail, 0

    def reshape(self, *shape):
        return self

    def __getitem__(self, i):
        return self

    @property
    def real(self):
        return self

    def item(self):
        self.reads += 1
        if self.reads <= self.fail:
            raise ConnectionError("dropped readback")
        return 3.0


def test_fence_ticks_once_an_attempt():
    from disco_tpu_torch.obs import accounting

    before = accounting.fence_count()
    assert milestones._fence(torch.tensor([2.0 + 1.0j, 5.0])) == 2.0
    assert accounting.fence_count() == before + 1
    flaky = _Flaky(fail=1)
    assert milestones._fence(flaky) == 3.0
    assert flaky.reads == 2 and accounting.fence_count() == before + 3


def test_pre_fence_seam_fires_before_the_readback():
    from disco_tpu_torch.obs import accounting
    from disco_tpu_torch.runs import chaos

    flaky = _Flaky(fail=0)
    before = accounting.fence_count()
    chaos.configure("pre_fence", after=1)
    try:
        with pytest.raises(chaos.ChaosCrash):
            milestones._fence(flaky)
    finally:
        chaos.disable()
    assert flaky.reads == 0 and accounting.fence_count() == before


# ------------------------------------------------------------------ device
@pytest.mark.parametrize("i", sorted(milestones.CONFIGS), ids=NAMES)
def test_refuses_without_cuda(i, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        milestones.CONFIGS[i](**milestones.TINY[i])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        milestones.run_all(tiny=True)
