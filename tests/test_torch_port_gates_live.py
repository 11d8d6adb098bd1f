"""The port's scene, scope and soak gates, each leg called on
``device="cpu"`` at the JAX gate's size: the scene factory's six legs and
its log legs (``scenes.check``); complete causal chains, the untraced
client, the status frame and the fault leg's byte-stable dump
(``obs.scope``); one soak seed run twice, byte-stable, and the crash leg
(``runs.soak``), whose campaign plans are the JAX package's draw for draw.
"""
import pytest

import disco_tpu_torch.obs as tobs
from disco_tpu.runs import soak as jsoak
from disco_tpu_torch.runs import soak as tsoak
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")


def test_scene_gate_passes_on_cpu(tmp_path):
    from disco_tpu_torch.scenes import check

    failures, out = [], {}
    with tobs.recording(tmp_path / "log.jsonl"):
        out.update(check.check_oracle_parity(failures, device="cpu"))
        out.update(check.check_batched_equals_per_scene(failures, device="cpu"))
        out.update(check.check_dispatch_budget(failures, device="cpu"))
        out.update(check.check_dynamic_continuity(failures, device="cpu"))
        out.update(check.check_datagen_chaos_resume(failures, tmp_path, device="cpu"))
        out.update(check.check_stream(failures, tmp_path, device="cpu"))
    out.update(check.check_scene_events(failures, tobs.read_events(tmp_path / "log.jsonl")))
    assert failures == []
    assert out["readbacks_per_batch"] == 1 and out["retraces_total"] == 2
    assert out["oracle_rel_err"] < check.ORACLE_RTOL


def test_scope_gate_passes_on_cpu(tmp_path):
    from disco_tpu_torch.obs import scope

    failures = []
    out = scope.run_scope(failures, tmp_path, device="cpu")
    assert failures == []
    # three traced clients of 24 frames in 8-frame blocks: 9 chains
    assert out["chains_verified"] == 9 and out["flight_dumps"] >= 1
    assert out["failing_spans"] >= 1 and out["injected_failures"] == 3


def test_soak_seed_is_byte_stable_on_cpu(tmp_path):
    failures = []
    summary = tsoak.check_byte_stable(failures, tmp_path, tsoak.SEEDS[0], device="cpu")
    assert failures == []
    assert summary["all_parks_reattached"] and summary["evictions"] == 0
    assert summary["transport_faults_injected"] == summary["transport_faults_planned"]


def test_soak_crash_leg_resumes_bit_exact_on_cpu(tmp_path):
    failures = []
    out = tsoak.crash_leg(tsoak.SEEDS[-1], tmp_path, failures, device="cpu")
    assert failures == []
    assert out["crash_injected"] and out["blocks_before_park"] == out["blocks_total"] // 2


@pytest.mark.parametrize("seed", jsoak.SEEDS)
def test_soak_plans_are_the_jax_packages(seed):
    assert tsoak.SEEDS == jsoak.SEEDS
    assert tsoak.plan_campaign(seed) == jsoak.plan_campaign(seed)
    assert tsoak.recovery_tick_bound(17) == jsoak.recovery_tick_bound(17)
