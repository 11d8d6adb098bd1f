"""The mesh lanes of the port's corpus driver, training CLI and tango CLI,
and the three gates as commands.

* ``enhance_rirs_batched(mesh=...)`` on a (batch 2) and a (node 2) mesh
  of two gloo ranks gives the meshless run's metrics (the bounds of
  tests/test_driver.py:320-340) and files; it refuses ``chained`` and
  ``bf16`` as the JAX package does.
* ``disco-torch-tango --mesh 1 1`` and ``disco-torch-train
  --data-parallel 1`` run in this process on a 1-rank world, byte for byte
  (the tree) or value for value (the checkpoint) the meshless commands;
  their too-few-devices messages are the JAX CLI's.
* The flywheel (with its data-parallel leg on two gloo ranks), promotion
  and endurance gates' ``main(["--device", "cpu"])`` exit 0 at their tiny
  sizes, and their event-log checks are the JAX gates' (fed a log that
  lacks every event, they report the JAX gates' failures).
"""
import re

import numpy as np
import pytest
import torch.distributed as dist

from disco_tpu_torch.enhance.driver import enhance_rirs_batched
from disco_tpu_torch.runs.check import NOISE, RIRS, SNR_RANGE, _mini_corpus
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread: a fixture)
    METRIC_ATOL, METRIC_RTOL, artifact_paths, one_host_thread)
from tests.torch_port_parallel_ranks import spawn

pytestmark = pytest.mark.usefixtures("one_host_thread")


@pytest.fixture(scope="module")
def corpus_runs(tmp_path_factory):
    io = tmp_path_factory.mktemp("lanes")
    _mini_corpus(io / "corpus")
    plain = enhance_rirs_batched(str(io / "corpus"), "living", list(RIRS), NOISE,
                                 snr_range=SNR_RANGE, n_nodes=4, mics_per_node=2,
                                 out_root=str(io / "plain"), save_fig=False, max_batch=2,
                                 score_workers=1, device="cpu")
    return io, plain, spawn(2, "driver_mesh", io)


def test_driver_mesh_lane_gives_the_meshless_metrics_and_files(corpus_runs):
    io, plain, mesh = corpus_runs
    assert set(plain) == set(RIRS)
    for rir, res in plain.items():
        for key, want in res.items():
            got = mesh[f"{rir}/{key}"]
            np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"{rir}/{key}")
    assert artifact_paths(io / "mesh") == artifact_paths(io / "plain")
    # rank 0 alone kept the ledger: every clip done once
    import json

    from disco_tpu_torch.runs.ledger import unit_rir

    recs = [json.loads(line) for line in (io / "mesh.jsonl").read_text().splitlines()]
    done = [r["unit"] for r in recs if r["state"] == "done"]
    assert sorted(done) == sorted(unit_rir(r, NOISE) for r in RIRS)


def test_driver_node_mesh_lane_gives_the_meshless_metrics_and_files(corpus_runs):
    """On a (batch 1, node 2) mesh each rank transforms and enhances its own
    two nodes, and rank 0 alone assembles the chunk."""
    io, plain, mesh = corpus_runs
    for rir, res in plain.items():
        for key, want in res.items():
            np.testing.assert_allclose(mesh[f"node/{rir}/{key}"], want, rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=f"{rir}/{key}")
    assert artifact_paths(io / "mesh_node") == artifact_paths(io / "plain")


def test_driver_mesh_lane_refuses_chained_and_bf16(corpus_runs):
    from disco_tpu_torch.parallel import make_mesh, single_rank_world

    io = corpus_runs[0]
    with single_rank_world("cpu"):
        mesh = make_mesh(n_node=1, device="cpu")
        for kw, msg in (({"chained": True}, "chained=True is a single-device lane"),
                        ({"precision": "bf16"}, "precision='bf16' is a single-device lane")):
            with pytest.raises(ValueError, match=re.escape(msg)):
                enhance_rirs_batched(str(io / "corpus"), "living", list(RIRS), NOISE,
                                     snr_range=SNR_RANGE, n_nodes=4, mics_per_node=2,
                                     out_root=str(io / "refused"), save_fig=False,
                                     max_batch=2, mesh=mesh, **kw)
    assert not dist.is_initialized()


def test_tango_cli_mesh_1_1_is_the_meshless_command(tmp_path):
    from disco_tpu_torch.cli import tango as ttango

    _mini_corpus(tmp_path / "ds", mics_per_node=4)
    base = ["--rirs", str(RIRS[0]), "2", "--dataset", str(tmp_path / "ds"), "--snr", "0", "6",
            "--noise", NOISE,
            "--batch_size", "2", "--device", "cpu"]
    plain = ttango.main(base + ["--out_root", str(tmp_path / "plain")])
    mesh = ttango.main(base + ["--out_root", str(tmp_path / "mesh"), "--mesh", "1", "1"])
    assert set(plain) == set(mesh) == set(RIRS)
    names = artifact_paths(tmp_path / "plain")
    assert names and names == artifact_paths(tmp_path / "mesh")
    for n in names:
        if n.endswith(".jsonl"):
            continue  # the run ledgers stamp wall-clock times
        assert (tmp_path / "mesh" / n).read_bytes() == (tmp_path / "plain" / n).read_bytes(), n
    assert not dist.is_initialized()


def test_train_cli_data_parallel_1_is_the_meshless_command(tmp_path):
    from disco_tpu_torch.cli import train as ttrain
    from disco_tpu_torch.nn.serialization import unpackb
    from disco_tpu_torch import flywheel as tfly

    rng = np.random.default_rng(5)
    shards = tmp_path / "shards"
    shards.mkdir()
    for i in range(3):
        recs = [{"session": "s", "seq": 2 * i + j, "t": 1.0 + j,
                 "Y": (rng.standard_normal((2, 2, 257, 8))
                       + 1j * rng.standard_normal((2, 2, 257, 8))).astype(np.complex64),
                 "yf": np.zeros((2, 257, 8), np.complex64),
                 "mask_z": rng.uniform(0.05, 0.95, (2, 257, 8)).astype(np.float32),
                 "mask_w": rng.uniform(0.05, 0.95, (2, 257, 8)).astype(np.float32)}
                for j in range(2)]
        tfly.write_shard(shards / f"tap-{i + 1:06d}.shard.msgpack", recs)
    base = ["--shards", str(shards), "--batch_size", "4", "--n_epochs", "2", "--device", "cpu"]
    ttrain.main(base + ["--save_path", str(tmp_path / "plain")])
    ttrain.main(base + ["--save_path", str(tmp_path / "mesh"), "--data-parallel", "1"])
    (a,), (b,) = ((tmp_path / d).glob("*_model.msgpack") for d in ("plain", "mesh"))
    pa, pb = unpackb(a.read_bytes()), unpackb(b.read_bytes())

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    la, lb = dict(leaves(pa)), dict(leaves(pb))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert not dist.is_initialized()


def test_too_few_devices_messages_are_the_jax_clis(tmp_path):
    """The JAX CLI on its 8 devices and the port on its 1-rank world
    refuse a mesh too wide with the same sentence."""
    from disco_tpu.cli import tango as jtango_cli
    from disco_tpu_torch.cli import tango as ttango
    from disco_tpu_torch.cli import train as ttrain

    template = r"^--mesh (\d+) (\d+) needs (\d+) devices; (\d+) available$"
    with pytest.raises(SystemExit) as jax_exit:
        jtango_cli.main(["--rirs", "1", "1", "--dataset", str(tmp_path), "--mesh", "4", "4"])
    assert re.match(template, str(jax_exit.value)), str(jax_exit.value)
    assert str(jax_exit.value) == "--mesh 4 4 needs 16 devices; 8 available"
    with pytest.raises(SystemExit) as port_exit:
        ttango.main(["--rirs", "1", "1", "--dataset", str(tmp_path), "--mesh", "4", "4",
                     "--device", "cpu"])
    assert str(port_exit.value) == "--mesh 4 4 needs 16 devices; 1 available"
    for argv, msg in ((["--batch_size", "3", "--mesh", "2", "1"], None),
                      (["--mesh", "1", "3"], None)):
        with pytest.raises(SystemExit) as j:
            jtango_cli.main(["--rirs", "1", "1", "--dataset", str(tmp_path)] + argv)
        with pytest.raises(SystemExit) as t:
            # the port checks the world first: a 1-rank world is too small
            ttango.main(["--rirs", "1", "1", "--dataset", str(tmp_path), "--device", "cpu"]
                        + argv)
        assert "needs" in str(t.value) or str(t.value) == str(j.value)
    with pytest.raises(SystemExit, match=r"^--data-parallel 3 needs 3 devices; 1 available$"):
        ttrain.main(["--data-parallel", "3", "--device", "cpu"])
    assert not dist.is_initialized()


# -------------------------------------------------------------- the gates
@pytest.mark.parametrize("gate", ["flywheel", "promote", "endure"])
def test_gate_command_on_the_cpu(gate, capsys):
    import importlib
    import json

    mod = importlib.import_module({"flywheel": "disco_tpu_torch.flywheel.check",
                                   "promote": "disco_tpu_torch.promote.check",
                                   "endure": "disco_tpu_torch.runs.endure"}[gate])
    assert mod.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line[f"{gate}_check"] == "ok"
    if gate == "flywheel":
        assert line["ranks"] == 2 and line["mesh_loss_rtol"] == 2e-4
    assert not dist.is_initialized()


def test_gate_event_log_checks_are_the_jax_gates():
    """Fed an empty log, each port check reports the JAX gate's failure
    sentences (disco_tpu/flywheel/check.py:397-403, disco_tpu/promote/
    check.py:691-720, disco_tpu/runs/endure.py:518-545)."""
    from disco_tpu_torch.flywheel import check as fc
    from disco_tpu_torch.promote import check as pc
    from disco_tpu_torch.runs import endure

    assert fc.event_log_failures([]) == [
        "event log missing tap shard-rotation events",
        "event log missing the corrupt-shard warning"]
    assert pc.event_log_failures([], 3) == [
        "event log missing the watch-dir staged event",
        "event log missing promoted events (clean + post-crash promotion)",
        "event log missing canary assign/swap events",
        "event log missing the demotion begin/done events",
        "event log missing the crash-resume rollback event",
        "event log carries 0 controller-crash events, expected 2 (mid_canary + post_gate)",
        "event log carries 0 chaos_crash events, expected 3"]
    assert endure.event_log_failures([], 5) == [
        "event log carries 0 generation-published events, need >= 3",
        "event log carries 0 promoted events, need >= 3",
        "event log missing the trainer's run_resume event (ledger resume never happened)",
        "event log carries 0 chaos_crash events, expected 5"]
    ev = [{"kind": "fault", "attrs": {"fault": "chaos_crash"}}] * 5
    assert endure.event_log_failures(ev, 5)[-1:] != ["event log carries 5 chaos_crash events, "
                                                     "expected 5"]
