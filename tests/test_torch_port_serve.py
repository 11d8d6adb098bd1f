"""The port's online serving (``disco_tpu_torch.serve``) on the CPU
(``device="cpu"``), held to the port's offline streaming bit for bit and to
the JAX package's offline streaming at its documented tolerance.

Sessions are the JAX package's serve-check sessions (K=4 nodes x C=2 mics,
F=257, 32 frames, blocks of 8; ``disco_tpu/serve/check.py``): defaults,
mu 1.2, lambda 0.97, a z_mask that drops node 1, and the fused solve's
plain version ('fused-xla'), on white-noise spectra with uniform soft
masks.  Inside the port every served stream equals the whole-clip
``streaming_tango`` bit for bit in both tick modes, with one batched
readback a tick.

Against the JAX package the streams are compared as
``tests/test_torch_port_streaming.py`` compares streaming: from a state
the JAX package warmed up, over every frame, within 1e-4 of the output
scale.  From the warm start ``R0 = 1e-6 I`` step 2's first refresh is
degenerate and set by roundoff in either framework (ROADMAP Queue 3, "not
port faults"), and its difference stays in the step-2 covariances with
weight 0.99^t.  Here the JAX package enhances each stream's first block
and writes its session checkpoint; the port's server resumes all five
from those files and serves the rest, which is held to the JAX package's
offline ``streaming_tango`` of the rest from the same state.  The JAX
package's own serve gate holds its served streams bit for bit to that
offline call.
"""
import time

import numpy as np
import pytest
import torch

import jax

from disco_tpu.enhance import streaming as jstream
from disco_tpu_torch.obs import REGISTRY
from disco_tpu_torch.serve import check as sc
from tests.torch_port_helpers import max_rel, one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

TOL = 1e-4
SESSIONS = [  # (seed, session config kwargs, offline kwargs, z_mask)
    (31, {}, {}, None),
    (32, {"mu": 1.2}, {"mu": 1.2}, None),
    (33, {"lambda_cor": 0.97}, {"lambda_cor": 0.97}, None),
    (34, {}, {"z_avail": np.array([1, 0, 1, 1], np.float32)}, np.array([1, 0, 1, 1], np.float32)),
    (35, {"solver": "fused-xla"}, {"solver": "fused-xla"}, None),
]
ST_KW = {"blocks_per_super_tick": 2, "max_queue_blocks": 8}


def _specs():
    specs = []
    for seed, ckw, okw, zm in SESSIONS:
        Y, m = sc.scene(seed, device="cpu")
        ref = sc.offline_stream(Y, m, device="cpu", **okw)
        specs.append({"Y": Y, "m": m, "ref": ref, "z_mask": zm, "okw": okw,
                      "config": sc.session_config(Y.shape[-2], **ckw)})
    return specs


@pytest.fixture(scope="module")
def specs():
    return _specs()


def test_per_block_calls_equal_the_whole_clip(specs):
    for sp in specs:
        pb = sc.per_block_stream(sp["Y"], sp["m"], block=sc.BLOCK, device="cpu", **sp["okw"])
        np.testing.assert_array_equal(pb, sp["ref"])


@pytest.mark.parametrize("mode", ["per-block", "super-ticks"])
def test_concurrent_sessions_bit_identical_one_readback_a_tick(specs, mode):
    failures = []
    res = sc.check_parity(failures, specs, device="cpu",
                          server_kw=ST_KW if mode == "super-ticks" else None, label=mode)
    assert not failures, failures
    assert res["ticks"] >= 1 and res["batched_readbacks"] == res["ticks"]
    assert res["blocks_total"] == len(specs) * 4


def test_sessions_resumed_from_jax_states_stay_within_tolerance_of_jax(specs, tmp_path):
    """All five sessions resumed concurrently from the JAX package's
    checkpoints after their first block, the rest served by the port and
    held to the JAX package's offline continuation (module docstring)."""
    from disco_tpu.serve import session as jsession
    from disco_tpu_torch.serve import EnhanceServer, ServeClient

    B = sc.BLOCK
    jrefs = []
    for i, sp in enumerate(specs):
        okw = dict(sp["okw"])
        za = okw.pop("z_avail", np.ones(sc.K, np.float32))
        first = jstream.streaming_tango(sp["Y"][..., :B], sp["m"][..., :B], sp["m"][..., :B],
                                        update_every=sc.U, policy="local",
                                        z_avail=np.broadcast_to(za[:, None], (sc.K, B // sc.U)),
                                        **okw)
        state = jax.tree_util.tree_map(np.asarray, first["state"])
        rest = jstream.streaming_tango(sp["Y"][..., B:], sp["m"][..., B:], sp["m"][..., B:],
                                       update_every=sc.U, policy="local", state=state,
                                       z_avail=np.broadcast_to(za[:, None],
                                                               (sc.K, (32 - B) // sc.U)), **okw)
        jrefs.append(np.asarray(rest["yf"]))
        jsession.save_session_state(
            tmp_path / f"session_j{i}.state.msgpack",
            jsession.Session(f"j{i}", jsession.SessionConfig(**sp["config"].to_dict()),
                             z_avail=sp["z_mask"], state=state, blocks_done=1))
    srv = EnhanceServer(max_sessions=8, state_dir=tmp_path, device="cpu")
    got = [None] * len(specs)
    try:
        addr = srv.start()

        def work(i):
            cl = ServeClient(addr)
            try:
                cl.open(specs[i]["config"], resume=f"j{i}")
                assert cl.blocks_done == 1
                got[i] = cl.enhance_clip(specs[i]["Y"], specs[i]["m"], specs[i]["m"])
                cl.close()
            finally:
                cl.shutdown()

        assert not sc._run_clients(len(specs), work, 120.0)
    finally:
        srv.stop()
    for g, jref in zip(got, jrefs):
        assert g.shape == jref.shape and max_rel(g, jref) <= TOL


def test_chained_lane_equals_streaming_clip_fused_window_by_window():
    F = 257
    Lw = (sc.BLOCK - 1) * (F - 1)
    rng = np.random.default_rng(71)
    wins = [rng.standard_normal((sc.K, sc.C, Lw)).astype(np.float32) for _ in range(3)]
    masks = [rng.uniform(0.05, 0.95, size=(sc.K, F, sc.BLOCK)).astype(np.float32)
             for _ in range(3)]
    for solver in ("fused-xla", "jacobi"):
        refs = sc.chained_windows(wins, masks, device="cpu", solver=solver)
        failures = []
        res = sc.check_chained(failures, wins, masks, refs,
                               sc.session_config(F, solver=solver, domain="time"), device="cpu")
        assert not failures, failures
        assert res["windows"] == 3 and res["outputs"][0].shape == (sc.K, Lw)


@pytest.mark.parametrize("mode", ["per-block", "super-ticks"])
def test_drain_and_resume_stitch_bit_identical(specs, tmp_path, mode):
    sp = specs[0]
    failures = []
    res = sc.check_drain_resume(failures, tmp_path / "state", sp["Y"], sp["m"], sp["ref"],
                                sp["config"], device="cpu",
                                server_kw=ST_KW if mode == "super-ticks" else None)
    assert not failures, failures
    assert res["blocks_before_drain"] == 2 and res["blocks_total"] == 4


@pytest.mark.parametrize("mode", ["per-block", "super-ticks"])
def test_chaos_serve_tick_and_mid_write(specs, tmp_path, mode):
    sp = specs[1]
    failures = []
    res = sc.check_chaos(failures, tmp_path / "chaos", sp["Y"], sp["m"], sp["ref"],
                         sp["config"], device="cpu",
                         server_kw=ST_KW if mode == "super-ticks" else None)
    assert not failures, failures
    assert res["crashes_injected"] == 2 and res["blocks_before_crash"] >= 1


def test_overload_drill():
    specs = []
    for i in range(4):
        Y, m = sc.scene(60 + i, length=16000, device="cpu")
        specs.append({"Y": Y, "m": m, "ref": sc.offline_stream(Y, m, device="cpu"),
                      "config": sc.session_config(Y.shape[-2])})
    failures = []
    res = sc.check_overload(failures, specs, device="cpu")
    assert not failures, failures
    assert res["peak_rung"] >= 1 and res["capacity_rejects"] >= 1 and res["recoveries"] >= 1


def test_ladder_walks_the_reference_rungs():
    from disco_tpu.serve.ladder import DegradationLadder as JLadder
    from disco_tpu_torch.serve.ladder import RUNGS, DegradationLadder

    from disco_tpu.serve.ladder import RUNGS as JRUNGS

    assert RUNGS == JRUNGS
    rng = np.random.default_rng(3)
    trace = np.concatenate([rng.uniform(0, 50, 30), rng.uniform(400, 900, 40),
                            rng.uniform(0, 90, 120), rng.uniform(200, 700, 20),
                            np.zeros(200)])
    hits = (rng.random(trace.size) < 0.03).astype(int)
    for kw in ({}, {"max_rung": 2, "recover_ticks": 5}, {"p95_high_ms": 300.0,
                                                          "p95_low_ms": 50.0}):
        port, ref = DegradationLadder(**kw), JLadder(**kw)
        rungs = [(port.observe(queue_wait_p95_ms=float(p), deadline_hits=int(h), tick=t),
                  ref.observe(queue_wait_p95_ms=float(p), deadline_hits=int(h), tick=t))
                 for t, (p, h) in enumerate(zip(trace, hits))]
        assert [a for a, _ in rungs] == [b for _, b in rungs]
        assert port.transitions == ref.transitions and len(port.transitions) >= 4


def test_transport_burst_quarantines_then_recovers(specs):
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, set_dispatch_fault_injector

    sp = specs[0]
    n = [0]

    def burst(_sid, _seqs):
        n[0] += 1
        if n[0] <= 4:   # past retries + 1 of the first dispatch: exhausts the budget
            raise TimeoutError("injected transport burst")

    quarantined0 = REGISTRY.counter("session_quarantined").value
    set_dispatch_fault_injector(burst)
    srv = EnhanceServer(max_sessions=2, quarantine_ticks=3, device="cpu")
    srv.scheduler.dispatch_retry_base_s = 0.001
    try:
        addr = srv.start()
        cl = ServeClient(addr, timeout_s=60)
        try:
            cl.open(sp["config"])
            yf = cl.enhance_clip(sp["Y"], sp["m"], sp["m"])
            cl.close()
        finally:
            cl.shutdown()
    finally:
        set_dispatch_fault_injector(None)
        srv.stop()
    assert n[0] > 4
    assert REGISTRY.counter("session_quarantined").value - quarantined0 == 1
    np.testing.assert_array_equal(yf, sp["ref"])


def test_non_transport_error_evicts_with_a_clean_frame(specs):
    from disco_tpu_torch.serve import (EnhanceServer, ServeClient, ServeError,
                                       set_dispatch_fault_injector)

    sp = specs[0]

    def broken(_sid, _seqs):
        raise ValueError("injected deterministic fault")

    set_dispatch_fault_injector(broken)
    srv = EnhanceServer(max_sessions=2, device="cpu")
    try:
        addr = srv.start()
        cl = ServeClient(addr, timeout_s=30, reattach_retries=0)
        try:
            cl.open(sp["config"])
            # one block, then wait: a client still sending when the server
            # closes the evicted stream reads a reset, not the frame
            cl.send_block(sp["Y"][..., :sc.BLOCK], sp["m"][..., :sc.BLOCK],
                          sp["m"][..., :sc.BLOCK])
            with pytest.raises(ServeError) as err:
                cl.recv_enhanced(0)
        finally:
            cl.shutdown()
    finally:
        set_dispatch_fault_injector(None)
        srv.stop()
    assert err.value.code == "evicted" and "injected deterministic fault" in str(err.value)
    assert srv.crashed is None


def test_shed_notice_behind_a_failed_send_keeps_its_back_off(specs, tmp_path):
    """A session shed while its client is still sending: the server posts
    the ``parked`` notice with its back-off hint, eats the next block and
    closes, so the client learns of the shed from a failed send.  The
    reattach waits out the hint all the same (at once, it would land on
    the rung that shed it and be shed again, until its reattaches ran
    out), and the stream then goes on bit for bit."""
    from disco_tpu_torch.serve import EnhanceServer, ServeClient

    sp, B, back_off = specs[0], sc.BLOCK, 0.5
    Y, m = sp["Y"], sp["m"]
    srv = EnhanceServer(max_sessions=2, unix_path=str(tmp_path / "serve.sock"), device="cpu")
    try:
        cl = ServeClient(srv.start(), timeout_s=30)
        try:
            sid = cl.open(sp["config"])
            cl.send_block(Y[..., :B], m[..., :B], m[..., :B], seq=0)
            first = cl.recv_enhanced(0, timeout_s=30)
            assert srv.scheduler.park(srv.scheduler.get(sid), "shed: overload (test)",
                                      notice=True, retry_after_s=back_off)
            deadline = time.monotonic() + 10.0
            while cl._frames.qsize() == 0:          # the notice reached the client
                assert time.monotonic() < deadline, "park notice never posted"
                time.sleep(0.01)
            cl.send_block(Y[..., B:2 * B], m[..., B:2 * B], m[..., B:2 * B], seq=1)  # eaten
            cl._reader.join(timeout=10.0)           # the server closed the stream
            assert not cl._reader.is_alive()
            t0 = time.monotonic()
            cl.send_block(Y[..., 2 * B:3 * B], m[..., 2 * B:3 * B], m[..., 2 * B:3 * B], seq=2)
            waited = time.monotonic() - t0
            assert cl.reattaches == 1 and waited >= back_off
            rest = cl.enhance_clip(Y, m, m)
            cl.close()
        finally:
            cl.shutdown()
    finally:
        srv.stop()
    np.testing.assert_array_equal(np.concatenate([first, rest], axis=-1), sp["ref"])


def test_reference_client_is_served_by_the_port(specs):
    from disco_tpu.serve.client import ServeClient as JClient
    from disco_tpu.serve.session import SessionConfig as JConfig
    from disco_tpu_torch.serve import EnhanceServer

    srv = EnhanceServer(max_sessions=4, device="cpu")
    try:
        addr = srv.start()
        for sp in (specs[1], specs[3]):
            cl = JClient(addr)
            try:
                cl.open(JConfig(**sp["config"].to_dict()), z_mask=sp["z_mask"])
                yf = cl.enhance_clip(sp["Y"], sp["m"], sp["m"])
                info = cl.close()
            finally:
                cl.shutdown()
            np.testing.assert_array_equal(yf, sp["ref"])
            assert info["type"] == "closed" and info["blocks_done"] == 4
    finally:
        srv.stop()


def test_model_masks_refused_at_admission(specs):
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, ServeError

    srv = EnhanceServer(max_sessions=2, device="cpu")
    try:
        addr = srv.start()
        cl = ServeClient(addr)
        try:
            with pytest.raises(ServeError) as err:
                cl.open(sc.session_config(257, masks="model"))
        finally:
            cl.shutdown()
    finally:
        srv.stop()
    assert err.value.code == "bad_config" and "promotion store" in str(err.value)


class _Seam:
    """Stands in for a tap, a promotion controller or a trainer: the
    scheduler binds a controller at construction."""

    def bind(self, scheduler):
        self.scheduler = scheduler


def test_server_needs_cuda_unless_cpu(monkeypatch):
    from disco_tpu_torch.serve import EnhanceServer, Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnhanceServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler()
    assert Scheduler(device="cpu").device == torch.device("cpu")
    for seam in ("tap", "promote", "resident"):
        sched = Scheduler(device="cpu", **{seam: _Seam()})
        assert getattr(sched, seam) is not None


def test_status_counters_equal_the_registry(specs):
    from disco_tpu_torch.serve import (EnhanceServer, ServeClient, STATUS_SECTIONS,
                                       evaluate_slo, fetch_status, status_section)

    sp = specs[2]
    srv = EnhanceServer(max_sessions=2, device="cpu")
    try:
        addr = srv.start()
        cl = ServeClient(addr)
        try:
            cl.open(sp["config"])
            cl.enhance_clip(sp["Y"], sp["m"], sp["m"])
            cl.close()
        finally:
            cl.shutdown()
        payload = fetch_status(addr)
    finally:
        srv.stop()
    assert set(STATUS_SECTIONS) <= set(payload)
    assert status_section(payload, "counters") == REGISTRY.snapshot()["counters"]
    assert status_section(payload, "latency")["serve_block_latency_ms"]["count"] >= 4
    assert evaluate_slo(payload)["verdict"] in ("OK", "VIOLATED")


def test_scheduler_readback_invariant():
    from disco_tpu_torch.enhance.stream_check import check_readback_invariant

    Y, m = sc.scene(11, length=30000, device="cpu")
    failures = []
    res = check_readback_invariant(failures, Y, m, block=sc.BLOCK, update_every=sc.U,
                                   device="cpu")
    assert not failures, failures
    assert res["readbacks_supertick_path"] < res["readbacks_per_block_path"] == res["blocks"]


def test_retry_schedule_and_transport_errors_match_the_reference():
    from disco_tpu.utils import resilience as jres
    from disco_tpu_torch.utils import resilience as tres

    assert tres.TRANSPORT_ERRORS == (ConnectionError, TimeoutError, OSError,
                                     torch.OutOfMemoryError)
    for mod in (tres, jres):
        assert issubclass(mod.DeadlineExceeded, TimeoutError)
    schedules = []
    for mod in (tres, jres):
        slept, n = [], [0]

        def flaky():
            n[0] += 1
            if n[0] <= 3:
                raise ConnectionError("injected")
            return "ok"

        assert mod.call_with_retries(flaky, retries=4, base_delay_s=0.01, jitter=0.5,
                                     jitter_seed=7, sleep=slept.append,
                                     retry_on=(ConnectionError,)) == "ok"
        schedules.append(slept)
    assert schedules[0] == schedules[1] and len(schedules[0]) == 3
    with pytest.raises(ValueError):
        tres.call_with_retries(lambda: (_ for _ in ()).throw(ValueError("x")),
                               retry_on=tres.TRANSPORT_ERRORS)
    assert tres.preflight_probe(device="cpu")["ok"]
    with tres.DispatchDeadline(0.001, label="t") as dd:
        time.sleep(0.05)
    assert dd.expired
