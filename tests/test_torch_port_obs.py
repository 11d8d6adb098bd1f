"""The port's observability core (``disco_tpu_torch.obs``) against the JAX
package's: the port's event logs, rotated segments and torn tails pass the
JAX package's validating reader; the port's histograms and registry
snapshot equal the reference's on the same samples; spans the port records
rebuild with the reference's chain walker; a flight dump reads back and is
byte-stable; the counters the serve contract is checked by count what
they say."""
import json
import random

import numpy as np
import pytest
import torch

from disco_tpu.obs import events as jevents
from disco_tpu.obs import metrics as jmetrics
from disco_tpu.obs import trace as jtrace
from disco_tpu_torch import obs
from disco_tpu_torch.device import to_host
from disco_tpu_torch.obs import accounting, events, flight, metrics, trace


@pytest.fixture
def recording(tmp_path):
    path = tmp_path / "events.jsonl"
    yield path
    events.disable()
    trace.disable()
    flight.disable()


def test_event_log_passes_the_reference_reader(recording):
    with obs.recording(recording):
        obs.write_manifest(config={"k": 4}, tool="test")
        with obs.stage("serve_tick", n_blocks=3):
            obs.fence_tick()
        obs.record("session", stage="serve", action="open", session="s1",
                   value=np.float32(1.5), arr=np.int64(3))
        obs.record("note", text="done")
    got = jevents.read_events(recording, validate=True)
    assert [e["kind"] for e in got] == ["manifest", "stage_end", "session", "note"]
    man = got[0]["attrs"]
    assert man["platform"] in ("cpu", "gpu") and man["config"] == {"k": 4}
    assert set(man["versions"]) == {"python", "torch", "numpy", "scipy"}
    assert man["versions"]["torch"] is not None
    assert got[1]["stage"] == "serve_tick" and got[1]["attrs"]["fences"] == 1
    assert got[1]["attrs"]["n_blocks"] == 3 and got[1]["attrs"]["dur_s"] >= 0
    assert got[2]["attrs"]["value"] == 1.5 and got[2]["attrs"]["arr"] == 3
    # the two readers agree line for line
    assert events.read_events(recording) == got


def test_rotated_segments_and_torn_tail_read_by_the_reference(recording):
    events.enable(recording, max_bytes=300)
    for i in range(40):
        events.record("note", stage="s", i=i, pad="x" * 20)
    rotations = events.recorder().rotations
    events.disable()
    segments = events.rotated_segments(recording)
    assert rotations >= 3 and len(segments) == rotations
    assert [p.name for p in segments] == [p.name for p in jevents.rotated_segments(recording)]
    # a crash mid-append before the next rotation: a torn last line in a segment
    with open(segments[0], "a") as fh:
        fh.write('{"t": 1.0, "kind": "no')
    got = jevents.read_events(recording, validate=True)
    assert [e["attrs"]["i"] for e in got] == list(range(40))
    assert events.read_events(recording) == got
    # a torn line in the live file (not at a rotation seam) raises in both
    with open(recording, "a") as fh:
        fh.write("{broken\n")
    for reader in (jevents.read_events, events.read_events):
        with pytest.raises(ValueError):
            reader(recording)


def test_event_schema_is_the_reference_schema():
    assert events.EVENT_KINDS == jevents.EVENT_KINDS
    bad = [{"t": 1, "kind": "nope", "stage": None, "attrs": {}},
           {"t": "x", "kind": "note", "stage": None, "attrs": {}},
           {"t": 1, "kind": "note", "stage": 3, "attrs": {}},
           {"kind": "note", "stage": None, "attrs": {}}]
    for d in bad:
        for validate in (jevents.validate_event, events.validate_event):
            with pytest.raises(ValueError):
                validate(d)


@pytest.mark.parametrize("n", [1, 7, 2048, 5000])
def test_histogram_quantiles_and_snapshot_match_the_reference(n):
    rng = random.Random(n)
    samples = [rng.lognormvariate(0.0, 1.0) * 10 for _ in range(n)]
    port, ref = metrics.Registry(), jmetrics.Registry()
    for reg in (port, ref):
        reg.counter("serve_blocks").inc(n)
        reg.gauge("queue_depth").set(n / 3)
        h = reg.histogram("serve_block_latency_ms")
        for v in samples:
            h.observe(v)
    assert port.snapshot() == ref.snapshot()
    hp, hr = port.histogram("serve_block_latency_ms"), ref.histogram("serve_block_latency_ms")
    for q in (0, 50, 90, 95, 99, 100):
        assert hp.percentile(q) == hr.percentile(q)
    if n <= metrics.RESERVOIR_SIZE:
        assert hp.percentile(95) == pytest.approx(float(np.percentile(samples, 95)), rel=1e-12)
    assert port.pretty() == ref.pretty()


def test_stage_timer_syncs_only_on_cuda_tensors():
    t = metrics.StageTimer()
    with t.stage("a", block_on=torch.zeros(3)):
        pass
    with t.stage("a", block_on={"x": [torch.zeros(1)]}):
        pass
    assert t.report()["a"]["calls"] == 2


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with metrics.trace_to(tmp_path / "prof"):
        torch.ones(8).sum()
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in data


def test_port_spans_rebuild_with_the_reference_chain(recording):
    trace.enable()
    with obs.recording(recording):
        ctx = trace.root("client_block", seq=0)
        for stage in ("enqueue", "dispatch", "readback", "deliver"):
            ctx = trace.span(stage, ctx, seq=0)
        # a failed dispatch attempt off the main path
        trace.span("dispatch", trace.root("client_block"), failed=True)
    trace.disable()
    evs = jevents.read_events(recording)
    tid = ctx.trace
    path = jtrace.verify_chain(evs, tid, require=("client_block", "enqueue", "dispatch",
                                                  "readback", "deliver"))
    assert [e["stage"] for e in path] == ["client_block", "enqueue", "dispatch", "readback",
                                          "deliver"]
    assert trace.chain(evs, tid) == jtrace.chain(evs, tid)
    assert trace.SPAN_STAGES == jtrace.SPAN_STAGES and trace.STAGE_ORDER == jtrace.STAGE_ORDER
    # the wire header round-trips into the reference's context
    assert jtrace.from_wire(ctx.to_wire()) == jtrace.SpanCtx(trace=ctx.trace, span=ctx.span)
    assert trace.from_wire({"trace": 3}) is None


def test_flight_dump_reads_back_and_is_byte_stable(tmp_path, recording):
    flight.enable(dump_dir=tmp_path / "flight", capacity=4)
    for i in range(6):
        events.record("note", stage="serve", i=i)
    events.record("session", stage="io", action="park")
    p1 = flight.dump(trigger="manual", reason="test")
    p2 = flight.dump(tmp_path / "again.json", trigger="manual", reason="test")
    assert p1.read_bytes() == p2.read_bytes()
    d = json.loads(p1.read_text())
    assert d["flight_recorder"] == 1 and d["capacity"] == 4
    assert [e["attrs"]["i"] for e in d["subsystems"]["serve"]] == [2, 3, 4, 5]
    assert d["subsystems"]["io"][0]["attrs"]["action"] == "park"
    auto = flight.auto_dump("quarantine", reason="strike 1")
    assert auto.name == "flight-0002-quarantine.json" and auto.exists()
    flight.disable()
    assert flight.auto_dump("park") is None


def test_to_host_counts_one_batched_readback():
    before, fences = accounting.device_get_count(), accounting.fence_count()
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.complex(torch.ones(4), -torch.ones(4))
    ha, hb = to_host([a, b])
    assert accounting.device_get_count() - before == 1
    assert accounting.fence_count() - fences == 1
    np.testing.assert_array_equal(ha, a.numpy())
    np.testing.assert_array_equal(hb, b.numpy())
    assert metrics.REGISTRY.snapshot()["counters"]["device_get_batches"] == \
        accounting.device_get_count()
