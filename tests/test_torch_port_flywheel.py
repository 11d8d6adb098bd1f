"""The port's flywheel (``disco_tpu_torch.flywheel``) against the JAX
package's: shard files byte for byte and readable across the packages, the
corpus tap's spool contract, the shard dataset's windows and their order
draw for draw, and the port's flywheel and serve-tap legs on the CPU.

Records are made with numpy from a seed (K=3 nodes x C=2 mics, F=9, 8
frames a block) and handed, as the same arrays, to both packages.  Every
comparison with the JAX package is exact: shards are bytes, and windows are
slices of the same arrays in the same order.
"""
import ast
import time
from pathlib import Path

import numpy as np
import pytest

from disco_tpu import flywheel as jfly
from disco_tpu_torch import flywheel as tfly
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

K, C, F, T = 3, 2, 9, 8
ROOT = Path(__file__).resolve().parents[1]


def _block(rng, seq=0, session="s"):
    cplx = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)  # noqa: E731
    return {"session": session, "seq": seq, "t": 1.5 + seq,
            "Y": cplx(K, C, F, T), "yf": cplx(K, F, T),
            "mask_z": rng.uniform(0.05, 0.95, (K, F, T)).astype(np.float32),
            "mask_w": rng.uniform(0.05, 0.95, (K, F, T)).astype(np.float32)}


def _records(seed, n=3, session="s"):
    rng = np.random.default_rng(seed)
    return [_block(rng, seq=i, session=session) for i in range(n)]


def _write_shards(mod, d: Path, n_shards=4, records=3, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_shards):
        mod.write_shard(d / f"tap-{i + 1:06d}.shard.msgpack", _records(seed + i, records),
                        meta={"source": "test", "i": i})
    return d


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            if isinstance(ra[k], np.ndarray):
                assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k]), k
            else:
                assert ra[k] == rb[k], k


# ------------------------------------------------------------------ shards
def test_shards_are_byte_identical_and_read_across_packages(tmp_path):
    recs = _records(1)
    meta = {"created_t": 12.25, "sessions": ["s"], "source": "serve-tap", "n": np.int64(3)}
    pj = jfly.write_shard(tmp_path / "j.shard.msgpack", recs, meta=meta)
    pt = tfly.write_shard(tmp_path / "t.shard.msgpack", recs, meta=meta)
    assert pj.read_bytes() == pt.read_bytes()
    for reader in (jfly.read_shard, tfly.read_shard):
        for path in (pj, pt):
            m, r = reader(path)
            assert m == {"created_t": 12.25, "sessions": ["s"], "source": "serve-tap", "n": 3}
            _same_records(r, recs)
    assert tfly.unit_shard("x") == jfly.unit_shard("x")
    assert (tfly.RECORD_ARRAYS, tfly.SHARD_SUFFIX, tfly.SHARD_VERSION) == \
        (jfly.RECORD_ARRAYS, jfly.SHARD_SUFFIX, jfly.SHARD_VERSION)


@pytest.mark.parametrize("damage", ["truncated", "tampered", "not-a-shard"])
def test_torn_and_tampered_shards_fail_probe_in_both(tmp_path, damage):
    path = tfly.write_shard(tmp_path / "a.shard.msgpack", _records(2))
    raw = bytearray(path.read_bytes())
    if damage == "truncated":
        raw = raw[: len(raw) // 2]
    elif damage == "tampered":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = bytearray(b"\x93\x01\x02\x03")
    path.write_bytes(bytes(raw))
    assert not tfly.probe_shard(path) and not jfly.probe_shard(path)
    with pytest.raises(tfly.ShardError):
        tfly.read_shard(path)


def test_mid_write_chaos_leaves_no_torn_shard(tmp_path):
    from disco_tpu_torch.io.atomic import TMP_SUFFIX
    from disco_tpu_torch.runs import chaos

    path = tmp_path / "tap-000001.shard.msgpack"
    chaos.configure("mid_write", after=1)
    try:
        with pytest.raises(chaos.ChaosCrash):
            tfly.write_shard(path, _records(3))
    finally:
        chaos.disable()
    assert not path.exists() and not list(tmp_path.rglob(f"*{TMP_SUFFIX}.*"))
    tfly.write_shard(path, _records(3))
    assert tfly.probe_shard(path) and jfly.probe_shard(path)


def test_host_modules_import_no_torch_at_module_level():
    """The tap's writer thread runs shards/tap/dataset beside the dispatch
    thread that owns the card; the store's listing and staging are host
    work too."""
    for rel in ("flywheel/shards.py", "flywheel/tap.py", "flywheel/dataset.py",
                "promote/store.py"):
        tree = ast.parse((ROOT / "disco_tpu_torch" / rel).read_text())
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n and n.split(".")[0] == "torch" for n in names), (rel, names)


# --------------------------------------------------------------------- tap
def test_tap_overflow_drops_and_counts_without_blocking(tmp_path):
    from disco_tpu_torch.obs.metrics import REGISTRY

    tap = tfly.CorpusTap(tmp_path / "tap", max_queue_blocks=4, records_per_shard=3, start=False)
    c0 = REGISTRY.counter("tap_dropped").value
    b = _records(4, n=1)[0]
    t0 = time.perf_counter()
    oks = [tap.offer("s1", i, b["Y"], b["mask_z"], b["mask_w"], b["yf"]) for i in range(7)]
    assert time.perf_counter() - t0 < 1.0
    assert oks == [True] * 4 + [False] * 3
    assert tap.dropped == 3 and REGISTRY.counter("tap_dropped").value - c0 == 3
    stats = tap.close()   # flushes the accepted blocks through a late start
    assert stats["blocks_accepted"] == 4 and stats["blocks_dropped"] == 3
    assert sum(len(tfly.read_shard(s)[1]) for s in tfly.list_shards(tmp_path / "tap")) == 4
    assert not tap.offer("s1", 99, b["Y"], b["mask_z"], b["mask_w"], b["yf"])


def test_tap_rotation_manifest_and_numbering_resumed_after_a_restart(tmp_path):
    from disco_tpu.runs.ledger import RunLedger as JLedger

    recs = _records(5, n=7)
    d = tmp_path / "tap"
    for start in (0, 7):     # a second tap over the same dir appends
        tap = tfly.CorpusTap(d, records_per_shard=3)
        for r in recs:
            assert tap.offer("s1", r["seq"] + start, r["Y"], r["mask_z"], r["mask_w"], r["yf"])
        tap.close()
    shards = tfly.list_shards(d)
    assert [p.name for p in shards] == [f"tap-{i:06d}.shard.msgpack" for i in range(1, 7)]
    assert [len(tfly.read_shard(s)[1]) for s in shards] == [3, 3, 1, 3, 3, 1]
    # the manifest is the JAX package's ledger: its replay verifies every shard
    done, requeued = JLedger(d / tfly.MANIFEST_NAME).verified_done(requeue=False)
    assert done == {f"shard:{p.name}" for p in shards} and not requeued
    # the JAX package reads the port's tapped shards
    _m, r = jfly.read_shard(shards[0])
    assert [x["seq"] for x in r] == [0, 1, 2]
    assert np.array_equal(r[1]["Y"], recs[1]["Y"])


# ------------------------------------------------------------------ dataset
def _pairs(gen):
    return [(np.asarray(x), np.asarray(y)) for x, y in gen]


def _assert_same_batches(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype == np.float32
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


@pytest.mark.parametrize("mode", [
    {"shuffle": True, "epoch": 0}, {"shuffle": True, "epoch": 3},
    {"shuffle": False, "epoch": 1}, {"shuffle": True, "epoch": 2, "recent": 2},
    {"shuffle": True, "epoch": 0, "drop_last": False},
])
def test_dataset_windows_and_order_equal_the_jax_package(tmp_path, mode):
    d = _write_shards(jfly, tmp_path / "tap")
    kw = dict(win_len=3, win_hop=2, ref_mic=1, seed=7)
    a = _pairs(tfly.ShardDataset(d, **kw).batches(4, **mode))
    b = _pairs(jfly.ShardDataset(d, **kw).batches(4, **mode))
    _assert_same_batches(a, b)
    assert tfly.peek_geometry(d) == jfly.peek_geometry(d) == \
        {"n_nodes": K, "mics_per_node": C, "n_freq": F, "block_frames": T}


def test_dataset_ledger_resume_skips_consumed_shards(tmp_path):
    d = _write_shards(tfly, tmp_path / "tap")
    ds = tfly.ShardDataset(d, win_len=4, seed=1)
    full = _pairs(ds.batches(4, epoch=0))
    led = tmp_path / "led.jsonl"
    gen = ds.batches(4, epoch=0, ledger=led)
    per_shard = len(full) // 4
    first = [next(gen) for _ in range(2 * per_shard + 1)]  # two shards done, the third in flight
    gen.close()
    rest = _pairs(ds.batches(4, epoch=0, ledger=led))
    _assert_same_batches(_pairs(first[:2 * per_shard]) + rest, full)
    assert _pairs(ds.batches(4, epoch=0, ledger=led)) == []
    # the JAX package's dataset resumes from the port's ledger the same way
    jrest = _pairs(jfly.ShardDataset(d, win_len=4, seed=1).batches(4, epoch=1, ledger=led))
    _assert_same_batches(jrest, _pairs(ds.batches(4, epoch=1)))


def test_dataset_skips_a_corrupt_shard_with_a_warning(tmp_path):
    from disco_tpu_torch import obs
    from disco_tpu_torch.obs.metrics import REGISTRY

    d = _write_shards(tfly, tmp_path / "tap", n_shards=3)
    bad = d / "tap-000002.shard.msgpack"
    bad.write_bytes(bad.read_bytes()[:100])
    s0 = REGISTRY.peek_counter("shards_skipped")
    with obs.recording(tmp_path / "ev.jsonl"):
        got = _pairs(tfly.ShardDataset(d, win_len=4, seed=2).batches(4, epoch=0))
    assert REGISTRY.peek_counter("shards_skipped") - s0 == 1
    warns = [e for e in obs.read_events(tmp_path / "ev.jsonl") if e["kind"] == "warning"]
    assert len(warns) == 1 and "corrupt shard skipped" in warns[0]["attrs"]["reason"]
    _assert_same_batches(got, _pairs(jfly.ShardDataset(d, win_len=4, seed=2).batches(4, epoch=0)))


def test_batch_fn_advances_epochs_and_honours_set_start_epoch(tmp_path):
    d = _write_shards(tfly, tmp_path / "tap")
    ds, jds = tfly.ShardDataset(d, win_len=4, seed=3), jfly.ShardDataset(d, win_len=4, seed=3)
    mk, jmk = ds.batch_fn(4), jds.batch_fn(4)
    _assert_same_batches(_pairs(mk()), _pairs(jmk()))
    _assert_same_batches(_pairs(mk()), _pairs(ds.batches(4, epoch=1)))
    mk.set_start_epoch(5)
    jmk.set_start_epoch(5)
    _assert_same_batches(_pairs(mk()), _pairs(jmk()))


def test_scene_stream_batches_accept_recent():
    import inspect

    from disco_tpu_torch.scenes.stream import SceneStream

    params = inspect.signature(SceneStream.batches).parameters
    assert "recent" in params and params["recent"].default is None


# ------------------------------------------------------ the port's legs
@pytest.fixture(scope="module")
def served_tap(tmp_path_factory):
    from disco_tpu_torch.serve import check as sc

    specs = []
    for i in range(2):
        Y, m = sc.scene(61 + i, length=8000, n_nodes=K, n_mics=C, device="cpu")
        cfg = sc.session_config(Y.shape[-2], n_nodes=K, n_mics=C)
        specs.append({"Y": Y, "m": m, "config": cfg, "ref": sc.offline_stream(Y, m, device="cpu")})
    d = tmp_path_factory.mktemp("flywheel")
    return specs, d


def test_flywheel_legs_on_the_cpu(served_tap):
    """The port's flywheel check: the serve tap leg, then the torn-shard,
    dataset-resume and fit legs over the shards it wrote."""
    from disco_tpu_torch.flywheel import check as fc
    from disco_tpu_torch.promote.check import tiny_arch

    specs, d = served_tap
    failures = []
    tap = fc.check_tap_serve(failures, d / "tap", specs, device="cpu")
    assert not failures, failures
    assert tap["blocks_accepted"] == 8 and tap["batched_readbacks"] == tap["ticks"]
    torn = fc.check_torn_shard(failures, d / "tap", win_len=4, batch_size=4)
    resume = fc.check_dataset_resume(failures, d / "tap", d, win_len=4, batch_size=4)
    fit = fc.check_fit(failures, d / "tap", d, tiny_arch(specs[0]["Y"].shape[-2], 4),
                       win_len=4, batch_size=4, device="cpu")
    assert not failures, failures
    assert torn["skipped"] == 1 and resume["batches_per_epoch"] > 0
    assert fit["fit_epochs"] == 2 and fit["epochs_restored"] >= 1
    # the JAX package reads every shard the port's served tap wrote
    for p in tfly.list_shards(d / "tap"):
        _m, recs = jfly.read_shard(p)
        assert recs and recs[0]["Y"].shape == (K, C, 257, 8)


def test_serve_check_tap_leg_keeps_serving_bit_identical(tmp_path):
    """``serve.check.check_tap``: the parity cycle with the tap on, in the
    super-tick mode (tapped super-tick slices are copies)."""
    from disco_tpu_torch.serve import check as sc

    specs = []
    for i in range(2):
        Y, m = sc.scene(41 + i, device="cpu")
        specs.append({"Y": Y, "m": m, "config": sc.session_config(Y.shape[-2]),
                      "ref": sc.offline_stream(Y, m, device="cpu")})
    failures = []
    st = sc.check_tap(failures, specs, tmp_path / "tap", device="cpu", records_per_shard=3,
                      server_kw={"blocks_per_super_tick": 2, "max_queue_blocks": 8})
    assert not failures, failures
    assert st["blocks_accepted"] == 8 and st["records"] == 8 and st["shards"] == 3
    # every record is its block's (Y, masks, yf): the input as sent, the
    # output as delivered
    recs = [r for p in tfly.list_shards(tmp_path / "tap") for r in tfly.read_shard(p)[1]]
    assert sorted((r["session"], r["seq"]) for r in recs) == \
        sorted((s, i) for s in {r["session"] for r in recs} for i in range(4))
    for r in recs:
        sl = slice(8 * r["seq"], 8 * r["seq"] + 8)
        sp = specs[0] if np.array_equal(r["Y"], specs[0]["Y"][..., sl]) else specs[1]
        assert np.array_equal(r["Y"], sp["Y"][..., sl])
        assert np.array_equal(r["mask_z"], sp["m"][..., sl])
        assert np.array_equal(r["yf"], sp["ref"][..., sl])
