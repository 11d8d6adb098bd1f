"""The port's co-resident trainer (``disco_tpu_torch.flywheel.resident``),
training's promotion seams and the endurance legs, against the JAX
package's on the CPU.

Each trainer scenario (throttle, idle, a ``mid_epoch`` crash, a
``pre_publish`` crash) runs on the same shards in both packages, and the
port's ledger must land where the JAX package's lands: the same units, in
the same states, with the same step counts.  Losses are compared from a
shared start — a JAX checkpoint in both trainers' directories, which both
restore — over the same shards and batch order, at the tolerance
``tests/test_torch_port_training.py`` holds a step's loss to (rtol 1e-5).
The shards are made with numpy from a seed (K=3 nodes x C=2 mics, F=9,
8 frames), the CRNN is the JAX package's resident tests' tiny one.
"""
import json

import numpy as np
import pytest
import torch

from disco_tpu import flywheel as jfly
from disco_tpu.flywheel import resident as jres
from disco_tpu.promote import store as jstore
from disco_tpu_torch.flywheel import resident as tres
from disco_tpu_torch.promote import store as tstore
from disco_tpu_torch.runs import chaos
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

K, C, F, T = 3, 2, 9, 8
ARCH = dict(n_ch=1, win_len=4, n_freq=9, cnn_filters=(2,), pool_kernels=((1, 2),),
            conv_padding=((0, 1),), rnn_units=(4,), ff_units=(9,), rnn_dropouts=0.0)
LOSS_RTOL = 1e-5


def _fill_shards(d, seed=0, n_shards=2, records=3):
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_shards):
        recs = []
        for j in range(records):
            Y = (rng.standard_normal((K, C, F, T)) + 1j * rng.standard_normal((K, C, F, T))
                 ).astype(np.complex64)
            m = rng.uniform(0.05, 0.95, (K, F, T)).astype(np.float32)
            recs.append({"session": "s", "seq": i * records + j, "Y": Y, "yf": Y[:, 0],
                         "mask_z": m, "mask_w": m})
        jfly.write_shard(d / f"s{i:03d}.shard.msgpack", recs)
    return d


def _trainer(pkg, tap, train, **kw):
    if pkg == "port":
        return tres.ResidentTrainer(tap, train, arch=ARCH, device="cpu", **kw)
    return jres.ResidentTrainer(tap, train, arch=ARCH, **kw)


def _ledger(path):
    """{unit: (state, steps)} of the latest records, t and digests left out."""
    latest = {}
    for line in (path.read_text().splitlines() if path.is_file() else ()):
        rec = json.loads(line)
        latest[rec["unit"]] = (rec["state"], (rec.get("attrs") or {}).get("steps"))
    return latest


def _done_counts(path, prefix):
    counts = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec["unit"].startswith(prefix) and rec["state"] == "done":
            counts[rec["unit"]] = counts.get(rec["unit"], 0) + 1
    return counts


def _shared_start(train_dir):
    """A JAX checkpoint of the tiny CRNN at its seeded init, epochs_done 0."""
    from disco_tpu.nn.crnn import build_crnn
    from disco_tpu.nn.training import create_train_state, save_checkpoint

    model, tx = build_crnn(**ARCH)
    state = create_train_state(model, tx, np.zeros((1, 1, 4, 9), np.float32), seed=4)
    train_dir.mkdir(parents=True, exist_ok=True)
    save_checkpoint(train_dir / jres.CKPT_NAME, state, np.zeros(0), np.zeros(0), epochs_done=0)


def _run(tr, pred, max_ticks=300):
    for tick in range(max_ticks):
        tr.step(tick_no=tick)
        if pred(tr):
            return
    raise AssertionError(f"never held in {max_ticks} ticks: {tr.stats()}")


# ----------------------------------------------------------- the trainer
def test_ladder_throttle_runs_no_step_that_tick(tmp_path):
    from disco_tpu_torch import obs
    from disco_tpu_torch.obs.metrics import REGISTRY

    tap = _fill_shards(tmp_path / "tap")
    tr = _trainer("port", tap, tmp_path / "train", batch_size=4, steps_per_tick=2,
                  throttle_rung=2)
    c0 = REGISTRY.counter("train_throttled_ticks").value
    try:
        with obs.recording(tmp_path / "ev.jsonl"):
            assert tr.step(tick_no=0, rung=2) == 0
            assert tr.step(tick_no=1, rung=3) == 0
            assert tr.stats()["throttled"] is True and tr.stats()["steps_total"] == 0
            assert tr.step(tick_no=2, rung=1) == 2
        assert tr.stats()["throttled"] is False
        assert REGISTRY.counter("train_throttled_ticks").value - c0 == 2
        ev = [e for e in obs.read_events(tmp_path / "ev.jsonl") if e["kind"] == "train_throttled"]
        assert [e["attrs"]["action"] for e in ev] == ["paused", "resumed"]
        assert ev[0]["attrs"]["rung"] == 2
    finally:
        tr.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_trainer_idles_without_consuming_anything(tmp_path, pkg):
    (tmp_path / "tap").mkdir()
    tr = _trainer(pkg, tmp_path / "tap", tmp_path / "train")
    try:
        assert tr.step(tick_no=0) == 0 and tr.step(tick_no=1) == 0
        assert not any(u.startswith("epoch:") for u in _ledger(tmp_path / "train" /
                                                                 tres.LEDGER_NAME))
        assert not tr.ckpt_path.exists()
    finally:
        tr.close()


def test_trainer_rejects_bad_knobs_as_jax(tmp_path):
    for kw in ({"steps_per_tick": 0}, {"publish_every": 0}, {"publish": "sometimes"},
               {"throttle_rung": -1}, {"recent_shards": 0}):
        for cls in (tres.ResidentTrainer, jres.ResidentTrainer):
            with pytest.raises(ValueError):
                cls(tmp_path, tmp_path, **kw)
    assert tres.unit_publish(3) == jres.unit_publish(3) == "publish:3"
    assert (tres.CKPT_NAME, tres.LEDGER_NAME) == (jres.CKPT_NAME, jres.LEDGER_NAME)


def _mid_epoch(pkg, root):
    tap = _fill_shards(root / "tap")
    train = root / "train"
    kw = dict(promote_dir=root / "promote", batch_size=4, steps_per_tick=4,
              publish="always", max_epochs=2)
    tr = _trainer(pkg, tap, train, **kw)
    mod = chaos if pkg == "port" else __import__("disco_tpu.runs.chaos", fromlist=["x"])
    mod.configure("mid_epoch", after=1)
    try:
        with pytest.raises(mod.ChaosCrash):
            for tick in range(300):
                tr.step(tick_no=tick)
    finally:
        mod.disable()
        tr.close()
    after_crash = _ledger(train / tres.LEDGER_NAME)
    assert not tr.ckpt_path.exists()
    tr2 = _trainer(pkg, tap, train, **kw)
    try:
        _run(tr2, lambda t: t.stats()["epochs_done"] >= 2)
    finally:
        tr2.close()
    return after_crash, _ledger(train / tres.LEDGER_NAME), train


def test_mid_epoch_crash_resumes_as_jax_without_reconsuming_shards(tmp_path):
    t_crash, t_final, t_train = _mid_epoch("port", tmp_path / "t")
    j_crash, j_final, _ = _mid_epoch("jax", tmp_path / "j")
    assert t_crash == j_crash and t_final == j_final
    assert t_crash["epoch:0"][0] == "in_flight"
    assert t_final["epoch:0"] == ("done", 0) and t_final["epoch:1"][0] == "done"
    assert t_final["epoch:1"][1] > 0
    assert "publish:0" not in t_final and t_final["publish:1"][0] == "done"
    assert all(n == 1 for n in _done_counts(t_train / tres.LEDGER_NAME, "shard:").values())
    assert len(tstore.GenerationStore(tmp_path / "t" / "promote").list_ids()) == 1


def _pre_publish(pkg, root):
    tap = _fill_shards(root / "tap")
    train, promote = root / "train", root / "promote"
    kw = dict(promote_dir=promote, batch_size=4, steps_per_tick=4, publish="always",
              max_epochs=1)
    tr = _trainer(pkg, tap, train, **kw)
    mod = chaos if pkg == "port" else __import__("disco_tpu.runs.chaos", fromlist=["x"])
    mod.configure("pre_publish", after=1)
    try:
        with pytest.raises(mod.ChaosCrash):
            for tick in range(300):
                tr.step(tick_no=tick)
    finally:
        mod.disable()
        tr.close()
    crash = _ledger(train / tres.LEDGER_NAME)
    assert not list(promote.glob("generations/*"))   # nothing staged
    tr2 = _trainer(pkg, tap, train, **kw)
    try:
        tr2.step(tick_no=0)   # one tick finishes the interrupted publish first
        stats = tr2.stats()
    finally:
        tr2.close()
    return crash, _ledger(train / tres.LEDGER_NAME), stats, train


def test_pre_publish_crash_restages_idempotently_as_jax(tmp_path):
    t_crash, t_final, t_stats, t_train = _pre_publish("port", tmp_path / "t")
    j_crash, j_final, j_stats, _ = _pre_publish("jax", tmp_path / "j")
    assert t_crash == j_crash and t_final == j_final
    assert t_crash["publish:0"][0] == "in_flight" and t_final["publish:0"][0] == "done"
    assert t_stats["generations_published"] == j_stats["generations_published"] == 1
    assert t_stats["steps_total"] == j_stats["steps_total"] == 0
    led = [json.loads(x) for x in (t_train / tres.LEDGER_NAME).read_text().splitlines()]
    pub = [r for r in led if r["unit"] == "publish:0" and r["state"] == "done"][-1]["attrs"]
    assert pub["resumed"] is True
    store = tstore.GenerationStore(tmp_path / "t" / "promote")
    assert store.list_ids() == [pub["gen"]]
    store.load(pub["gen"])
    assert all(n == 1 for n in _done_counts(t_train / tres.LEDGER_NAME, "shard:").values())


def test_epoch_losses_match_jax_from_a_shared_start(tmp_path):
    losses = {}
    for pkg in ("port", "jax"):
        root = tmp_path / pkg
        tap = _fill_shards(root / "tap", seed=9, n_shards=3)
        _shared_start(root / "train")
        tr = _trainer(pkg, tap, root / "train", batch_size=4, steps_per_tick=3, max_epochs=2)
        try:
            _run(tr, lambda t: t.stats()["epochs_done"] >= 2)
        finally:
            tr.close()
        led = [json.loads(x) for x in (root / "train" / tres.LEDGER_NAME).read_text().splitlines()]
        losses[pkg] = [(r["attrs"]["steps"], r["attrs"]["train_loss"]) for r in led
                       if r["unit"].startswith("epoch:") and r["state"] == "done"]
    assert [s for s, _ in losses["port"]] == [s for s, _ in losses["jax"]]
    assert all(s > 0 for s, _ in losses["port"])
    np.testing.assert_allclose([v for _, v in losses["port"]], [v for _, v in losses["jax"]],
                               rtol=LOSS_RTOL)


# ------------------------------------------------------------ training seams
def test_fit_publishes_the_jax_generation_of_its_weights(tmp_path):
    from disco_tpu_torch.flywheel import ShardDataset
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.serialization import unpackb
    from disco_tpu_torch.nn.training import create_train_state, fit, publish_checkpoint

    tap = _fill_shards(tmp_path / "tap")
    torch.manual_seed(0)
    model = build_crnn(**ARCH)
    state = create_train_state(model, build_optimizer(model))
    ds = ShardDataset(tap, win_len=4, seed=0)
    with pytest.raises(ValueError, match="promote_arch"):
        fit(model, state, ds.batch_fn(4), ds.batch_fn(4, shuffle=False), 1,
            save_path=tmp_path / "m", device="cpu", promote_dir=tmp_path / "p")
    _, tr, _, name = fit(model, state, ds.batch_fn(4), ds.batch_fn(4, shuffle=False), 2,
                         save_path=tmp_path / "m", run_name="r", verbose=False, device="cpu",
                         ledger=tmp_path / "fit.jsonl", promote_dir=tmp_path / "p",
                         promote_arch=ARCH)
    store = tstore.GenerationStore(tmp_path / "p")
    assert 1 <= len(store.list_ids()) <= 2
    ckpt = tmp_path / "m" / "r_model.msgpack"
    gj = jstore.GenerationStore(tmp_path / "j").stage_checkpoint(ckpt, arch=ARCH)
    assert gj.gen_id == store.list_ids()[-1]
    payload = unpackb(ckpt.read_bytes())
    gv = tstore.GenerationStore(tmp_path / "v").stage_variables(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]}, arch=ARCH)
    assert gv.gen_id == gj.gen_id
    # the publish seam itself, and its refusal of an in-flight run
    assert publish_checkpoint(tmp_path / "p", ckpt, arch=ARCH).gen_id == gj.gen_id
    from disco_tpu_torch.runs.ledger import RunLedger

    led = RunLedger(tmp_path / "fit.jsonl")
    led.mark_in_flight("epoch:2")
    with pytest.raises(tstore.PublishRefused, match="epoch:2"):
        publish_checkpoint(tmp_path / "p", ckpt, arch=ARCH, ledger=led)
    led.close()


# --------------------------------------------------------------- endurance
def test_endurance_campaign_on_the_cpu(tmp_path):
    """The port's endurance legs at the checks' tiny size: every seam of the
    campaign crashed once, at least three generations promoted."""
    from disco_tpu_torch.promote import check as pc
    from disco_tpu_torch.runs import endure

    clips = [pc.scene(131 + i, 24, device="cpu") for i in range(len(endure.SEAM_LEGS))]
    Fq = clips[0].shape[-2]
    arch = pc.tiny_arch(Fq)
    failures = []
    st = endure.campaign(failures, tmp_path, lambda leg: clips[leg], pc.model_config(Fq), arch,
                         pc.seeded_variables(arch, 6), device="cpu")
    endure.campaign_end_asserts(failures, st)
    assert not failures, failures
    assert st["crashes"] == len(endure.SEAM_LEGS) - 1
    assert len(st["promoted"]) >= endure.MIN_GENERATIONS
    assert st["blocks_dropped"] == 0 and st["shards_written"] > 0 and st["train_steps"] > 0
