"""The port's promotion (``disco_tpu_torch.promote``) and model-mask serving
against the JAX package's, on the CPU.

* The store: the same numpy weights staged by either package give the same
  ``weights.msgpack`` bytes and the same ``gen_id``, and each package's
  store loads the other's generation.
* The lane: :func:`block_masks` within ``TOL_MASK`` = 2e-5 (the port's
  CRNN inference tolerance, ``tests/test_torch_port_inference.py``) of the
  JAX package's on the same block and weights.
* The controller: a rollout ledger left in flight resolves the same way
  when either package replays it, and the port's demotion, promotion,
  ``pre_swap``, ``mid_canary`` and ``post_gate`` legs end in the
  reference's states and reasons.
* Serving: a model-mask stream served through a canary swap and a rollback
  is bit-identical to the port's per-generation oracle; and from a state
  the JAX package warmed up on the stream's first block, the port's oracle
  over the served generations is within ``TOL_STREAM`` = 1e-4 of the
  output scale of the JAX package's
  (the JAX lane's masks under the same generations, loaded by the JAX
  store from the port's files, through the JAX package's
  ``streaming_tango``).  From the warm start the first refresh is
  degenerate at a scene's natural level in either framework (ROADMAP
  Queue 3, "not port faults"), hence the shared state.

The CRNN is the JAX gate's tiny one (conv 4, GRU 16, FF 257,
``disco_tpu/promote/check.py:85-92``) with every leaf of a JAX ``init``
redrawn from a seed.
"""
import shutil

import numpy as np
import pytest
import torch

import jax

from disco_tpu.promote import controller as jctl
from disco_tpu.promote import store as jstore
from disco_tpu_torch.promote import check as pc
from disco_tpu_torch.promote import controller as tctl
from disco_tpu_torch.promote import store as tstore
from tests.test_torch_port_crnn import randomized
from tests.torch_port_helpers import max_rel, one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

TOL_MASK = 2e-5
TOL_STREAM = 1e-4
F = 257
ARCH = pc.tiny_arch(F)


def jax_variables(seed):
    from disco_tpu.nn.crnn import build_crnn
    from disco_tpu.nn.training import create_train_state

    model, tx = build_crnn(**ARCH)
    x0 = np.zeros((1, 1, ARCH["win_len"], F), np.float32)
    state = create_train_state(model, tx, x0, seed=seed)
    return randomized({"params": state.params, "batch_stats": state.batch_stats}, seed)


@pytest.fixture(scope="module")
def variables():
    return jax_variables(1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


# ------------------------------------------------------------------ store
def test_generation_bytes_and_ids_equal_across_packages(tmp_path, variables):
    gj = jstore.GenerationStore(tmp_path / "j").stage_variables(variables, arch=ARCH)
    gt = tstore.GenerationStore(tmp_path / "t").stage_variables(variables, arch=ARCH)
    assert gt.gen_id == gj.gen_id and gt.digest == gj.digest
    assert gt.weights_path.read_bytes() == gj.weights_path.read_bytes()
    # each package's store serves the other's generation
    tmodel, tvars = tstore.GenerationStore(tmp_path / "j").load(gj.gen_id)
    _same_tree(tvars, variables)
    _jm, jvars = jstore.GenerationStore(tmp_path / "t").load(gt.gen_id)
    _same_tree(jax.device_get(jvars), variables)
    # a port module staged through its state dict lands on the same id
    g2 = tstore.GenerationStore(tmp_path / "t2").stage_module(tmodel, arch=ARCH)
    assert g2.gen_id == gj.gen_id
    assert not tmodel.training and next(tmodel.parameters()).device.type == "cpu"


def test_staging_is_idempotent_and_key_order_canonical(tmp_path, variables):
    store = tstore.GenerationStore(tmp_path)
    a = store.stage_variables(variables, arch=ARCH)
    b = store.stage_variables(variables, arch=ARCH)
    rev = {"batch_stats": variables["batch_stats"],
           "params": dict(reversed(list(variables["params"].items())))}
    c = store.stage_variables(rev, arch=ARCH)
    assert a.gen_id == b.gen_id == c.gen_id and store.list_ids() == [a.gen_id]
    d = store.stage_variables(pc.perturbed(variables, 1e-3), arch=ARCH)
    assert store.list_ids() == [a.gen_id, d.gen_id] and d.serial == 2
    store.set_active(d.gen_id)
    assert store.active() == d.gen_id == jstore.GenerationStore(tmp_path).active()
    with pytest.raises(FileNotFoundError):
        store.set_active("gdeadbeef0000")


def test_torn_weight_file_fails_loudly_on_load(tmp_path, variables):
    store = tstore.GenerationStore(tmp_path)
    g = store.stage_variables(variables, arch=ARCH)
    raw = g.weights_path.read_bytes()
    g.weights_path.write_bytes(raw[: len(raw) // 2])
    for s in (store, jstore.GenerationStore(tmp_path)):
        with pytest.raises((tstore.PublishRefused, jstore.PublishRefused), match="digest"):
            s.load(g.gen_id)


def test_junk_and_in_flight_checkpoints_are_refused_as_in_jax(tmp_path, variables):
    from disco_tpu_torch.nn.serialization import packb
    from disco_tpu_torch.runs.ledger import RunLedger

    junk = tmp_path / "junk.msgpack"
    junk.write_bytes(b"\x00not msgpack")
    partial = tmp_path / "partial.msgpack"
    partial.write_bytes(packb({"params": variables["params"]}))
    good = tmp_path / "good.msgpack"
    good.write_bytes(packb({**variables, "epochs_done": np.asarray(2, np.int32),
                            "train_loss": np.asarray([3.0, 2.0, 0.0]),
                            "val_loss": np.asarray([4.0, 3.5, 0.0])}))
    led = RunLedger(tmp_path / "ledger.jsonl")
    led.mark_done("epoch:0")
    led.mark_in_flight("epoch:1")
    led.close()
    for mod in (tstore, jstore):
        store = mod.GenerationStore(tmp_path / mod.__name__)
        for ckpt in (junk, partial):
            with pytest.raises(mod.PublishRefused):
                store.stage_checkpoint(ckpt, arch=ARCH)
        with pytest.raises(mod.PublishRefused) as e:
            store.stage_checkpoint(good, arch=ARCH, ledger=tmp_path / "ledger.jsonl")
        assert e.value.unit == "epoch:1"
    gt = tstore.GenerationStore(tmp_path / "t").stage_checkpoint(good, arch=ARCH)
    gj = jstore.GenerationStore(tmp_path / "j").stage_checkpoint(good, arch=ARCH)
    assert gt.gen_id == gj.gen_id
    for k in ("epochs_done", "train_loss", "val_loss", "source_ckpt_digest"):
        assert gt.meta[k] == gj.meta[k], k
    assert gt.meta["train_loss"] == 2.0


# ------------------------------------------------------------------- lane
def test_block_masks_match_jax(tmp_path, variables):
    from disco_tpu.promote.lane import block_masks as jmasks
    from disco_tpu_torch.promote.lane import block_masks as tmasks

    g = tstore.GenerationStore(tmp_path).stage_variables(variables, arch=ARCH)
    tmodel, _ = tstore.GenerationStore(tmp_path).load(g.gen_id)
    jmodel, jvars = jstore.GenerationStore(tmp_path).load(g.gen_id)
    rng = np.random.default_rng(5)
    Y = (rng.standard_normal((3, 2, F, 8)) + 1j * rng.standard_normal((3, 2, F, 8))
         ).astype(np.complex64)
    for ref_mic in (0, 1):
        got = tmasks(Y, tmodel, ref_mic=ref_mic)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        want = jmasks(Y, jmodel, jvars, ref_mic=ref_mic)
        assert got.shape == want.shape == (3, F, 8)
        assert np.abs(got.numpy() - want).max() <= TOL_MASK
        assert torch.equal(got, tmasks(Y, tmodel, ref_mic=ref_mic))


# -------------------------------------------------------------- controller
def _fake(fill):
    return {"params": {"w": np.full(3, fill, np.float32)}, "batch_stats": {}}


def _settled(root):
    led = tstore.GenerationStore(root).rollout_ledger()
    try:
        return {u: (r["state"], {k: v for k, v in (r.get("attrs") or {}).items()})
                for u, r in led.replay().items()}
    finally:
        led.close()


@pytest.mark.parametrize("phase,flipped", [("canary", False), ("promoting", False),
                                           ("promoting", True), ("rolling_back", False)])
def test_an_interrupted_rollout_resolves_the_same_in_both(tmp_path, phase, flipped):
    store = tstore.GenerationStore(tmp_path / "a")
    g1 = store.stage_variables(_fake(0.0), arch=ARCH)
    g2 = store.stage_variables(_fake(1.0), arch=ARCH)
    store.set_active(g2.gen_id if flipped else g1.gen_id)
    led = store.rollout_ledger()
    led.record(tctl.rollout_unit(g2.gen_id), "in_flight", phase=phase,
               candidate=g2.gen_id, incumbent=g1.gen_id)
    led.close()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for mod, root in ((tctl, tmp_path / "a"), (jctl, tmp_path / "b")):
        ctl = mod.PromotionController(root, poll_s=0.01)
        ctl._resume()
        ctl._ledger.close()
    a, b = _settled(tmp_path / "a"), _settled(tmp_path / "b")
    assert a == b
    state, attrs = a[tctl.rollout_unit(g2.gen_id)]
    assert state == ("done" if flipped else "failed")
    if not flipped:
        assert attrs["error"] == f"crash during {phase!r}; rolled back"


def test_controller_rejects_bad_knobs_as_jax(tmp_path):
    for kw in ({"canary_frac": 1.5}, {"window_blocks": 0}, {"gc_keep_last": -1}):
        for mod in (tctl, jctl):
            with pytest.raises(ValueError):
                mod.PromotionController(tmp_path, **kw)


# ------------------------------------------------------------ the legs
@pytest.fixture(scope="module")
def legs_setup(variables):
    clips = [pc.scene(71 + i, 14, device="cpu") for i in range(2)]
    configs = [pc.model_config(F), pc.model_config(F, solver="fused")]
    return clips, configs


def _jax_oracle(Y, gens, root, config):
    """The JAX package's replay from the state it reaches after block 0:
    its lane's masks under each block's generation (its store reading the
    port's files), its ``streaming_tango`` over block 0, then over the rest
    from that state.  Returns (the rest's output, the state)."""
    from disco_tpu.enhance import streaming as jstream
    from disco_tpu.promote.lane import block_masks

    store, bf, cache, ms = jstore.GenerationStore(root), config.block_frames, {}, []
    for i, g in enumerate(gens):
        if g not in cache:
            cache[g] = store.load(g)
        ms.append(block_masks(Y[..., i * bf:(i + 1) * bf], *cache[g]))
    m = np.concatenate(ms, axis=-1)
    kw = dict(update_every=config.update_every, policy="local",
              solver={"fused": "fused-xla"}.get(config.solver, config.solver))
    first = jstream.streaming_tango(Y[..., :bf], m[..., :bf], m[..., :bf], **kw)
    state = jax.tree_util.tree_map(np.asarray, first["state"])
    n = len(gens) * bf
    rest = jstream.streaming_tango(Y[..., bf:n], m[..., bf:n], m[..., bf:n], state=state, **kw)
    return np.asarray(rest["yf"]), state


def test_rollback_leg_bit_exact_and_within_tolerance_of_jax(tmp_path, variables, legs_setup):
    clips, configs = legs_setup
    failures = []
    st = pc.check_rollback(failures, tmp_path, clips, configs, ARCH, variables, device="cpu")
    assert not failures, failures
    state, attrs = _settled(st["store"].root)[tctl.rollout_unit(st["candidate"])]
    assert state == "failed" and attrs["phase"] == "rolled_back"
    assert attrs["error"].startswith("canary_sdr_db=2.0 vs target 9.0")
    assert st["dumps"] == 1
    (d0, g0), (d1, g1) = st["streams"]
    assert set(g0.values()) == {st["incumbent"], st["candidate"]}
    assert set(g1.values()) == {st["incumbent"]}
    # (the legs held each served stream to the port's oracle bit for bit)
    for (delivered, gen_of), Y, cfg in zip(st["streams"], clips, configs):
        gens = [gen_of[i] for i in range(len(delivered))]
        ref, state = _jax_oracle(Y, gens, st["store"].root, cfg)
        bf = cfg.block_frames
        got = pc.gen_oracle(Y[..., bf:], gens[1:], st["store"], cfg, device="cpu", state=state)
        assert got.shape == ref.shape and max_rel(got, ref) <= TOL_STREAM


def test_promote_leg(tmp_path, variables, legs_setup):
    """The leg judges its own server: tap drops and evictions the process
    counted before it (another test's) do not fail its SLO gate."""
    from disco_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter("tap_dropped").inc(5)
    REGISTRY.counter("session_evicted").inc(3)
    clips, configs = legs_setup
    failures = []
    st = pc.check_promote(failures, tmp_path, clips, configs, ARCH, variables, device="cpu")
    assert not failures, failures
    assert _settled(st["store"].root)[tctl.rollout_unit(st["candidate"])][0] == "done"
    assert st["store"].active() == st["candidate"]
    assert st["tap_to_promotion_ms"] is not None


def test_pre_swap_leg(tmp_path, variables, legs_setup):
    clips, configs = legs_setup
    failures = []
    st = pc.check_pre_swap(failures, tmp_path, clips, configs, ARCH, variables, device="cpu")
    assert not failures, failures
    assert st["crashes_injected"] == 1
    settled = _settled(st["store"].root)
    reasons = sorted(a.get("error", "") for s, a in settled.values() if s == "failed")
    assert reasons == ["crash during 'canary'; rolled back"]
    assert sum(s == "done" for s, _ in settled.values()) == 1


def test_controller_crash_legs(tmp_path, variables, legs_setup):
    clips, configs = legs_setup
    failures = []
    st = pc.check_controller_crash(failures, tmp_path, clips[0], configs[0], ARCH, variables,
                                   device="cpu")
    assert not failures, failures
    assert st["crashes_injected"] == 2
    settled = _settled(st["store"].root)
    assert [s for s, _ in settled.values()] == ["failed", "failed"]
    assert all(a["error"] == "crash during 'canary'; rolled back" for _, a in settled.values())


def test_model_masks_refused_without_a_store_and_served_with_one(tmp_path, variables):
    from disco_tpu_torch.serve import AdmissionError, Scheduler

    with pytest.raises(AdmissionError, match="promotion store") as e:
        Scheduler(device="cpu").open_session(pc.model_config(F))
    assert e.value.code == "bad_config"
    store = tstore.GenerationStore(tmp_path)
    sched = Scheduler(device="cpu", promote=tctl.PromotionController(store))
    with pytest.raises(AdmissionError, match="no ACTIVE generation"):
        sched.open_session(pc.model_config(F))
    g = store.stage_variables(variables, arch=ARCH)
    store.set_active(g.gen_id)
    s = sched.open_session(pc.model_config(F))
    assert s.generation == g.gen_id and sched.model_session_ids() == [s.id]


class _Counter:
    """Stands in for a kernel wrapper's launch counter."""

    launches = 5


def test_model_sessions_beside_a_time_domain_session_with_the_tap(tmp_path, variables):
    """``check_model_sessions``: two model sessions and a time-domain
    client-mask session on one server with the tap on; the counters it is
    given are set to 0 around serving and around the oracles."""
    from disco_tpu_torch.serve import check as sc

    clips = [pc.scene(81 + i, 5, device="cpu") for i in range(2)]
    configs = [pc.model_config(F), pc.model_config(F, solver="fused")]
    rng = np.random.default_rng(3)
    chained = {"windows": [rng.standard_normal((pc.K, pc.C, 7 * 256)).astype(np.float32)
                           for _ in range(2)],
               "masks": [rng.uniform(0.05, 0.95, (pc.K, F, 8)).astype(np.float32)
                         for _ in range(2)],
               "config": sc.session_config(F, n_nodes=pc.K, n_mics=pc.C, domain="time")}
    counters = {"stft": (_Counter, "launches")}
    failures = []
    st = pc.check_model_sessions(failures, tmp_path, clips, configs, ARCH, variables,
                                 chained=chained, counters=counters, device="cpu")
    assert not failures, failures
    assert st["batched_readbacks"] == st["ticks"] and st["records"] == 10
    assert st["served_launches"] == st["oracle_launches"] == {"stft": 0}
    assert st["blocks"] == 12 and st["tap"]["blocks_dropped"] == 0
