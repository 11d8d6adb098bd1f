"""The port's scene factory (``disco_tpu_torch.scenes``: ``batched``,
``dynamic``, ``stream``) against the JAX package's on the same numpy inputs
(RIR orders 2-3, 2-4 mics, 0.25-s scenes).

Tolerances:
- the drawn scene batches, buckets, SNR gains, dry pairs, segment weights
  and trajectories: exactly equal (host numpy, the same draws);
- ``simulate_scene_batch``: ``rirs``, ``noisy``, ``clean`` and
  ``mag_noisy`` within 1e-5 of their scale; the masks within 1e-6 of the
  JAX package's ``tf_mask_mag`` of the port's own magnitudes, and against
  the JAX package's masks within what their magnitudes' difference
  carries (``assert_factory_matches``; in the quietest bins 1e-7 of the
  scale is ~1e-5 of the bin, as in ``tests/test_torch_port_postgen.py``);
- ``dynamic_scene_mixture``: 1e-5 of the scale; the crossfaded boundary
  jumps under half the hard switch's (the continuity bound of
  ``disco_tpu/scenes/check.py``);
- ``SceneStream``: the windows in the same order, ``x`` within 1e-5 of its
  scale and ``y`` within the masks' bound; ledger resume, the
  ``between_scene_batches`` seam and ``set_start_epoch`` within the port;
  ``fit`` off ``batch_fn`` against the JAX package's ``fit`` off its own
  stream with the same weights: the losses within 1e-5 relative, the
  training tests' bound (measured 6e-8 and 1.4e-7).
"""
import numpy as np
import pytest
import torch

from disco_tpu import scenes as jscenes
from disco_tpu.core.masks import tf_mask_mag as jtf_mask_mag
from disco_tpu_torch import scenes as tscenes
from disco_tpu_torch.runs import chaos
from tests.torch_port_helpers import max_rel, one_host_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_host_thread")

FS = 16000
FIELDS = ("room_dims", "sources", "mics", "alphas", "betas", "dry", "noise_gains", "snr_db")


def port_factory(monkeypatch, fn):
    """``fn()``'s result, and the (target, noise) magnitudes the port's
    factory handed ``tf_mask_mag`` while it ran, as numpy."""
    from disco_tpu_torch.core import masks as tmasks

    seen, mask_mag = [], tmasks.tf_mask_mag

    def recording(mag_s, mag_n, *args, **kw):
        seen.append((mag_s.numpy(), mag_n.numpy()))
        return mask_mag(mag_s, mag_n, *args, **kw)

    monkeypatch.setattr(tmasks, "tf_mask_mag", recording)
    out = fn()
    monkeypatch.setattr(tmasks, "tf_mask_mag", mask_mag)
    return out, seen


def assert_factory_matches(ours, theirs, mags):
    """One factory pass of each package: every array within 1e-5 of its
    scale; the port's mask within 1e-6 of the JAX package's mask of the
    port's own (target, noise) magnitudes ``mags``, and against the JAX
    package's mask within what the two packages' magnitudes' difference
    carries: the mask of the port's magnitudes against the mask of the JAX
    package's (recomputed from its returned clean and noisy signals, within
    1e-5 of their scale of the port's), plus how far that recomputed mask
    lies from the JAX package's returned one (measured, ~3e-6).  Where the
    noise is ~0 (before the direct path arrives) the masks are ~1 with
    noise magnitudes of roundoff, 1e-7 in one package and 1e-10 in the
    other, and differ by ~1e-5."""
    from disco_tpu.ops.stft_ops import stft_with_mag as jstft_with_mag

    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32 and ours[k].shape == theirs[k].shape, k
    for k in ("rirs", "noisy", "clean", "mag_noisy"):
        assert max_rel(ours[k], theirs[k]) <= 1e-5, k
    np.testing.assert_allclose(ours["mask"], np.asarray(jtf_mask_mag(*mags, "irm1")), rtol=0,
                               atol=1e-6)
    jmags = [np.asarray(jstft_with_mag(x)[1]) for x in (
        theirs["clean"][:, 0], theirs["noisy"][:, 0] - theirs["clean"][:, 0])]
    for a, b in zip(mags, jmags):
        assert max_rel(a, b) <= 1e-5
    m = theirs["mask"]
    carried = np.abs(np.asarray(jtf_mask_mag(*mags, "irm1")) - np.asarray(
        jtf_mask_mag(*jmags, "irm1")))
    recomputed = np.abs(np.asarray(jtf_mask_mag(*jmags, "irm1")) - m)
    assert np.all(np.abs(ours["mask"] - m) <= carried + recomputed + 1e-6)
    assert np.all((ours["mask"] >= 0) & (ours["mask"] <= 1))


def tiny_batch(mod, seed, n_scenes=2, n_mics=2, L=2048):
    """A hand-built SceneBatch (tests/test_scenes.py's ``_tiny_batch``)."""
    rng = np.random.default_rng(seed)
    dims, srcs, mics, alphas, betas, drys, gains, snrs = [], [], [], [], [], [], [], []
    for _ in range(n_scenes):
        dim = rng.uniform([3.5, 3.0, 2.5], [5.0, 4.0, 3.0])
        dims.append(dim.astype(np.float32))
        srcs.append(rng.uniform(0.8, 2.2, size=(2, 3)).astype(np.float32))
        mics.append(rng.uniform(1.0, 2.4, size=(n_mics, 3)).astype(np.float32))
        alphas.append(np.float32(rng.uniform(0.2, 0.5)))
        betas.append(np.float32(rng.uniform(0.3, 0.5)))
        target, noise = mod.synthetic_dry_pair(rng, L)
        drys.append(np.stack([target, noise]))
        snr = float(rng.uniform(-5, 10))
        gains.append(np.float32(mod.noise_gain_for_snr(target, noise, snr)))
        snrs.append(np.float32(snr))
    return mod.SceneBatch(
        room_dims=np.stack(dims), sources=np.stack(srcs), mics=np.stack(mics),
        alphas=np.asarray(alphas, np.float32), betas=np.asarray(betas, np.float32),
        dry=np.stack(drys), noise_gains=np.asarray(gains, np.float32),
        snr_db=np.asarray(snrs, np.float32))


# ------------------------------------------------------------- batched factory
@pytest.mark.parametrize("scenario", ["random", "living", "meeting", "meetit"])
def test_draw_scene_batch_is_the_jax_packages(scenario):
    kw = dict(scenario=scenario, duration_s=0.25,
              setup_overrides={"n_sensors_per_node": (2, 2, 2)})  # living needs 3 nodes
    a = tscenes.draw_scene_batch(np.random.default_rng(21), 3, **kw)
    b = jscenes.draw_scene_batch(np.random.default_rng(21), 3, **kw)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for order in (2, 8, 20):
        assert tscenes.scene_batch_bucket(a, max_order=order) == \
            jscenes.scene_batch_bucket(b, max_order=order)


def test_host_helpers_are_the_jax_packages():
    assert tscenes.BATCH_QUANTUM == jscenes.BATCH_QUANTUM
    a = tscenes.synthetic_dry_pair(np.random.default_rng(3), 4096)
    b = jscenes.synthetic_dry_pair(np.random.default_rng(3), 4096)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    for snr in (-10.0, 0.0, 7.5):
        assert tscenes.noise_gain_for_snr(a[0], a[1], snr) == jscenes.noise_gain_for_snr(*b, snr)


@pytest.mark.parametrize("seed,order,rir_len", [(13, 3, None), (14, 2, 1024)])
def test_simulate_scene_batch_matches_jax(monkeypatch, seed, order, rir_len):
    ours, seen = port_factory(monkeypatch, lambda: tscenes.simulate_scene_batch(
        tiny_batch(tscenes, seed), max_order=order, rir_len=rir_len, device="cpu"))
    theirs = jscenes.simulate_scene_batch(tiny_batch(jscenes, seed), max_order=order,
                                          rir_len=rir_len)
    assert len(seen) == 1
    assert_factory_matches(ours, theirs, seen[0])


def test_scene_batch_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenes.simulate_scene_batch(tiny_batch(tscenes, 13), max_order=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenes.SceneStream()


# ------------------------------------------------------------ dynamic scenes
@pytest.mark.parametrize("n_seg,crossfade", [(1, 0), (3, 0), (3, 256), (5, 512)])
def test_segment_weights_and_paths_are_the_jax_packages(n_seg, crossfade):
    a, b = tscenes.segment_weights(4096, n_seg, crossfade), jscenes.segment_weights(
        4096, n_seg, crossfade)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    a = tscenes.piecewise_trajectory([0.0, 0.0, 1.0], [2.0, 4.0, 1.0], n_seg)
    assert np.array_equal(a, jscenes.piecewise_trajectory([0.0, 0.0, 1.0], [2.0, 4.0, 1.0], n_seg))
    with pytest.raises(ValueError):
        tscenes.piecewise_trajectory([0, 0, 0], [1, 1, 1], 0)


@pytest.mark.parametrize("moving_mics", [False, True])
def test_dynamic_scene_mixture_matches_jax(moving_mics):
    t = np.arange(4096) / FS
    dry = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    path = jscenes.piecewise_trajectory([1.0, 1.0, 1.2], [3.0, 2.0, 1.2], 3)
    mics = np.array([[2.0, 1.5, 1.5], [2.1, 1.5, 1.5]], np.float32)
    kw = dict(max_order=2, rir_len=1024, fs=FS)
    if moving_mics:
        kw["mic_path"] = mics[None] + np.linspace(0, 0.3, 3, dtype=np.float32)[:, None, None]
    jumps = {}
    for crossfade in (512, 0):
        ours = tscenes.dynamic_scene_mixture([4.0, 3.0, 2.5], path, mics, 0.3, dry,
                                             crossfade=crossfade, device="cpu", **kw)
        theirs = jscenes.dynamic_scene_mixture([4.0, 3.0, 2.5], path, mics, 0.3, dry,
                                               crossfade=crossfade, **kw)
        for k in ("mixture", "rirs"):
            assert ours[k].shape == theirs[k].shape and max_rel(ours[k], theirs[k]) <= 1e-5, k
        jumps[crossfade] = tscenes.boundary_jumps(ours["mixture"], 3)
        np.testing.assert_allclose(jumps[crossfade], jscenes.boundary_jumps(theirs["mixture"], 3),
                                   rtol=1e-4)
    assert jumps[512].max() < 0.5 * jumps[0].max()


# --------------------------------------------------------------- SceneStream
def stream(mod, seed=7, batches_per_epoch=2, **kw):
    if mod is tscenes:
        kw["device"] = "cpu"
    return mod.SceneStream(seed=seed, scenes_per_batch=2, batches_per_epoch=batches_per_epoch,
                           duration_s=0.25, max_order=2, win_len=4, snr_range=(0.0, 5.0),
                           setup_overrides={"n_sensors_per_node": (2, 2)}, **kw)


@pytest.fixture(scope="module")
def epoch0(tmp_path_factory):
    """Epoch 0 of both packages' streams (batches of 4 windows), shuffled and
    in order, each package's under its own recorder (its events under
    ``(name, "events")``)."""
    import disco_tpu.obs as jobs
    import disco_tpu_torch.obs as tobs
    from tests.torch_port_helpers import recorded

    out = {}
    log = tmp_path_factory.mktemp("stream_events")
    for name, mod, obs in (("port", tscenes, tobs), ("jax", jscenes, jobs)):
        s = stream(mod)

        def both():
            return list(s.batches(4, epoch=0)), list(s.batches(4, epoch=0, shuffle=False))

        (out[name], out[name, "ordered"]), out[name, "events"] = recorded(
            obs, log / f"{name}.jsonl", both)
        out[name, "counters"] = obs.REGISTRY.snapshot()["counters"]
    return out


def test_scene_stream_events_match_jax(epoch0):
    """One ``scene`` event per simulated batch and the scene counters, the
    same in both packages."""
    from tests.torch_port_helpers import assert_events_match

    # a jit_trace event depends on what the process ran before: the
    # signature counts are held in tests/test_torch_port_sentinels.py
    ours, theirs = ([e for e in epoch0[name, "events"] if e["kind"] != "jit_trace"]
                    for name in ("port", "jax"))
    assert [(e["kind"], e["stage"]) for e in ours] == [("scene", "scenes")] * 4
    assert_events_match(ours, theirs)
    for key in ("scene_batches", "scenes_simulated"):
        assert epoch0["port", "counters"][key] == epoch0["jax", "counters"][key] > 0


def test_scene_stream_batches_match_jax(monkeypatch, epoch0):
    """Each scene batch as the factory simulates it, against the JAX
    package's; the windows cut from it in the JAX package's order (x within
    1e-5 of its scale), and exactly the port's windows of its own batches."""
    ours = stream(tscenes)
    for i in range(2):
        sim, seen = port_factory(monkeypatch, lambda: ours.simulate_batch(0, i))
        assert_factory_matches(sim, stream(jscenes).simulate_batch(0, i), seen[0])
    for key, jkey in (("port", "jax"), (("port", "ordered"), ("jax", "ordered"))):
        assert len(epoch0[key]) == len(epoch0[jkey]) == 4
        for (x, y), (xj, yj) in zip(epoch0[key], epoch0[jkey]):
            assert x.shape == xj.shape == y.shape == yj.shape == (4, 4, 257)
            assert max_rel(x, xj) <= 1e-5
    xs, ys = ours._windows(ours.simulate_batch(0, 1), 0, 1)
    assert np.array_equal(epoch0["port"][2][0], xs[:4]) and np.array_equal(epoch0["port"][3][1], ys[4:8])


def test_scene_stream_is_deterministic_and_seeded(epoch0):
    again = list(stream(tscenes).batches(4, epoch=0))
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(again, epoch0["port"]))
    other = list(stream(tscenes, seed=8).batches(4, epoch=0))
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(other, epoch0["port"]))
    assert stream(tscenes).peek_geometry() == stream(jscenes).peek_geometry()


def test_scene_stream_ledger_resume(tmp_path, epoch0):
    led = tmp_path / "led.jsonl"
    first = list(stream(tscenes).batches(4, epoch=0, ledger=led))
    assert len(first) == len(epoch0["port"])
    assert list(stream(tscenes).batches(4, epoch=0, ledger=led)) == []
    assert len(list(stream(tscenes).batches(4, epoch=1, ledger=led))) == len(first)


def test_scene_stream_crash_and_resume(tmp_path, epoch0):
    """A crash at ``between_scene_batches`` after the first scene batch; the
    resumed epoch serves exactly the rest, bit for bit."""
    led = tmp_path / "led.jsonl"
    got = []
    chaos.configure("between_scene_batches", after=1)
    try:
        with pytest.raises(chaos.ChaosCrash):
            for xy in stream(tscenes).batches(4, epoch=0, ledger=led):
                got.append(xy)
    finally:
        chaos.disable()
    rest = list(stream(tscenes).batches(4, epoch=0, ledger=led))
    assert got and rest and len(got) + len(rest) == len(epoch0["port"])
    for (x, y), (xf, yf) in zip(got + rest, epoch0["port"]):
        assert np.array_equal(x, xf) and np.array_equal(y, yf)


def test_scene_stream_batch_fn_start_epoch():
    s = stream(tscenes, batches_per_epoch=1)
    make = s.batch_fn(4)
    make.set_start_epoch(2)
    resumed, direct = list(make()), list(s.batches(4, epoch=2))
    assert len(resumed) == len(direct) > 0
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(resumed, direct))
    with pytest.raises(ValueError):
        next(s.batches(0))
    with pytest.raises(ValueError):
        tscenes.SceneStream(scenes_per_batch=0, device="cpu")


def test_scene_stream_feeds_fit(tmp_path):
    """``fit`` trains off ``SceneStream.batch_fn`` (train and validation
    feeds, one epoch) as the JAX package's ``fit`` does off its stream
    (tests/test_scenes.py::test_scene_stream_feeds_fit), from the same
    weights: the losses finite and within 1e-5 relative of the JAX
    package's."""
    from disco_tpu.nn.crnn import build_crnn as jbuild_crnn
    from disco_tpu.nn.training import create_train_state as jcreate, fit as jfit
    from disco_tpu_torch.nn.convert import state_dict_from_flax
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, fit
    from tests.test_torch_port_training import randomized

    F = stream(tscenes).peek_geometry()["n_freq"]
    kw = dict(n_ch=1, win_len=4, n_freq=F, cnn_filters=(2,), pool_kernels=((1, 2),),
              conv_padding=((0, 1),), rnn_units=(4,), ff_units=(F,), rnn_dropouts=0.0)
    jmodel, tx = jbuild_crnn(**kw)
    js = stream(jscenes, batches_per_epoch=1)
    jstate = jcreate(jmodel, tx, next(js.batches(2, epoch=0))[0][:1], seed=2)
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, 5)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    _, jtr, jva, _ = jfit(jmodel, jstate, js.batch_fn(4), js.batch_fn(4, shuffle=False),
                          n_epochs=1, save_path=tmp_path / "j", verbose=False)

    model = build_crnn(**kw)
    model.load_state_dict(state_dict_from_flax(variables, model))
    ts = stream(tscenes, batches_per_epoch=1)
    _, tr, va, _ = fit(model, create_train_state(model, build_optimizer(model)), ts.batch_fn(4),
                       ts.batch_fn(4, shuffle=False), n_epochs=1, save_path=tmp_path / "t",
                       verbose=False, device="cpu")
    assert len(tr) == len(va) == 1 and np.isfinite(tr[0]) and tr[0] > 0 and np.isfinite(va[0])
    np.testing.assert_allclose(tr, jtr, rtol=1e-5)
    np.testing.assert_allclose(va, jva, rtol=1e-5)
