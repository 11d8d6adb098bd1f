"""The port's numerics sentinels (``disco_tpu_torch.obs.sentinels``) and
signature counter (``obs.accounting.counted_jit``) against the JAX
package's on the same numpy inputs.

Sentinels: the same trees — clean, with NaN, with inf, complex, bf16 and
nested — give the same ``sentinel`` events in both packages: ``shape``,
``dtype``, ``n_nonfinite``, ``frac_nonfinite``, ``n_nan`` and ``n_inf``
exactly, ``finite_absmax`` and ``finite_mean`` within 1e-6 relative,
``precision`` only when given; the same check and fence counts; one flight
dump a tripped check; and with no sink live a strict no-op.

Signature counter: the same call sequence on ``streaming_tango`` (two
lengths, a repeat, a changed static argument) and on the scene factory's
``scene_batch`` gives the same per-label counts and ``jit_trace`` events.
Shapes no other test uses keep each label's count fresh in a shared
process.
"""
import numpy as np
import pytest
import torch

import disco_tpu.obs as jobs
import disco_tpu_torch.obs as tobs
from disco_tpu.obs import flight as jflight
from disco_tpu.obs import sentinels as jsent
from disco_tpu_torch.obs import flight as tflight
from disco_tpu_torch.obs import sentinels as tsent


def _trees():
    """{name: (numpy tree, dtype of its float leaves)}, from one seed."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 7)).astype(np.float32)
    nan = a.copy()
    nan[0, 1] = np.nan
    inf = a.copy()
    inf[2, 3] = -np.inf
    inf[1, 1] = np.nan
    z = (rng.standard_normal((2, 5)) + 1j * rng.standard_normal((2, 5))).astype(np.complex64)
    z[1, 2] = complex(0.0, np.nan)
    allbad = np.full((4,), np.inf, np.float32)
    return {
        "clean": (a, None),
        "nan": (nan, None),
        "inf": (inf, None),
        "complex": (z, None),
        "bf16": (inf, "bf16"),
        "nested": ({"b": (a, nan), "a": [z, allbad]}, None),
    }


def _to(tree, leaf):
    if isinstance(tree, dict):
        return {k: _to(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, leaf) for v in tree)
    return leaf(tree)


def _check(pkg, tree, bf16, precision, tmp_path):
    """One check under ``pkg``'s recorder with its flight ring armed:
    (returned flag, sentinel events, checks, trips, fences, dumps)."""
    obs, sent, flight = {"jax": (jobs, jsent, jflight), "port": (tobs, tsent, tflight)}[pkg]
    if pkg == "jax":
        import jax.numpy as jnp

        leaf = (lambda x: jnp.asarray(x, jnp.bfloat16)) if bf16 else jnp.asarray
    else:
        leaf = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) if bf16 else torch.from_numpy
    dumps = tmp_path / pkg / "flight"
    obs.REGISTRY.reset()
    flight.enable(dump_dir=dumps)
    try:
        with obs.recording(tmp_path / pkg / "log.jsonl"):
            ok = sent.check_finite("x", _to(tree, leaf), stage="stft", precision=precision)
        events = obs.read_events(tmp_path / pkg / "log.jsonl")
    finally:
        flight.disable()
    c = obs.REGISTRY.snapshot()["counters"]
    return (ok, [e for e in events if e["kind"] == "sentinel"], c["sentinel_checks"],
            c["sentinel_trips"], c["fences"], len(list(dumps.glob("flight-*.json"))))


@pytest.mark.parametrize("case", list(_trees()))
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_sentinel_events_match_jax(case, precision, tmp_path):
    tree, bf16 = _trees()[case]
    ours = _check("port", tree, bf16, precision, tmp_path)
    theirs = _check("jax", tree, bf16, precision, tmp_path)
    assert ours[0] is theirs[0] is (case == "clean")
    assert ours[2:] == theirs[2:]              # checks, trips, fences, dumps
    assert ours[5] == (0 if case == "clean" else 1)
    assert len(ours[1]) == len(theirs[1]) == ours[3]
    for a, b in zip(ours[1], theirs[1]):
        assert a["stage"] == b["stage"] == "stft"
        fa, fb = a["attrs"], b["attrs"]
        assert set(fa) == set(fb)
        assert ("precision" in fa) == (precision is not None)
        for key in ("name", "shape", "dtype", "n_nonfinite", "frac_nonfinite", "n_nan", "n_inf",
                    "precision"):
            assert fa.get(key) == fb.get(key), key
        for key in ("finite_absmax", "finite_mean"):
            if key in fb:
                np.testing.assert_allclose(fa[key], fb[key], rtol=1e-6)


def test_sentinel_is_a_strict_noop_when_disabled():
    """No sink live: True at once, no leaf touched, no count moved."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"the sentinel touched a leaf ({name})")

    assert not tobs.events.active()
    before = tobs.REGISTRY.snapshot()["counters"]
    assert tsent.check_finite("x", [Untouchable(), {"a": Untouchable()}]) is True
    assert tsent.check_finite("x", torch.full((3,), float("nan"))) is True
    after = tobs.REGISTRY.snapshot()["counters"]
    for key in ("sentinel_checks", "sentinel_trips", "fences", "device_get_batches"):
        assert after.get(key) == before.get(key), key


def test_sentinel_readback_is_not_a_batched_readback(tmp_path):
    from disco_tpu_torch.obs.accounting import device_get_count

    g0 = device_get_count()
    with tobs.recording(tmp_path / "log.jsonl"):
        assert tsent.check_finite("x", torch.ones(4, dtype=torch.complex64)) is True
    assert device_get_count() == g0


def _traces(events, label):
    return [(e["kind"], e["stage"], e["attrs"]["n_new_programs"]) for e in events
            if e["kind"] == "jit_trace" and e["stage"] == label]


def test_streaming_tango_counts_match_jax(tmp_path):
    """Two lengths, a repeat, a changed static argument: 3 new signatures
    in both packages, with the same jit_trace events."""
    from disco_tpu.enhance import streaming as jstream
    from disco_tpu_torch.enhance import streaming as tstream

    rng = np.random.default_rng(2)
    Y = (rng.standard_normal((2, 2, 9, 20)) + 1j * rng.standard_normal((2, 2, 9, 20))
         ).astype(np.complex64)
    m = rng.uniform(0.1, 0.9, (2, 9, 20)).astype(np.float32)
    calls = [(12, {}), (20, {}), (12, {}), (12, {"update_every": 2})]

    def run(pkg):
        import jax.numpy as jnp

        obs, fn = (jobs, jstream.streaming_tango) if pkg == "jax" else (
            tobs, tstream.streaming_tango)
        counts = []
        with obs.recording(tmp_path / f"{pkg}.jsonl"):
            for T, kw in calls:
                r0 = obs.recompile_count("streaming_tango")
                if pkg == "jax":
                    fn(jnp.asarray(Y[..., :T]), jnp.asarray(m[..., :T]), jnp.asarray(m[..., :T]),
                       **kw)
                else:
                    fn(Y[..., :T], m[..., :T], m[..., :T], device="cpu", **kw)
                counts.append(obs.recompile_count("streaming_tango") - r0)
        return counts, _traces(obs.read_events(tmp_path / f"{pkg}.jsonl"), "streaming_tango")

    ours, theirs = run("port"), run("jax")
    assert ours == theirs
    assert ours[0] == [1, 1, 0, 1] and len(ours[1]) == 3


def test_scene_batch_counts_match_jax(tmp_path):
    """A batch, a same-bucket batch, a new batch size: 1, 0, 1 new
    signatures and one readback each, in both packages."""
    from disco_tpu.obs.accounting import device_get_count as jgets
    from disco_tpu.scenes import batched as jbatched
    from disco_tpu_torch.obs.accounting import device_get_count as tgets
    from disco_tpu_torch.scenes import batched as tbatched

    overrides = {"n_sensors_per_node": (1, 2)}

    def run(pkg):
        mod, obs, gets = (jbatched, jobs, jgets) if pkg == "jax" else (tbatched, tobs, tgets)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        rng = np.random.default_rng(9)
        counts = []
        with obs.recording(tmp_path / f"{pkg}.jsonl"):
            for n in (2, 2, 3):
                batch = mod.draw_scene_batch(rng, n, duration_s=0.37, setup_overrides=overrides)
                r0, g0 = obs.recompile_count("scene_batch"), gets()
                mod.simulate_scene_batch(batch, max_order=1, **kw)
                counts.append((obs.recompile_count("scene_batch") - r0, gets() - g0))
        return counts, _traces(obs.read_events(tmp_path / f"{pkg}.jsonl"), "scene_batch")

    ours, theirs = run("port"), run("jax")
    assert ours == theirs
    assert ours[0] == [(1, 1), (0, 1), (1, 1)]
