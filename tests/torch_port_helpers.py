"""Shared inputs and measures of the ``disco_tpu_torch`` parity tests.

Every input is made with numpy from a seed and handed, as the same arrays,
to the JAX function and to its port (``device="cpu"``), so a test compares
the two implementations and nothing else.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


def to_np(x) -> np.ndarray:
    """A JAX array, tensor or numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all elements (b is the reference)."""
    a, b = to_np(a).astype(np.complex128), to_np(b).astype(np.complex128)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def max_rel(a, b) -> float:
    """max |a - b| / max |b| (the error against the output scale)."""
    a, b = to_np(a).astype(np.complex128), to_np(b).astype(np.complex128)
    return float(np.abs(a - b).max() / np.abs(b).max())


def complex_normal(rng, shape) -> np.ndarray:
    """complex64 standard normal samples."""
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def pencils(rng, C, F=16, T=80):
    """(F, C, C) float64 Hermitian PSD (Rss, Rnn) pencils: a rank-1
    dominant speech field over diffuse, diagonally loaded noise — the shape
    of the filter bank's covariances."""
    src = rng.standard_normal((F, T))
    gains = rng.standard_normal((C, 1, 1)) + 1j * rng.standard_normal((C, 1, 1))
    S = gains * src[None] + 0.05 * (rng.standard_normal((C, F, T))
                                    + 1j * rng.standard_normal((C, F, T)))
    N = 0.6 * (rng.standard_normal((C, F, T)) + 1j * rng.standard_normal((C, F, T)))
    Rss = np.einsum("cft,dft->fcd", S, np.conj(S)) / T
    Rnn = np.einsum("cft,dft->fcd", N, np.conj(N)) / T + 0.1 * np.eye(C)
    return Rss, Rnn


def scene(K, C, L, seed=0, noise_scale=0.8):
    """(y, s, n), each (K, C, L) float32: a broadband source through short
    random filters per mic plus white noise (the scene of
    ``disco_tpu/milestones.py``)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(L)
    s = np.stack([
        np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(C)])
        for _ in range(K)
    ]).astype(np.float32)
    n = noise_scale * rng.standard_normal((K, C, L)).astype(np.float32)
    return s + n, s, n


# ----------------------------------------------------------- corpus driver
#: the bound of tests/test_driver.py:342 on every metric key (dB), and the
#: bound on the STOI deltas
METRIC_RTOL, METRIC_ATOL, STOI_ATOL = 2e-4, 1e-3, 1e-4


def assert_results_close(ours: dict, theirs: dict) -> None:
    """{rir: results dict} of the two drivers: the same RIRs and keys, float64
    numpy values within the metric bounds (NaN where the other has NaN)."""
    assert set(ours) == set(theirs)
    for rir in theirs:
        a, b = ours[rir], theirs[rir]
        assert set(a) == set(b), rir
        for k in b:
            assert isinstance(a[k], np.ndarray) and a[k].dtype == b[k].dtype == np.float64, k
            atol, rtol = (STOI_ATOL, 0) if k.startswith("delta_stoi") else (METRIC_ATOL,
                                                                          METRIC_RTOL)
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"rir {rir} key {k}")


def artifact_paths(root) -> list:
    """Sorted relative paths of every file under ``root``."""
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def artifact_errors(ours, theirs, skip_frames: int = 0) -> dict:
    """{relative path: max |a - b| / max |b|} over the WAV and .npy artifacts
    of two result trees (NaNs required at the same places); the first
    ``skip_frames`` STFT frames (256 samples each in the WAVs) are left
    out."""
    from disco_tpu_torch.io.audio import read_wav

    errs = {}
    for rel in artifact_paths(theirs):
        if rel.endswith(".wav"):
            a, b = read_wav(ours / rel)[0], read_wav(theirs / rel)[0]
            a, b = a[256 * skip_frames:], b[256 * skip_frames:]
        elif rel.endswith(".npy"):
            a, b = np.load(ours / rel), np.load(theirs / rel)
            assert a.dtype == b.dtype, rel
            a, b = a[..., skip_frames:], b[..., skip_frames:]
        else:
            continue
        assert a.shape == b.shape, rel
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=rel)
        errs[rel] = 0.0 if np.isnan(b).all() else float(np.nanmax(np.abs(a - b))
                                                         / np.nanmax(np.abs(b)))
    return errs


def _openblas_thread_setters() -> list:
    """(get, set) thread-count functions of the OpenBLAS builds bundled
    with numpy and scipy, where their libraries export them."""
    import ctypes
    import glob
    import os

    import scipy

    found = []
    for pkg in (np, scipy):
        libs = os.path.join(os.path.dirname(os.path.dirname(pkg.__file__)),
                            f"{pkg.__name__}.libs", "*openblas*.so*")
        for path in glob.glob(libs):
            lib = ctypes.CDLL(path)
            for suffix in ("64_", ""):
                get = getattr(lib, f"scipy_openblas_get_num_threads{suffix}", None)
                put = getattr(lib, f"scipy_openblas_set_num_threads{suffix}", None)
                if get is not None and put is not None:
                    found.append((get, put))
    return found


@pytest.fixture(scope="module")
def one_host_thread():
    """Run a module's port calls on one torch thread and one BLAS thread,
    and restore the counts after it.  The corpus-driver tests make
    thousands of small torch and BLAS calls beside scoring threads; under
    the test runner's parallel workers the default pools (one thread per
    core each) oversubscribe the host and spin: the engine tests took
    ~20x their time alone.  The tests compare results within bounds far
    above a change of summation order inside BLAS, or between runs made
    under the same settings."""
    n = torch.get_num_threads()
    blas = [(get, put, get()) for get, put in _openblas_thread_setters()]
    torch.set_num_threads(1)
    for _, put, _ in blas:
        put(1)
    yield
    torch.set_num_threads(n)
    for _, put, old in blas:
        put(old)


# ------------------------------------------------------------ observability
#: attributes that are timings (or derived from them), left out when two
#: packages' events are compared
TIMING_KEYS = frozenset({"t", "dur_s", "dur_ms", "overlap_efficiency"})


def recorded(obs, path, fn):
    """``fn()`` under one package's recorder (``obs``: ``disco_tpu.obs`` or
    ``disco_tpu_torch.obs``) at ``path``, its registry reset first; returns
    (fn's value, the log read back through that package's reader)."""
    obs.REGISTRY.reset()
    with obs.recording(path):
        value = fn()
    return value, obs.read_events(path)


def _untimed(attrs: dict, ignore=()) -> dict:
    return {k: v for k, v in attrs.items()
            if k not in TIMING_KEYS and k not in ignore and not k.endswith(("_ms", "_s"))}


def _shape_of(ev: dict, ignore=()):
    """An event with its float attributes replaced by a marker: what must
    match exactly; the floats are compared to the metric bounds."""
    attrs = _untimed(ev["attrs"], ignore)
    return repr((ev["kind"], ev["stage"],
                 sorted((k, "<float>" if isinstance(v, float) else v) for k, v in attrs.items())))


def _floats(ev: dict, ignore=()) -> list:
    attrs = _untimed(ev["attrs"], ignore)
    return [attrs[k] for k in sorted(attrs) if isinstance(attrs[k], float)]


def _assert_same_events(ours: list, theirs: list, label: str, ignore=()) -> None:
    assert [_shape_of(e, ignore) for e in ours] == [_shape_of(e, ignore) for e in theirs], label
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(_floats(a, ignore), _floats(b, ignore), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, equal_nan=True, err_msg=f"{label}: {b}")


def assert_events_match(ours: list, theirs: list, ignore=()) -> None:
    """Two packages' logs of the same run: the events that name no clip (the
    main thread's) in order, each clip's events (attribute ``rir``, which
    worker threads record in an order that varies) as a multiset, with the
    same attributes but timings and ``ignore`` (attributes naming each
    run's own paths); float attributes within the metric bounds.  The
    ``counters`` snapshots are left to :func:`assert_counters_match`."""
    def split(events):
        events = [e for e in events if e["kind"] != "counters"]
        main = [e for e in events if "rir" not in e["attrs"]]
        clips = {}
        for e in events:
            if "rir" in e["attrs"]:
                clips.setdefault(e["attrs"]["rir"], []).append(e)
        return main, {r: sorted(v, key=lambda e: _shape_of(e, ignore))
                      for r, v in clips.items()}

    (main_a, clips_a), (main_b, clips_b) = split(ours), split(theirs)
    _assert_same_events(main_a, main_b, "main-thread events", ignore)
    assert set(clips_a) == set(clips_b)
    for rir in clips_b:
        _assert_same_events(clips_a[rir], clips_b[rir], f"events of clip {rir}", ignore)


def assert_counters_match(ours: list, theirs: list, names) -> None:
    """The last ``counters`` snapshot of each log agrees on ``names``."""
    def last(events):
        return next(e["attrs"]["counters"] for e in reversed(events) if e["kind"] == "counters")

    a, b = last(ours), last(theirs)
    assert {n: a.get(n) for n in names} == {n: b.get(n) for n in names}


# ------------------------------------------------ the JAX meter as an oracle
class _Prim:
    def __init__(self, name):
        self.name = name


def _proxied(v):
    if isinstance(v, (list, tuple)):
        return type(v)(_proxied(e) for e in v) if isinstance(v, list) else tuple(
            _proxied(e) for e in v)
    if hasattr(v, "eqns"):
        return _JaxprProxy(v)
    if hasattr(v, "jaxpr"):
        return _ClosedProxy(v)
    return v


class _EqnProxy:
    """One equation as ``disco_tpu.analysis.meter.costmodel`` reads it, from
    jax 0.9's: its ``jit`` primitive shown as ``pjit`` (the name the meter's
    ``_CONTROL`` table knows, so a nested program is walked, not left as one
    unmodeled equation), and a convolution's dimension numbers with the
    ``rhs_spec`` attribute the meter reads (jax 0.9 hands a plain tuple)."""

    def __init__(self, eqn):
        import collections

        name = eqn.primitive.name
        self.primitive = _Prim("pjit") if name == "jit" else eqn.primitive
        self.params = {k: _proxied(v) for k, v in eqn.params.items()}
        dn = self.params.get("dimension_numbers")
        if name == "conv_general_dilated" and isinstance(dn, tuple) and not hasattr(
                dn, "rhs_spec"):
            spec = collections.namedtuple("ConvDimensionNumbers", "lhs_spec rhs_spec out_spec")
            self.params["dimension_numbers"] = spec(*dn)
        self.invars, self.outvars = eqn.invars, eqn.outvars


class _JaxprProxy:
    def __init__(self, jaxpr):
        self.eqns = [_EqnProxy(e) for e in jaxpr.eqns]
        self.invars, self.outvars, self.constvars = jaxpr.invars, jaxpr.outvars, jaxpr.constvars


class _ClosedProxy:
    def __init__(self, closed):
        self.jaxpr = _JaxprProxy(getattr(closed, "jaxpr", closed))


def jax_meter(closed_jaxpr, program: str = "") -> dict:
    """The JAX package's cost report of a (closed) jaxpr, read through the duck-typed
    proxy (:class:`_EqnProxy`): ``cost_of_jaxpr`` only reads attributes, so
    the proxy makes it a sound oracle on jax 0.9 without editing it."""
    from disco_tpu.analysis.meter.costmodel import cost_of_jaxpr

    return cost_of_jaxpr(_ClosedProxy(closed_jaxpr), program=program)
