"""The kernels' build cache seam (``disco_tpu_torch/utils/compile_cache.py``)
against the JAX package's ``disco_tpu/utils/compile_cache.py``.

* ``tests/test_pipeline.py``'s four cases on the port (explicit path and
  idempotence, env ``off``, ``False``, env path wins), with the port's own
  variable ``DISCO_TORCH_COMPILE_CACHE``;
* ``ops._build.build()`` (its compiler faked) under the resolved root with
  the note event, or, when the cache is off or unusable (with a warning
  event), under a per-process temporary root removed when the process
  forgets it; resolving the cache builds and makes nothing else;
* ``disco-torch-tango --compile-cache`` and ``enhance_rirs_batched(
  compile_cache=...)`` reach ``ensure_enabled`` as the JAX package's do
  (monkeypatched: no corpus run);
* nothing on the CPU builds or loads the kernel library.
"""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from disco_tpu_torch import obs as tobs
from disco_tpu_torch.ops import _build
from disco_tpu_torch.utils import compile_cache


@pytest.fixture
def _cache_state(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    compile_cache._reset_for_tests()
    yield compile_cache
    compile_cache._reset_for_tests()


# ---------------------------------------- tests/test_pipeline.py's four cases
def test_compile_cache_enables_at_explicit_path(_cache_state, tmp_path):
    path = _cache_state.ensure_enabled(str(tmp_path / "kernels"))
    assert path == str(tmp_path / "kernels")
    assert Path(path).is_dir()
    # idempotent: the first resolution wins for the whole process
    assert _cache_state.ensure_enabled(str(tmp_path / "other")) == path
    assert _cache_state.ensure_enabled(False) == path
    assert not (tmp_path / "other").exists()


@pytest.mark.parametrize("value", ["off", "0", "none", "Disabled", " false "])
def test_compile_cache_env_off(_cache_state, monkeypatch, value):
    monkeypatch.setenv(_cache_state.ENV_VAR, value)
    assert _cache_state.ensure_enabled() is None


def test_compile_cache_false_disables(_cache_state):
    assert _cache_state.ensure_enabled(False) is None


def test_compile_cache_env_path_wins(_cache_state, monkeypatch, tmp_path):
    monkeypatch.setenv(_cache_state.ENV_VAR, str(tmp_path / "envcache"))
    assert _cache_state.ensure_enabled() == str(tmp_path / "envcache")


# ------------------------------------------------------------ the port's seam
def test_default_is_the_checkout_build_dir_and_ignores_the_jax_variable(_cache_state,
                                                                          monkeypatch):
    monkeypatch.setenv("DISCO_TPU_COMPILE_CACHE", "off")
    root = Path(__file__).resolve().parents[1]
    assert _cache_state.default_path() == str(root / "build" / "kernels")
    assert _cache_state.ensure_enabled() == _cache_state.default_path()


def test_explicit_argument_beats_env_and_takes_a_path(_cache_state, monkeypatch, tmp_path):
    monkeypatch.setenv(_cache_state.ENV_VAR, "off")
    assert _cache_state.ensure_enabled(tmp_path / "arg") == str(tmp_path / "arg")


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """``_build``'s compiler replaced by a script that writes each ``-o``
    file, so ``build()`` runs on the CPU: the library is an empty file."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                      '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\ndone\n')
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    return script


def _cache_events(log):
    return [e for e in tobs.read_events(log) if e["stage"] == "compile_cache"]


def test_build_dir_lies_under_the_resolved_root_with_a_note(_cache_state, fake_nvcc, tmp_path):
    root = _cache_state.ensure_enabled(str(tmp_path / "kernels"))
    assert not any(Path(root).iterdir())  # resolving builds nothing
    with tobs.recording(tmp_path / "log.jsonl"):
        lib = _build.build()
    assert lib == Path(root) / _build.source_digest() / _build.LIB_NAME
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [_build.LIB_NAME, "ptxas.log"] + [f"{s}{x}" for s in _build.SOURCES
                                          for x in (".o", ".log")])
    assert [p.name for p in Path(root).iterdir()] == [_build.source_digest()]  # no temp left
    assert [(e["kind"], e["attrs"]["path"]) for e in _cache_events(tmp_path / "log.jsonl")] \
        == [("note", root)]
    assert _build.build() == lib  # a built digest is not rebuilt
    assert _build.build_dir() is None and _build.ptxas_log() == ""  # nothing loaded


def test_off_builds_into_a_per_process_temporary_root(_cache_state, fake_nvcc, tmp_path):
    assert _cache_state.ensure_enabled("off") is None
    with tobs.recording(tmp_path / "log.jsonl"):
        lib = _build.build()
    scratch = lib.parent.parent
    assert scratch.parent == Path(tempfile.gettempdir())
    assert scratch.name.startswith("disco_torch_kernels_")
    assert lib == scratch / _build.source_digest() / _build.LIB_NAME and lib.exists()
    assert _cache_state.kernel_root() == scratch  # one root for the process
    assert not _cache_events(tmp_path / "log.jsonl")
    _cache_state._reset_for_tests()
    assert not scratch.exists()


def test_unwritable_root_warns_and_falls_to_a_temporary_root(_cache_state, fake_nvcc, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    with tobs.recording(tmp_path / "log.jsonl"):
        assert _cache_state.ensure_enabled(str(blocker / "kernels")) is None
        lib = _build.build()
    events = _cache_events(tmp_path / "log.jsonl")
    assert [e["kind"] for e in events] == ["warning"]
    assert str(blocker / "kernels") in events[0]["attrs"]["reason"]
    assert lib.exists() and lib.parent.parent.parent == Path(tempfile.gettempdir())


# ------------------------------------------------------ the flag and the keyword
def _tango_cli_calls(pkg, argv, monkeypatch):
    """(ensure_enabled's arguments, enhance_rirs_batched's compile_cache) of
    one ``disco-tango`` call of ``pkg``, the driver monkeypatched."""
    if pkg == "jax":
        from disco_tpu.cli import tango as cli
        from disco_tpu.enhance import driver
        from disco_tpu.utils import compile_cache as seam

        monkeypatch.setattr(cli, "enhance_rir", lambda *a, **k: None)
    else:
        from disco_tpu_torch.cli import tango as cli
        from disco_tpu_torch.enhance import driver
        seam = compile_cache

        monkeypatch.setattr(driver, "enhance_rir", lambda *a, **k: None)
        argv = argv + ["--device", "cpu"]
    enabled, batched = [], []
    monkeypatch.setattr(seam, "ensure_enabled", lambda path=None: enabled.append(path))
    monkeypatch.setattr(driver, "enhance_rirs_batched",
                        lambda *a, **k: batched.append(k["compile_cache"]) or {})
    cli.main(argv)
    return enabled, batched


@pytest.mark.parametrize("mode", [["--rir", "1"], ["--rirs", "1", "2"]])
@pytest.mark.parametrize("flag", [[], ["--compile-cache", "DIR"], ["--compile-cache", "off"],
                                  ["--compile-cache", "0"]])
def test_tango_cli_compile_cache_reaches_the_seam_as_in_jax(mode, flag, monkeypatch, tmp_path):
    argv = mode + ["--dataset", str(tmp_path / "DS"), "--noise", "ssn"] + flag
    ours = _tango_cli_calls("port", argv, monkeypatch)
    theirs = _tango_cli_calls("jax", argv, monkeypatch)
    assert ours == theirs
    want = {(): None, ("DIR",): "DIR", ("off",): False, ("0",): False}[tuple(flag[1:])]
    assert ours == (([want], []) if mode[0] == "--rir" else ([], [want]))


class _Reached(Exception):
    pass


@pytest.mark.parametrize("value", [None, "DIR", False])
def test_enhance_rirs_batched_resolves_the_cache_first(value, monkeypatch, tmp_path):
    """Both drivers hand ``compile_cache`` to ``ensure_enabled`` before
    reading the corpus (which does not exist here)."""
    from disco_tpu.enhance import driver as jdriver
    from disco_tpu.utils import compile_cache as jseam
    from disco_tpu_torch.enhance import driver as tdriver

    seen = []

    def reached(path=None):
        seen.append(path)
        raise _Reached

    for seam, run in ((compile_cache, lambda: tdriver.enhance_rirs_batched(
            str(tmp_path / "none"), "living", [1], "ssn", device="cpu", compile_cache=value)),
                      (jseam, lambda: jdriver.enhance_rirs_batched(
            str(tmp_path / "none"), "living", [1], "ssn", compile_cache=value))):
        monkeypatch.setattr(seam, "ensure_enabled", reached)
        with pytest.raises(_Reached):
            run()
    assert seen == [value, value]


# ----------------------------------------------------------- nothing builds here
def test_nothing_on_the_cpu_builds_or_loads_the_library(_cache_state, monkeypatch):
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.ops import eigh_ops, stft_ops

    def refuse(*a, **k):
        raise AssertionError("the kernel library was built, loaded or given a root on the CPU")

    for name in ("build", "load"):
        monkeypatch.setattr(_build, name, refuse)
    monkeypatch.setattr(compile_cache, "kernel_root", refuse)
    counters = (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, eigh_ops.eigh_jacobi_kernel)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(0)
    y, s, n = (torch.from_numpy(rng.standard_normal((2, 2, 2048)).astype(np.float32))
               for _ in range(3))
    for precision in ("f32", "bf16"):
        out = tango_clip_fused(y, s, n, solver="fused", precision=precision, device="cpu")
        assert all(torch.isfinite(torch.as_tensor(v)).all() for v in
                   (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(v))
    stft_ops.stft_kernel(y)
    a = torch.randn(4, 3, 3, dtype=torch.complex64)
    eigh_ops.eigh_jacobi_kernel(a @ a.mH)
    assert _build._lib is None and _build.build_dir() is None and _build.ptxas_log() == ""
    assert not compile_cache._state["resolved"] and compile_cache._state["scratch"] is None
    assert [c.launches for c in counters] == before
