"""The kernels' build cache seam (the port's reading of
``disco_tpu/utils/compile_cache.py``).

What the port compiles at run time is its kernel library: ``ops/_build.py``
runs ``nvcc`` over ``csrc/`` at the first kernel launch (~10 s on an H100)
into ``<root>/<sha256 of flags and sources>/``, and a later process loads
that library without compiling.  This module is the one place that
chooses ``<root>``, with the JAX seam's policy:

* **Path-configurable**: explicit argument > ``DISCO_TORCH_COMPILE_CACHE``
  env var > :func:`default_path` (``<checkout>/build/kernels/``, which
  ``.gitignore`` lists).  The variable is the port's own, so the JAX
  package's ``DISCO_TPU_COMPILE_CACHE`` does not reach it.
* **Opt-out**: ``False``, or the env var (or argument) set to ``0`` /
  ``off`` / ``none`` / ``disabled`` / ``false``, turns the cache off:
  :func:`ensure_enabled` returns ``None``.
* **Idempotent**: the first resolution wins for the process, so a library
  already loaded keeps the root it was loaded from.
* **Never fatal**: a root that cannot be created or written degrades to
  "no cache" with a ``warning`` obs event and the reason.

With the cache off or unusable, the library builds into a per-process
temporary directory that is removed at exit (:func:`kernel_root`): the
kernels still build with ``nvcc`` and still launch.  No path gives way to
the plain versions.  Only the library's build asks for that root
(``ops/_build.py::build``, once a process, at the first :func:`load
<disco_tpu_torch.ops._build.load>`), and :func:`kernel_root` records a
``note`` event with ``stage="compile_cache"`` and the path when it hands
out the cache: a run on the CPU builds nothing, makes no temporary root
and records no note (:func:`ensure_enabled`, which the CLI and the corpus
driver call as the JAX package's do, makes and probes the cache
directory it resolves, as the JAX seam does).  The JAX seam's "off on the tunneled attachment unless forced"
branch is TPU deployment machinery and has no counterpart here.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path

#: Environment override: a cache directory, or 0/off/none/disabled/false.
ENV_VAR = "DISCO_TORCH_COMPILE_CACHE"

_OFF_VALUES = ("0", "off", "none", "disabled", "false")

_lock = threading.Lock()
#: resolved: ensure_enabled has run; path: the cache root or None;
#: scratch: the per-process root used when path is None
_state = {"resolved": False, "path": None, "scratch": None}


def default_path() -> str:
    """Default kernel build cache, ``<checkout>/build/kernels`` (the JAX
    seam's ``default_path``, disco_tpu/utils/compile_cache.py:43)."""
    return str(Path(__file__).resolve().parents[2] / "build" / "kernels")


def ensure_enabled(path: str | os.PathLike | bool | None = None) -> str | None:
    """Resolve the kernel build cache once per process (the JAX seam's
    ``ensure_enabled``, disco_tpu/utils/compile_cache.py:54).

    Args:
      path: explicit cache directory; ``False`` (or an off-string) disables;
        ``None`` resolves the env var, then :func:`default_path`.

    Returns:
      The cache directory, or ``None`` when disabled or unusable (the
      library then builds into a per-process temporary root).  Idempotent:
      later calls return the first resolution.
    """
    reason = None
    with _lock:
        if not _state["resolved"]:
            _state["path"], reason = _resolve(path)
            _state["resolved"] = True
        resolved = _state["path"]
    if reason is not None:  # recorded outside the lock, which guards _state alone
        _record("warning", reason=reason)
    return resolved


def _record(kind: str, **attrs) -> None:
    try:
        from disco_tpu_torch.obs import events as obs_events

        obs_events.record(kind, stage="compile_cache", **attrs)
    except Exception:
        pass


def _resolve(path) -> tuple[str | None, str | None]:
    """(the cache root or None, the reason it is unusable or None)."""
    if path is False:
        return None, None
    explicit = os.fspath(path) if isinstance(path, (str, os.PathLike)) else os.environ.get(ENV_VAR)
    if isinstance(explicit, str) and explicit.strip().lower() in _OFF_VALUES:
        return None, None
    cache_dir = explicit or default_path()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        # a write probe, since a directory that exists may still refuse one
        with tempfile.TemporaryFile(dir=cache_dir):
            pass
        return cache_dir, None
    except Exception as e:
        return None, (f"kernel build cache unavailable at {cache_dir}: "
                      f"{type(e).__name__}: {e}")[:300]


def kernel_root() -> Path:
    """The root the kernel library builds under and loads from (no JAX
    counterpart, where XLA owns the cache): the resolved cache, with a
    ``note`` event naming it, or, when it is off or unusable, a per-process
    temporary directory made at the first such call and removed at exit.
    ``ops/_build.py::build`` is its caller, once a process."""
    path = ensure_enabled()
    if path is not None:
        _record("note", path=path)
        return Path(path)
    with _lock:
        if _state["scratch"] is None:
            _state["scratch"] = tempfile.mkdtemp(prefix="disco_torch_kernels_")
            atexit.register(shutil.rmtree, _state["scratch"], True)
        return Path(_state["scratch"])


def _reset_for_tests() -> None:
    """Forget the process-wide resolution (test isolation only)."""
    with _lock:
        if _state["scratch"] is not None:
            shutil.rmtree(_state["scratch"], ignore_errors=True)
        _state.update(resolved=False, path=None, scratch=None)
