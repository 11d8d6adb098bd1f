"""AST extraction of the port's in-code string registries (the port's copy
of ``disco_tpu/analysis/registries.py``, reading the port's own sources).

The registry rules (DL009 obs event kinds, DL010 chaos seams, DL014 span
stages / status sections) check string literals at call sites against the
closed sets declared in ``disco_tpu_torch/obs/events.py`` (``EVENT_KINDS``),
``disco_tpu_torch/runs/chaos.py`` (``SEAMS``), ``disco_tpu_torch/obs/trace.py``
(``SPAN_STAGES``) and ``disco_tpu_torch/serve/status.py`` (``STATUS_SECTIONS``).
The sets are read by PARSING those files, not importing them: the linter
must stay importable with no torch, no jax (and no production dependency)
in the process — ``disco-torch-lint`` is a hermetic CPU gate that touches
no device.

No reference counterpart: the reference repo has neither telemetry kinds
nor chaos seams to register.
"""
from __future__ import annotations

import ast
from pathlib import Path

#: repo-relative file and assigned name per registry
REGISTRY_SOURCES = {
    "event_kinds": ("disco_tpu_torch/obs/events.py", "EVENT_KINDS"),
    "chaos_seams": ("disco_tpu_torch/runs/chaos.py", "SEAMS"),
    "span_stages": ("disco_tpu_torch/obs/trace.py", "SPAN_STAGES"),
    "status_sections": ("disco_tpu_torch/serve/status.py", "STATUS_SECTIONS"),
}

_cache: dict = {}


class RegistryExtractionError(RuntimeError):
    """The declared registry could not be located/parsed — the registry
    moved or changed shape, and the lint rule would otherwise silently
    check nothing."""


def _extract_string_set(path: Path, name: str) -> frozenset:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            strings = {
                c.value
                for c in ast.walk(node.value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            }
            if strings:
                return frozenset(strings)
    raise RegistryExtractionError(
        f"could not extract {name} from {path} — if the registry moved, "
        f"update disco_tpu_torch.analysis.registries.REGISTRY_SOURCES"
    )


def load(root, which: str) -> frozenset:
    """The named registry's string set, parsed from the repo at ``root``
    (cached per (root, registry))."""
    rel, name = REGISTRY_SOURCES[which]
    key = (str(root), which)
    if key not in _cache:
        _cache[key] = _extract_string_set(Path(root) / rel, name)
    return _cache[key]


def event_kinds(root) -> frozenset:
    """``EVENT_KINDS`` as declared in ``disco_tpu_torch/obs/events.py``."""
    return load(root, "event_kinds")


def chaos_seams(root) -> frozenset:
    """``SEAMS`` as declared in ``disco_tpu_torch/runs/chaos.py``."""
    return load(root, "chaos_seams")


def span_stages(root) -> frozenset:
    """``SPAN_STAGES`` as declared in ``disco_tpu_torch/obs/trace.py``."""
    return load(root, "span_stages")


def status_sections(root) -> frozenset:
    """``STATUS_SECTIONS`` as declared in ``disco_tpu_torch/serve/status.py``."""
    return load(root, "status_sections")
