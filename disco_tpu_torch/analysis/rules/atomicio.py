"""DL004 — run-critical artifacts are written atomically, or not at all.

The port's reading of ``disco_tpu/analysis/rules/atomicio.py``, unchanged
but for one writer: crash-safe resume stands on one invariant, a final
artifact path is either complete or absent, never truncated.
``disco_tpu_torch.io.atomic`` (tmp + fsync + rename) is the only writer
allowed to produce final paths in the run-critical packages (enhance /
datagen / nn / runs / serve / flywheel); raw truncate-mode ``open``,
``np.save``/``savez``, ``pickle.dump``, ``soundfile.write``,
``Path.write_text``/``write_bytes`` and — torch's own writer —
``torch.save`` all leave the torn-write window the verified-resume probes
cannot see past.  Append mode ("a") is allowed: the run ledger's
append-only JSONL with per-line fsync is itself the crash-safe protocol.

No reference counterpart: the reference writes artifacts raw and cannot
resume (SURVEY.md §5).
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain, str_literal
from disco_tpu_torch.analysis.registry import Rule, register

_SCOPE = (
    "disco_tpu_torch/enhance", "disco_tpu_torch/datagen", "disco_tpu_torch/nn",
    "disco_tpu_torch/runs", "disco_tpu_torch/serve", "disco_tpu_torch/flywheel",
)
_NP_WRITERS = {"save", "savez", "savez_compressed"}
_NP_BASES = {"np", "numpy"}
_SF_BASES = {"sf", "soundfile"}
_PATH_WRITERS = {"write_text", "write_bytes"}
_HINT = ("route it through disco_tpu_torch.io.atomic (atomic_write / "
         "write_bytes_atomic / save_npy_atomic / savez_atomic / "
         "dump_pickle_atomic / write_wav_atomic) so a crash cannot leave a "
         "truncated final artifact")


#: modules whose ``X.open(path, mode)`` has the BUILTIN signature (mode at
#: position 1), unlike ``Path.open(mode)`` (mode at position 0)
_OPEN_MODULES = {"io", "gzip", "bz2", "lzma", "codecs", "tarfile", "zipfile"}


def _write_mode(mode: str | None) -> bool:
    """True for truncate/create modes; read ("r") and append ("a") pass."""
    return mode is not None and any(c in mode for c in "wx+")


def _open_mode(call: ast.Call, base: str | None) -> str | None:
    """The literal mode of an ``open``-shaped call, or None (default 'r' or
    non-literal — non-literal modes are skipped, not guessed).  ``base``
    distinguishes builtin-signature variants (``open``/``gzip.open``/... —
    mode at position 1) from method form (``path.open(mode)`` — position 0)."""
    pos = 1 if (base is None or base in _OPEN_MODULES) else 0
    for kw in call.keywords:
        if kw.arg == "mode":
            return str_literal(kw.value)
    if len(call.args) > pos:
        return str_literal(call.args[pos])
    return None


@register
class AtomicWrite(Rule):
    id = "DL004"
    name = "atomic-write"
    summary = ("raw write (open('w') / np.save / torch.save / pickle.dump / "
               "soundfile / write_text) in a run-critical package — final "
               "artifacts must go through io.atomic")

    def applies(self, ctx) -> bool:
        return ctx.in_dir(*_SCOPE)

    def check(self, ctx):
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            name = chain[-1]
            base = chain[0] if len(chain) > 1 else None
            if name == "open":
                mode = _open_mode(node, base)
                if _write_mode(mode):
                    yield self.finding(
                        ctx, node,
                        f"raw open(..., {mode!r}) in a run-critical module; {_HINT}")
            elif name in _NP_WRITERS and base in _NP_BASES:
                yield self.finding(
                    ctx, node, f"raw np.{name} in a run-critical module; {_HINT}")
            elif name == "save" and base == "torch":
                yield self.finding(
                    ctx, node, f"raw torch.save in a run-critical module; {_HINT}")
            elif name == "dump" and base in ("pickle", "cPickle"):
                yield self.finding(
                    ctx, node, f"raw pickle.dump in a run-critical module; {_HINT}")
            elif name == "write" and base in _SF_BASES:
                yield self.finding(
                    ctx, node, f"raw soundfile write in a run-critical module; {_HINT}")
            elif name in _PATH_WRITERS:
                yield self.finding(
                    ctx, node, f"raw .{name}() in a run-critical module; {_HINT}")
