"""DL005 — import purity: serve clients, the flywheel host side and CLI
wiring stay torch-free (the port's reading of
``disco_tpu/analysis/rules/purity.py``).

The numpy+stdlib serve client (``serve/client.py`` + ``serve/protocol.py``)
must be importable and runnable with no torch (and no jax, jaxlib or
triton) anywhere — not even lazily: a client process that reaches torch
pays its import and may initialize CUDA on a host it shares with the
server.  The flywheel's host side (``flywheel/tap.py`` writer thread,
``flywheel/shards.py`` codec, ``flywheel/dataset.py`` reader) carries the
same contract for a different reason: its tap thread runs INSIDE the
serving process, where a second thread entering torch would queue work on
the card beside the one dispatch thread (disco-torch-race DR002 pins the
role; this rule pins the modules).  The CLI modules may use torch, but
only INSIDE ``main``-path functions: a module-level import would pay
torch's import (and its CUDA probe) at ``--help`` time.

The contract is lexical: these files name no banned module.  The package
root ``disco_tpu_torch/__init__.py`` imports torch (it turns TF32 off for
the whole port), so ``import disco_tpu_torch.serve.client`` still loads
torch transitively; ROADMAP records that, and a test pins it.

No reference counterpart: the reference has no serve client.
"""
from __future__ import annotations

from disco_tpu_torch.analysis.context import imports_module
from disco_tpu_torch.analysis.registry import Rule, register

_BANNED = ("torch", "jax", "jaxlib", "triton")
#: no torch/jax/triton ANYWHERE (module or function level): the numpy-only
#: serve client plus the flywheel host side (the tap's writer thread must
#: never enter torch — it shares a process with the dispatch thread)
CLIENT_FILES = (
    "disco_tpu_torch/serve/client.py",
    "disco_tpu_torch/serve/protocol.py",
    "disco_tpu_torch/flywheel/__init__.py",
    "disco_tpu_torch/flywheel/tap.py",
    "disco_tpu_torch/flywheel/shards.py",
    "disco_tpu_torch/flywheel/dataset.py",
)
#: no torch/jax/triton at MODULE level (lazy in-function imports are the idiom)
_CLI_DIR = "disco_tpu_torch/cli"


@register
class ImportPurity(Rule):
    id = "DL005"
    name = "import-purity"
    summary = ("torch/jax/triton imported in the numpy-only serve client or "
               "flywheel host side (anywhere) or at module level in cli "
               "arg-parsing modules")

    def applies(self, ctx) -> bool:
        return ctx.is_file(*CLIENT_FILES) or ctx.in_dir(_CLI_DIR)

    def check(self, ctx):
        if ctx.is_file(*CLIENT_FILES):
            import ast

            for node in ctx.walk():
                if isinstance(node, (ast.Import, ast.ImportFrom)) and imports_module(
                    node, *_BANNED
                ):
                    yield self.finding(
                        ctx, node,
                        "torch/jax import in a numpy-only module (serve "
                        "client / flywheel host side): it must be importable "
                        "and runnable without torch (the client runs beside "
                        "the server; the tap's writer thread shares the "
                        "server process with the dispatch thread)",
                    )
        else:
            for node in ctx.module_level_imports():
                if imports_module(node, *_BANNED):
                    yield self.finding(
                        ctx, node,
                        "module-level torch/jax import in a CLI module pays "
                        "torch's import and CUDA probe at --help time — "
                        "import lazily inside the function that needs it",
                    )
