"""DL008 — the never-SIGKILL contract, statically.

The port's reading of ``disco_tpu/analysis/rules/sigkill.py``.  On the
card a killed process does not wedge a remote claim as the TPU's did, but
the contract it protects still holds: a hard-killed server, trainer or
corpus run skips its graceful drain, so its ledger, session checkpoints,
tap shards and flight dumps end wherever the signal found them, and
resume must repair what a drain would have closed.  So nothing in the port
may hard-kill a process: no ``SIGKILL`` reference, no ``os.kill``, no
``Popen.kill()``/``terminate()``.  The sanctioned stop path is
``disco_tpu_torch.runs.interrupt`` (signal a graceful flag, drain between
units, exit resumable) and, for subprocesses, a SIGINT + wait.  A last
resort after SIGINT and a bounded wait (a harness that must stop every
process it starts) carries a suppression saying so.

No reference counterpart: the reference has no process management at all.
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.registry import Rule, register


@register
class NeverSigkill(Rule):
    id = "DL008"
    name = "never-sigkill"
    summary = ("SIGKILL reference or os.kill/.kill()/.terminate() call — a "
               "hard-killed process skips its drain; use runs.interrupt "
               "graceful stops (SIGINT + wait)")

    def check(self, ctx):
        for node in ctx.walk():
            if isinstance(node, (ast.Attribute, ast.Name)):
                chain = attr_chain(node)
                if chain and chain[-1] == "SIGKILL" and (
                    not isinstance(node, ast.Name) or len(chain) == 1
                ):
                    yield self.finding(
                        ctx, node,
                        "SIGKILL referenced: a hard-killed process skips its "
                        "graceful drain (ledger, checkpoints, shards end "
                        "wherever the signal found them) — send SIGINT and "
                        "wait",
                    )
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if not chain:
                    continue
                if chain == ("os", "kill"):
                    yield self.finding(
                        ctx, node,
                        "os.kill(): signal delivery to another process risks "
                        "the never-SIGKILL contract — use runs.interrupt "
                        "(graceful flag + drain) or justify why the target "
                        "has nothing to drain",
                    )
                elif len(chain) > 1 and chain[-1] in ("kill", "terminate"):
                    yield self.finding(
                        ctx, node,
                        f".{chain[-1]}() on a process object: Popen.kill is "
                        "SIGKILL and terminate skips the graceful drain — "
                        "send SIGINT and wait for the resumable exit instead",
                    )
