"""DL013 — transport retries go through ``utils.resilience``, nowhere else.

The port's reading of ``disco_tpu/analysis/rules/retryloop.py``: the port
centralizes transient-failure recovery in
:func:`disco_tpu_torch.utils.resilience.call_with_retries` — bounded
attempts, a wall deadline, seeded-jitter backoff, and first-class
telemetry (``fault`` events per failed attempt, ``recovery`` on a late
success, the ``retries``/``retry_giveups`` counters) — over the port's
``TRANSPORT_ERRORS`` (connection, timeout and OS errors, and
``torch.OutOfMemoryError``: a card allocation that may succeed once the
caching allocator has freed).  An ad-hoc ``try/except OSError``-and-go-
again loop has none of that — it retries forever (or a magic number of
times), sleeps however it likes, desynchronizes with nothing and tells the
obs log nothing — so any loop that swallows a transport-layer error type
and keeps looping is a finding.

The shape flagged: a ``while`` loop (or a ``for`` over ``range(...)`` — an
attempt counter) containing a ``try`` whose handler catches a transport
error type (``OSError``/``ConnectionError``/``TimeoutError`` or their
subclasses/aliases, ``socket.error``, or torch's ``OutOfMemoryError``) and
then lets the loop continue — no ``raise``, ``return`` or ``break``
anywhere in the handler.  A handler that re-raises (fail-fast), returns a
fallback or breaks out is not a retry loop and is not flagged; neither is
a loop *inside* a ``try`` (one attempt, not a retry), nor a ``for`` over
distinct items that skips a failed item and moves on (the next iteration
is different work, not a re-attempt of the same crossing).

Allowed files: ``utils/resilience.py`` (the one implementation), and the
DL005 numpy-only client files (``serve/client.py``/``protocol.py`` and the
flywheel host side) — the import-purity contract bars them from
``utils.resilience``, which imports torch (its transport-error table names
``torch.OutOfMemoryError``), so their *client-socket* retries (connect
backoff, reattach) are documented inline stdlib implementations.

No reference counterpart: the reference never leaves one host process.
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.registry import Rule, register
from disco_tpu_torch.analysis.rules.purity import CLIENT_FILES

#: transport-layer exception names (the retry_on set of the wired seams,
#: plus the OSError subclasses a socket failure commonly surfaces as)
_TRANSPORT_NAMES = frozenset({
    "OSError", "IOError", "EnvironmentError",
    "ConnectionError", "ConnectionRefusedError", "ConnectionResetError",
    "ConnectionAbortedError", "BrokenPipeError",
    "TimeoutError", "InterruptedError",
})

_ALLOWED_FILES = ("disco_tpu_torch/utils/resilience.py",) + CLIENT_FILES


def _is_transport_type(node) -> bool:
    """True when an except-clause type expression names a transport error
    (a bare name, ``socket.error``/``socket.timeout``, or a tuple holding
    at least one of them)."""
    if node is None:
        return False
    if isinstance(node, ast.Tuple):
        return any(_is_transport_type(e) for e in node.elts)
    chain = attr_chain(node)
    if not chain:
        return False
    if len(chain) == 1:
        return chain[0] in _TRANSPORT_NAMES
    if chain[0] == "torch" and chain[-1] == "OutOfMemoryError":
        return True
    return chain[0] == "socket" and chain[-1] in ("error", "timeout")


def _handler_exits(handler: ast.ExceptHandler) -> bool:
    """True when the handler body can leave the loop / unwind (raise,
    return, break anywhere inside — conservative: a conditional re-raise
    still counts as an exit path, the DL013 concern is handlers with NO
    exit at all)."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Break)):
            return True
    return False


@register
class AdHocTransportRetryLoop(Rule):
    id = "DL013"
    name = "adhoc-transport-retry"
    summary = ("try/except swallowing a transport error type inside a loop "
               "outside utils.resilience — transport retries go through "
               "call_with_retries (bounded, jittered, telemetered)")

    def applies(self, ctx) -> bool:
        return not ctx.is_file(*_ALLOWED_FILES)

    @staticmethod
    def _is_retry_shaped(loop) -> bool:
        """``while`` loops and ``for`` over ``range(...)`` re-attempt the
        SAME work each iteration; a ``for`` over items does different work
        (skipping a failed item is not a retry)."""
        if isinstance(loop, ast.While):
            return True
        if isinstance(loop, (ast.For, ast.AsyncFor)):
            it = loop.iter
            return (isinstance(it, ast.Call)
                    and attr_chain(it.func) in (("range",), ("itertools", "count")))
        return False

    def check(self, ctx):
        for loop in ctx.walk():
            if not self._is_retry_shaped(loop):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    if _is_transport_type(handler.type) and not _handler_exits(handler):
                        yield self.finding(
                            ctx, handler,
                            "ad-hoc transport retry loop: this handler "
                            "swallows a transport error type and loops "
                            "again — unbounded, unjittered and invisible "
                            "to obs; route the retry through utils."
                            "resilience.call_with_retries (retry_on="
                            "TRANSPORT_ERRORS) instead",
                        )
