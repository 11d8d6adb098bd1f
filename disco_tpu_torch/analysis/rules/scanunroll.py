"""DL011 — ``lax.scan`` must pass ``unroll=``: no counterpart in the port.

The JAX rule (``disco_tpu/analysis/rules/scanunroll.py``) makes the unroll
choice of every ``lax.scan`` explicit in the bit-exactness-gated modules
(``enhance/streaming.py``, ``serve/scheduler.py``, ``scenes/dynamic.py``),
because a ROLLED scan body compiles with different FMA/fusion choices
than the standalone per-block program.  The port has no ``lax.scan`` and
no compiler between its source and the card: ``streaming_tango_scan``
loops over the per-block function itself (``enhance/streaming.py``), so a
super-tick runs the very kernels and products a per-block call runs, and
the bit-exactness gates hold it with ``torch.equal``.  There is no unroll
choice to state, so the rule checks nothing.  The id stays in the catalog
(ids, names and registration order match the JAX package's ``disco-lint``,
and a suppression naming DL011 stays a known id), and a test pins that
the JAX rule's snippets give no port finding.

No reference counterpart: the reference has no jit, no scan and no
bit-exactness gate.
"""
from __future__ import annotations

from disco_tpu_torch.analysis.registry import Rule, register


@register
class ScanUnroll(Rule):
    id = "DL011"
    name = "scan-unroll"
    summary = ("no counterpart in the port: it has no lax.scan, and "
               "streaming_tango_scan loops over the per-block function — "
               "checks nothing")

    def applies(self, ctx) -> bool:
        return False

    def check(self, ctx):
        return iter(())
