"""DL009/DL010/DL014 — registered telemetry strings: event kinds, chaos
seams, span stages, status sections.

The obs event log, the chaos harness, the causal tracer and the serve
status surface are all keyed by bare strings at the call site
(``record("clip", ...)``, ``chaos.tick("mid_write")``,
``span("dispatch", ctx)``, ``status_section(payload, "counters")``).  A
typo'd kind crashes only when the schema-validating reader runs; a typo'd
seam is worse — it arms NOTHING and the chaos test silently tests
nothing; a typo'd span stage breaks every chain reconstruction that
expects the canonical hop names, and a typo'd status section renders
blanks in ``disco-obs top``.  These rules check every string literal at
those call sites against the declared registries (``EVENT_KINDS`` in
``obs/events.py``, ``SEAMS`` in ``runs/chaos.py``, ``SPAN_STAGES`` in
``obs/trace.py``, ``STATUS_SECTIONS`` in ``serve/status.py``), parsed
from source so the linter stays hermetic (no production import, no torch).
The port's copy of ``disco_tpu/analysis/rules/registered.py``, reading the
port's registries (``disco_tpu_torch/runs/chaos.py`` carries the same
fifteen seams as the JAX package's).

No reference counterpart: the reference has neither telemetry nor chaos.
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis import registries
from disco_tpu_torch.analysis.context import attr_chain, str_literal
from disco_tpu_torch.analysis.registry import Rule, register

#: receiver aliases under which obs.events' record() is called in-repo
_OBS_ALIASES = {"obs", "_obs", "obs_events", "events", "_events", "ev", "_ev"}


def _record_calls(ctx):
    """Calls that are (by alias convention) obs.events.record invocations."""
    bare_record = any(
        isinstance(node, ast.ImportFrom)
        and (node.module or "").startswith("disco_tpu_torch.obs")
        and any(a.name == "record" for a in node.names)
        for node in ctx.walk()
    )
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain:
            continue
        if (len(chain) >= 2 and chain[-1] == "record" and chain[0] in _OBS_ALIASES) or (
            chain == ("record",) and bare_record
        ):
            yield node


@register
class ObsEventKind(Rule):
    id = "DL009"
    name = "obs-event-kind"
    summary = ("obs record() called with an event kind missing from "
               "EVENT_KINDS — the schema-validating reader would reject the "
               "log it produces")

    def check(self, ctx):
        kinds = registries.event_kinds(ctx.root)
        for call in _record_calls(ctx):
            kind = str_literal(call.args[0]) if call.args else None
            if kind is not None and kind not in kinds:
                yield self.finding(
                    ctx, call,
                    f"event kind {kind!r} is not in obs.events.EVENT_KINDS — "
                    "register it there (and teach disco-obs report about it) "
                    "or fix the typo; the JSONL reader rejects unknown kinds",
                )


@register
class ChaosSeamName(Rule):
    id = "DL010"
    name = "chaos-seam"
    summary = ("chaos tick() called with a seam missing from runs.chaos.SEAMS "
               "— a typo'd seam arms nothing and the chaos gate silently "
               "tests nothing")

    def check(self, ctx):
        seams = registries.chaos_seams(ctx.root)
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] != "tick":
                continue
            seam = str_literal(node.args[0]) if node.args else None
            if seam is not None and seam not in seams:
                yield self.finding(
                    ctx, node,
                    f"chaos seam {seam!r} is not in runs.chaos.SEAMS — "
                    "register the seam (and document it in the chaos module "
                    "docstring) or fix the typo; an unknown seam never arms",
                )


#: receiver aliases under which obs.trace's span()/root() are called
_TRACE_ALIASES = {"trace", "_trace", "obs_trace", "tracer"}


def _span_stage_literal(call: ast.Call):
    """The stage string literal of a span()/root() call: first positional
    arg, or the ``stage=`` keyword (root's signature)."""
    for kw in call.keywords:
        if kw.arg == "stage":
            return str_literal(kw.value)
    if call.args:
        return str_literal(call.args[0])
    return None


@register
class SpanStageStatusSection(Rule):
    id = "DL014"
    name = "span-stage-status-section"
    summary = ("span()/root() called with a stage missing from SPAN_STAGES, "
               "or status_section() with a section missing from "
               "STATUS_SECTIONS — a typo'd hop breaks chain reconstruction, "
               "a typo'd section renders blanks")

    def check(self, ctx):
        stages = registries.span_stages(ctx.root)
        sections = registries.status_sections(ctx.root)
        bare_span = any(
            isinstance(node, ast.ImportFrom)
            and (node.module or "").startswith("disco_tpu_torch.obs")
            and any(a.name in ("span", "root", "record_span")
                    for a in node.names)
            for node in ctx.walk()
        )
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            name = chain[-1]
            if name in ("span", "root", "record_span") and (
                (len(chain) >= 2 and chain[0] in _TRACE_ALIASES)
                or (len(chain) == 1 and bare_span)
            ):
                stage = _span_stage_literal(node)
                if stage is not None and stage not in stages:
                    yield self.finding(
                        ctx, node,
                        f"span stage {stage!r} is not in obs.trace."
                        "SPAN_STAGES — register the hop (and teach the "
                        "waterfall/STAGE_ORDER about it) or fix the typo; "
                        "chain reconstruction expects the canonical names",
                    )
            elif name == "status_section":
                section = (str_literal(node.args[1])
                           if len(node.args) > 1 else None)
                if section is not None and section not in sections:
                    yield self.finding(
                        ctx, node,
                        f"status section {section!r} is not in serve.status."
                        "STATUS_SECTIONS — register the section in the "
                        "status payload or fix the typo; an unknown section "
                        "raises KeyError at render time",
                    )
