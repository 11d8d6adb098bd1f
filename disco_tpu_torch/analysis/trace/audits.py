"""The dtype audit and the donation audit's counterpart over the port's
catalog programs (counterpart of ``disco_tpu/analysis/trace/audits.py``).

**Dtype.** The pipeline is complex64/float32 end to end on the device.  A
float64 or complex128 tensor on the card in a catalog program is a finding
(2x the memory and other numerics than the validated ones), unless the
program declares it in :data:`F64_ALLOWED` with its reason — a reviewed
list, as the meter's ``UNMODELED_OVERRIDES`` is.  Host float64 (numpy, or
torch tensors on the CPU) stays allowed.  A dtype-preserving
``aten::_to_copy`` is copy churn; its count is in the golden, and
:data:`COPY_CHURN_MAX` bounds what ``--update`` may commit.

**Donation.** Eager torch has no donation; what donation buys in the JAX
package is that a step's old carry dies when the step returns, so the
state is held once, not twice.  The audit checks that for each program the
JAX catalog donates with ``must_alias``:

* ``streaming_tango_state``: the serve carry.  After the call the port
  holds no reference to the old carry — weakrefs to its tensors are dead
  once the caller drops them — and the step's peak extra bytes (the
  meter's peak live bytes above its inputs, traced for the card) are
  reported;
* ``train_step``: the TrainState.  The step updates the parameters and the
  optimizer's ``nu`` in place (the same storages after the call), which is
  what aliasing gives the JAX lane.

States are not rewritten in place to get there: that would put the
bit-exact contracts at risk.  Programs whose donation the JAX package
reports without requiring it (the corpus runners) are reported alike.
"""
from __future__ import annotations

import gc
import weakref

import torch

#: dtype-preserving ``_to_copy`` ceiling per program (the count itself is
#: in the golden, so any drift fails the diff; this bound fails a
#: ``--update`` that would commit an explosion)
COPY_CHURN_MAX = 60

#: program -> why it keeps float64 tensors on the device by design
F64_ALLOWED: dict = {
    "scene_batch": (
        "sim/ism.py takes the image sources' distances in float64 on the device "
        "(_sqrt_rn: the correctly rounded float32 square root by way of float64; "
        "_norm3: each fused multiply-add in float64), so the card and the host compute "
        "the same delays as the JAX package's float32 arithmetic on the CPU"
    ),
}


def audit_dtypes(name: str, fp: dict) -> list:
    """Gate findings from one fingerprint's dtype fields (empty = clean)."""
    out = []
    if fp.get("f64") and name not in F64_ALLOWED:
        out.append("float64/complex128 tensor on the device: " + "; ".join(fp["f64"][:5])
                   + (" ..." if len(fp["f64"]) > 5 else "")
                   + " — fix the program, or declare it in audits.F64_ALLOWED with its reason")
    churn = int(fp.get("copy_churn", 0))
    if churn > COPY_CHURN_MAX:
        out.append(f"{churn} dtype-preserving aten::_to_copy calls (> {COPY_CHURN_MAX}): "
                   "copy churn exploded")
    return out


def audit_donation(spec) -> dict:
    """One program's donation verdict, from a run on real CPU tensors at the
    catalog's shapes: ``{program, kind ('freed' or 'in_place'),
    declared_tensors, held_to_contract, peak_extra_bytes, ok, must_alias,
    note}``."""
    from disco_tpu_torch.analysis.meter.costmodel import cost_of_spec
    from disco_tpu_torch.analysis.trace.fingerprint import materialize, tensors_of

    device = "cpu"
    don = spec.donate or {}
    with spec.context(device):
        fn, args, kwargs = spec.build(device)
        args = list(materialize(args, device))
        if don.get("arg") is None and hasattr(args[0], "optimizer"):
            # the TrainState: its tensors before and after a step (the
            # first step makes the optimizer's nu, so the second is held)
            state = args[0]
            fn(*args, **kwargs)
            before = [t.data_ptr() for t in tensors_of(state)]
            fn(*args, **kwargs)
            after = [t.data_ptr() for t in tensors_of(state)]
            kind, declared = "in_place", len(before)
            kept = sum(a == b for a, b in zip(before, after)) if len(before) == len(after) else 0
            ok = kept == declared
        else:
            carried = don.get("arg")
            refs = [weakref.ref(t)
                    for t in tensors_of(args if carried is None else args[carried])]
            declared = len(refs)
            out = fn(*args, **kwargs)
            args = None
            gc.collect()
            # a carried tensor the step returns as it is lives on in the
            # new carry: that is the buffer reused, not a reference kept
            returned = {id(t) for t in tensors_of(out)}
            alive = sum(r() is not None and id(r()) not in returned for r in refs)
            kind, kept = "freed", declared - alive
            ok = alive == 0
            del out
    report = cost_of_spec(spec)
    inputs = report["hbm_bytes_in"]
    return {
        "program": spec.name,
        "kind": kind,
        "declared_tensors": declared,
        "held_to_contract": kept,
        "peak_extra_bytes": max(int(report["peak_live_bytes"]) - int(inputs), 0),
        "ok": ok or not don.get("must_alias"),
        "must_alias": bool(don.get("must_alias")),
        "note": don.get("note", ""),
    }
