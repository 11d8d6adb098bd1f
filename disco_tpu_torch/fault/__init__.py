"""Declarative fault injection at the z-exchange seam (counterpart of
``disco_tpu/fault``): :class:`FaultSpec` names a seeded scenario (node
dropout, per-block link loss, stale delivery, NaN-corrupted z) and
:func:`plan_faults` expands it into a :class:`FaultPlan` — the (K,)/(K, B)
availability and NaN flags that ``enhance.tango.tango`` (``z_mask`` /
``z_nan``) and ``enhance.streaming.streaming_tango`` (``z_avail``) consume."""
from disco_tpu_torch.fault.inject import FaultPlan, plan_faults
from disco_tpu_torch.fault.spec import FaultSpec, load_fault_spec

__all__ = ["FaultPlan", "FaultSpec", "load_fault_spec", "plan_faults"]
