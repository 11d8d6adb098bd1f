"""disco-torch-trace — operator-level program contracts of the port
(counterpart of ``disco_tpu/analysis/trace``, which reads jaxprs).

* golden fingerprints (:mod:`.fingerprint`, :mod:`.programs`): the
  catalog programs traced for the card on fake ``cuda`` tensors and
  reduced to the operators they dispatch, their kernel ops, host syncs
  and device dtypes, diffed against goldens under
  ``disco_tpu_torch/analysis/golden/``;
* retrace budgets (:mod:`.budgets`): the ``counted_jit`` signature counts
  of a miniature workload;
* dtype and donation audits (:mod:`.audits`);
* the gate (:mod:`.check`) and ``disco-torch-trace`` (:mod:`.cli`).
"""
from disco_tpu_torch.analysis.trace.check import TraceResult, run_checks  # noqa: F401
from disco_tpu_torch.analysis.trace.fingerprint import (  # noqa: F401
    diff_fingerprints,
    fingerprint_program,
    fingerprint_trace,
)
