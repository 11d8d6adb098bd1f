"""disco_tpu_torch.analysis — the port's program contracts and cost model
(counterpart of ``disco_tpu/analysis``).

* :mod:`.trace` — ``disco-torch-trace``: golden fingerprints of the
  catalog programs traced for the card, retrace budgets, dtype and
  donation audits;
* :mod:`.meter` — ``disco-torch-meter``: cost manifests, budgets and the
  stage costs the roofline (``obs.roofline``) joins with measured times.

The AST linter (``disco-lint``) and the thread-contract gate
(``disco-race``) are not ported yet.
"""
