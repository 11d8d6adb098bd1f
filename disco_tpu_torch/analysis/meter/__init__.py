"""disco-torch-meter: the per-program cost and roofline observatory of the
port (counterpart of ``disco_tpu/analysis/meter``).

* :mod:`.costmodel` — the operator-walking cost model (the kernels as
  fused islands with declared costs; an explicit ``unmodeled`` bucket);
* :mod:`.budgets` — unmodeled ceilings and the fused-vs-eigh cross
  budgets;
* :mod:`.stages` — the stage programs at the headline workload, traced for
  the card, so a measured stage time joins a cost of the same program;
* :mod:`.check` / :mod:`.cli` — the gate and ``disco-torch-meter``.
"""
