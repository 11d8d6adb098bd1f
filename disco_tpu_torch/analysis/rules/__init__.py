"""Rule modules — importing this package populates the registry.

Rule catalog (one module per contract, one per module of
``disco_tpu/analysis/rules``: the same ids, names and registration order
as the JAX package's ``disco-lint``, each contract re-read for torch on the
card in its module's docstring):

* DL001 ``fence-discipline``      — :mod:`.fence`
* DL002 ``host-readback-in-loop`` — :mod:`.readback`
* DL003 ``raw-tunnel-transfer``   — :mod:`.transfer`
* DL004 ``atomic-write``          — :mod:`.atomicio`
* DL005 ``import-purity``         — :mod:`.purity`
* DL006 ``reference-citation``    — :mod:`.citations`
* DL007 ``traced-float-literal``  — :mod:`.tracedfloat`
* DL008 ``never-sigkill``         — :mod:`.sigkill`
* DL009 ``obs-event-kind``        — :mod:`.registered`
* DL010 ``chaos-seam``            — :mod:`.registered`
* DL011 ``scan-unroll``           — :mod:`.scanunroll` (no counterpart in
  the port: it has no ``lax.scan``; the id stays, and checks nothing)
* DL012 ``fused-magnitude-precision`` — :mod:`.magnitude`
* DL013 ``adhoc-transport-retry`` — :mod:`.retryloop`
* DL014 ``span-stage-status-section`` — :mod:`.registered`
* DL015 ``bare-thread-primitive``  — :mod:`.threads`
* DL016 ``fused-solver-selection`` — :mod:`.fusedsolver`

(DL000 ``lint-suppression`` is the engine's own hygiene rule — see
:mod:`disco_tpu_torch.analysis.suppressions`.)

No reference counterpart: the reference repo has no static analysis.
"""
from disco_tpu_torch.analysis.rules import (  # noqa: F401  (import = register)
    atomicio,
    citations,
    fence,
    fusedsolver,
    magnitude,
    purity,
    readback,
    registered,
    retryloop,
    scanunroll,
    sigkill,
    threads,
    tracedfloat,
    transfer,
)
