"""disco_tpu_torch.promote — live SDR-gated model promotion (the port's
counterpart of ``disco_tpu/promote``).

Candidate CRNN weights are staged as immutable, digest-addressed weight
generations (:mod:`.store`, the JAX package's bytes and ids), a fraction of
the live model-mask sessions is canaried onto a candidate at an atomic
block boundary, an SDR/SLO gate over a bounded canary window decides
promote or roll back, and each step is crash-drilled through the chaos
seams ``pre_swap``, ``mid_canary`` and ``post_gate`` (:mod:`.controller`).
:mod:`.lane` computes a model session's per-block masks on the device;
:mod:`.check` holds the legs as functions of a device.
"""
from disco_tpu_torch.promote.controller import (  # noqa: F401
    PromotionController,
    rollout_unit,
)
from disco_tpu_torch.promote.store import (  # noqa: F401
    Generation,
    GenerationStore,
    PublishRefused,
)
