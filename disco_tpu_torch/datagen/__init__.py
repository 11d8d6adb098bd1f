"""Training-data generation (counterpart of ``disco_tpu/datagen``, less its
corpus downloads): the DISCO generator (rooms, RIRs, convolved images, SNR
gating, ledger resume), the MEETIT generator, and the mixing pass
:class:`~disco_tpu_torch.datagen.postgen.PostGenerator`."""
from disco_tpu_torch.datagen.disco import (
    generate_disco_rirs,
    generate_disco_rirs_batched,
    reverb_other_noises,
    simulate_scene,
    snr_at_mics,
)
from disco_tpu_torch.datagen.meetit import (
    check_sir_validity,
    get_masks,
    get_value_range,
    simulate_meetit_room,
    sir_at_node,
)
from disco_tpu_torch.datagen.postgen import PostGenerator

__all__ = [
    "simulate_meetit_room",
    "sir_at_node",
    "check_sir_validity",
    "get_value_range",
    "get_masks",
    "simulate_scene",
    "snr_at_mics",
    "reverb_other_noises",
    "generate_disco_rirs",
    "generate_disco_rirs_batched",
    "PostGenerator",
]
