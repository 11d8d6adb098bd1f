"""Room and scene simulation (counterpart of ``disco_tpu/sim``): the scenario
constants, the geometry samplers and signal setups (host numpy, draw for draw
as the JAX package), and the image-source RIRs and FFT convolution (torch, on
the device of the call)."""
from disco_tpu_torch.sim.defaults import RoomDefaults, SignalDefaults, make_setup
from disco_tpu_torch.sim.geometry import (
    LivingRoomSetup,
    MeetingRoomSetup,
    MeetitSetup,
    RandomRoomSetup,
    RoomSetup,
    circular_array_2d,
    eyring_absorption,
)
from disco_tpu_torch.sim.ism import (
    fft_convolve,
    image_lattice,
    rir_bucket,
    rir_length_for,
    shoebox_rir,
    shoebox_rirs,
    shoebox_rirs_batched,
)
from disco_tpu_torch.sim.signals import (
    InterferentSpeakersSetup,
    SpeechAndNoiseSetup,
    normalize_to_var,
)

__all__ = [
    "RoomDefaults",
    "SignalDefaults",
    "make_setup",
    "RandomRoomSetup",
    "MeetingRoomSetup",
    "LivingRoomSetup",
    "MeetitSetup",
    "RoomSetup",
    "circular_array_2d",
    "eyring_absorption",
    "shoebox_rir",
    "shoebox_rirs",
    "shoebox_rirs_batched",
    "fft_convolve",
    "rir_bucket",
    "rir_length_for",
    "image_lattice",
    "SpeechAndNoiseSetup",
    "InterferentSpeakersSetup",
    "normalize_to_var",
]
