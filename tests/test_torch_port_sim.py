"""The port's room simulation (``disco_tpu_torch.sim``: ``defaults``,
``geometry``, ``ism``) against the JAX package's on the same numpy inputs.

Tolerances:
- the image lattice, the RIR buckets and the four scenarios' geometry
  samplers: exactly equal (host numpy, the same draws in the same order);
- ``shoebox_rir``/``shoebox_rirs``/``shoebox_rirs_batched``: 1e-6 relative
  L2 a RIR (measured ~5e-8: the port takes XLA's fused norm and correctly
  rounded square roots, ``sim/ism.py::_norm3``; a last-bit change of a
  distance alone costs ~1e-5);
- the order-20 golden fixture (float64 oracle): < 5e-4 relative L2, the JAX
  package's own budget (tests/test_sim.py);
- the chunked RIR engine: bit-identical to the unchunked one, and a RIR
  computed in a batch bit-identical to the same RIR computed alone;
- ``fft_convolve``: 1e-6 of the output scale.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from disco_tpu import sim as jsim
from disco_tpu_torch import sim as tsim
from disco_tpu_torch.sim import ism as tism
from tests.torch_port_helpers import max_rel

GOLDEN = Path(__file__).parent / "data" / "golden_rir_order20.npz"
SCENARIOS = ["random", "living", "meeting", "meetit"]


def rel_per_rir(a, b) -> float:
    """The largest relative L2 error over the RIRs of ``a`` against ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def small_rooms(rng, n_rooms, n_src=2, n_mics=3):
    """(dims (B, 3), sources (B, S, 3), mics (B, M, 3), alphas (B,)) float32
    rooms with their sources and mics inside."""
    dims = rng.uniform([3.5, 3.0, 2.5], [6.0, 4.5, 3.0], (n_rooms, 3))
    srcs = dims[:, None] * rng.uniform(0.2, 0.8, (n_rooms, n_src, 3))
    mics = dims[:, None] * rng.uniform(0.2, 0.8, (n_rooms, n_mics, 3))
    alphas = rng.uniform(0.2, 0.6, n_rooms)
    return tuple(a.astype(np.float32) for a in (dims, srcs, mics, alphas))


# ------------------------------------------------------------ lattice, buckets
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4, 20])
def test_image_lattice_is_the_jax_packages(order):
    for a, b in zip(tism.image_lattice(order), jsim.image_lattice(order)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("order", [2, 4, 20])
@pytest.mark.parametrize("quantum", [256, 2048])
def test_rir_bucket_is_the_jax_packages(order, quantum):
    rng = np.random.default_rng(order * quantum)
    for _ in range(5):
        beta = float(rng.uniform(0.2, 0.8))
        dim = rng.uniform([3, 3, 2.5], [8, 5, 3])
        for room in (None, dim, dim.astype(np.float32)):
            want = jsim.rir_bucket(beta, room, max_order=order, quantum=quantum)
            assert tsim.rir_bucket(beta, room, max_order=order, quantum=quantum) == want
        assert tsim.rir_length_for(beta) == jsim.rir_length_for(beta)


# ----------------------------------------------------------------------- ISM
@pytest.mark.parametrize("order", [0, 2, 4])
def test_shoebox_rir_matches_jax(order):
    rng = np.random.default_rng(order)
    dims, srcs, mics, alphas = small_rooms(rng, 1)
    kw = dict(max_order=order, rir_len=2048)
    got = tsim.shoebox_rir(dims[0], srcs[0, 0], mics[0], float(alphas[0]), **kw, device="cpu")
    want = np.asarray(jsim.shoebox_rir(dims[0], srcs[0, 0], mics[0], float(alphas[0]), **kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 2048)
    assert rel_per_rir(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("order", [2, 4])
def test_shoebox_rirs_and_batched_match_jax(order):
    rng = np.random.default_rng(10 + order)
    dims, srcs, mics, alphas = small_rooms(rng, 3)
    kw = dict(max_order=order, rir_len=2048)
    got = tsim.shoebox_rirs_batched(dims, srcs, mics, alphas, **kw, device="cpu").numpy()
    want = np.asarray(jsim.shoebox_rirs_batched(dims, srcs, mics, alphas, **kw))
    assert got.shape == want.shape == (3, 2, 3, 2048)
    assert rel_per_rir(got, want) <= 1e-6
    one = tsim.shoebox_rirs(dims[1], srcs[1], mics[1], float(alphas[1]), **kw, device="cpu")
    assert rel_per_rir(one.numpy(), np.asarray(jsim.shoebox_rirs(
        dims[1], srcs[1], mics[1], float(alphas[1]), **kw))) <= 1e-6


def test_golden_fixture_order20():
    """The float64 oracle's order-20 RIRs (tests/data/gen_golden_rir.py):
    the port within the JAX package's 5e-4, and within 1e-6 of the JAX
    package's float32 RIRs."""
    g = np.load(GOLDEN)
    args = (g["room_dim"].astype(np.float32), g["sources"].astype(np.float32),
            g["mics"].astype(np.float32), float(g["alpha"]))
    kw = dict(max_order=int(g["max_order"]), rir_len=int(g["rir_len"]))
    got = tsim.shoebox_rirs(*args, **kw, device="cpu").numpy()
    assert got.shape == g["rirs"].shape == (2, 4, int(g["rir_len"]))
    assert rel_per_rir(got, g["rirs"]) < 5e-4
    assert rel_per_rir(got, np.asarray(jsim.shoebox_rirs(*args, **kw))) <= 1e-6


@pytest.mark.parametrize("order,rir_len", [(3, 2048), (20, 12288)])
def test_chunked_rirs_are_bit_identical(order, rir_len):
    """The rows' chunking (one row a chunk, three, all) changes no bit, and a
    row computed in a batch is the row computed alone."""
    rng = np.random.default_rng(7)
    dims, srcs, mics, alphas = small_rooms(rng, 2, n_src=2, n_mics=2)
    rows = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.repeat(dims, 4, 0), srcs.repeat(2, 1).reshape(-1, 3), np.tile(mics, (1, 2, 1)).reshape(-1, 3),
        np.repeat(alphas, 4))]
    n = len(tism.image_lattice(order)[0]) * tism.FDL
    whole = tism._rir_rows(*rows, order, rir_len, 16000, budget=1 << 40)
    assert whole.shape == (8, rir_len) and whole.abs().max() > 0
    for budget in (1, 3 * n):
        assert torch.equal(tism._rir_rows(*rows, order, rir_len, 16000, budget=budget), whole)
    alone = tism._rir_rows(*(r[5:6] for r in rows), order, rir_len, 16000)
    assert torch.equal(alone[0], whole[5])


def test_fft_convolve_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, 1000)).astype(np.float32)
    h = rng.standard_normal((2, 3, 200)).astype(np.float32)
    for out_len in (1000, 1199):
        got = tsim.fft_convolve(x, h, out_len=out_len, device="cpu")
        want = np.asarray(jsim.fft_convolve(x, h, out_len=out_len))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 3, out_len)
        assert max_rel(got, want) <= 1e-6
    # a tensor argument sets the device; numpy arguments go with it
    got = tsim.fft_convolve(torch.from_numpy(x), h, out_len=1000)
    assert got.device.type == "cpu"


def test_numpy_calls_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    dims, srcs, mics, alphas = small_rooms(np.random.default_rng(0), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.shoebox_rirs(dims[0], srcs[0], mics[0], float(alphas[0]), max_order=1, rir_len=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.fft_convolve(srcs, mics, out_len=3)


# ------------------------------------------------------------------ geometry
def _setup_fields(cfg):
    return (cfg.length, cfg.width, cfg.height, cfg.alpha, cfg.beta, cfg.nodes_centers,
            cfg.source_positions, cfg.mic_positions)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [5, 11])
def test_geometry_samplers_draw_as_the_jax_packages(scenario, seed):
    """Three configurations from equal-seeded samplers: every field equal,
    bit for bit, and the generators left in the same state."""
    overrides = {"n_sensors_per_node": (2, 3, 2)} if seed == 11 else {}
    tj = jsim.make_setup(scenario, rng=np.random.default_rng(seed), **overrides)
    tt = tsim.make_setup(scenario, rng=np.random.default_rng(seed), **overrides)
    assert type(tt).__name__ == type(tj).__name__
    for _ in range(3):
        a, b = tt.create_room_setup(), tj.create_room_setup()
        for x, y in zip(_setup_fields(a), _setup_fields(b)):
            assert np.array_equal(x, y)
        assert np.array_equal(a.room_dim, b.room_dim)
    assert tt.rng.bit_generator.state == tj.rng.bit_generator.state


def test_geometry_helpers_and_errors():
    args = ([1.0, 2.0], 5, 0.3, 0.05)
    assert np.array_equal(tsim.circular_array_2d(*args), jsim.circular_array_2d(*args))
    assert tsim.eyring_absorption(0.5, 6.0, 4.0, 3.0) == jsim.eyring_absorption(0.5, 6.0, 4.0, 3.0)
    import dataclasses

    assert dataclasses.asdict(tsim.RoomDefaults()) == dataclasses.asdict(jsim.RoomDefaults())
    assert dataclasses.asdict(tsim.SignalDefaults()) == dataclasses.asdict(jsim.SignalDefaults())
    with pytest.raises(ValueError, match="unknown scenario"):
        tsim.make_setup("garden")
    sampler = tsim.make_setup("random", rng=np.random.default_rng(9), d_nn=50.0,
                              n_sensors_per_node=(2, 2))
    with pytest.raises(RuntimeError, match="no valid room configuration"):
        sampler.create_room_setup(max_config_trials=5)
    cfg = tsim.make_setup("random", rng=np.random.default_rng(3)).create_room_setup()
    with pytest.raises(NotImplementedError, match="tools slice"):
        cfg.plot()
