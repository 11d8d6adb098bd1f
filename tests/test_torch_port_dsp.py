"""The port's STFT/ISTFT and masks (``disco_tpu_torch.core.dsp``,
``ops.stft_ops``, ``core.masks``) against the JAX package.

Tolerances: the STFT is a float32 product over 512 samples in both
frameworks, summed in different orders, so the two agree to ~1e-7 rel-l2;
the bound is 1e-5 rel-l2, against the interpret-mode Pallas kernel and
against the float64 numpy oracle alike.  The ISTFT is two float32 products
plus the overlap-add: 1e-5 of the output scale.
"""
import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu.core import masks as jmasks
from disco_tpu.ops import stft_ops as jstft
from disco_tpu_torch.core import dsp as tdsp
from disco_tpu_torch.core import masks as tmasks
from disco_tpu_torch.ops import stft_ops as tstft
from tests.reference_impls import stft_np
from tests.torch_port_helpers import complex_normal, max_rel, rel_l2, to_np

TOL = 1e-5


def test_tables_match_jax():
    np.testing.assert_allclose(to_np(tdsp.hann_periodic(512)), np.asarray(jdsp.hann_periodic(512)),
                               rtol=0, atol=1e-7)
    for ours, theirs in zip(tstft.dft_matrices(512) + tstft.idft_matrices(512),
                            jstft.dft_matrices(512) + jstft.idft_matrices(512)):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    for L in (257, 512, 12345, 160000):
        assert tdsp.n_stft_frames(L) == jdsp.n_stft_frames(L)


@pytest.mark.parametrize("L", [12000, 12345])
def test_stft_with_mag_matches_pallas_interpret_and_oracle(rng, L):
    x = rng.standard_normal((2, 3, L)).astype(np.float32)
    spec, mag = tstft.stft_with_mag(torch.from_numpy(x))
    assert spec.dtype == torch.complex64 and mag.dtype == torch.float32
    j_spec, j_mag = jstft.stft_pallas(x, interpret=True, with_mag=True)
    assert spec.shape == j_spec.shape == (2, 3, 257, jdsp.n_stft_frames(L))
    assert rel_l2(spec, j_spec) <= TOL, rel_l2(spec, j_spec)
    assert rel_l2(mag, j_mag) <= TOL, rel_l2(mag, j_mag)
    oracle = np.stack([[stft_np(row) for row in node] for node in x])
    assert rel_l2(spec, oracle) <= TOL, rel_l2(spec, oracle)
    assert rel_l2(mag, np.abs(oracle)) <= TOL


def test_stft_entry_points_match_jax(rng):
    x = rng.standard_normal((3, 9000)).astype(np.float32)
    xt = torch.from_numpy(x)
    ref = jdsp.stft(x)
    for impl in ("auto", "xla", "pallas"):
        assert rel_l2(tstft.stft_fused(xt, impl=impl), ref) <= TOL
    assert rel_l2(tdsp.stft(xt), ref) <= TOL
    # on a CPU tensor the kernel wrapper is its plain version, and counts nothing
    before = tstft.stft_kernel.launches
    np.testing.assert_array_equal(to_np(tstft.stft_kernel(xt)), to_np(tstft.stft_matmul(xt)))
    assert tstft.stft_kernel.launches == before


@pytest.mark.parametrize("impl", ["irfft", "matmul"])
@pytest.mark.parametrize("length", [9000, 8000])
def test_istft_matches_jax(rng, impl, length):
    """Same (not STFT-consistent) spectra through both inverses, with
    ``length`` equal to and shorter than the signal (the trim)."""
    x = rng.standard_normal((2, 2, 9000)).astype(np.float32)
    spec = np.asarray(jdsp.stft(x))
    spec = (spec + 0.01 * complex_normal(rng, spec.shape)).astype(np.complex64)
    ref = np.asarray(jdsp.istft(spec, length=length, impl=impl))
    ours = tdsp.istft(torch.from_numpy(spec), length=length)
    assert ours.shape == ref.shape == (2, 2, length) and ours.dtype == torch.float32
    assert max_rel(ours, ref) <= TOL, max_rel(ours, ref)


@pytest.mark.parametrize("impl", ["irfft", "matmul"])
def test_istft_zero_pads_past_the_overlap_add(rng, impl):
    """``length`` longer than the overlap-add output is zero-padded.  The
    signal ends in silence, so the last frames hold exact zeros and the
    near-zero squared-window sum at the very end divides nothing."""
    x = rng.standard_normal((2, 9000)).astype(np.float32)
    x[:, -700:] = 0.0
    spec = np.array(jdsp.stft(x))
    ref = np.asarray(jdsp.istft(spec, length=9600, impl=impl))
    ours = tdsp.istft(torch.from_numpy(spec), length=9600)
    assert ours.shape == ref.shape == (2, 9600)
    assert max_rel(ours, ref) <= TOL, max_rel(ours, ref)
    assert not to_np(ours)[:, 9472 - 256:].any()


def test_stft_istft_roundtrip(rng):
    x = rng.standard_normal((2, 7000)).astype(np.float32)
    back = tdsp.istft(tdsp.stft(torch.from_numpy(x)), length=7000)
    assert max_rel(back, x) <= TOL


def test_stft_seams_validate():
    x = torch.zeros(2, 4000)
    with pytest.raises(NotImplementedError, match="bf16"):
        tstft.stft_with_mag(x, precision="bf16")
    with pytest.raises(ValueError, match="unknown impl"):
        tstft.stft_with_mag(x, impl="mosaic")
    with pytest.raises(ValueError, match="more than 256 samples"):
        tstft.stft_matmul(torch.zeros(2, 200))
    with pytest.raises(ValueError, match="unsupported device"):
        tstft.stft_with_mag(torch.zeros(2, 4000, device="meta"))


@pytest.mark.parametrize("mask_type", ["irm1", "irm2", "ibm1", "iam1"])
def test_tf_mask_matches_jax(rng, mask_type):
    s = complex_normal(rng, (3, 257, 40))
    n = complex_normal(rng, (3, 257, 40))
    n[0, 0, :4] = 0  # the eps floor of an all-silent noise bin
    ref = np.asarray(jmasks.tf_mask(s, n, mask_type))
    ours = tmasks.tf_mask(torch.from_numpy(s), torch.from_numpy(n), mask_type)
    np.testing.assert_allclose(to_np(ours), ref, rtol=1e-6, atol=1e-7)
    if mask_type != "iam1":
        ref_m = np.asarray(jmasks.tf_mask_mag(np.abs(s), np.abs(n), mask_type))
        ours_m = tmasks.tf_mask_mag(torch.from_numpy(np.abs(s)), torch.from_numpy(np.abs(n)),
                                    mask_type)
        np.testing.assert_allclose(to_np(ours_m), ref_m, rtol=1e-6, atol=1e-7)
    else:
        with pytest.raises(ValueError, match="irmX"):
            tmasks.tf_mask_mag(torch.ones(2), torch.ones(2), mask_type)


def test_tf_mask_rejects_unknown_family():
    with pytest.raises(ValueError, match="Unknown mask type"):
        tmasks.tf_mask(torch.ones(2, dtype=torch.complex64), torch.ones(2, dtype=torch.complex64),
                       "xyz1")
