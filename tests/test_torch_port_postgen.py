"""The port's mixing pass (``disco_tpu_torch.datagen.postgen.
PostGenerator``) against the JAX package's on a tiny convolved-WAV tree
(4 nodes x 4 mics, 0.6-s clips, 2 RIRs, one SNR draw each from the same
seeded generator): the same files in the same places, the WAVs and the SNR
logs byte-identical, the STFTs within 1e-5 of their scale.  The masks are
held within 1e-6 of the JAX package's ``tf_mask`` of the port's own
spectra.  Against the JAX package's files, which come from its own STFT,
each bin is held within twice the error that the two STFTs' difference
carries into |s|/(|s|+|n|), plus 1e-6: at the quietest bins 1e-7 of the
scale is ~1e-5 of the bin, and the masks differ there by up to ~1e-5."""
import shutil

import numpy as np
import pytest

from disco_tpu.core.masks import tf_mask
from disco_tpu.datagen.postgen import PostGenerator as JPostGenerator
from disco_tpu.io import write_wav
from disco_tpu_torch.datagen.postgen import PostGenerator as TPostGenerator

FS = 16000
L = int(0.6 * FS)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(JAX output root, port output root) after one mixing pass each over
    copies of one convolved-WAV tree."""
    root = tmp_path_factory.mktemp("postgen")
    src = root / "src"
    rng = np.random.default_rng(0)
    base = src / "random" / "train" / "wav_original" / "cnv"
    (base / "target").mkdir(parents=True)
    (base / "noise").mkdir(parents=True)
    for rir in (1, 2):
        dry = 0.2 * rng.standard_normal(L)
        for ch in range(1, 17):
            write_wav(base / "target" / f"{rir}_S-1_Ch-{ch}.wav",
                      np.convolve(dry, 0.5 * rng.standard_normal(8), mode="same"), FS)
            write_wav(base / "noise" / f"{rir}_S-2_ssn_Ch-{ch}.wav",
                      0.1 * rng.standard_normal(L), FS)
    out = {}
    for name, cls, kw in (("jax", JPostGenerator, {}), ("port", TPostGenerator, {"device": "cpu"})):
        shutil.copytree(src, root / name)
        pg = cls(1, 2, "random", "ssn", [0, 6], str(root / name),
                 rng=np.random.default_rng(7), **kw)
        assert pg.post_process() == [1, 2]
        assert pg.post_process() == []  # idempotent on the SNR log
        out[name] = root / name
    return out


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_same_files_in_the_same_places(trees):
    assert _files(trees["port"]) == _files(trees["jax"])
    assert not any(".tmp" in f for f in _files(trees["port"]))


def test_wavs_and_snr_logs_are_byte_identical(trees):
    names = [f for f in _files(trees["jax"]) if f.endswith(".wav") or "/snrs/" in f]
    assert len(names) == 2 * (16 * 2 + 16 * 3) + 2
    for f in names:
        assert (trees["port"] / f).read_bytes() == (trees["jax"] / f).read_bytes(), f


def test_stfts_and_masks_match(trees):
    checked = {"stft": 0, "mask": 0}
    for f in _files(trees["jax"]):
        if not f.endswith(".npy") or "/snrs/" in f:
            continue
        ours, ref = np.load(trees["port"] / f), np.load(trees["jax"] / f)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, f
        if "mask_processed" in f:
            rir, ch = f.split("/")[-1].split("_ssn_Ch-")
            s, n = ({k: np.load(trees[k] / "random" / "train" / "stft_processed" / "raw" / "0-6"
                                / kind / name) for k in trees}
                    for kind, name in (("target", f"{rir}_Ch-{ch}"),
                                       ("noise", f"{rir}_ssn_Ch-{ch}")))
            np.testing.assert_allclose(ours, np.asarray(tf_mask(s["port"], n["port"], "irm1")),
                                       rtol=0, atol=1e-6, err_msg=f)
            # m = xi / (1 + xi), xi = |s| / |n|: dm = m (1 - m) (d|s|/|s| - d|n|/|n|)
            rel = sum(np.abs(np.abs(a["port"]) - np.abs(a["jax"])) / np.abs(a["jax"])
                      for a in (s, n))
            assert np.all(np.abs(ours - ref) <= 2 * ref * (1 - ref) * rel + 1e-6), f
            checked["mask"] += 1
        else:
            err = np.abs(ours - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (f, err)
            checked["stft"] += 1
    assert checked == {"stft": 2 * 16 * 4, "mask": 2 * 16}


def test_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPostGenerator(1, 1, "random", "ssn", [0, 6], str(tmp_path))
