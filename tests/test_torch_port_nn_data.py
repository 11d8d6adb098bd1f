"""The port's training data pipeline (``disco_tpu_torch.nn.data``,
``disco_tpu_torch.nn.fastload``) against the JAX package's: the same lists,
datasets and batch iterator drawing from the same seeded generators give
byte-identical lists and batches, and ``load_abs_batch`` equals the JAX
package's NumPy path, errors included."""
import numpy as np
import pytest

from disco_tpu.io.layout import DatasetLayout
from disco_tpu.nn import data as jdata
from disco_tpu.nn import fastload as jfastload
from disco_tpu_torch.nn import data as tdata
from disco_tpu_torch.nn import fastload as tfastload

N_FREQ = 257
SNR = [0, 6]
RIRS = (1, 2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Full-length train STFTs (11 s, 684 centered frames) of 2 RIRs in the
    generated-file layout, with two z signals (the JAX data tests'
    corpus)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lay = DatasetLayout(str(root), "random", "train")
    n_frames = (jdata.TRAIN_DUR * jdata.FS - 512) // 256 + 3
    for rir in RIRS:
        for node in range(4):
            ch = 1 + 4 * node
            stft = (rng.random((N_FREQ, n_frames)) + 0.1).astype("complex64")
            np.save(lay.ensure_dir(lay.stft_processed(SNR, "mixture", rir, ch, noise="ssn",
                                                      normed=True)), stft)
            np.save(lay.ensure_dir(lay.mask_processed(SNR, rir, ch, "ssn")),
                    rng.random((N_FREQ, n_frames)).astype("float32"))
            for zsig in ("zs_hat", "zn_hat"):
                z = (rng.random((N_FREQ, n_frames)) + 0.1).astype("complex64")
                np.save(lay.ensure_dir(lay.stft_z("oracle", SNR, zsig, rir, node + 1, "ssn",
                                                  normed=True)), z)
    return str(root)


@pytest.mark.parametrize("kw", [
    {"scenes": "random", "z_sigs": ["zs_hat"]},
    {"scenes": ["random", "living", "meeting"], "noise_to_get": "all",
     "z_sigs": ["zs_hat", "zn_hat"], "snr_range": [-5, 5], "ref_channel": 2},
    {"z_sigs": None, "noise_to_get": "noit", "z_file": "crnn"},
])
def test_input_lists_match_jax(corpus, kw):
    rirs = list(range(1, 9))
    ours = tdata.get_input_lists(corpus, rirs, rng=np.random.default_rng(5), **kw)
    ref = jdata.get_input_lists(corpus, rirs, rng=np.random.default_rng(5), **kw)
    assert ours == ref


def test_written_lists_cross_between_packages(corpus, tmp_path):
    lists = tdata.get_input_lists(corpus, list(RIRS), z_sigs=["zs_hat"],
                                  rng=np.random.default_rng(1))
    tdata.write_input_lists(lists, tmp_path / "t")
    jdata.write_input_lists(lists, tmp_path / "j")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
    assert tdata.load_input_lists(tmp_path / "j") == jdata.load_input_lists(tmp_path / "t") == lists


def _lists(corpus, z_sigs):
    return tdata.get_input_lists(corpus, list(RIRS), scenes="random", z_sigs=z_sigs,
                                 rng=np.random.default_rng(2))


@pytest.mark.parametrize("cls,stack_axis,z_sigs,z_nodes", [
    ("DiscoDataset", 2, ["zs_hat"], None),
    ("DiscoDataset", 1, ["zs_hat", "zn_hat"], None),
    ("DiscoDataset", 0, [], None),
    ("DiscoDataset", 2, ["zs_hat"], 1),
    ("DiscoPartialDataset", 2, ["zs_hat"], None),
])
def test_datasets_and_batches_are_byte_identical(corpus, cls, stack_axis, z_sigs, z_nodes):
    lists = _lists(corpus, z_sigs)
    kw = dict(stack_axis=stack_axis, z_nodes=z_nodes, win_len=21, win_hop=8)
    ours = getattr(tdata, cls)(lists, rng=np.random.default_rng(11), **kw)
    ref = getattr(jdata, cls)(lists, rng=np.random.default_rng(11), **kw)
    assert len(ours) == len(ref) > 0
    assert ours.data.tobytes() == ref.data.tobytes()
    np.testing.assert_array_equal(ours.win_per_seg, ref.win_per_seg)
    batches = [list(mod.batch_iterator(ds, 64, rng=np.random.default_rng(4), drop_last=True))
               for mod, ds in ((tdata, ours), (jdata, ref))]
    assert len(batches[0]) == len(batches[1]) == len(ours) // 64
    for (xa, ya), (xb, yb) in zip(*batches):
        assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()
        assert ya.dtype == yb.dtype and ya.tobytes() == yb.tobytes()
    tail = [list(mod.batch_iterator(ds, 100, shuffle=False))[-1]
            for mod, ds in ((tdata, ours), (jdata, ref))]
    assert tail[0][0].tobytes() == tail[1][0].tobytes() and len(tail[0][0]) == len(ours) % 100


def test_random_dataset_matches_jax():
    ours = tdata.RandomDataset((2, 21, 33), (21, 33), length=5, rng=np.random.default_rng(3))
    ref = jdata.RandomDataset((2, 21, 33), (21, 33), length=5, rng=np.random.default_rng(3))
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            assert a.tobytes() == b.tobytes()


@pytest.fixture
def numpy_fastload(monkeypatch):
    """The JAX package's NumPy path of ``load_abs_batch`` (its native
    library disabled)."""
    monkeypatch.setattr(jfastload, "get_lib", lambda: None)


def _npy_files(tmp_path):
    rng = np.random.default_rng(9)
    files = []
    for i, (t, dt) in enumerate([(30, np.complex64), (12, np.float32), (45, np.complex64)]):
        a = rng.standard_normal((17, t)) + (1j * rng.standard_normal((17, t)) if dt == np.complex64
                                            else 0)
        p = tmp_path / f"f{i}.npy"
        np.save(p, a.astype(dt))
        files.append(p)
    return files


@pytest.mark.parametrize("max_frames,skip", [(40, 0), (20, 5), (50, 13)])
def test_load_abs_batch_matches_the_numpy_path(tmp_path, numpy_fastload, max_frames, skip):
    files = _npy_files(tmp_path)
    ours, f_ours = tfastload.load_abs_batch(files, 17, max_frames, skip_cols=skip, n_threads=3)
    ref, f_ref = jfastload.load_abs_batch(files, 17, max_frames, skip_cols=skip)
    assert ours.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(f_ours, f_ref)
    out = np.full((3, 17, max_frames), 7.0, np.float32)
    back, _ = tfastload.load_abs_batch(files, 17, max_frames, skip_cols=skip, out=out)
    assert back is out and out.tobytes() == ref.tobytes()


def test_load_abs_batch_errors_match_the_numpy_path(tmp_path, numpy_fastload):
    files = _npy_files(tmp_path)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((5, 10), np.float32))
    for paths, exc in (([files[0], bad, tmp_path / "missing.npy"], RuntimeError),
                       ([files[0], tmp_path / "missing.npy", bad], FileNotFoundError)):
        with pytest.raises(exc) as ref:
            jfastload.load_abs_batch(paths, 17, 40)
        with pytest.raises(exc) as ours:
            tfastload.load_abs_batch(paths, 17, 40)
        assert str(ours.value) == str(ref.value)
