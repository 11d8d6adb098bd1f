"""The port's files and runs layer (``disco_tpu_torch.io``, ``runs``,
``fault``) against the JAX package's: WAVs written by either package read
back bit-equal in the other, the dataset layout gives equal paths, a run
ledger written by either is replayed by the other, the miniature corpus is
byte-identical, and a fault spec expands to the same plan."""
import itertools
import json

import numpy as np
import pytest

from disco_tpu import fault as jfault
from disco_tpu.io import atomic as jatomic
from disco_tpu.io import audio as jaudio
from disco_tpu.io import fastwav as jfastwav
from disco_tpu.io import layout as jlayout
from disco_tpu.runs import check as jcheck
from disco_tpu.runs import ledger as jledger
from disco_tpu_torch import fault as tfault
from disco_tpu_torch.io import atomic as tatomic
from disco_tpu_torch.io import audio as taudio
from disco_tpu_torch.io import fastwav as tfastwav
from disco_tpu_torch.io import layout as tlayout
from disco_tpu_torch.runs import chaos as tchaos
from disco_tpu_torch.runs import check as tcheck
from disco_tpu_torch.runs import interrupt as tinterrupt
from disco_tpu_torch.runs import ledger as tledger


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("subtype", ["FLOAT", "DOUBLE", "PCM_16", "PCM_24", "PCM_32"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bytes_equal_and_cross_read(tmp_path, subtype, channels):
    rng = np.random.default_rng(channels)
    shape = (1001,) if channels == 1 else (1001, channels)
    x = np.clip(0.5 * rng.standard_normal(shape), -1, 1).astype(np.float32)
    ours, theirs = tmp_path / "port.wav", tmp_path / "jax.wav"
    taudio.write_wav(ours, x, 16000, subtype=subtype)
    jaudio.write_wav(theirs, x, 16000, subtype=subtype)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader, path in ((jaudio.read_wav, ours), (taudio.read_wav, theirs)):
        got, fs = reader(path)
        ref, fs_ref = (taudio.read_wav if reader is jaudio.read_wav else jaudio.read_wav)(path)
        assert fs == fs_ref == 16000
        np.testing.assert_array_equal(got, ref)


def test_atomic_writers_equal_and_probes_agree(tmp_path):
    x = np.linspace(-0.5, 0.5, 777, dtype=np.float32)
    for mod, d in ((tatomic, tmp_path / "p"), (jatomic, tmp_path / "j")):
        mod.write_wav_atomic(d / "a.wav", x, 16000)
        mod.save_npy_atomic(d / "b", x)
        mod.dump_pickle_atomic(d / "c.p", {"k": x.astype(np.float64)})
        mod.savez_atomic(d / "d", x=x)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    for name in ("a.wav", "b.npy", "c.p", "d.npz"):
        p = tmp_path / "p" / name
        assert tatomic.probe_artifact(p) and jatomic.probe_artifact(p)
        assert tatomic.file_digest(p) == jatomic.file_digest(tmp_path / "j" / name)
        p.write_bytes(p.read_bytes()[: len(p.read_bytes()) // 2])  # truncate
        assert not tatomic.probe_artifact(p) and not jatomic.probe_artifact(p)
    (tmp_path / "p" / f"x.wav{tatomic.TMP_SUFFIX}.123").write_bytes(b"litter")
    assert len(tatomic.remove_tmp_litter(tmp_path / "p")) == 1


def test_mid_write_chaos_leaves_no_artifact(tmp_path):
    tchaos.configure("mid_write")
    try:
        with pytest.raises(tchaos.ChaosCrash):
            tatomic.save_npy_atomic(tmp_path / "z", np.zeros(3))
    finally:
        tchaos.disable()
    assert not (tmp_path / "z.npy").exists() and not list(tmp_path.iterdir())


def test_chaos_arms_from_the_shared_variable(monkeypatch):
    monkeypatch.setenv("DISCO_TPU_CHAOS", "between_clips:2")
    tchaos._reset_for_tests()
    try:
        tchaos.tick("between_clips")
        assert tchaos.active()
        with pytest.raises(tchaos.ChaosCrash) as e:
            tchaos.tick("between_clips")
        assert (e.value.seam, e.value.hit) == ("between_clips", 2)
    finally:
        tchaos.disable()
    assert not tchaos.active()


def test_graceful_interrupt_flag():
    assert not tinterrupt.stop_requested() and not tinterrupt.request_stop()
    with tinterrupt.GracefulInterrupt() as stop:
        assert not stop()
        assert tinterrupt.request_stop("test")
        assert stop() and tinterrupt.stop_requested()
    assert not tinterrupt.stop_requested()


_LAYOUT_CASES = list(itertools.product(["living", "meetit"], ["train", "test"], [(0, 6), (-5, 5)],
                                       [11001, 7], [None, "ssn"]))


@pytest.mark.parametrize("scenario,case,snr,rir,noise", _LAYOUT_CASES)
def test_dataset_layout_paths_equal(scenario, case, snr, rir, noise):
    a = tlayout.DatasetLayout("/data", scenario, case)
    b = jlayout.DatasetLayout("/data", scenario, case)
    for source in ("target", "noise", "mixture"):
        assert a.wav_processed(snr, source, rir, 3, noise=noise) == \
            b.wav_processed(snr, source, rir, 3, noise=noise)
        assert a.stft_processed(snr, source, rir, 2, noise, True) == \
            b.stft_processed(snr, source, rir, 2, noise, True)
    for kind in ("dry", "cnv"):
        assert a.wav_original(kind, "noise", rir, 2, 5, noise) == \
            b.wav_original(kind, "noise", rir, 2, 5, noise)
    assert a.dry_source("target", rir, 1, noise) == b.dry_source("target", rir, 1, noise)
    assert a.cnv_image("target", rir, 1, 4, noise) == b.cnv_image("target", rir, 1, 4, noise)
    tag = noise or "ssn"
    assert a.mask_processed(snr, rir, 2, tag) == b.mask_processed(snr, rir, 2, tag)
    for normed in (False, True):
        assert a.stft_z("oracle", snr, "zn_hat", rir, 3, tag, normed) == \
            b.stft_z("oracle", snr, "zn_hat", rir, 3, tag, normed)
    assert a.snr_log(snr, rir, tag) == b.snr_log(snr, rir, tag)
    assert a.infos(rir) == b.infos(rir)
    assert tlayout.snr_dirname(snr) == jlayout.snr_dirname(snr)
    assert tlayout.case_of_rir(rir) == jlayout.case_of_rir(rir)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ledger_replays_across_packages(tmp_path, writer):
    art = tmp_path / "a.npy"
    np.save(art, np.arange(5))
    other = tmp_path / "b.npy"
    np.save(other, np.arange(3))
    W, R = (tledger, jledger) if writer == "port" else (jledger, tledger)
    led = W.RunLedger(tmp_path / "ledger.jsonl")
    led.mark_in_flight(W.unit_rir(11001, "ssn"), bucket=32768)
    led.mark_done(W.unit_rir(11001, "ssn"), [art])
    led.mark_done(W.unit_rir(11002, "ssn"), [other])
    led.mark_failed(W.unit_rir(11003, "ssn"), error="boom")
    led.close()
    with open(tmp_path / "ledger.jsonl", "a") as fh:
        fh.write('{"torn": \n')  # a torn line
    other.write_bytes(b"corrupt")
    reader = R.RunLedger(tmp_path / "ledger.jsonl")
    state = reader.replay()
    assert {u: r["state"] for u, r in state.items()} == {
        "rir:11001:ssn": "done", "rir:11002:ssn": "done", "rir:11003:ssn": "failed"}
    assert state["rir:11001:ssn"]["artifacts"] == {str(art): tledger.digest_artifacts([art])[str(art)]}
    done, requeued = reader.verified_done()
    assert done == {"rir:11001:ssn"} and set(requeued) == {"rir:11002:ssn"}
    reader.close()
    last = json.loads((tmp_path / "ledger.jsonl").read_text().splitlines()[-1])
    assert (last["unit"], last["state"]) == ("rir:11002:ssn", "requeued")
    assert set(last) == {"t", "unit", "state", "artifacts", "attrs"}
    assert W.unit_rir(5, "x") == R.unit_rir(5, "x")


def test_mini_corpus_byte_identical_to_jax(tmp_path):
    tcheck._mini_corpus(tmp_path / "port")
    jcheck._mini_corpus(tmp_path / "jax")
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert len(ours) == 2 * (3 * 8 + 3) and ours == theirs


def test_read_wavs_batch_equals_jax(tmp_path):
    tcheck._mini_corpus(tmp_path, rirs=(11001,), n_nodes=2, mics_per_node=3, seconds=0.5)
    paths = sorted(str(p) for p in tmp_path.rglob("*_Ch-*.wav"))
    assert len(paths) == 18
    ours, fs = tfastwav.read_wavs_batch(paths, n_threads=4)
    theirs, fs_j = jfastwav.read_wavs_batch(paths)
    assert fs == fs_j == 16000 and ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    short = tmp_path / "short.wav"
    taudio.write_wav(short, np.zeros(10, np.float32), 16000)
    with pytest.raises(RuntimeError, match="ragged"):
        tfastwav.read_wavs_batch(paths[:2] + [str(short)])


_FAULT_SPECS = [
    {},
    {"seed": 3, "node_dropout": [1]},
    {"seed": 1, "nan_z": [0, 2], "dropout_prob": 0.3},
    {"seed": 7, "link_loss_prob": 0.4, "stale_prob": 0.2, "link_loss_nodes": [0, 1]},
    {"seed": 2, "nan_prob": 0.5, "link_loss_prob": 0.1},
]


@pytest.mark.parametrize("spec", _FAULT_SPECS)
@pytest.mark.parametrize("n_blocks", [1, 9])
def test_fault_plan_equals_jax(spec, n_blocks):
    ours = tfault.plan_faults(tfault.FaultSpec.from_dict(spec), 4, n_blocks)
    ref = jfault.plan_faults(jfault.FaultSpec.from_dict(spec), 4, n_blocks)
    np.testing.assert_array_equal(ours.avail, ref.avail)
    np.testing.assert_array_equal(ours.z_nan, ref.z_nan)
    np.testing.assert_array_equal(ours.avail_offline, ref.avail_offline)
    np.testing.assert_array_equal(ours.avail_streaming, ref.avail_streaming)
    assert ours.faults == ref.faults and ours.any_fault() == ref.any_fault()
    assert ours.spec.to_dict() == ref.spec.to_dict()


def test_fault_spec_loading_and_validation(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"seed": 4, "node_dropout": [2]}))
    assert tfault.load_fault_spec(path) == tfault.FaultSpec(seed=4, node_dropout=(2,))
    for bad in ({"node_dropout": True}, {"dropout_prob": 2.0}, {"unknown": 1}):
        with pytest.raises(ValueError):
            tfault.load_fault_spec(bad)
    with pytest.raises(ValueError, match="nodes"):
        tfault.plan_faults({"node_dropout": [5]}, 4)
