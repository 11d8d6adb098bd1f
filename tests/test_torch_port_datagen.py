"""The port's corpus generators (``disco_tpu_torch.datagen.disco`` and
``.meetit``) against the JAX package's on a synthetic WAV corpus (two
LibriSpeech-shaped talkers of 4 s, one 6-s noise file; RIR order 2), and
the batched generator's crash-and-resume within the port.

Both packages draw the same rooms, signals and SNRs from equal-seeded
generators, so they must generate the same RIR ids with the same geometry.
Tolerances: the WAVs within 1e-5 of their scale, the RIRs within 1e-6
relative L2, ``snr_images`` within 1e-3 dB; MEETIT's mixture STFTs within
1e-5 of their scale, its masks within 1e-6 of the JAX package's
``tf_mask`` of the port's own spectra (and against the JAX package's masks
within the bound their magnitudes' difference carries, as
``tests/test_torch_port_postgen.py``), its SIRs within 1e-3 dB.  The SNR
gate of the batched runs is the reference's upper bound with a tighter
lower one (-3 to 15 dB, ΔSNR above 0.2 dB), so rooms are redrawn (the
per-scene driver runs ungated: its redraws redraw the signals too, and
cost); the tests require
every gated value the port computed to lie more than 1e-3 dB from its
threshold, where a float difference between the packages could flip the
decision.  The crashed and resumed batched corpus must be byte-identical to
the uninterrupted one, at each of its two chaos seams.
"""
import numpy as np
import pytest

import disco_tpu.obs as jobs
import disco_tpu_torch.obs as tobs
from disco_tpu.core.dsp import stft as jstft
from disco_tpu.core.masks import tf_mask as jtf_mask
from disco_tpu.datagen import disco as jdisco
from disco_tpu.datagen import meetit as jmeetit
from disco_tpu.io import DatasetLayout as JLayout
from disco_tpu.io import write_wav
from disco_tpu.sim import InterferentSpeakersSetup as JInterferent
from disco_tpu.sim import SpeechAndNoiseSetup as JSpeechNoise
from disco_tpu_torch.core.dsp import stft as tstft
from disco_tpu_torch.datagen import disco as tdisco
from disco_tpu_torch.datagen import meetit as tmeetit
from disco_tpu_torch.io import DatasetLayout as TLayout
from disco_tpu_torch.io.audio import read_wav
from disco_tpu_torch.runs import RunLedger, chaos
from disco_tpu_torch.sim import InterferentSpeakersSetup as TInterferent
from disco_tpu_torch.sim import SpeechAndNoiseSetup as TSpeechNoise
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread: a fixture)
    artifact_paths, assert_events_match, max_rel, one_host_thread, recorded)

pytestmark = pytest.mark.usefixtures("one_host_thread")

FS = 16000
ORDER = 2
GATE, MIN_DELTA = (-3.0, 15.0), 0.2
BATCHED = dict(max_order=ORDER, batch=2, seed=17)
N_BATCHED, N_SCENES = 3, 2
PACKAGES = {"jax": (jdisco, JLayout, JSpeechNoise), "port": (tdisco, TLayout, TSpeechNoise)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("datagen_corpus")
    rng = np.random.default_rng(0)
    speech = []
    for spk in ("7", "8"):
        f = root / "LibriSpeech" / spk / "1" / f"{spk}-1-0001.wav"
        f.parent.mkdir(parents=True)
        t = np.arange(4 * FS) / FS
        env = (np.sin(2 * np.pi * 1.1 * t + float(spk)) > -0.2).astype(np.float64)
        write_wav(f, 0.3 * env * rng.standard_normal(len(t)), FS)
        speech.append(str(f))
    nf = root / "noises" / "n0.wav"
    nf.parent.mkdir()
    write_wav(nf, 0.2 * rng.standard_normal(6 * FS), FS)
    return root, speech, [str(nf)]


def signal_setup(cls, corpus, gated=True):
    """1-2 s talkers after 1 s of silence; the SNR gate of the module
    docstring, or (``gated=False``) one no room fails."""
    _, speech, noise = corpus
    gate, min_delta = (GATE, MIN_DELTA) if gated else ((-60, 60), -1)
    return cls(target_list=speech, talkers_list=speech, noises_dict={"fs": noise},
               duration_range=(1, 2), var_tar=10 ** (-23 / 10), snr_dry_range=[[0, 0]],
               snr_cnv_range=gate, min_delta_snr=min_delta, rng=np.random.default_rng(3))


def run_batched(pkg, corpus, root, **kw):
    mod, layout, setup = PACKAGES[pkg]
    return mod.generate_disco_rirs_batched(
        "random", "test", 1, N_BATCHED, signal_setup(setup, corpus),
        layout(str(root / "dataset"), "random", "test"), rng=np.random.default_rng(5),
        **BATCHED, **kw)


@pytest.fixture(scope="module")
def trees(corpus, tmp_path_factory):
    """{(package, driver): dataset root} after one run of each driver, and
    every (node SNRs, min ΔSNR) the port's gate saw."""
    seen = []
    gate = tdisco.snr_at_mics

    def recording(*args, **kw):
        out = gate(*args, **kw)
        seen.append(out[1:])
        return out

    tdisco.snr_at_mics = recording
    try:
        out = {}
        for pkg, (mod, layout, setup) in PACKAGES.items():
            kw = {"device": "cpu"} if pkg == "port" else {}
            root = tmp_path_factory.mktemp(f"batched_{pkg}")
            done, out[pkg, "events"] = recorded(
                tobs if pkg == "port" else jobs, root / "events.jsonl",
                lambda: run_batched(pkg, corpus, root, ledger=str(root / "ledger.jsonl"),
                                    resume=True, **kw))
            assert done == [1, 2, 3]
            out[pkg, "batched"] = root / "dataset"
            root = tmp_path_factory.mktemp(f"scenes_{pkg}")
            lay = layout(str(root / "dataset"), "random", "train")
            assert mod.generate_disco_rirs("random", "train", 1, N_SCENES,
                                           signal_setup(setup, corpus, gated=False), lay,
                                           rng=np.random.default_rng(5), max_order=ORDER,
                                           **kw) == [1, 2]
            out[pkg, "scenes"] = root / "dataset"
    finally:
        tdisco.snr_at_mics = gate
    return out, seen


def test_gate_decisions_lie_clear_of_their_thresholds(trees):
    _, seen = trees
    assert len(seen) >= N_BATCHED + N_SCENES + 1  # at least one room was redrawn
    for nodes, diff in seen:
        assert np.min(np.abs(np.asarray(nodes)[:, None] - np.asarray(GATE))) > 1e-3
        assert abs(diff - MIN_DELTA) > 1e-3


@pytest.mark.parametrize("driver", ["batched", "scenes"])
def test_generated_corpus_matches_jax(trees, driver):
    roots, _ = trees
    ours, theirs = roots["port", driver], roots["jax", driver]
    files = artifact_paths(theirs)
    assert artifact_paths(ours) == files
    n_wav = 0
    for rel in files:
        if rel.endswith(".wav"):
            a, b = read_wav(ours / rel)[0], read_wav(theirs / rel)[0]
            assert a.shape == b.shape and max_rel(a, b) <= 1e-5, rel
            n_wav += 1
            continue
        a = np.load(ours / rel, allow_pickle=True).item()
        b = np.load(theirs / rel, allow_pickle=True).item()
        assert a["room"] == b["room"] and a["noise_files"] == b["noise_files"]
        for k in ("mics", "sources", "nodes_centers", "noise_starts"):
            assert np.array_equal(a[k], b[k]), k
        rel_l2 = np.linalg.norm(a["rirs"] - b["rirs"], axis=-1) / np.linalg.norm(b["rirs"], axis=-1)
        assert a["rirs"].dtype == b["rirs"].dtype and rel_l2.max() <= 1e-6
        assert np.abs(a["snr_images"] - b["snr_images"]).max() <= 1e-3
    # per RIR: 2 dry + 1 extra dry noise, 16 channels x (target, ssn, fs)
    assert n_wav == (N_BATCHED if driver == "batched" else N_SCENES) * (3 + 3 * 16)


@pytest.mark.parametrize("seam,after", [("between_scenes", 2), ("between_scene_batches", 1)])
def test_batched_crash_and_resume_is_byte_identical(trees, corpus, tmp_path, seam, after):
    roots, _ = trees
    chaos.configure(seam, after=after)
    try:
        with pytest.raises(chaos.ChaosCrash):
            run_batched("port", corpus, tmp_path, ledger=str(tmp_path / "ledger.jsonl"),
                        resume=True, device="cpu")
    finally:
        chaos.disable()
    resumed = run_batched("port", corpus, tmp_path, ledger=str(tmp_path / "ledger.jsonl"),
                          resume=True, device="cpu")
    assert resumed == [3]
    ours, theirs = tmp_path / "dataset", roots["port", "batched"]
    assert artifact_paths(ours) == artifact_paths(theirs)
    for rel in artifact_paths(theirs):
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel
    done, _ = RunLedger(tmp_path / "ledger.jsonl").verified_done()
    assert done == {"scene:1", "scene:2", "scene:3"}


def test_per_scene_driver_resumes_from_its_ledger(corpus, tmp_path):
    lay = TLayout(str(tmp_path / "dataset"), "random", "test")
    kw = dict(rng=np.random.default_rng(5), max_order=ORDER, ledger=str(tmp_path / "l.jsonl"),
              resume=True, device="cpu")
    chaos.configure("between_scenes", after=1)
    try:
        with pytest.raises(chaos.ChaosCrash):
            tdisco.generate_disco_rirs("random", "test", 1, 2,
                                       signal_setup(TSpeechNoise, corpus, gated=False), lay, **kw)
    finally:
        chaos.disable()
    kw["rng"] = np.random.default_rng(6)
    for want in ([2], []):
        assert tdisco.generate_disco_rirs("random", "test", 1, 2,
                                          signal_setup(TSpeechNoise, corpus, gated=False), lay,
                                          **kw) == want


def test_datagen_events_match_jax(trees, corpus, tmp_path):
    """The batched generator's run_resume and per-chunk scene events, and a
    resume's temp-litter warning, the same in both packages."""
    (out, _seen) = trees
    ours, theirs = out["port", "events"], out["jax", "events"]
    assert [e["kind"] for e in ours] == ["run_resume", "scene", "scene"]
    assert_events_match(ours, theirs, ignore=("ledger",))
    logs = {}
    for pkg, obs in (("port", tobs), ("jax", jobs)):
        root = tmp_path / pkg
        litter = root / "dataset" / "random" / "test" / "x.wav.tmp.123"
        litter.parent.mkdir(parents=True)
        litter.write_bytes(b"torn")
        kw = {"device": "cpu"} if pkg == "port" else {}
        _, logs[pkg] = recorded(obs, root / "events.jsonl", lambda: PACKAGES[pkg][0]
                                .generate_disco_rirs_batched(
                                    "random", "test", 1, 0, signal_setup(PACKAGES[pkg][2], corpus),
                                    PACKAGES[pkg][1](str(root / "dataset"), "random", "test"),
                                    rng=np.random.default_rng(5), ledger=str(root / "l.jsonl"),
                                    resume=True, **BATCHED, **kw))
        assert not litter.exists()
    assert [e["kind"] for e in logs["port"]] == ["warning", "run_resume"]
    assert [len(e["attrs"].get("files", [1])) for e in logs["port"]] == [1, 1]
    assert_events_match(logs["port"], logs["jax"], ignore=("ledger", "files"))


def test_simulate_scene_matches_jax(corpus):
    """One scene from one room and one signal draw: the images, RIRs and
    per-mic SNRs close, the VADs of the target images exactly equal."""
    from disco_tpu_torch.sim import make_setup

    cfg = make_setup("random", rng=np.random.default_rng(2)).create_room_setup()
    got = tdisco.simulate_scene(cfg, signal_setup(TSpeechNoise, corpus, gated=False), 0, "test",
                                [4] * 4, max_order=ORDER, device="cpu")
    want = jdisco.simulate_scene(cfg, signal_setup(JSpeechNoise, corpus, gated=False), 0, "test",
                                 [4] * 4, max_order=ORDER)
    assert np.array_equal(got.sources, want.sources)
    assert np.array_equal(got.target_vad, want.target_vad)
    assert np.array_equal(got.image_vads, want.image_vads)
    assert got.images.shape == want.images.shape and max_rel(got.images, want.images) <= 1e-5
    assert max_rel(got.rirs, want.rirs) <= 1e-6
    assert np.abs(got.snr_images - want.snr_images).max() <= 1e-3


def test_host_helpers_match_jax(corpus, tmp_path):
    rng = np.random.default_rng(4)
    s, n = rng.standard_normal((8, 16000)), 0.1 * rng.standard_normal((8, 16000))
    for a, b in zip(tdisco.snr_at_mics(s, n, [4, 4]), jdisco.snr_at_mics(s, n, [4, 4])):
        assert np.array_equal(a, b)
    for name in ("ssn", "it", "fs", "interferent_talker", "Other"):
        assert tdisco.noise_tag(name) == jdisco.noise_tag(name)
    root = corpus[0] / "LibriSpeech"
    got = tdisco.get_wavs_list(root, dset="test", cache_dir=tmp_path / "port")
    assert got == jdisco.get_wavs_list(root, dset="test", cache_dir=tmp_path / "jax")
    assert (tmp_path / "port" / "targets_flat.txt").read_text() == \
        (tmp_path / "jax" / "targets_flat.txt").read_text()


def test_entry_points_default_to_the_card(corpus, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    lay = TLayout(str(tmp_path), "random", "test")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdisco.generate_disco_rirs_batched("random", "test", 1, 1,
                                           signal_setup(TSpeechNoise, corpus), lay)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdisco.generate_disco_rirs("random", "test", 1, 1, signal_setup(TSpeechNoise, corpus), lay)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmeetit.get_masks(np.zeros((2, 2, 1024), np.float32), [1, 1])


# ------------------------------------------------------------------- MEETIT
@pytest.fixture(scope="module")
def speakers(tmp_path_factory):
    root = tmp_path_factory.mktemp("meetit_speakers")
    rng = np.random.default_rng(0)
    files = []
    for spk in ("201", "202", "203", "204"):
        f = root / spk / "1" / f"{spk}-1-0001.wav"
        f.parent.mkdir(parents=True)
        t = np.arange(4 * FS) / FS
        env = (np.sin(2 * np.pi * (1.0 + 0.1 * int(spk[-1])) * t) > -0.3).astype(np.float64)
        write_wav(f, 0.3 * env * rng.standard_normal(len(t)), FS)
        files.append(str(f))
    return files


def interferent(cls, speakers):
    return cls(speakers_list=speakers, duration_range=(2, 3), var_tar=10 ** (-23 / 10),
               snr_dry_range=[[0, 0]], snr_cnv_range=(-60, 60), min_delta_snr=-1,
               rng=np.random.default_rng(3))


@pytest.fixture(scope="module")
def meetit_trees(speakers, tmp_path_factory):
    """{package: layout} after ``generate_meetit_rirs`` of RIR 7 (2 sources
    facing 2 nodes of 4 mics), and the SIRs the port's gate saw."""
    seen = []
    gate = tmeetit.check_sir_validity

    def recording(current_sirs, *args, **kw):
        seen.append(np.asarray(current_sirs))
        return gate(current_sirs, *args, **kw)

    tmeetit.check_sir_validity = recording
    try:
        out = {}
        for pkg, mod, layout, cls, kw in (("jax", jmeetit, JLayout, JInterferent, {}),
                                          ("port", tmeetit, TLayout, TInterferent,
                                           {"device": "cpu"})):
            lay = layout(str(tmp_path_factory.mktemp(f"meetit_{pkg}")), "meetit", "train")
            assert mod.generate_meetit_rirs(2, "train", 7, 1, interferent(cls, speakers), lay,
                                            rng=np.random.default_rng(1), max_order=ORDER,
                                            **kw) == [7]
            out[pkg] = lay
    finally:
        tmeetit.check_sir_validity = gate
    return out, seen


def test_meetit_sir_gate_lies_clear_of_its_thresholds(meetit_trees):
    _, seen = meetit_trees
    assert seen
    edges = np.linspace(2, 14, 5)
    for sirs in seen:
        spread = [sirs[i] - sirs[j] for i in range(len(sirs)) for j in range(len(sirs)) if i != j]
        assert np.min(np.abs(np.asarray(spread) - 2.0)) > 1e-3
        assert np.min(np.abs(sirs[0] - edges)) > 1e-3


def test_meetit_corpus_matches_jax(meetit_trees):
    trees, _ = meetit_trees
    ours, theirs = trees["port"].base, trees["jax"].base
    files = artifact_paths(theirs)
    assert artifact_paths(ours) == files
    for rel in files:
        if rel.endswith(".wav"):
            a, b = read_wav(ours / rel)[0], read_wav(theirs / rel)[0]
            assert max_rel(a, b) <= 1e-5, rel
        elif "/infos/" in rel:
            a = np.load(ours / rel, allow_pickle=True).item()
            b = np.load(theirs / rel, allow_pickle=True).item()
            assert a["room"] == b["room"] and np.array_equal(a["mics"], b["mics"])
            assert np.array_equal(a["sources"], b["sources"])
            assert np.abs(a["sirs"] - b["sirs"]).max() <= 1e-3
        elif "/stft/" in rel:
            a, b = np.load(ours / rel), np.load(theirs / rel)
            assert a.dtype == b.dtype == np.complex64 and max_rel(a, b) <= 1e-5, rel
    Y_t, m_t = tmeetit.load_meetit_sample(trees["port"], 7, [4, 4])
    Y_j, m_j = jmeetit.load_meetit_sample(trees["jax"], 7, [4, 4])
    assert Y_t.shape == Y_j.shape == (2, 4, 257, Y_j.shape[-1]) and m_t.shape == m_j.shape
    assert max_rel(Y_t, Y_j) <= 1e-5


def test_meetit_masks(speakers):
    """``get_masks`` on one room's images: the mixture STFTs within 1e-5 of
    their scale, the masks within 1e-6 of the JAX package's ``tf_mask`` of
    the port's own spectra, and within the bound of the magnitudes'
    difference of the JAX package's masks."""
    rng = np.random.default_rng(8)
    images = (0.1 * rng.standard_normal((3, 4, 9000))).astype(np.float32)
    mix_t, masks_t = tmeetit.get_masks(images, [2, 2], device="cpu")
    mix_j, masks_j = jmeetit.get_masks(images, [2, 2])
    assert mix_t.dtype == np.complex64 and masks_t.dtype == np.float32
    assert mix_t.shape == mix_j.shape and masks_t.shape == masks_j.shape == (3, 4, 257, 36)
    assert max_rel(mix_t, mix_j) <= 1e-5
    import torch

    S_t = tstft(torch.from_numpy(images)).numpy()
    S_j = np.asarray(jstft(images))
    for s in range(3):
        np.testing.assert_allclose(masks_t[s], np.asarray(jtf_mask(S_t[s], mix_t - S_t[s])),
                                   rtol=0, atol=1e-6)
        # m = xi / (1 + xi), xi = |s| / |n|: dm = m (1 - m) (d|s|/|s| - d|n|/|n|)
        rel = sum(np.abs(np.abs(a) - np.abs(b)) / np.abs(b)
                  for a, b in ((S_t[s], S_j[s]), (mix_t - S_t[s], mix_j - S_j[s])))
        ref = masks_j[s]
        assert np.all(np.abs(masks_t[s] - ref) <= 2 * ref * (1 - ref) * rel + 1e-6)


def test_meetit_host_helpers_match_jax():
    for i in (0, 13, 99):
        assert np.array_equal(tmeetit.get_value_range(i, 100), jmeetit.get_value_range(i, 100))
    rng = np.random.default_rng(5)
    s, n = rng.standard_normal((4, 8000)), 0.3 * rng.standard_normal((4, 8000))
    assert tmeetit.sir_at_node(s, n) == jmeetit.sir_at_node(s, n)
    past = [[5.1, 5.0], [5.2, 5.0], [12.0, 12.5]]
    for cur in ([10.0, 5.0], [1.0, 1.0], [5.0, 5.0], [12.0, 12.0], [8.5, 9.0]):
        for level in (1, 2):
            assert tmeetit.check_sir_validity(cur, past, level) == \
                jmeetit.check_sir_validity(cur, past, level)
    assert np.array_equal(tmeetit.node_channel_bounds([4, 2, 3]),
                          jmeetit.node_channel_bounds([4, 2, 3]))
    a, b = tmeetit.sir_histogram([3.0, 6.0, 13.0]), jmeetit.sir_histogram([3.0, 6.0, 13.0])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
