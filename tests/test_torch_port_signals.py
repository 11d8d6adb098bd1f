"""The port's signal setups (``disco_tpu_torch.sim.signals``,
``core.sigproc.stack_talkers``) against the JAX package's on a synthetic
LibriSpeech-shaped WAV corpus, with equal-seeded generators.

The picks, SNR draws and segment lengths are host numpy, drawn in the same
order: equal.  The VADs (``core.masks.vad_oracle_batch`` on a CPU tensor in
the port, the JAX function in the JAX package) are required exactly equal;
the segments, whose scale comes from the VAD-active variance, within 1e-6
of their scale.  A VAD decides a window by a count of samples above a
threshold, so the tests also require the inputs' decisions to lie clear of
a flip (``vad_margin``): a flip there would be a float decision, not a
fault.
"""
import numpy as np
import pytest
import torch

from disco_tpu.core.sigproc import stack_talkers as jstack_talkers
from disco_tpu.io import write_wav
from disco_tpu.sim import signals as jsig
from disco_tpu_torch.core.sigproc import stack_talkers as tstack_talkers
from disco_tpu_torch.sim import signals as tsig
from tests.torch_port_helpers import max_rel

FS = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{speaker}/{chapter}/{utt}.wav speech (5-6 s of gated noise bursts) and
    two 8-s noise files."""
    root = tmp_path_factory.mktemp("signals")
    rng = np.random.default_rng(0)
    speech = []
    for i, spk in enumerate(("101", "102", "103", "104")):
        f = root / "speech" / spk / "1" / f"{spk}-1-0001.wav"
        f.parent.mkdir(parents=True)
        t = np.arange(int((5 + 0.4 * i) * FS)) / FS
        env = (np.sin(2 * np.pi * (1.1 + 0.2 * i) * t) > -0.2).astype(np.float64)
        write_wav(f, 0.3 * env * rng.standard_normal(len(t)), FS)
        speech.append(str(f))
    noises = []
    for i in range(2):
        f = root / "noise" / f"n{i}.wav"
        f.parent.mkdir(exist_ok=True)
        write_wav(f, 0.2 * rng.standard_normal(8 * FS), FS)
        noises.append(str(f))
    short = root / "short.wav"
    write_wav(short, rng.standard_normal(FS), FS)
    return speech, noises, str(short)


def _speech_noise(mod, corpus, seed):
    speech, noises, _ = corpus
    return mod.SpeechAndNoiseSetup(
        target_list=speech, talkers_list=speech,
        noises_dict={"fs": noises, "interferent_talker": speech},
        duration_range=(3, 5), var_tar=10 ** (-23 / 10), snr_dry_range=[[0, 6], [3, 9]],
        snr_cnv_range=(-10, 15), min_delta_snr=0, rng=np.random.default_rng(seed))


def _interferent(mod, corpus, seed):
    return mod.InterferentSpeakersSetup(
        speakers_list=corpus[0], duration_range=(3, 5), var_tar=10 ** (-23 / 10),
        snr_dry_range=[[0, 0]], snr_cnv_range=(-10, 15), min_delta_snr=0,
        rng=np.random.default_rng(seed))


def vad_margin(x, win_len=512, win_hop=256, thr=0.001, rat=2) -> float:
    """How far the VAD's decisions lie from a flip (a float64 model of
    ``vad_oracle_batch``: a window is active when at least half its samples
    lie above the threshold): over the windows that one sample crossing the
    threshold would flip, the smallest relative distance of a sample's
    power to the threshold (inf when no window is that close).  The two
    packages' VADs differ by float roundoff, ~1e-7 relative."""
    x = np.asarray(x, np.float64)
    x2 = (x - x.mean()) ** 2
    t = thr * np.quantile(x2, 0.99)
    n_win = -(-(len(x) - win_len) // win_hop) + 1
    margin = np.inf
    for w in range(n_win):
        seg = x2[w * win_hop:w * win_hop + win_len]
        count, need = int((seg > t).sum()), len(seg) // rat
        if count in (need, need - 1):
            margin = min(margin, float(np.min(np.abs(seg - t)) / t))
    return margin


def assert_segment(ours, theirs):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert max_rel(ours, theirs) <= 1e-6


def test_normalize_to_var(corpus):
    rng = np.random.default_rng(0)
    x = np.concatenate([np.zeros(FS), rng.standard_normal(2 * FS)])
    (y_t, v_t), (y_j, v_j) = tsig.normalize_to_var(x, 0.005), jsig.normalize_to_var(x, 0.005)
    assert v_t.dtype == v_j.dtype and np.array_equal(v_t, v_j)
    assert_segment(y_t, y_j)
    assert vad_margin(x) > 1e-5 and vad_margin(y_j) > 1e-5


@pytest.mark.parametrize("i_file", [0, 1, 2, 3])
def test_target_segment(corpus, i_file):
    t, j = _speech_noise(tsig, corpus, 1), _speech_noise(jsig, corpus, 1)
    f = corpus[0][i_file]
    (s_t, v_t, fs_t), (s_j, v_j, fs_j) = t.get_target_segment(f), j.get_target_segment(f)
    assert fs_t == fs_j == FS and t.target_duration == j.target_duration
    assert np.array_equal(v_t, v_j) and v_t.dtype == v_j.dtype
    assert_segment(s_t, s_j)
    np.testing.assert_array_equal(s_t[:FS], 0)
    assert vad_margin(s_j[FS:]) > 1e-5


def test_short_target_is_rejected(corpus):
    t, j = _speech_noise(tsig, corpus, 1), _speech_noise(jsig, corpus, 1)
    assert t.get_target_segment(corpus[2])[:2] == (None, None) == j.get_target_segment(corpus[2])[:2]
    assert t.target_duration == j.target_duration


@pytest.mark.parametrize("kind", ["fs", "interferent_talker", "SSN"])
def test_noise_segments(corpus, kind):
    """A category file at a random offset, an interferent talker (with its
    VAD), or speech-shaped noise from stacked talkers: three draws each."""
    t, j = _speech_noise(tsig, corpus, 4), _speech_noise(jsig, corpus, 4)
    for duration in (2.0, 3.5, 4.0):
        (n_t, f_t, st_t, v_t, fs_t) = t.get_noise_segment(kind, duration)
        (n_j, f_j, st_j, v_j, fs_j) = j.get_noise_segment(kind, duration)
        assert (f_t, st_t, fs_t) == (f_j, st_j, fs_j)
        assert np.array_equal(n_t, n_j)
        assert (v_t is None) == (v_j is None)
        if v_j is not None:
            assert np.array_equal(v_t, v_j)
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_noise_segment_errors(corpus):
    t = _speech_noise(tsig, corpus, 4)
    with pytest.raises(ValueError, match="lasting more than"):
        t.get_noise_segment("fs", 100.0)
    with pytest.raises(ValueError, match="Unknown noise type"):
        t.get_noise_segment("bogus", 1.0)


def test_random_dry_snr(corpus):
    t, j = _speech_noise(tsig, corpus, 6), _speech_noise(jsig, corpus, 6)
    for _ in range(3):
        assert np.array_equal(t.get_random_dry_snr(), j.get_random_dry_snr())


def test_interferent_speakers(corpus):
    """Distinct speakers a room, normalized segments with their VADs, the
    same picks; a fifth speaker in a 4-speaker corpus fails in both."""
    t, j = _interferent(tsig, corpus, 0), _interferent(jsig, corpus, 0)
    for _ in range(4):
        (y_t, v_t), (y_j, v_j) = t.get_signal(3.0), j.get_signal(3.0)
        assert np.array_equal(v_t, v_j)
        assert_segment(y_t, y_j)
    assert t.speakers_files == j.speakers_files and len(set(t.speakers_ids)) == 4
    with pytest.raises(ValueError):
        t.get_signal(3.0)
    t.reset()
    t.get_signal(3.0)
    assert len(t.speakers_ids) == 1


def test_stack_talkers(corpus):
    speech = corpus[0]
    got = tstack_talkers(speech, 7.0, "101", rng=np.random.default_rng(2))
    want = jstack_talkers(speech, 7.0, "101", rng=np.random.default_rng(2))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert "101-1-0001" not in got[2]


def test_vad_runs_on_the_host(corpus):
    """The setups' VAD is a host computation (numpy in, numpy out), whatever
    device the rest of the path runs on."""
    v = tsig._vad(np.ones(2048))
    assert isinstance(v, np.ndarray) and v.dtype == np.float32
    assert not isinstance(v, torch.Tensor)
