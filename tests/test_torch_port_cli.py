"""The port's command line (``disco_tpu_torch.cli``) against the JAX
package's (``disco_tpu.cli``), on the CPU (``--device cpu``).

The JAX package generates a tiny corpus once for the module (3 synthetic
talkers, 1 RIR, ``--max_order 4``, ``--duration 2 3``); each stage of both
packages then reads a copy of the same input tree, so each comparison holds
one stage:

* ``gen``: the trees' file names identical, the infos' geometry equal,
  their RIRs within 1e-6 of scale and ``snr_images`` within 1e-3 dB (the
  bounds of ``tests/test_torch_port_datagen.py``);
* ``mix``: the WAVs within 1e-5 of scale, the SNR logs equal (the mixing
  SNR is drawn from an unseeded generator in both packages: the test seeds
  it the same for both runs);
* ``get-z``: the z ``.npy`` files within 1e-4 of scale (the z-export
  tolerance of ``tests/test_torch_port_driver.py``) from bin 2 (62.5 Hz)
  up; bins 0 and 1 within 1e-2.  The generated corpus has one point noise
  source and no sensor noise, so below ~50 Hz every mic of a 5-cm node sees
  the same field: the noise covariance there is rank-deficient, the step-1
  filter is set by float32 roundoff in either package, and the two differ
  by up to ~6e-3 of scale in those two bins (the OIM scores below still
  agree to the driver tests' dB bounds);
* ``lists``: the text files identical; ``aggregate``: the same summary of
  the same pickles;
* ``tango --rir 1``: the OIM results within the driver tests' dB bounds
  (``torch_port_helpers.assert_results_close``).

Then the parsers (the JAX parser's options, dests, defaults, choices and
nargs, plus ``--device``), the solver/config precedence and its clean
errors, a fault-spec run's events, ``disco-obs`` on the JAX package's logs,
the figures, and the refusals.
"""
import contextlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from disco_tpu.cli import aggregate as jaggregate
from disco_tpu.cli import gen_disco as jgen
from disco_tpu.cli import gen_meetit as jmeetit
from disco_tpu.cli import get_z as jgetz
from disco_tpu.cli import lists as jlists
from disco_tpu.cli import mix as jmix
from disco_tpu.cli import obs as jobs
from disco_tpu.cli import scenes as jscenes
from disco_tpu.cli import serve as jserve
from disco_tpu.cli import tango as jtango
from disco_tpu.cli import train as jtrain
from disco_tpu_torch.cli import aggregate as taggregate
from disco_tpu_torch.cli import gen_disco as tgen
from disco_tpu_torch.cli import gen_meetit as tmeetit
from disco_tpu_torch.cli import get_z as tgetz
from disco_tpu_torch.cli import lists as tlists
from disco_tpu_torch.cli import mix as tmix
from disco_tpu_torch.cli import obs as tobs
from disco_tpu_torch.cli import scenes as tscenes
from disco_tpu_torch.cli import serve as tserve
from disco_tpu_torch.cli import tango as ttango
from disco_tpu_torch.cli import train as ttrain
from tests.torch_port_helpers import (  # noqa: F401 (one_host_thread is a fixture)
    artifact_paths,
    assert_results_close,
    one_host_thread,
)

pytestmark = pytest.mark.usefixtures("one_host_thread")

FS = 16000
CPU = ["--device", "cpu"]
SCENARIO, NOISE = "living", "ssn"
#: the 11 CLIs: (JAX module, port module)
CLIS = {"gen": (jgen, tgen), "gen-meetit": (jmeetit, tmeetit), "mix": (jmix, tmix),
        "get-z": (jgetz, tgetz), "lists": (jlists, tlists), "train": (jtrain, ttrain),
        "tango": (jtango, ttango), "aggregate": (jaggregate, taggregate),
        "scenes": (jscenes, tscenes), "serve": (jserve, tserve), "obs": (jobs, tobs)}
#: the mixing stage's WAVs (max-abs of scale) and the z export's files
#: (max-rel, tests/test_torch_port_driver.py's TOL)
MIX_TOL, Z_TOL, Z_LOW_TOL = 1e-5, 1e-4, 1e-2
#: the z bins below ~50 Hz, held at Z_LOW_TOL (see the module docstring)
Z_LOW_BINS = 2
#: the generated infos: RIRs (max-abs of scale) and image SNRs (dB), the
#: bounds of tests/test_torch_port_datagen.py
RIR_TOL, SNR_DB_TOL = 1e-6, 1e-3


@contextlib.contextmanager
def seeded_default_rng(seed: int = 5):
    """``np.random.default_rng()`` without a seed gives the same generator
    in both packages' runs (``PostGenerator``'s SNR draw)."""
    real = np.random.default_rng
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.random, "default_rng", lambda s=None: real(seed if s is None else s))
        yield


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _gen_argv(out, speech):
    return ["--dset", "train", "--scenario", SCENARIO, "--rirs", "1", "1", "--dir_out", str(out),
            "--librispeech", str(speech), "--max_order", "4", "--duration", "2", "3"]


@pytest.fixture(scope="module")
def speech(tmp_path_factory):
    """A LibriSpeech-shaped tree of 3 synthetic talkers (4 s of gated,
    first-differenced noise each) in the train and test splits.  Speech
    has no DC; white noise through the image-source RIRs, whose taps are
    all positive, would put a large, mic-coherent DC component in both
    sources, and the near-degenerate DC pencils it makes amplify the two
    packages' roundoff to tenths of a dB."""
    from disco_tpu_torch.io.audio import write_wav

    root = tmp_path_factory.mktemp("libri")
    rng = np.random.default_rng(0)
    t = np.arange(4 * FS) / FS
    for spk in ("19", "26", "32"):
        env = (np.sin(2 * np.pi * 1.3 * t + float(spk)) > -0.3).astype(np.float64)
        for split in ("train-clean-100", "train-clean-360", "test-clean"):
            d = root / split / spk / "1"
            d.mkdir(parents=True)
            talk = 0.3 * env * np.diff(rng.standard_normal(len(t) + 1))
            write_wav(d / f"{spk}-1-0001.wav", talk, FS)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory, speech):
    """Every stage of both packages, each on a copy of the JAX package's
    tree of the stage before: {stage: (JAX tree, port tree)}."""
    base = tmp_path_factory.mktemp("stages")
    out = {"gen": (base / "gen_jax", base / "gen_port")}
    assert jgen.main(_gen_argv(out["gen"][0], speech)) == [1]
    assert tgen.main(_gen_argv(out["gen"][1], speech) + CPU) == [1]

    mix_argv = ["--rirs", "1", "1", "--scenario", SCENARIO, "--noise", NOISE, "--snr", "0", "6"]
    out["mix"] = (_copy(out["gen"][0], base / "mix_jax"), _copy(out["gen"][0], base / "mix_port"))
    for mod, root, extra in ((jmix, out["mix"][0], []), (tmix, out["mix"][1], CPU)):
        with seeded_default_rng():
            mod.main(mix_argv + ["--dir", str(root)] + extra)

    z_argv = ["--rir", "1", "--scenario", SCENARIO, "--noise", NOISE, "--sav_dir", "oracle"]
    out["get-z"] = (_copy(out["mix"][0], base / "z_jax"), _copy(out["mix"][0], base / "z_port"))
    for mod, root, extra in ((jgetz, out["get-z"][0], []), (tgetz, out["get-z"][1], CPU)):
        assert mod.main(z_argv + ["--dataset", str(root)] + extra) == 1
        assert mod.main(z_argv + ["--dataset", str(root)] + extra) == 0  # idempotent
    return out


@pytest.fixture(scope="module")
def tango_runs(trees, tmp_path_factory):
    """``tango --rir 1`` of both packages on the JAX mixing tree:
    (JAX results, port results, JAX out_root, port out_root)."""
    base = tmp_path_factory.mktemp("tango")
    argv = ["--rir", "1", "--scenario", SCENARIO, "--noise", NOISE,
            "--dataset", str(trees["mix"][0])]
    res_j = jtango.main(argv + ["--out_root", str(base / "jax")])
    res_t = ttango.main(argv + ["--out_root", str(base / "port")] + CPU)
    return res_j, res_t, base / "jax", base / "port"


# ------------------------------------------------------------------ stages
def _layout_base(root):
    return root / SCENARIO / "train"


def test_gen_tree_matches_jax(trees):
    jroot, troot = trees["gen"]
    assert artifact_paths(troot) == artifact_paths(jroot)
    ours = np.load(_layout_base(troot) / "log" / "infos" / "1.npy", allow_pickle=True).item()
    theirs = np.load(_layout_base(jroot) / "log" / "infos" / "1.npy", allow_pickle=True).item()
    assert set(ours) == set(theirs)
    assert ours["room"] == theirs["room"] and ours["noise_files"] == theirs["noise_files"]
    for key in ("mics", "sources", "nodes_centers", "noise_starts"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    err = np.abs(ours["rirs"] - theirs["rirs"]).max() / np.abs(theirs["rirs"]).max()
    assert err <= RIR_TOL, err
    assert np.abs(ours["snr_images"] - theirs["snr_images"]).max() <= SNR_DB_TOL


def test_gen_meetit_tree_matches_jax(tmp_path, speech):
    argv = ["--dset", "train", "--rirs", "3", "1", "--n_src", "2", "--librispeech", str(speech),
            "--max_order", "4", "--duration", "2", "3"]
    assert jmeetit.main(argv + ["--dir_out", str(tmp_path / "jax")]) == [3]
    assert tmeetit.main(argv + ["--dir_out", str(tmp_path / "port")] + CPU) == [3]
    assert artifact_paths(tmp_path / "port") == artifact_paths(tmp_path / "jax")


def test_mix_matches_jax(trees):
    jroot, troot = trees["mix"]
    paths = artifact_paths(jroot)
    assert artifact_paths(troot) == paths
    wavs = [p for p in paths if "wav_processed" in p]
    assert len(wavs) == 3 * 16
    for p in wavs:
        from disco_tpu_torch.io.audio import read_wav

        a, b = read_wav(troot / p)[0], read_wav(jroot / p)[0]
        assert np.abs(a - b).max() <= MIX_TOL * np.abs(b).max(), p
    snrs = [p for p in paths if "/log/snrs/" in p]
    assert snrs
    for p in snrs:
        np.testing.assert_array_equal(np.load(troot / p), np.load(jroot / p))


def test_get_z_matches_jax(trees):
    jroot, troot = (_layout_base(r) / "stft_z" for r in trees["get-z"])
    paths = artifact_paths(jroot)
    assert len(paths) == 2 * 2 * 4 and artifact_paths(troot) == paths
    errs = {}
    for p in paths:
        a, b = np.load(troot / p), np.load(jroot / p)
        assert a.dtype == b.dtype and a.shape == b.shape and np.isfinite(a).all(), p
        scale = np.abs(b).max()
        errs[p] = (np.abs(a - b)[Z_LOW_BINS:].max() / scale,
                   np.abs(a - b)[:Z_LOW_BINS].max() / scale)
    assert max(e for e, _ in errs.values()) <= Z_TOL, errs
    assert max(e for _, e in errs.values()) <= Z_LOW_TOL, errs


def test_lists_identical_to_jax(trees, tmp_path):
    argv = ["--scene", SCENARIO, "--noise", NOISE, "--n_files", "2",
            "--path_data", str(trees["get-z"][0])]
    out_j = jlists.main(argv + ["--out", str(tmp_path / "jax")])
    out_t = tlists.main(argv + ["--out", str(tmp_path / "port")] + CPU)
    assert out_t == out_j and len(out_j) == 12
    names = artifact_paths(tmp_path / "jax")
    assert artifact_paths(tmp_path / "port") == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_tango_rir_matches_jax(tango_runs):
    res_j, res_t, out_j, out_t = tango_runs
    assert_results_close({1: res_t}, {1: res_j})
    assert (out_t / "OIM" / "results_tango_1_ssn.p").exists()
    # the figure of the clip, drawn from the generation infos as the JAX
    # package draws it
    assert (out_t / "FIG" / "1.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (out_j / "FIG" / "1.png").exists()


def test_aggregate_identical_to_jax(tango_runs, capsys):
    oim = str(tango_runs[2] / "OIM")
    capsys.readouterr()
    for argv in ([oim, "--json"], [oim, "--kind", "mwf", "--keys", "sdr_cnv", "snr_out"]):
        want = jaggregate.main(argv)
        printed = capsys.readouterr().out
        assert taggregate.main(argv + CPU) == want
        assert capsys.readouterr().out == printed


def test_tango_rirs_cli_equals_the_direct_call(trees, tmp_path):
    """``disco-tango --rirs`` is ``enhance_rirs_batched`` with the CLI's
    defaults: the same results tree, byte for byte."""
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched

    root = str(trees["mix"][0])
    ttango.main(["--rirs", "1", "1", "--scenario", SCENARIO, "--noise", NOISE, "--dataset", root,
                 "--solver", "fused", "--out_root", str(tmp_path / "cli")] + CPU)
    enhance_rirs_batched(root, SCENARIO, range(1, 2), NOISE, out_root=str(tmp_path / "direct"),
                         solver="fused", bucket=8192, max_batch=16, device="cpu")
    names = artifact_paths(tmp_path / "direct")
    assert "FIG/1.png" in names and artifact_paths(tmp_path / "cli") == names
    for n in names:
        assert (tmp_path / "cli" / n).read_bytes() == (tmp_path / "direct" / n).read_bytes(), n


def test_train_checkpoint_loads_into_tango_and_jax(trees, tmp_path):
    """``disco-train --single_channel`` writes a checkpoint that the port's
    ``disco-tango --mods`` and the JAX package's loader both read."""
    from disco_tpu.nn.training import create_train_state as jstate
    from disco_tpu.nn.training import load_params_for_inference as jload

    root = trees["mix"][0]
    run = ttrain.main(["--scene", SCENARIO, "--noise", NOISE, "--n_files", "2",
                       "--path_data", str(root), "--save_path", str(tmp_path / "models"),
                       "--n_epochs", "1", "--batch_size", "16", "--single_channel"] + CPU)
    ckpt = tmp_path / "models" / f"{run}_model.msgpack"
    res = ttango.main(["--rir", "1", "--scenario", SCENARIO, "--noise", NOISE,
                       "--dataset", str(root), "--mods", str(ckpt), "None",
                       "--out_root", str(tmp_path / "res")] + CPU)
    assert np.isfinite(res["sdr_cnv"]).all()
    from disco_tpu.nn.crnn import build_crnn

    model, tx = build_crnn(n_ch=1)
    state = jload(str(ckpt), jstate(model, tx, np.zeros((1, 1, 21, 257), np.float32)))
    assert int(state.step) > 0


def test_scenes_subcommands_report_the_jax_keys(tmp_path, capsys):
    """Each ``disco-scenes`` subcommand prints one JSON line with the JAX
    CLI's keys (at tiny sizes; the batched factory itself is held by
    ``tests/test_torch_port_scenes.py``)."""
    keys = {
        "simulate": {"cmd", "n_batches", "n_scenes", "scenes_per_s", "elapsed_s",
                     "device_get_batches", "fences", "recompiles_scene_batch"},
        "stream": {"cmd", "n_batches", "batch_shape", "elapsed_s", "geometry"},
        "dynamic": {"cmd", "n_segments", "crossfade", "mixture_shape", "boundary_jump_max",
                    "mixture_rms"},
    }
    argv = {"simulate": ["--batches", "1", "--scenes", "2", "--max_order", "2"],
            "stream": ["--batches", "1", "--scenes", "2", "--max_order", "2",
                       "--ledger", str(tmp_path / "l.jsonl")],
            "dynamic": ["--segments", "2", "--max_order", "2", "--duration", "0.5"]}
    capsys.readouterr()
    for cmd, want in keys.items():
        assert tscenes.main([cmd] + argv[cmd] + CPU) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(out) == want and out["cmd"] == cmd


# ----------------------------------------------------------------- parsers
def _actions(parser, prefix=()):
    """{(subcommand path, option strings or dest): the action's contract}."""
    import argparse

    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out[prefix + ("<cmd>",)] = (a.dest, sorted(a.choices), a.required)
            for name, sub in a.choices.items():
                out.update(_actions(sub, prefix + (name,)))
            continue
        key = prefix + (tuple(a.option_strings) or a.dest,)
        out[key] = (a.dest, a.default, a.choices and list(a.choices), a.nargs, a.required,
                    type(a).__name__, getattr(a.type, "__name__", a.type), a.const)
    return out


@pytest.mark.parametrize("name", list(CLIS))
def test_parser_matches_jax(name):
    jmod, tmod = CLIS[name]
    theirs = _actions(jmod.build_parser())
    ours = _actions(tmod.build_parser())
    extra = {k: v for k, v in ours.items() if k not in theirs}
    assert extra and all(k[-1] == ("--device",) for k in extra), extra
    assert all(v[:4] == ("device", "cuda", ["cuda", "cpu"], None) for v in extra.values())
    assert {k: ours[k] for k in theirs} == theirs


# --------------------------------------------------- config and refusals
def _resolved(mod, argv):
    return mod.resolve_solver(mod.build_parser().parse_args(argv + ["--rir", "1"]))


def _both_resolved(argv):
    """The two packages' resolutions, or their SystemExit messages."""
    got = []
    for mod in (jtango, ttango):
        try:
            got.append(("ok", _resolved(mod, argv)))
        except SystemExit as e:
            got.append(("exit", str(e)))
    assert got[0] == got[1], got
    return got[0]


def test_tango_cli_solver_precedence(tmp_path):
    """--solver resolution: explicit flag > the config file's
    enhance.solver > None (the driver's mode-aware default), as the JAX
    CLI resolves it, in YAML and in JSON."""
    import dataclasses

    from disco_tpu.config import DiscoConfig, EnhanceConfig, _to_plain, save_config

    cfg = DiscoConfig(enhance=dataclasses.replace(EnhanceConfig(), solver="power:8"))
    path = save_config(cfg, tmp_path / "cfg.yaml")
    as_json = tmp_path / "cfg.json"
    as_json.write_text(json.dumps(_to_plain(cfg)))
    assert _both_resolved([]) == ("ok", None)
    assert _both_resolved(["--config", str(path)]) == ("ok", "power:8")
    assert ttango.resolve_solver(ttango.build_parser().parse_args(
        ["--rir", "1", "--config", str(as_json)])) == "power:8"
    assert _both_resolved(["--config", str(path), "--solver", "jacobi"]) == ("ok", "jacobi")
    for name, text in (("nosolver.yaml", "enhance:\n  mu: 1.5\n"), ("empty.yaml", ""),
                       ("nullsec.yaml", "enhance:\n")):
        (tmp_path / name).write_text(text)
        assert _both_resolved(["--config", str(tmp_path / name)]) == ("ok", None)
    (tmp_path / "badtype.yaml").write_text("enhance:\n  solver: null\n")
    kind, msg = _both_resolved(["--config", str(tmp_path / "badtype.yaml")])
    assert kind == "exit" and "enhance.solver" in msg


def test_tango_cli_non_mapping_yaml_shapes_are_clean_errors(tmp_path):
    """Non-mapping files and sections, and a bad solver in the file: the
    same SystemExit messages as the JAX CLI's."""
    import dataclasses

    from disco_tpu.config import DiscoConfig, EnhanceConfig, save_config

    cases = {"list.yaml": "- enhance\n- solver\n", "scalar.yaml": "eigh\n",
             "scalarsec.yaml": "enhance: eigh\n", "listsec.yaml": "enhance:\n  - solver\n"}
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        kind, msg = _both_resolved(["--config", str(tmp_path / name)])
        assert kind == "exit" and name in msg, msg
    bad = save_config(DiscoConfig(enhance=dataclasses.replace(EnhanceConfig(), solver="nope")),
                      tmp_path / "bad.yaml")
    kind, msg = _both_resolved(["--config", str(bad)])
    assert kind == "exit" and "enhance.solver" in msg


@pytest.fixture(scope="module")
def fault_runs(trees, tmp_path_factory):
    """``tango --rir 1 --fault-spec F --fault-seed 7 --obs-log L`` through
    both CLIs: {package: (results, the log read back)}."""
    from disco_tpu import obs as jobs_pkg
    from disco_tpu_torch import obs as tobs_pkg

    base = tmp_path_factory.mktemp("faults")
    spec = base / "faults.yaml"
    spec.write_text("node_dropout: [1]\nnan_z: [2]\nseed: 4\n")
    argv = ["--rir", "1", "--scenario", SCENARIO, "--noise", NOISE,
            "--dataset", str(trees["mix"][0]), "--fault-spec", str(spec), "--fault-seed", "7"]
    out = {}
    for name, mod, pkg, extra in (("jax", jtango, jobs_pkg, []), ("port", ttango, tobs_pkg, CPU)):
        log = base / f"{name}.jsonl"
        res = mod.main(argv + ["--out_root", str(base / name), "--obs-log", str(log)] + extra)
        out[name] = (res, log, pkg.read_events(log))
    return out


def test_tango_cli_fault_spec_matches_jax(trees, fault_runs):
    """--fault-spec (with --fault-seed) through both CLIs: finite degraded
    output, the same fault and degraded events; a bare --fault-seed gives
    the same refusal."""
    kinds = []
    for res, _log, events in fault_runs.values():
        assert np.isfinite(res["sdr_cnv"]).all()
        kinds.append((sorted(e["attrs"]["fault"] for e in events if e["kind"] == "fault"),
                      [e["attrs"] for e in events if e["kind"] == "degraded"],
                      events[0]["kind"]))
    assert kinds[0] == kinds[1] and kinds[0][0] == ["nan_z", "node_dropout"], kinds
    msgs = []
    for mod, extra in ((jtango, []), (ttango, CPU)):
        with pytest.raises(SystemExit) as e:
            mod.main(["--rir", "1", "--dataset", str(trees["mix"][0]), "--fault-seed", "7"]
                     + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "--fault-seed needs --fault-spec"


def test_obs_report_of_a_jax_log(fault_runs, capsys):
    """``disco-obs report`` of a log the JAX CLI wrote: the port's summary
    is the JAX package's without its estimated tunnel-RPC overhead, and
    the rendering differs only on the fences line."""
    log = fault_runs["jax"][1]
    capsys.readouterr()
    theirs = jobs.main(["report", str(log)])
    jtext = capsys.readouterr().out
    ours = tobs.main(["report", str(log)] + CPU)
    ttext = capsys.readouterr().out
    assert theirs.pop("est_rpc_s") >= 0
    assert ours == theirs and ours["clips"] == 1 and ours["faults"]
    drop = ("fences:",)
    assert ([ln for ln in ttext.splitlines() if not ln.startswith(drop)]
            == [ln for ln in jtext.splitlines() if not ln.startswith(drop)])
    assert f"fences: {ours['n_fences']}\n" in ttext and "RPC" not in ttext


def test_obs_trace_of_a_jax_log(tmp_path, capsys):
    from disco_tpu import obs as jobs_pkg
    from disco_tpu.obs import trace as jtrace

    log = tmp_path / "run.jsonl"
    with jobs_pkg.recording(log):
        jtrace.enable()
        try:
            ctx = jtrace.root("client_block", seq=0, session="sC")
            ctx = jtrace.span("enqueue", ctx, session="sC", seq=0)
            jtrace.span("dispatch", ctx, failed=True, error="boom")
            ctx = jtrace.span("dispatch", ctx, tick=1, wait_ms=0.5)
            jtrace.span("readback", ctx, tick=1, readback_ms=2.0)
        finally:
            jtrace.disable()
    capsys.readouterr()
    for argv in (["trace", str(log)], ["trace", str(log), "--limit", "1"]):
        want = jobs.main(argv)
        printed = capsys.readouterr().out
        assert tobs.main(argv + CPU) == want
        assert capsys.readouterr().out == printed
    tid = want[0]
    want = jobs.main(["trace", str(log), tid])
    printed = capsys.readouterr().out
    assert tobs.main(["trace", str(log), tid] + CPU) == want
    assert capsys.readouterr().out == printed and "waterfall" in printed


def test_refusals(trees, tmp_path):
    """Flags whose machinery the port does not have parse and exit naming
    it; the mesh flags refuse a world too small for them with the JAX
    CLI's message; ``xla`` impls exit naming the flag only on the card;
    without ``--device`` a command on this CUDA-less host raises."""
    root = str(trees["mix"][0])
    with pytest.raises(SystemExit, match=r"^--mesh 2 2 needs 4 devices; 1 available$"):
        ttango.main(["--rirs", "1", "1", "--dataset", root, "--mesh", "2", "2"] + CPU)
    with pytest.raises(SystemExit, match=r"--mesh needs batched corpus mode"):
        ttango.main(["--rir", "1", "--dataset", root, "--mesh", "1", "1"] + CPU)
    with pytest.raises(SystemExit, match=r"^--data-parallel 2 needs 2 devices; 1 available$"):
        ttrain.main(["--data-parallel", "2"] + CPU)
    with pytest.raises(SystemExit, match="ROADMAP Queue 1"):
        tobs.main(["compare", "a.json", "b.json"] + CPU)
    # roofline runs since the cost model is ported: a record's stage times
    # against its workload's modeled costs
    rec = tmp_path / "record.json"
    rec.write_text(json.dumps({"metric": "rtf", "stage_ms": {"stft_x3": 0.5, "masks": 0.1},
                               "workload": {"batch": 1, "dur_s": 0.5, "n_nodes": 2,
                                            "mics_per_node": 2}}))
    res = tobs.main(["roofline", str(rec), "--format", "json"] + CPU)
    assert [r["stage"] for r in res["rows"]] == ["stft_x3", "masks"]
    assert res["peaks"]["card"] == "NVIDIA H100 80GB HBM3" and not res["workload_assumed"]
    import torch

    if not torch.cuda.is_available():
        for mod, argv in ((ttango, ["--rir", "1", "--dataset", root]), (tlists, []),
                          (tobs, ["report", "x.jsonl"]), (tserve, ["--port", "0"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main(argv)
    else:  # pragma: no cover - the card
        with pytest.raises(SystemExit, match="--cov_impl xla"):
            ttango.main(["--rir", "1", "--dataset", root, "--cov_impl", "xla"])


def test_tango_help_loads_no_jax(tmp_path):
    code = ("import runpy, sys\nsys.argv = ['disco-torch-tango', '--help']\n"
            "try:\n    runpy.run_module('disco_tpu_torch.cli.tango', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0\n"
            "print('jax' in sys.modules, 'disco_tpu' in sys.modules)\n")
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--compile-cache" in out.stdout and "--device" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "False False"


# ----------------------------------------------------------------- figures
def _drawn(fig):
    ax = fig.axes[0]
    return ([line.get_xydata().tolist() for line in ax.lines],
            [(t.get_position(), t.get_text()) for t in ax.texts],
            [p.get_bbox().bounds for p in ax.patches], ax.get_xlim(), ax.get_ylim())


def test_figures_draw_the_jax_lines(trees):
    """``plot_conf`` on a generated clip's infos and ``RoomSetup.plot`` on a
    sampled room draw the JAX package's lines, labels and outline."""
    from disco_tpu.enhance.inference import plot_conf as jplot
    from disco_tpu.sim.defaults import make_setup as jsetup
    from disco_tpu_torch.enhance.inference import plot_conf as tplot
    from disco_tpu_torch.sim.defaults import make_setup as tsetup

    infos = np.load(_layout_base(trees["gen"][0]) / "log" / "infos" / "1.npy",
                    allow_pickle=True).item()
    assert tplot(infos) is None and jplot(infos) is None
    ours, theirs = tplot(infos, return_fig=True), jplot(infos, return_fig=True)
    assert type(ours).__name__ == "Figure" and _drawn(ours) == _drawn(theirs)
    rooms = [f("meeting", rng=np.random.default_rng(4)).create_room_setup()
             for f in (tsetup, jsetup)]
    assert _drawn(rooms[0].plot()) == _drawn(rooms[1].plot())
