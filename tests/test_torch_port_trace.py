"""``disco_tpu_torch.analysis.trace`` — the port's program contracts: the
catalog traced for the card on fake tensors against its committed goldens,
the retrace budgets against the JAX package's, the dtype and donation
audits, each gate made to fail by the change it exists for, and the five
kernel ops routed by device."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from disco_tpu_torch.analysis.trace import audits, budgets, check, cli, fingerprint
from disco_tpu_torch.analysis.trace.fingerprint import Struct
from disco_tpu_torch.analysis.trace.programs import PROGRAMS


@pytest.fixture(scope="module")
def full_run():
    """The whole gate once: fingerprints, donation, dtype, budgets."""
    return check.run_checks()


def _one(name, **kw):
    return check.run_checks(programs={name}, budgets=False, donation=False, **kw)


def test_gate_clean_against_committed_goldens(full_run):
    assert full_run.clean, check.format_text(full_run)
    assert full_run.n_programs == len(PROGRAMS) == 15
    assert full_run.budgets == budgets.BUDGETS
    fps = full_run.fingerprints
    # the card's route: one STFT, two covariance and two fused-solve launches
    # a clip, as chip_smoke.py phase 3 counts them on the card
    assert fps["tango_clip_fused"]["kernel_ops"] == {
        "disco_torch::fused_mwf": 2, "disco_torch::masked_cov": 2, "disco_torch::stft": 1}
    assert all(fp["traced"] == "fake-cuda" for n, fp in fps.items() if n != "train_step")
    assert fps["train_step"]["traced"] == "real-cpu"
    assert "CUDA runtime" in fps["train_step"]["readback"]
    assert all(fp["host_syncs"] == {"scalar_reads": 0, "d2h_copies": 0} for fp in fps.values())
    # no spectrogram-shaped or pencil-shaped output escapes the chained programs
    assert fps["tango_clip_fused"]["out_avals"] == ["float32[2,1024]"]
    assert not any(",257," in a for a in fps["tango_clip_fused"]["out_avals"])
    assert fps["tango_step2_fused"]["out_avals"] == ["complex64[5,8]"] * 3
    assert fps["tango_step1_fused"]["kernel_ops"]["disco_torch::fused_mwf"] == 1


def test_donation_counterpart(full_run):
    reps = {r["program"]: r for r in full_run.donation}
    assert set(reps) == {n for n, s in PROGRAMS.items() if s.donate}
    carry = reps["streaming_tango_state"]
    assert carry["kind"] == "freed" and carry["ok"]
    assert carry["held_to_contract"] == carry["declared_tensors"] == 10
    assert carry["peak_extra_bytes"] > 0
    state = reps["train_step"]
    assert state["kind"] == "in_place" and state["ok"]
    assert state["held_to_contract"] == state["declared_tensors"] > 0


def test_catalog_on_real_tensors_held_to_the_goldens(capsys):
    """chip_smoke.py phase 3n's check rehearsed on the CPU route: each
    program run on real tensors agrees with its golden on what does not
    move with the torch version (the CPU holds no device float64); the
    gate's ``--device cpu`` holds the same."""
    for name, spec in PROGRAMS.items():
        fp = fingerprint.fingerprint_trace(fingerprint.trace_real(spec, "cpu"))
        assert fp["traced"] == "real-cpu"
        golden = check.load_golden(name)
        want = [f"f64: {golden['f64']} -> []"] if name in audits.F64_ALLOWED else []
        assert fingerprint.portable_diff(golden, fp) == want, name
    assert cli.main(["--device", "cpu", "--no-budgets"]) == 0
    assert "15 program(s) checked" in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--update"]) == 2


def test_budgets_match_jax_except_the_explained_labels():
    from disco_tpu.analysis.trace.budgets import BUDGETS as JAX

    assert set(budgets.BUDGETS) == set(JAX)
    for label, n in budgets.BUDGETS.items():
        assert n == JAX[label] or label in budgets.DIFFERS, label
    assert set(budgets.DIFFERS) == {k for k in JAX if budgets.BUDGETS[k] != JAX[k]}


def test_int_mu_through_a_fresh_call_site_fails_the_budget(full_run):
    def int_mu(streaming, Y, mz, mw):
        streaming.streaming_tango(Y, mz, mw, update_every=4, mu=1, device="cpu")

    findings, counts = budgets.check_budgets(extra=int_mu)
    assert counts["streaming_tango"] == budgets.BUDGETS["streaming_tango"] + 1
    assert len(findings) == 1 and "'streaming_tango'" in findings[0]
    assert "mu=1 trap" in findings[0]


def test_float64_on_the_device_caught_from_a_real_trace(monkeypatch):
    from disco_tpu_torch.enhance import tango

    def apply_f64(w, X):
        w = w.to(torch.complex128)
        return (w.transpose(-1, -2)[..., None] * X.to(torch.complex128)).sum(-3).to(X.dtype)

    monkeypatch.setattr(tango, "_apply", apply_f64)
    res = _one("tango_step2_fused")
    kinds = {f["check"] for f in res.findings}
    assert {"dtype", "fingerprint"} <= kinds
    leak = res.fingerprints["tango_step2_fused"]["f64"]
    assert leak and all("complex128" in e for e in leak)
    # the reviewed allow-list: scene_batch keeps float64 by design
    fp = fingerprint.fingerprint_program(PROGRAMS["scene_batch"])
    assert fp["f64"] and audits.audit_dtypes("scene_batch", fp) == []
    assert audits.audit_dtypes("tango_clip_fused", fp) != []


def test_one_more_device_float64_than_the_golden_fails_the_card_check(monkeypatch):
    """scene_batch may hold float64 on the device (the reviewed allow-list),
    but the card's run is held to the golden's float64 tensors one by one:
    one more is a difference, not just the same answer to "any?"."""
    from disco_tpu_torch.sim import ism

    monkeypatch.setattr(ism, "_sqrt_rn", lambda x: torch.sqrt(x.double().abs()).float())
    fp = fingerprint.fingerprint_program(PROGRAMS["scene_batch"])
    golden = check.load_golden("scene_batch")
    assert audits.audit_dtypes("scene_batch", fp) == []
    assert set(golden["f64"]) < set(fp["f64"])
    (diff,) = fingerprint.portable_diff(golden, fp)
    assert diff.startswith("f64: ") and "aten::abs float64" in diff


def test_an_extra_kernel_call_fails_the_fingerprint(monkeypatch):
    from disco_tpu_torch.enhance import fused

    real = fused.stft_with_mag

    def twice(x, **kw):
        real(x, **kw)
        return real(x, **kw)

    monkeypatch.setattr(fused, "stft_with_mag", twice)
    res = _one("tango_clip_fused")
    msgs = [f["message"] for f in res.findings if f["check"] == "fingerprint"]
    assert any(m.startswith("kernel_ops:") and "'disco_torch::stft': 2" in m for m in msgs)
    assert any(m.startswith("op disco_torch::stft: 1 -> 2") for m in msgs)


def test_missing_and_stale_goldens(tmp_path):
    res = _one("tango_step2_fused", golden_dir=tmp_path)
    assert [f["check"] for f in res.findings] == ["golden"]
    assert "no committed golden" in res.findings[0]["message"]
    stale = dict(check.load_golden("tango_step2_fused"))
    stale["ops"] = dict(stale["ops"], **{"aten::bmm": 3})
    (tmp_path / "tango_step2_fused.json").write_text(fingerprint.dumps(stale))
    res = _one("tango_step2_fused", golden_dir=tmp_path)
    assert [f["check"] for f in res.findings] == ["fingerprint"]
    assert res.findings[0]["message"] == "op aten::bmm: 3 -> 0 (-3)"
    assert "DRIFT" in check.format_text(res)


def test_a_torch_version_mismatch_asks_to_regenerate(tmp_path):
    old = dict(check.load_golden("tango_step2_fused"), torch="2.0.0")
    (tmp_path / "tango_step2_fused.json").write_text(fingerprint.dumps(old))
    res = _one("tango_step2_fused", golden_dir=tmp_path)
    assert len(res.findings) == 1
    msg = res.findings[0]["message"]
    assert msg.startswith("torch version 2.0.0 != ") and "--update" in msg


def test_goldens_rebuild_bit_identically(full_run, tmp_path):
    for name, fp in full_run.fingerprints.items():
        assert fingerprint.dumps(fp).encode() == check.golden_path(name).read_bytes(), name
    res = check.run_checks(update=True, programs={"streaming_clip_fused"}, budgets=False,
                           donation=False, golden_dir=tmp_path)
    assert res.clean and res.updated == ["streaming_clip_fused"]
    assert (tmp_path / "streaming_clip_fused.json").read_bytes() == \
        check.golden_path("streaming_clip_fused").read_bytes()


def test_json_reporter_contract(tmp_path, capsys):
    res = _one("tango_step2_fused", golden_dir=tmp_path)
    payload = json.loads(check.format_json(res))
    assert set(payload) >= {"clean", "counts", "findings", "fingerprints", "donation",
                            "budgets", "updated"}
    assert payload["clean"] is False
    assert payload["counts"] == {"findings": 1, "programs": 1, "by_check": {"golden": 1}}
    assert payload["findings"][0]["program"] == "tango_step2_fused"
    assert cli.main(["--list"]) == 0
    assert "streaming_tango_state" in capsys.readouterr().out
    assert cli.main(["--program", "nope"]) == 2
    assert cli.main(["--program", "tango_step2_fused", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["clean"] is True


# ------------------------------------------------------------ routing
def _kernel_calls():
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    x = Struct((2, 3, 1024), torch.float32)
    y = Struct((2, 3, 5, 8), torch.complex64)
    m = Struct((2, 5, 8), torch.float32)
    R = Struct((4, 3, 3), torch.complex64)
    return {
        "stft": (lambda a: stft_ops.stft_kernel(a, with_mag=True), (x,),
                 [(2, 3, 257, 5), (2, 3, 257, 5)]),
        "stft_bf16": (lambda a: stft_ops.stft_bf16_kernel(a), (x,), [(2, 3, 257, 5)]),
        "masked_cov": (lambda a, b: cov_ops.masked_cov_kernel(a, b), (y, m),
                       [(2, 5, 3, 3), (2, 5, 3, 3)]),
        "fused_mwf": (lambda a, b: mwf_ops.fused_mwf_kernel(a, b, mu=1.0), (R, R),
                      [(4, 3), (4, 3)]),
        "eigh_jacobi": (lambda a: eigh_ops.eigh_jacobi_kernel(a), (R,), [(4, 3), (4, 3, 3)]),
    }


@pytest.mark.parametrize("kernel", ["stft", "stft_bf16", "masked_cov", "fused_mwf",
                                    "eigh_jacobi"])
def test_kernel_ops_route_by_device(kernel):
    """A fake ``cuda`` tensor reaches the op's fake implementation (one op
    call, no launch counted); a real CPU tensor reaches the plain version,
    bit for bit."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    fn, structs, shapes = _kernel_calls()[kernel]
    counters = (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel,
                mwf_ops.fused_mwf_kernel, eigh_ops.eigh_jacobi_kernel)
    before = [(f.launches, getattr(f, "launches_bf16", 0)) for f in counters]
    trace = fingerprint.trace_program(lambda dev: (fn, structs, {}), "cuda")
    assert trace.traced == "fake-cuda"
    assert [e.name for e in trace.events if fingerprint.is_kernel(e.name)] == \
        [f"disco_torch::{kernel}"]
    assert [tuple(o.shape) for o in trace.outputs] == shapes
    assert all(o.device == "cuda" for o in trace.outputs)
    assert [(f.launches, getattr(f, "launches_bf16", 0)) for f in counters] == before

    args = fingerprint.materialize(structs, "cpu", seed=3)
    plain = {
        "stft": lambda a: stft_ops.stft_matmul(a, with_mag=True),
        "stft_bf16": lambda a: stft_ops.stft_matmul(a, precision="bf16"),
        "masked_cov": lambda a, b: cov_ops.masked_covariances_plain(a, b),
        "fused_mwf": lambda a, b: mwf_ops.fused_mwf_plain(a, b, 1.0),
        "eigh_jacobi": lambda a: eigh_ops.eigh_jacobi_unsorted(a),
    }[kernel]
    got, want = fn(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    rec, _ = fingerprint.record(fn, args)
    assert [e.name for e in rec.events] == [f"disco_torch::{kernel}"]


def test_mixed_devices_raise_the_wrappers_errors():
    """Every tensor argument of a kernel wrapper is on one device, or the
    wrapper raises its own error before the op picks an implementation."""
    from disco_tpu_torch.ops import cov_ops, mwf_ops

    R = torch.eye(3, dtype=torch.complex64).expand(4, 3, 3)
    with pytest.raises(ValueError, match="fused_mwf_kernel: pencils on cpu and meta"):
        mwf_ops.fused_mwf_kernel(R, R.to("meta"))
    with pytest.raises(ValueError, match="fused_mwf_kernel: pencils on meta and cpu"):
        mwf_ops.fused_mwf_kernel(R.to("meta"), R)
    y = torch.ones(2, 3, 5, 8, dtype=torch.complex64)
    m = torch.ones(2, 5, 8)
    with pytest.raises(ValueError, match="masked_cov_kernel: spectra on cpu, mask on meta"):
        cov_ops.masked_cov_kernel(y, m.to("meta"))
    with pytest.raises(ValueError, match="masked_cov_kernel: spectra on meta, mask on cpu"):
        cov_ops.masked_cov_kernel(y.to("meta"), m)


def test_a_card_mu_beside_host_pencils_runs_the_plain_version():
    """A per-pencil ``mu`` on the card beside host pencils joins the pencils
    on the host, as a host ``mu`` joins card pencils: the op reads host
    tensors only, so it runs the plain version (traced on fake tensors,
    the ``mu`` a fake ``cuda`` one)."""
    from disco_tpu_torch.ops import mwf_ops

    with fingerprint._fake_mode(), fingerprint.CardIndexing() as indexing:
        R = fingerprint.materialize(Struct((4, 3, 3), torch.complex64), "cpu", fake=True)
        mu = fingerprint.materialize(Struct((4,), torch.float32), "cuda:0", fake=True)
        rec, _ = fingerprint.record(lambda a, m: mwf_ops.fused_mwf_kernel(a, a, mu=m), (R, mu),
                                    recorder=fingerprint.Recorder(indexing))
    assert mu.device.type == "cuda"
    (op,) = [e for e in rec.events if e.name == "disco_torch::fused_mwf"]
    assert [t.device for t in op.ins] == ["cpu", "cpu", "cpu"]


def test_a_fake_trace_leaves_the_device_tables_uncached():
    """The table builders skip their caches while tracing for the card: a
    fake trace stores no fake table for a real card to be served, and
    records the tables' making each time."""
    from disco_tpu_torch.core.dsp import istft
    from disco_tpu_torch.ops import stft_ops

    stft_ops._idft_tables.cache_clear()
    spec = Struct((2, 257, 5), torch.complex64)
    prog = lambda dev: (lambda z: istft(z, length=1024), (spec,), {})  # noqa: E731
    first = fingerprint.fingerprint_trace(fingerprint.trace_program(prog, "cuda"))
    assert stft_ops._idft_tables.cache_info().currsize == 0
    again = fingerprint.fingerprint_trace(fingerprint.trace_program(prog, "cuda"))
    assert first == again and first["traced"] == "fake-cuda"
    stft_ops._idft_tables(512, "cpu")
    assert stft_ops._idft_tables.cache_info().currsize == 1


def test_per_pencil_mu_rides_the_op_as_a_tensor():
    from disco_tpu_torch.ops import mwf_ops

    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 3, 3)) + 1j * rng.standard_normal((6, 3, 3))
    R = torch.as_tensor(a @ a.conj().transpose(0, 2, 1) + 3 * np.eye(3), dtype=torch.complex64)
    mu = torch.linspace(0.5, 2.0, 6)
    got = mwf_ops.fused_mwf_kernel(R, R * 0.5 + torch.eye(3), mu=mu)
    want = mwf_ops.fused_mwf_plain(R, R * 0.5 + torch.eye(3), mu)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    schema = str(torch.ops.disco_torch.fused_mwf.default._schema)
    assert "Tensor? mu, float mu_value" in schema
