"""``disco_tpu_torch.analysis.meter`` and ``obs.roofline`` — the port's cost
model held to the JAX package's meter (read through the ``jit``→``pjit``
proxy of ``torch_port_helpers``): single-op flops and every catalog
program's boundary bytes exactly; the per-class and island flops side by
side, each ratio that is not 1 pinned with its reason; the gates made to
fail by the change they exist for; the manifests rebuilt bit-identically;
the roofline's verdict boundaries."""
from __future__ import annotations

import functools
import json

import pytest
import torch

from disco_tpu_torch.analysis.meter import budgets, check, cli, costmodel, stages
from disco_tpu_torch.analysis.trace.fingerprint import Struct
from disco_tpu_torch.analysis.trace.programs import PROGRAMS, _step2
from disco_tpu_torch.obs import roofline
from tests.torch_port_helpers import jax_meter


def _port_cost(fn, *structs):
    return costmodel.cost_of_fn(fn, structs)


def _jax_cost(fn, *shapes):
    import jax

    return jax_meter(jax.make_jaxpr(fn)(*shapes))


def _jshape(s: Struct):
    import jax
    import jax.numpy as jnp

    return jax.ShapeDtypeStruct(s.shape, {torch.float32: jnp.float32,
                                          torch.complex64: jnp.complex64}[s.dtype])


def _single_ops():
    import jax
    import jax.numpy as jnp

    f32 = lambda *s: Struct(s, torch.float32)      # noqa: E731
    c64 = lambda *s: Struct(s, torch.complex64)    # noqa: E731
    spd = lambda a: a @ a.mT + 4 * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)  # noqa: E731,E501
    # (torch fn, jax fn, inputs, the class compared or None for the total)
    return {
        "real product": (lambda a, b: a @ b, lambda a, b: a @ b, (f32(3, 4, 5), f32(3, 5, 6)),
                         None),
        "complex product": (lambda a, b: a @ b, lambda a, b: a @ b,
                            (c64(3, 4, 5), c64(3, 5, 6)), None),
        "einsum": (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                   lambda a, b: jnp.einsum("bij,bjk->bik", a, b), (c64(3, 4, 5), c64(3, 5, 6)),
                   None),
        "fft": (torch.fft.fft, jnp.fft.fft, (c64(7, 64),), None),
        "rfft": (torch.fft.rfft, jnp.fft.rfft, (f32(7, 64),), None),
        # eigh / Cholesky: the factorization's class (the JAX wrappers
        # symmetrize their input first, elementwise)
        "eigh": (torch.linalg.eigh, jnp.linalg.eigh, (c64(5, 4, 4),), "linalg"),
        "cholesky": (lambda a: torch.linalg.cholesky(a), jnp.linalg.cholesky, (c64(5, 4, 4),),
                     "linalg"),
        # a general solve is its LU cubic in both (the JAX model leaves the
        # substitutions inside an unmodeled custom_linear_solve)
        "solve": (torch.linalg.solve, jnp.linalg.solve, (f32(5, 4, 4), f32(5, 4, 3)), "linalg"),
        "triangular solve": (
            lambda a, b: torch.linalg.solve_triangular(a, b, upper=False),
            lambda a, b: jax.scipy.linalg.solve_triangular(a, b, lower=True),
            (f32(5, 4, 4), f32(5, 4, 3)), None),
        "complex add": (torch.add, jnp.add, (c64(3, 4), c64(3, 4)), None),
        "complex multiply": (torch.mul, jnp.multiply, (c64(3, 4), c64(3, 4)), None),
        "divide": (torch.div, jnp.divide, (f32(3, 4), f32(3, 4)), None),
        "sqrt": (torch.sqrt, jnp.sqrt, (f32(3, 4),), None),
        "complex exp": (torch.exp, jnp.exp, (c64(3, 4),), None),
        "complex abs": (torch.abs, jnp.abs, (c64(3, 4),), None),
        "sigmoid": (torch.sigmoid, jax.nn.sigmoid, (f32(3, 4),), None),
        "where": (lambda a, b: torch.where(a > 0, a, b), lambda a, b: jnp.where(a > 0, a, b),
                  (f32(3, 4), f32(3, 4)), None),
        "complex sum": (lambda a: a.sum(-1), lambda a: a.sum(-1), (c64(3, 4),), None),
        "max": (lambda a: a.amax(0), lambda a: a.max(0), (f32(3, 4),), None),
        "mean": (lambda a: a.mean(-1), lambda a: a.mean(-1), (f32(3, 4),), None),
        "square": (lambda a: a ** 2, lambda a: a ** 2, (f32(3, 4),), None),
        "spd": (spd, lambda a: a @ a.mT + 4 * jnp.eye(a.shape[-1], dtype=a.dtype),
                (f32(2, 3, 3),), "dot_general"),
    }


@pytest.mark.parametrize("op", list(_single_ops()))
def test_single_op_flops_equal_the_jax_meter(op):
    tfn, jfn, structs, cls = _single_ops()[op]
    port = _port_cost(tfn, *structs)
    jx = _jax_cost(jfn, *map(_jshape, structs))
    if cls is None:
        assert port["flops"] == jx["flops"] > 0, (port["flops_by_class"], jx["flops_by_class"])
    else:
        assert port["flops_by_class"][cls] == jx["flops_by_class"][cls] > 0
    assert port["unmodeled"]["primitives"] == {}


# ------------------------------------------------------- the catalog
@functools.lru_cache(maxsize=None)
def _jax_report(name: str) -> dict:
    """The JAX catalog program costed by the JAX meter, its kernels pinned
    to their Pallas lanes so that both sides have islands in the same
    places."""
    import jax

    from disco_tpu.analysis.trace.programs import PROGRAMS as JAX_PROGRAMS

    fn, args, kwargs = JAX_PROGRAMS[name].build()
    pins = {"cov_impl": {"xla": "pallas"}, "stft_impl": {"xla": "pallas"},
            "solver": {"fused-xla": "fused-pallas"}}
    kw = {k: pins.get(k, {}).get(v, v) for k, v in kwargs.items()}
    return jax_meter(jax.make_jaxpr(lambda *a: fn(*a, **kw))(*args), program=name)


def _port_report(name: str) -> dict:
    return check.load_golden(name)


#: the only boundary that differs: the train state (bytes, port − JAX)
BOUNDARY_DIFFERS = {
    "train_step": (60, 60, "torch's GRU keeps a hidden bias for all three gates where flax's "
                           "GRUCell has one for the candidate gate alone (2 × 4 floats, in the "
                           "parameters and in nu: +64 bytes), and the state holds BatchNorm's "
                           "int64 num_batches_tracked (+8) where the JAX state holds the int32 "
                           "step and the uint32[2] dropout key (−12)"),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_boundary_bytes_equal_the_jax_meter(name):
    port, jx = _port_report(name), _jax_report(name)
    d_in, d_out, _why = BOUNDARY_DIFFERS.get(name, (0, 0, ""))
    assert port["hbm_bytes_in"] - jx["hbm_bytes_in"] == d_in
    assert port["hbm_bytes_out"] - jx["hbm_bytes_out"] == d_out


#: why a per-class ratio (port / JAX) is not 1
RATIO_REASONS = {
    "apply": "the port applies the (F, C) filters as a product and a channel sum (batch-"
             "invariant on the card), where the JAX package's einsum is a dot_general",
    "island": "inside a kernel the JAX meter files the Pallas body's products under their "
              "classes (the STFT's DFT product under dot_general); the port files a kernel's "
              "declared cost under 'kernel'",
    "istft": "the port's ISTFT is two products against the inverse-DFT tables "
             "(istft_matmul), the JAX package's an irfft",
    "xla_lane": "the JAX catalog's closure pins the 'fused-xla' solve (and there the 'xla' "
                "STFT): its Cholesky, products and rfft are XLA ops outside any island, where "
                "the port's run inside its kernels",
    "scene": "the JAX scene factory's STFT resolves per backend to its XLA rfft on the CPU "
             "(691,200 fft flops); the port's is the STFT kernel",
    "runner_cov": "the JAX corpus runner's closure has no cov_impl to pin: its covariances "
                  "are XLA products (dot_general) on the CPU, where the port's are the "
                  "covariance kernel; its filters are applied as in 'apply'",
    "crnn": "torch's GRU multiplies the hidden state by one (3H × H) matrix and the input by "
            "one (3H × I), flax's GRUCell by three of each; the same products, grouped "
            "otherwise, with bias adds counted apart",
}


def _ratio(p: int, j: int):
    if p == j:
        return 1.0
    return float("inf") if j == 0 else round(p / j, 4)


def test_per_class_flops_side_by_side():
    rows, got = [], {}
    for name in PROGRAMS:
        port, jx = _port_report(name), _jax_report(name)
        for cls in ("fft", "dot_general", "linalg"):
            p, j = port["flops_by_class"].get(cls, 0), jx["flops_by_class"].get(cls, 0)
            rows.append(f"{name:<22} {cls:<12} port {p:>12,d}  jax {j:>12,d}")
            if p != j:
                got[(name, cls)] = _ratio(p, j)
    print("\n".join(rows))
    assert set(got) == set(PINNED_RATIOS), sorted(set(got) ^ set(PINNED_RATIOS))
    for key, (ratio, reason) in PINNED_RATIOS.items():
        assert got[key] == ratio, (key, got[key])
        assert reason in RATIO_REASONS


#: (program, class) -> (port / JAX, reason key); a pair absent is equal
PINNED_RATIOS: dict = {
    ("tango_step1", "dot_general"): (0.403, "apply"),
    ("tango_step2", "dot_general"): (0.625, "apply"),
    ("tango_step2_fused", "dot_general"): (0.0, "apply"),
    ("tango_step2_eigh", "dot_general"): (0.1111, "apply"),
    ("tango_step1_fused", "dot_general"): (0.0, "xla_lane"),
    ("tango_step1_fused", "linalg"): (0.0, "xla_lane"),
    ("tango_step1_eigh", "dot_general"): (0.0222, "apply"),
    ("tango_clip_fused", "fft"): (0.0, "istft"),
    ("tango_clip_fused", "dot_general"): (0.0777, "island"),
    ("streaming_clip_fused", "fft"): (0.0, "xla_lane"),
    ("streaming_clip_fused", "dot_general"): (7.2857, "istft"),
    ("streaming_clip_fused", "linalg"): (0.0, "xla_lane"),
    ("streaming_tango", "dot_general"): (0.6647, "apply"),
    ("streaming_tango_state", "dot_general"): (0.6647, "apply"),
    ("streaming_tango_scan", "dot_general"): (0.6647, "apply"),
    ("scene_batch", "fft"): (0.8202, "scene"),
    ("train_step", "dot_general"): (0.9804, "crnn"),
    ("run_batch", "dot_general"): (0.2834, "runner_cov"),
    ("run_batch_with_masks", "dot_general"): (0.2834, "runner_cov"),
}


@pytest.mark.parametrize("solver", ["power", "eigh"])
def test_padded_batches_cost_the_callers_pencils(solver):
    """On the card the 'power' and 'eigh' solvers pad their pencils to a
    fixed batch; the meter counts those batches' operators at the share of
    their rows that are the caller's, so the card route's products and
    factorizations cost what the unpadded CPU route's do."""
    from disco_tpu_torch.beam.filters import rank1_gevd
    from disco_tpu_torch.analysis.trace.fingerprint import trace_program

    R = Struct((3, 5, 4, 4), torch.complex64)
    prog = lambda dev: (lambda a, b: rank1_gevd(a, b, solver=solver), (R, R), {})  # noqa: E731
    card = costmodel.cost_of_trace(trace_program(prog, "cuda"))
    host = costmodel.cost_of_trace(trace_program(prog, "cpu"))
    for cls in ("dot_general", "linalg"):
        assert card["flops_by_class"].get(cls, 0) == host["flops_by_class"].get(cls, 0), cls
    assert card["flops_by_class"]["linalg"] > 0
    # the padding stays held while it lives
    assert card["peak_live_bytes"] > 100 * host["peak_live_bytes"]


# ------------------------------------------------------- islands
def _island_cases():
    return {
        # one Pallas tile each, so the JAX interior count is the whole call
        "masked_cov": ("cov", ((1, 2, 128, 256), (1, 128, 256))),
        "masked_cov per-channel": ("cov", ((1, 3, 128, 256), (1, 3, 128, 256))),
        "fused_mwf": ("mwf", ((512, 4, 4),)),
        "eigh_jacobi": ("eigh", ((512, 4, 4),)),
        "stft": ("stft", ((1, 32512),)),
    }


def _pallas_calls(jaxpr):
    for e in jaxpr.eqns:
        if e.primitive.name.startswith("pallas_call"):
            yield e
            continue
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _pallas_calls(inner)


#: kernel -> (port's declared flops / JAX interior flops, reason)
ISLAND_RATIOS = {
    "masked_cov": (0.998506, "the JAX body adds its tile's mask-weight and guard equations "
                             "(2,305 flops a tile) to the same per-pair products and sums"),
    "masked_cov per-channel": (0.998634, "as masked_cov: the tile's weight equations"),
    "fused_mwf": (0.434396, "the JAX meter counts every real-plane equation of the Pallas "
                            "body at one flop an element, the rotation's selects, compares "
                            "and guards too; the declared cost counts the chain's float "
                            "operations once (48 C + 20 a rotation)"),
    "eigh_jacobi": (0.417241, "as fused_mwf: the Jacobi sweeps' selects and guards are "
                              "equations the JAX meter counts, the declared cost does not"),
    "stft": (0.022838, "a real FFT (2.5 n log2 n a frame) against the TPU kernel's DFT "
                       "product (2 · 512 · 514 a frame), as the kernels line records it"),
}


@pytest.mark.parametrize("case", list(ISLAND_RATIOS))
def test_island_flops_beside_the_jax_interior(case):
    import jax
    import jax.numpy as jnp

    from disco_tpu.ops.cov_ops import masked_cov_pallas
    from disco_tpu.ops.eigh_ops import eigh_jacobi_pallas
    from disco_tpu.ops.mwf_ops import fused_mwf_pallas
    from disco_tpu.ops.stft_ops import stft_pallas
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    kind, shapes = _island_cases()[case]
    c64, f32 = jnp.complex64, jnp.float32
    S = jax.ShapeDtypeStruct
    if kind == "cov":
        jf, jargs = (lambda y, m: masked_cov_pallas(y, m, interpret=True),
                     (S(shapes[0], c64), S(shapes[1], f32)))
        tf, targs = cov_ops.masked_cov_kernel, (Struct(shapes[0], torch.complex64),
                                                Struct(shapes[1], torch.float32))
    elif kind == "mwf":
        jf, jargs = (lambda a, b: fused_mwf_pallas(a, b, interpret=True),
                     (S(shapes[0], c64),) * 2)
        tf, targs = mwf_ops.fused_mwf_kernel, (Struct(shapes[0], torch.complex64),) * 2
    elif kind == "eigh":
        jf, jargs = (lambda a: eigh_jacobi_pallas(a, interpret=True), (S(shapes[0], c64),))
        tf, targs = eigh_ops.eigh_jacobi_kernel, (Struct(shapes[0], torch.complex64),)
    else:
        jf, jargs = (lambda x: stft_pallas(x, interpret=True), (S(shapes[0], f32),))
        tf, targs = stft_ops.stft_kernel, (Struct(shapes[0], torch.float32),)
    closed = jax.make_jaxpr(jf)(*jargs)
    calls = list(_pallas_calls(closed.jaxpr))
    assert len(calls) == 1
    interior = jax_meter(calls[0].params["jaxpr"])["flops"]
    port = costmodel.cost_of_fn(tf, targs)
    (island,) = port["islands"].values()
    assert island["calls"] == 1
    ratio, reason = ISLAND_RATIOS[case]
    print(f"{case}: declared {island['flops']:,d}  JAX interior {interior:,d}")
    assert round(island["flops"] / interior, 6) == ratio, island["flops"] / interior
    assert reason


# ------------------------------------------------------- the gate
def test_meter_gate_clean_and_manifests_rebuild_bit_identically(tmp_path):
    res = check.run_checks(update=True, golden_dir=tmp_path)
    assert res.clean and sorted(res.updated) == sorted(PROGRAMS)
    for name in PROGRAMS:
        assert (tmp_path / f"{name}.json").read_bytes() == check.golden_path(name).read_bytes()
    # against the committed manifests, with the reports just made
    clean = check.run_checks(reports=res.reports)
    assert clean.clean, check.format_text(clean)
    payload = json.loads(check.format_json(res))
    assert payload["clean"] is True and payload["counts"]["programs"] == 15
    # the cross budgets hold in the port
    assert budgets.check_cross(res.reports) == []
    for small, large, key, _ in budgets.CROSS_BUDGETS:
        assert res.reports[small][key] < res.reports[large][key]
    # registry sync: a stale manifest and a missing one
    (tmp_path / "gone.json").write_text("{}")
    (tmp_path / "tango_step1.json").unlink()
    res = check.run_checks(golden_dir=tmp_path, reports=res.reports)
    assert {(f["program"], f["check"]) for f in res.findings} == {
        ("gone", "registry"), ("tango_step1", "golden"), ("tango_step1", "registry")}


def test_an_unmodeled_op_past_the_ceiling_fails(tmp_path):
    rep = _port_cost(lambda a: torch.special.bessel_j0(a) + a, Struct((64,), torch.float32))
    assert rep["unmodeled"]["primitives"] == {"aten::special_bessel_j0": 1}
    assert rep["unmodeled"]["traffic_fraction"] > budgets.UNMODELED_FRACTION_MAX
    rep["program"] = "tango_step2_fused"
    res = check.run_checks(update=True, programs={"tango_step2_fused"}, golden_dir=tmp_path,
                           reports={"tango_step2_fused": rep})
    assert {f["check"] for f in res.findings} == {"budget", "golden"}
    assert not (tmp_path / "tango_step2_fused.json").exists()
    assert "special_bessel_j0" in res.findings[0]["message"]


def test_the_solver_unfused_trips_the_cross_budget(tmp_path):
    reports = {n: json.loads(check.golden_path(n).read_text()) for n in PROGRAMS}
    unfused = costmodel.cost_of_spec(
        PROGRAMS["tango_step2_fused"].__class__("tango_step2_fused", "", _step2("eigh")))
    reports["tango_step2_fused"] = unfused
    msgs = budgets.check_cross(reports)
    assert len(msgs) == 1 and msgs[0].startswith("cross-budget violated: tango_step2_fused")
    res = check.run_checks(reports=reports)
    assert {f["check"] for f in res.findings} == {"manifest", "cross"}
    del reports["tango_step1_eigh"]
    assert "missing from the run" in budgets.check_cross(reports)[-1]


def test_cli(capsys):
    assert cli.main(["--list"]) == 0
    assert "train_step" in capsys.readouterr().out
    assert cli.main(["--program", "nope"]) == 2
    assert cli.main(["--program", "tango_step2_fused"]) == 0
    assert "tango_step2_fused" in capsys.readouterr().out


# ------------------------------------------------------- stages, roofline
def test_stage_keys_and_small_workload_costs():
    from disco_tpu.analysis.meter.stages import STAGE_KEYS as JAX_KEYS

    assert stages.STAGE_KEYS == JAX_KEYS
    w = stages.Workload(batch=1, dur_s=0.5, n_nodes=2, mics_per_node=2)
    c = stages.offline_stage_costs(w)
    assert tuple(c) == stages.STAGE_KEYS
    assert all(v["flops"] > 0 and v["traffic_bytes"] > 0 for v in c.values())
    full = costmodel.cost_of_fn(*stages.stage_programs(w)["tango_full"])
    assert c["step2_exchange_mwf"]["flops"] == full["flops"] - c["step1_local_mwf"]["flops"]
    # the streaming lanes, per window and per block, at the JAX bench lanes'
    # shapes cut in duration (the scan's block shrinks to fit, as there)
    scan = stages.streaming_scan_cost(dur_s=0.6, n_nodes=2, mics_per_node=2)
    assert (scan["block_frames"], scan["window_frames"]) == (4, 32) and scan["flops"] > 0
    assert stages.streaming_scan_cost(dur_s=0.1) is None
    block = stages.serve_block_cost(n_nodes=2)
    assert block["block_frames"] == 16 and block["flops"] > 0 and block["traffic_bytes"] > 0


def _record(stage_ms):
    return {"metric": "rtf", "stage_ms": stage_ms,
            "workload": {"batch": 1, "dur_s": 1.0, "fs": 16000, "n_nodes": 2,
                         "mics_per_node": 2}}


def test_roofline_verdict_boundaries():
    costs = {"stft_x3": {"flops": 67e9, "traffic_bytes": 1e6},       # 1 ms at the FP32 roof
             "masks": {"flops": 1e6, "traffic_bytes": 3.35e9},       # 1 ms at the HBM roof
             "istft": {"flops": 67e9 * 0.0099, "traffic_bytes": 1.0},
             "chained_clip": {"flops": 67e9 * 0.01, "traffic_bytes": 1.0}}
    for c in costs.values():
        c["arithmetic_intensity"] = c["flops"] / c["traffic_bytes"]
    res = roofline.stage_verdicts(_record({"stft_x3": 1.0, "masks": 1.0, "istft": 1.0,
                                           "chained_clip": 1.0, "full_pipeline": 5.0}),
                                  costs=costs)
    rows = {r["stage"]: r for r in res["rows"]}
    assert set(rows) == set(costs)                     # no modeled cost: no row
    assert rows["stft_x3"]["verdict"] == "compute-bound"
    assert rows["stft_x3"]["fraction_of_peak"] == 1.0
    assert rows["masks"]["verdict"] == "bandwidth-bound"
    assert rows["istft"]["verdict"] == "dispatch-bound"      # below 1 % of peak
    assert rows["chained_clip"]["verdict"] == "compute-bound"  # at 1 %
    assert res["peaks"] == {"tflops": 67.0, "gbps": 3350.0, "card": "NVIDIA H100 80GB HBM3",
                            "power_limit_w": 700.0}
    assert not res["workload_assumed"]
    text = roofline.render(res)
    assert "NVIDIA H100 80GB HBM3 at 700 W" in text and "dispatch-bound" in text
    assert roofline.workload_of_record({})[1] is True
    assert (roofline.PEAK_FP32, roofline.PEAK_BF16, roofline.PEAK_BYTES) == (67e12, 989e12,
                                                                             3.35e12)
