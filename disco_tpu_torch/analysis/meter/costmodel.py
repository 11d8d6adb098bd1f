"""The operator-walking cost model — FLOPs, device-memory traffic and live
bytes of the port's torch programs (counterpart of
``disco_tpu/analysis/meter/costmodel.py``, which walks jaxprs).

A report is a pure function of a recorded program (:mod:`~disco_tpu_torch.
analysis.trace.fingerprint`: traced for the card on fake tensors, no FLOP
runs), so the committed manifests rebuild bit-identically on any host.
The model is *declared*, not measured, and copies the JAX model's
conventions:

* **FLOPs** — products (``mm``, ``bmm``, ``addmm``, convolutions) count
  ``2·M·N·K``; an FFT ``5·N·log2 N`` per transform (a real transform's
  batch by the larger of its input and output, as the JAX model counts
  rfft); dense linear algebra the textbook cubics (Cholesky ``n³/3``,
  eigh ``12·n³``, triangular solve ``n²·m``, a general solve its LU
  ``2n³/3``); elementwise ops 1 flop per output element, transcendentals
  10, divisions 4, integer powers 2; reductions one flop per input
  element (a mean adds its division); a sort ``n·log2 n``.  Complex
  arithmetic scales as there: add ×2, multiply ×6, divide ×20, products
  and linear algebra ×4.
* **Traffic** (``traffic_bytes``) — the materialization model: every
  operator reads its operands from and writes its results to device
  memory once.  Views (``view``, ``permute``, ``select``, ``expand``, the
  lazy ``_conj``) move nothing in eager torch and cost 0, where the JAX
  model counts its reshapes and transposes.
* **Fused islands** — each hand-written kernel is one op
  (``disco_torch::*``): it contributes its boundary bytes and the flops
  :data:`KERNEL_COSTS` declares for its shapes — the one place the port
  states a kernel's cost (``chip_smoke.py`` phase 5 reads it).
* **Padded batches** — where the port pads a batch to a fixed size (the
  ``'power'`` and ``'eigh'`` solvers on the card,
  ``beam.filters._fixed_batches``), each operator of the batch counts its
  flops and traffic at the share of its rows that are the caller's
  (:func:`disco_tpu_torch.device.useful_share`): the padding is not the
  function's work.  Peak live bytes keep the padding, which is held.
* **Boundary bytes** (``hbm_bytes_in``/``hbm_bytes_out``) — the
  program's own inputs and outputs.
* **Peak live bytes** — a linear scan over the recorded order: inputs
  live from the start, a result from its op to its last use (views and
  in-place results add nothing).
* **Unmodeled ops** land in the ``unmodeled`` bucket with their names,
  counts and traffic share — never a silent zero; the meter gate holds
  that share under a declared ceiling (:mod:`.budgets`).
"""
from __future__ import annotations

import json
import math

#: bump when the report schema or the model's conventions change
VERSION = 1

#: views: no bytes move
_VIEW = frozenset((
    "_conj", "_unsafe_view", "alias", "detach", "diagonal", "expand", "permute", "select",
    "slice", "split", "split_with_sizes", "unsafe_split", "squeeze", "t", "transpose",
    "transpose_", "unbind", "unsqueeze", "view", "view_as_real", "view_as_complex",
    "lift_fresh", "as_strided", "_reshape_alias", "real", "imag", "narrow", "unfold",
    "expand_as", "view_as", "squeeze_", "unsqueeze_", "_neg_view", "conj", "chunk",
    "unsafe_chunk", "movedim", "swapaxes", "t_",
))
#: allocations that write nothing
_EMPTY = frozenset(("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"))
#: creations that write their result
_FILL = frozenset((
    "arange", "eye", "full", "full_like", "zeros", "zeros_like", "ones", "ones_like", "fill_",
    "zero_", "scalar_tensor", "new_zeros", "new_ones", "new_full", "linspace",
))
#: copies and layout changes (zero flops; the traffic is the point)
_MOVE = frozenset((
    "clone", "copy_", "cat", "stack", "constant_pad_nd", "reflection_pad1d", "flip", "roll",
    "repeat", "diag_embed", "tril", "triu", "_local_scalar_dense", "contiguous", "_copy_from",
    "_linalg_check_errors",
    "allreduce_", "allgather_", "allgather_into_tensor_coalesced", "broadcast_",
    "reduce_scatter_", "_allgather_base_", "send", "recv_", "pad",
))
_GATHER_SCATTER = frozenset((
    "index", "index_put_", "index_put", "index_select", "gather", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_add", "index_add_", "masked_select", "nonzero",
    "masked_scatter", "max_pool2d_with_indices_backward", "embedding",
))
#: 1 flop per output element (complex ×2)
_ELEMENTWISE_1 = frozenset((
    "add", "add_", "sub", "sub_", "rsub", "neg", "neg_", "abs", "sgn", "sign", "maximum",
    "minimum", "clamp", "clamp_", "clamp_min", "clamp_min_", "clamp_max", "clamp_max_", "floor",
    "ceil", "round", "trunc", "remainder", "fmod", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_and_",
    "bitwise_or", "bitwise_or_", "bitwise_not", "bitwise_xor", "where", "isfinite", "isnan",
    "isinf", "copysign", "nextafter", "masked_fill", "masked_fill_", "resolve_conj",
    "resolve_neg", "complex", "relu", "relu_", "threshold", "threshold_backward", "lerp",
    "polar", "square",
))
_MUL = frozenset(("mul", "mul_", "addcmul", "addcmul_"))
_DIV = frozenset(("div", "div_", "reciprocal", "reciprocal_", "addcdiv", "addcdiv_"))
#: 10 flops per output element (complex ×2)
_TRANSCENDENTAL = frozenset((
    "exp", "exp_", "exp2", "log", "log_", "log1p", "expm1", "sqrt", "sqrt_", "rsqrt", "rsqrt_",
    "sin", "sin_", "cos", "cos_", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "tanh", "tanh_", "asinh", "acosh", "atanh", "erf", "erfc", "erfinv", "sigmoid", "sigmoid_",
    "log_sigmoid", "softplus", "gelu", "lgamma", "digamma", "sinc", "angle", "pow_",
))
#: a product and a difference per element: d(sigmoid) = g·y·(1 − y), d(tanh) = g·(1 − y²)
_BACKWARD_3 = frozenset(("sigmoid_backward", "tanh_backward"))
#: one flop per INPUT element
_REDUCTION = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "all", "any", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "max_pool2d_with_indices",
    "max_pool2d", "std", "var", "var_mean", "std_mean", "norm",
))
_SORT = frozenset(("sort", "argsort", "topk", "msort"))
_RANDOM = frozenset((
    "rand", "randn", "randint", "randperm", "uniform_", "normal_", "bernoulli", "bernoulli_",
    "native_dropout", "rand_like", "randn_like",
))
_FFT = frozenset(("_fft_r2c", "_fft_c2r", "_fft_c2c"))
_DOT = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
                  "convolution", "_convolution", "cudnn_convolution", "convolution_backward"))
_LINALG = frozenset((
    "_linalg_eigh", "linalg_eigh", "linalg_cholesky_ex", "cholesky", "linalg_solve_triangular",
    "triangular_solve", "_linalg_solve_ex", "linalg_solve", "linalg_lu_factor_ex",
    "linalg_qr", "_linalg_svd", "linalg_inv_ex",
))


def base_name(name: str) -> str:
    """``'aten::add_.Tensor'`` -> ``'add_'``; ``'c10d::allreduce_'`` ->
    ``'allreduce_'``."""
    return name.split("::", 1)[-1].split(".", 1)[0]


# -- the hand-written kernels' declared costs --------------------------------
def stft_flops(rows: int, length: int, n_fft: int = 512, hop: int = 256,
               with_mag: bool = True) -> int:
    """Operations of the centered real STFT kernel (``csrc/stft.cu``): per
    frame the window, one real FFT (2.5 n log2 n, half those of a complex
    radix-2 FFT) and, with magnitudes, 4 a bin."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    per = n_fft + 2.5 * n_fft * math.log2(n_fft) + (4 * n_freq if with_mag else 0)
    return int(frames * per)


def stft_bf16_flops(rows: int, length: int, n_fft: int = 512, hop: int = 256,
                    with_mag: bool = True) -> int:
    """Operations of the bf16 STFT kernel (``csrc/stft_bf16.cu``) as the DFT
    product it is: per frame the window, the (n_fft × 2 n_freq) product (2
    a multiply-add) and, with magnitudes, 4 a bin."""
    n_freq = n_fft // 2 + 1
    frames = rows * (1 + length // hop)
    return int(frames * (n_fft + 2 * n_fft * 2 * n_freq + (4 * n_freq if with_mag else 0)))


def cov_flops(batch: int, D: int, F: int, T: int, chan: bool) -> int:
    """Operations of the masked covariance kernel (``csrc/cov.cu``): per
    frame and upper-triangle pair the complex product and two weighted
    sums (14), per-channel weights 6 more; a shared mask's weights 5 a
    frame."""
    pairs = D * (D + 1) // 2
    per_t = pairs * (14 + (6 if chan else 0)) + (0 if chan else 5)
    return batch * F * T * per_t


def jacobi_flops(C: int, sweeps: int) -> int:
    """Operations of ``sweeps`` cyclic Jacobi sweeps on one C × C Hermitian
    matrix with V: 48 C + 20 a rotation (its own ~20, then 16 per element
    of two rows, two columns and two V columns)."""
    return sweeps * (C * (C - 1) // 2) * (48 * C + 20)


def mwf_flops(n: int, C: int, sweeps: int) -> int:
    """Operations of the fused rank-1 GEVD-MWF kernel (``csrc/mwf.cu``),
    its chain counted per pencil, times ``n``."""
    f = 3 * C * C + 2 * C + 6                                  # traces, scale
    for j in range(C):                                           # Cholesky
        f += 4 * j + 3 + (C - 1 - j) * (8 * j + 2)
    f += sum(C * (8 * i + 2) for i in range(C))                  # B = L^-1 Rss
    f += sum(C * (8 * i + 3) for i in range(C)) + 4 * C * C      # M, re-hermitize
    f += jacobi_flops(C, sweeps)                                 # Jacobi
    f += C + 2 + sum(8 * (C - 1 - i) + 2 for i in range(C))      # max, clip, back-sub
    f += 6 + 12 * C                                              # filter formation
    return n * f


def eigh_flops(n: int, C: int, sweeps: int) -> int:
    """Operations of ``n`` fixed-sweep Jacobi eigensolves (``csrc/eigh.cu``)."""
    return n * jacobi_flops(C, sweeps)


def _stft_cost(ev, bf16=False):
    x = ev.ins[0]
    p = ev.params
    rows = math.prod(x.shape[:-1]) if len(x.shape) > 1 else 1
    fn = stft_bf16_flops if bf16 else stft_flops
    return fn(rows, x.shape[-1], p.get("n_fft", 512), p.get("hop", 256),
              bool(p.get("with_mag", True)))


def _cov_cost(ev):
    y, m = ev.ins[0], ev.ins[1]
    *lead, D, F, T = y.shape
    return cov_flops(math.prod(lead), D, F, T, len(m.shape) == len(y.shape))


def _mwf_cost(ev):
    rss = ev.ins[0]
    return mwf_flops(math.prod(rss.shape[:-2]), rss.shape[-1], int(ev.params["sweeps"]))


def _eigh_cost(ev):
    a = ev.ins[0]
    return eigh_flops(math.prod(a.shape[:-2]), a.shape[-1], int(ev.params["sweeps"]))


#: kernel op -> its declared flops as a function of the recorded call
KERNEL_COSTS = {
    "disco_torch::stft": _stft_cost,
    "disco_torch::stft_bf16": lambda ev: _stft_cost(ev, bf16=True),
    "disco_torch::masked_cov": _cov_cost,
    "disco_torch::fused_mwf": _mwf_cost,
    "disco_torch::eigh_jacobi": _eigh_cost,
}


# -- aten formulas -----------------------------------------------------------
def _cplx(info) -> int:
    return 2 if info is not None and info.is_complex else 1


def _first(infos):
    return infos[0] if infos else None


def _dot_flops(ev) -> tuple[int, int]:
    """``(2·out·K, bias)`` of one product (complex ×4): the product's flops,
    and the bias sum's (1 an output element), which the JAX model counts as
    a separate add."""
    name = base_name(ev.name)
    if name in ("convolution", "_convolution", "cudnn_convolution"):
        x, w = ev.ins[0], ev.ins[1]
        groups = int(ev.params.get("groups", 1) or 1)
        out = _first(ev.outs)
        k_spatial = math.prod(w.shape[2:]) or 1
        f = 2 * out.numel * k_spatial * w.shape[1] // max(groups, 1) * (4 if w.is_complex else 1)
        return f, (out.numel if len(ev.ins) > 2 else 0)
    if name == "convolution_backward":
        grad_out, x, w = ev.ins[0], ev.ins[1], ev.ins[2]
        groups = int(ev.params.get("groups", 1) or 1)
        mask = ev.params.get("output_mask") or (True, True, True)
        k_spatial = math.prod(w.shape[2:]) or 1
        fwd = 2 * grad_out.numel * k_spatial * w.shape[1] // max(groups, 1)
        return fwd * (int(bool(mask[0])) + int(bool(mask[1]))), (
            grad_out.numel if len(mask) > 2 and mask[2] else 0)
    a, b = ev.ins[-2], ev.ins[-1]
    out = _first(ev.outs)
    factor = 4 if (a.is_complex or b.is_complex) else 1
    k = a.shape[-1] if a.shape else 1
    bias = out.numel * _cplx(out) if name in ("addmm", "baddbmm", "addbmm", "addmv") else 0
    return 2 * out.numel * k * factor, bias


def _fft_flops(ev) -> int:
    """``5·N·log2 N`` per transform over the batch."""
    x, out = ev.ins[0], _first(ev.outs)
    dims = ev.params.get("dim") or [len(x.shape) - 1]
    if base_name(ev.name) == "_fft_c2r":
        n = math.prod(x.shape[d] for d in dims[:-1]) * int(ev.params["last_dim_size"])
    else:
        n = math.prod(x.shape[d] for d in dims)
    n = max(n, 1)
    batch = max(x.numel, out.numel) // n
    return int(5 * max(batch, 1) * n * max(math.log2(n), 1.0))


def _linalg_flops(ev) -> int:
    """Textbook cubics per matrix in the batch (complex ×4)."""
    name = base_name(ev.name)
    a = ev.ins[0]
    if len(a.shape) < 2:
        return 0
    n, m = a.shape[-1], a.shape[-2]
    batch = math.prod(a.shape[:-2]) or 1
    factor = 4 if a.is_complex else 1
    if name in ("linalg_cholesky_ex", "cholesky"):
        per = n * n * n // 3
    elif name in ("_linalg_eigh", "linalg_eigh"):
        per = 12 * n * n * n
    elif name in ("linalg_solve_triangular", "triangular_solve"):
        b = ev.ins[1] if name == "linalg_solve_triangular" else ev.ins[0]
        if name == "triangular_solve":       # (self=B, A)
            n = ev.ins[1].shape[-1]
            factor = 4 if ev.ins[1].is_complex else 1
        per = n * n * (b.shape[-1] if b.shape else 1)
        batch = math.prod(b.shape[:-2]) or 1
    elif name in ("_linalg_solve_ex", "linalg_solve", "linalg_lu_factor_ex"):
        per = 2 * n * n * n // 3
    elif name == "linalg_qr":
        per = 2 * m * n * n
    else:
        per = 12 * m * n * n
    return batch * per * factor


def _pow_flops(ev, out_elems: int, cplx: int) -> int:
    e = ev.params.get("exponent")
    if isinstance(e, (int, float)) and float(e).is_integer():
        return out_elems * 2 * cplx
    return out_elems * 10 * cplx


def op_cost(ev) -> tuple[list, bool]:
    """``([(class, flops), ...], moves_bytes)`` of one recorded operator;
    ``([('unmodeled', 0)], True)`` when the model has no entry for it."""
    if ev.name in KERNEL_COSTS:
        return [("kernel", KERNEL_COSTS[ev.name](ev))], True
    name = base_name(ev.name)
    foreach = name.startswith("_foreach_")
    if foreach:
        name = name[len("_foreach_"):]
    out = _first(ev.outs)
    if foreach:
        elems = sum(t.numel for t in ev.ins[:ev.first])
        cplx = 1
    else:
        elems = out.numel if out is not None else 0
        cplx = _cplx(out)
    if name in _VIEW or name in _EMPTY:
        return [("data_movement", 0)], False
    if name in _FILL or name in _MOVE:
        return [("data_movement", 0)], True
    if name == "_to_copy":
        src = ev.ins[0]
        return [("convert" if out is not None and src.dtype != out.dtype
                 else "data_movement", 0)], True
    if name in _GATHER_SCATTER:
        return [("gather_scatter", 0)], True
    if name in _ELEMENTWISE_1:
        return [("elementwise", elems * cplx)], True
    if name in _MUL:
        return [("elementwise", elems * (6 if cplx == 2 else 1))], True
    if name in _DIV:
        return [("elementwise", elems * (20 if cplx == 2 else 4))], True
    if name == "pow":
        return [("elementwise", _pow_flops(ev, elems, cplx))], True
    if name in _TRANSCENDENTAL:
        return [("elementwise", elems * 10 * cplx)], True
    if name in _BACKWARD_3:
        return [("elementwise", 3 * elems)], True
    if name in _REDUCTION:
        inp = _first(ev.ins)
        f = [("reduction", (inp.numel if inp is not None else 0) * cplx)]
        if name == "mean":
            f.append(("elementwise", elems * (20 if cplx == 2 else 4)))
        return f, True
    if name == "linalg_vector_norm":
        inp = _first(ev.ins)
        return [("elementwise", 2 * inp.numel * _cplx(inp) + 10 * elems),
                ("reduction", inp.numel)], True
    if name in _SORT:
        inp = _first(ev.ins)
        n = inp.numel if inp is not None else 0
        return [("reduction", int(n * max(math.log2(max(n, 2)), 1.0)))], True
    if name in _RANDOM:
        return [("random", elems * 100)], True
    if name in _FFT:
        return [("fft", _fft_flops(ev))], True
    if name in _DOT:
        f, bias = _dot_flops(ev)
        return [("dot_general", f)] + ([("elementwise", bias)] if bias else []), True
    if name in _LINALG:
        return [("linalg", _linalg_flops(ev))], True
    return [("unmodeled", 0)], True


class _Acc:
    def __init__(self):
        self.flops: dict[str, int] = {}
        self.traffic: dict[str, int] = {}
        self.unmodeled: dict[str, int] = {}
        self.islands: dict[str, dict] = {}

    def add(self, cls: str, flops: int, traffic: int) -> None:
        self.flops[cls] = self.flops.get(cls, 0) + int(flops)
        self.traffic[cls] = self.traffic.get(cls, 0) + int(traffic)


def _boundary(ev) -> int:
    return sum(t.nbytes for t in ev.ins) + sum(t.nbytes for t in ev.outs)


def _peak_live_bytes(trace) -> int:
    """Linear-scan high-water mark of live tensor bytes over the recorded
    order (views and in-place results alias what they view)."""
    n = len(trace.events)
    last: dict[int, int] = {}
    for pos, ev in enumerate(trace.events):
        for t in ev.ins:
            last[t.tid] = pos
    keep = {t.tid for t in trace.outputs}
    live = {t.tid: t.nbytes for t in trace.inputs}
    peak = sum(live.values())
    for pos, ev in enumerate(trace.events):
        aliasing = base_name(ev.name) in _VIEW
        for t in ev.outs:
            if t.tid not in live:
                live[t.tid] = 0 if aliasing else t.nbytes
        peak = max(peak, sum(live.values()))
        for t in ev.ins:
            if t.tid in live and last.get(t.tid, n) <= pos and t.tid not in keep:
                del live[t.tid]
    return int(peak)


def cost_of_trace(trace, program: str = "") -> dict:
    """Cost report of one recorded program (the manifest payload)."""
    acc = _Acc()
    for ev in trace.events:
        parts, moves = op_cost(ev)
        traffic = _boundary(ev) if moves else 0
        if ev.share != 1.0:
            parts = [(cls, round(f * ev.share)) for cls, f in parts]
            traffic = round(traffic * ev.share)
        if parts[0][0] == "kernel":
            acc.add("data_movement", 0, traffic)
            isl = acc.islands.setdefault(ev.name, {"calls": 0, "flops": 0, "bytes": 0})
            isl["calls"] += 1
            isl["flops"] += int(parts[0][1])
            isl["bytes"] += traffic
            acc.add("kernel", parts[0][1], 0)
            continue
        if parts[0][0] == "unmodeled":
            acc.unmodeled[ev.name] = acc.unmodeled.get(ev.name, 0) + 1
        for i, (cls, flops) in enumerate(parts):
            acc.add(cls, flops, traffic if i == 0 else 0)
    flops = sum(acc.flops.values())
    traffic = sum(acc.traffic.values())
    unmodeled_traffic = acc.traffic.get("unmodeled", 0)
    return {
        "version": VERSION,
        "program": program,
        "traced": trace.traced,
        "flops": int(flops),
        "flops_by_class": {k: v for k, v in sorted(acc.flops.items()) if v},
        "traffic_bytes": int(traffic),
        "traffic_by_class": {k: v for k, v in sorted(acc.traffic.items()) if v},
        "hbm_bytes_in": int(sum(t.nbytes for t in trace.inputs)),
        "hbm_bytes_out": int(sum(t.nbytes for t in trace.outputs)),
        "peak_live_bytes": _peak_live_bytes(trace),
        "arithmetic_intensity": round(flops / traffic, 6) if traffic else None,
        "fused_islands": sorted(acc.islands),
        "islands": {k: acc.islands[k] for k in sorted(acc.islands)},
        "n_eqns": len(trace.events),
        "unmodeled": {
            "primitives": dict(sorted(acc.unmodeled.items())),
            "traffic_bytes": int(unmodeled_traffic),
            "traffic_fraction": round(unmodeled_traffic / traffic, 6) if traffic else 0.0,
        },
    }


def cost_of_fn(fn, args, kwargs=None, program: str = "") -> dict:
    """Trace ``fn(*args, **kwargs)`` (``args`` with
    :class:`~disco_tpu_torch.analysis.trace.fingerprint.Struct` leaves) for
    the card on fake tensors and cost it."""
    from disco_tpu_torch.analysis.trace.fingerprint import trace_program

    trace = trace_program(lambda dev: (fn, args, kwargs or {}))
    return cost_of_trace(trace, program)


def cost_of_spec(spec, device: str = "cuda") -> dict:
    """Cost report of one catalog program, traced as the trace gate traces
    it."""
    from disco_tpu_torch.analysis.trace.fingerprint import trace_program

    with spec.context(device):
        trace = trace_program(spec.build, device, real_because=spec.real_because)
    return cost_of_trace(trace, spec.name)


def kernel_cost(fn, *args, **kwargs) -> tuple[int, int]:
    """``(flops, bytes)`` of one kernel wrapper call, by the declared cost
    of its op and its boundary bytes, traced on fake tensors of ``args``'
    shapes (tensor arguments become declared inputs; nothing launches)."""
    import torch

    from disco_tpu_torch.analysis.trace.fingerprint import Struct

    structs = tuple(Struct(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                    for a in args)
    rep = cost_of_fn(fn, structs, kwargs)
    isl = rep["islands"]
    return (sum(v["flops"] for v in isl.values()), sum(v["bytes"] for v in isl.values()))


def diff_reports(golden: dict, current: dict) -> list:
    """Readable per-class / per-op cost differences, empty when identical."""
    if golden.get("version") != current.get("version"):
        return [f"cost-model version {golden.get('version')} != {current.get('version')}: "
                "regenerate manifests with `disco-torch-meter --update`"]
    out: list[str] = []
    for key, unit in (("flops", "flops"), ("traffic_bytes", "bytes"),
                      ("hbm_bytes_in", "bytes"), ("hbm_bytes_out", "bytes"),
                      ("peak_live_bytes", "bytes"), ("n_eqns", "ops")):
        a, b = golden.get(key), current.get(key)
        if a != b:
            rel = f" ({(b - a) / a:+.1%})" if a else ""
            out.append(f"{key}: {a} -> {b} {unit}{rel}")
    for table in ("flops_by_class", "traffic_by_class"):
        ga, cu = golden.get(table, {}), current.get(table, {})
        for cls in sorted(set(ga) | set(cu)):
            a, b = ga.get(cls, 0), cu.get(cls, 0)
            if a != b:
                out.append(f"{table}[{cls}]: {a} -> {b} ({b - a:+d})")
    gu = (golden.get("unmodeled") or {}).get("primitives", {})
    cuu = (current.get("unmodeled") or {}).get("primitives", {})
    for prim in sorted(set(gu) | set(cuu)):
        a, b = gu.get(prim, 0), cuu.get(prim, 0)
        if a != b:
            out.append(f"unmodeled op {prim}: {a} -> {b} ({b - a:+d})")
    if golden.get("islands") != current.get("islands"):
        out.append(f"fused islands: {golden.get('islands')} -> {current.get('islands')} (a lost "
                   "island re-exposes its interior traffic)")
    return out


def dumps(report: dict) -> str:
    """Canonical JSON text of one report (sorted keys, indented)."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
