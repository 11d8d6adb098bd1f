"""Structural fingerprints of the port's torch programs — the identity of
a program (counterpart of ``disco_tpu/analysis/trace/fingerprint.py``,
which reads jaxprs).

A torch program has no jaxpr: it is the sequence of operators it
dispatches.  :class:`Recorder` (a ``TorchDispatchMode``) writes that
sequence down as the program runs, each operator with the shapes, dtypes
and devices of what it reads and writes.  Each hand-written kernel is one
named op (``disco_torch::stft``, ``::stft_bf16``, ``::masked_cov``,
``::fused_mwf``, ``::eigh_jacobi``): the recorder sees it as one operator,
with its operands, a boundary and a body it does not enter — the part
``pallas_call`` plays in a jaxpr.

By default a program is traced **for the card**: its inputs are fake
``cuda`` tensors under ``FakeTensorMode``, every operator runs its shape
function only, and no card is needed.  A program that reads a value back
(``.item()``, a branch on a tensor) cannot go on under fake tensors; it is
traced on real tensors at the catalog's shapes instead, and its
fingerprint says so (``traced``) and names the read that stopped the fake
trace (``readback``).  ``device='cpu'`` traces the CPU route (the kernels'
plain versions inside the same named ops).

A fingerprint holds:

* the input/output signature (``in_avals``/``out_avals``,
  ``'complex64[2,5,8]'``),
* the **operator multiset** and a **sequence hash** over the recorded
  order,
* each **kernel op** and how many times it is called,
* the **host syncs**: scalar reads (``aten::_local_scalar_dense``) and
  device-to-host copies — the counterpart of the JAX fingerprint's host
  callbacks,
* the **float64/complex128 tensors on the device** (none allowed unless
  declared, :mod:`.audits`) and the count of dtype-preserving
  ``aten::_to_copy`` calls (copy churn).

Operator names and counts move with the torch version, as primitive names
moved with jax's (``pjit`` became ``jit`` in jax 0.9).  Each fingerprint
records the torch version it was made on; a golden of another version is
reported as "regenerate with ``--update``", not as a program drift.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from disco_tpu_torch.device import useful_share

#: bump when the fingerprint schema changes incompatibly
VERSION = 1

#: the namespace of the hand-written kernels' ops
KERNEL_NAMESPACE = "disco_torch"

#: dtypes that must not appear on the device in the float32 pipeline
BANNED_DTYPES = ("float64", "complex128")

#: the scalar read that waits for the device (``.item()``, ``bool(t)``)
SCALAR_READ = "aten::_local_scalar_dense"


def torch_version() -> str:
    """The torch release a fingerprint is made on (local build tag cut)."""
    return torch.__version__.split("+")[0]


@dataclasses.dataclass(frozen=True)
class Struct:
    """A declared program input: shape and dtype, no values (the
    ``jax.ShapeDtypeStruct`` of the catalog)."""

    shape: tuple
    dtype: torch.dtype


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``'float32'``."""
    return str(dtype).removeprefix("torch.")


def op_name(func) -> str:
    """``'aten::mm'``, ``'aten::add.Tensor'``, ``'disco_torch::stft'``."""
    schema = func._schema
    return schema.name + (f".{schema.overload_name}" if schema.overload_name else "")


def is_kernel(name: str) -> bool:
    """Whether op ``name`` is one of the port's hand-written kernels."""
    return name.startswith(KERNEL_NAMESPACE + "::")


@dataclasses.dataclass
class TensorInfo:
    """What the recorder keeps of one tensor an operator reads or writes."""

    tid: int
    shape: tuple
    dtype: torch.dtype
    device: str

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize

    @property
    def is_complex(self) -> bool:
        return self.dtype.is_complex


@dataclasses.dataclass
class OpEvent:
    """One dispatched operator: its name, the tensors it reads and writes,
    its non-tensor arguments by schema name (dims, sizes, flags) for the
    cost model, how many of ``ins`` its first argument holds (a
    ``_foreach_*`` op's list), and the share of its rows that are the
    caller's (below 1 in a batch padded to a fixed size,
    :func:`disco_tpu_torch.device.useful_share`)."""

    name: str
    ins: list
    outs: list
    params: dict
    first: int
    share: float = 1.0


def _params(func, args, kwargs) -> dict:
    out = {}
    for i, arg in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(arg.name)
        if not isinstance(v, torch.Tensor) and not (
                isinstance(v, (list, tuple)) and any(isinstance(e, torch.Tensor) for e in v)):
            out[arg.name] = v
    return out


def _first_list(args) -> int:
    if args and isinstance(args[0], (list, tuple)):
        return sum(isinstance(e, torch.Tensor) for e in args[0])
    return 1 if args and isinstance(args[0], torch.Tensor) else 0


#: dispatched calls that are not operators of the program: a fake tensor's
#: device query, the profiler's record-function markers
_NOT_OPERATORS = ("prim::", "profiler::")


class Recorder(TorchDispatchMode):
    """Record every operator dispatched under it, in order.

    Each tensor gets a serial number the first time it is seen, kept while
    the tensor lives (a weakref drops it), so that liveness and
    program-input identity survive id() reuse.
    """

    def __init__(self, indexing: "CardIndexing | None" = None):
        super().__init__()
        self.indexing = indexing
        self.events: list[OpEvent] = []
        self._serial: dict[int, int] = {}
        self._next = 0

    def tid(self, t: torch.Tensor) -> int:
        key = id(t)
        sid = self._serial.get(key)
        if sid is None:
            sid = self._serial[key] = self._next
            self._next += 1
            weakref.finalize(t, self._serial.pop, key, None)
        return sid

    def info(self, t: torch.Tensor) -> TensorInfo:
        dev = t.device.type
        if dev == "cpu" and self.indexing is not None and self.indexing.active:
            dev = "cuda"
        return TensorInfo(self.tid(t), tuple(int(d) for d in t.shape), t.dtype, dev)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.name.startswith(_NOT_OPERATORS):
            return func(*args, **kwargs)
        ins = [self.info(t) for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        outs = [self.info(t) for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.events.append(OpEvent(op_name(func), ins, outs, _params(func, args, kwargs),
                                   _first_list(args), useful_share()))
        return out


@dataclasses.dataclass
class Trace:
    """One recorded run of a program: its operators, its inputs and
    outputs, and how it was traced."""

    events: list
    inputs: list
    outputs: list
    traced: str
    device: str
    readback: str | None = None


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


class CardIndexing(TorchFunctionMode):
    """Tensor methods of fake ``cuda`` tensors on a torch build without CUDA.

    Python indexing (``t[..., None]``, ``t[idx] = v``) and some Tensor
    methods (``contiguous``, ``~t``) take a device guard of their tensor's
    device, which a build without CUDA cannot make, even for a fake tensor.
    For the span of such a call the fake ``cuda`` tensors among its
    arguments show the CPU as their device (the fake mode reads a fake
    tensor's device from ``fake_device``); the operators it dispatches are
    the same, and its fake outputs are moved back to the card's device.
    Indexing always takes this path, another call only when it raised for
    want of CUDA.  ``active`` is true for the span of such a call: a
    :class:`Recorder` given this mode reports the tensors it sees then as
    the card's.
    """

    def __init__(self):
        super().__init__()
        self.active = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            try:
                return func(*args, **kwargs)
            except RuntimeError as e:
                if "not linked with support for cuda" not in str(e):
                    raise
        from torch._subclasses.fake_tensor import FakeTensor

        saved = [(t, t.fake_device) for t in pytree.tree_leaves((args, kwargs))
                 if isinstance(t, FakeTensor) and t.fake_device.type == "cuda"]
        if not saved:
            return func(*args, **kwargs)
        for t, _ in saved:
            t.fake_device = torch.device("cpu")
        self.active = True
        try:
            out = func(*args, **kwargs)
        finally:
            self.active = False
            for t, dev in saved:
                t.fake_device = dev
        for o in pytree.tree_leaves(out):
            if isinstance(o, FakeTensor):
                o.fake_device = saved[0][1]
        return out


def _readback_errors() -> tuple:
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
        UnsupportedOperatorException,
    )

    return (DataDependentOutputException, DynamicOutputShapeException,
            UnsupportedOperatorException)


def _value(rng, shape, dtype, device):
    """Seeded values of a declared input: masks and other reals uniform in
    (0.1, 0.9), complex spectra standard normal, integers 0."""
    if dtype.is_complex:
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    elif dtype.is_floating_point:
        a = rng.uniform(0.1, 0.9, shape)
    elif dtype == torch.bool:
        a = np.ones(shape, bool)
    else:
        a = np.zeros(shape, np.int64)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def materialize(tree, device: str, seed: int = 0, fake: bool = False):
    """The declared inputs of ``tree`` (:class:`Struct` leaves; other
    leaves kept) as tensors on ``device``: empty (fake) tensors under a
    fake mode, else seeded values."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def leaf(x):
        if not isinstance(x, Struct):
            return x
        if fake:
            return torch.empty(x.shape, dtype=x.dtype, device=dev)
        return _value(rng, x.shape, x.dtype, dev)

    return pytree.tree_map(leaf, tree, is_leaf=lambda x: isinstance(x, Struct))


def tensors_of(tree) -> list:
    """The tensors of a program's inputs or outputs, in a fixed order:
    dicts by insertion, tuples and lists (NamedTuples too) by position,
    dataclasses by field, a module's parameters then its buffers, an
    optimizer's state tensors by parameter."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors_of(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.optim.Optimizer):
        return [t for group in tree.param_groups for p in group["params"]
                for t in tensors_of(tree.state.get(p, {}))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tensors_of(getattr(tree, f.name))]
    return []



def record(fn, args, kwargs=None, recorder: Recorder | None = None):
    """Run ``fn(*args, **kwargs)`` under a recorder; ``(recorder, out)``."""
    rec = recorder or Recorder()
    for t in tensors_of(args):
        rec.tid(t)
    with rec:
        out = fn(*args, **(kwargs or {}))
    return rec, out


def _run(build, device: str, fake: bool, indexing=None):
    fn, args, kwargs = build(device)
    args = materialize(args, device, fake=fake)
    rec, out = record(fn, args, kwargs, Recorder(indexing))
    return Trace(rec.events, [rec.info(t) for t in tensors_of(args)],
                 [rec.info(t) for t in tensors_of(out)],
                 traced="fake-" + torch.device(device).type if fake else "real-cpu", device=device)


def _port_frame(e: BaseException) -> str:
    """'package/module.py:line' of the innermost frame of the port's own
    code (outside this package) in ``e``'s traceback."""
    import traceback

    where = "?"
    for fr in traceback.extract_tb(e.__traceback__):
        path = fr.filename.replace("\\", "/")
        if "/disco_tpu_torch/" in path and "/analysis/" not in path:
            where = f"{path.split('/disco_tpu_torch/')[-1]}:{fr.lineno}"
    return where


def trace_program(build, device: str = "cuda", real_because: str | None = None) -> Trace:
    """Trace a catalog program: ``build(device)`` returns ``(fn, args,
    kwargs)`` with :class:`Struct` leaves in ``args``.

    ``device='cuda'`` traces for the card on fake ``cuda:0`` tensors; where
    the program reads a value back, the fake trace stops and the program is
    traced on real CPU tensors at the same shapes instead (``traced`` says
    so, ``readback`` names the read).  ``device='cpu'`` traces the CPU
    route on real tensors.  ``real_because`` (the catalog's reason a
    program cannot run on fake tensors at all) sends it to real CPU
    tensors at once.
    """
    if torch.device(device).type == "cpu":
        trace = _run(build, "cpu", fake=False)
        trace.traced = "cpu"
        return trace
    if real_because is not None:
        trace = _run(build, "cpu", fake=False)
        trace.readback = real_because
        return trace
    try:
        with _fake_mode(), CardIndexing() as indexing:
            return _run(build, "cuda:0", fake=True, indexing=indexing)
    except _readback_errors() as e:
        why = f"{str(getattr(e, 'func', '') or e).splitlines()[0]} at {_port_frame(e)}"
    trace = _run(build, "cpu", fake=False)
    trace.readback = why
    return trace


def fingerprint_trace(trace: Trace) -> dict:
    """The structural fingerprint of one :class:`Trace` (module docstring)."""
    ops: dict[str, int] = {}
    kernels: dict[str, int] = {}
    seq = hashlib.sha256()
    scalar_reads = d2h = churn = 0
    f64: list[str] = []
    seen_f64: set = set()

    def note_f64(entry: str) -> None:
        if entry not in seen_f64:
            seen_f64.add(entry)
            f64.append(entry)

    for t in trace.inputs:
        if dtype_name(t.dtype) in BANNED_DTYPES and t.device != "cpu":
            note_f64(f"input {dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]")
    for ev in trace.events:
        ops[ev.name] = ops.get(ev.name, 0) + 1
        seq.update(f"{ev.name}\n".encode())
        if is_kernel(ev.name):
            kernels[ev.name] = kernels.get(ev.name, 0) + 1
        if ev.name == SCALAR_READ:
            scalar_reads += 1
        if ev.name in ("aten::_to_copy", "aten::copy_") and ev.ins and ev.outs:
            src, dst = ev.ins[-1] if ev.name == "aten::copy_" else ev.ins[0], ev.outs[0]
            if src.device != "cpu" and dst.device == "cpu":
                d2h += 1
            if ev.name == "aten::_to_copy" and src.dtype == dst.dtype and src.device == dst.device:
                churn += 1
        for t in ev.ins + ev.outs:
            if dtype_name(t.dtype) in BANNED_DTYPES and t.device != "cpu":
                note_f64(f"{ev.name} {dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]")

    def avals(infos):
        return [f"{dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]" for t in infos]

    fp = {
        "version": VERSION,
        "torch": torch_version(),
        "traced": trace.traced,
        "in_avals": avals(trace.inputs),
        "out_avals": avals(trace.outputs),
        "n_ops": len(trace.events),
        "ops": dict(sorted(ops.items())),
        "sequence_sha256": seq.hexdigest(),
        "kernel_ops": dict(sorted(kernels.items())),
        "host_syncs": {"scalar_reads": scalar_reads, "d2h_copies": d2h},
        "copy_churn": churn,
        "f64": f64,
    }
    if trace.readback is not None:
        fp["readback"] = trace.readback
    return fp


def trace_real(spec, device: str = "cuda") -> Trace:
    """Run a catalog program on real tensors on ``device`` (the card, in
    ``chip_smoke.py`` phase 3n) under the recorder, at the catalog's
    shapes and seeded values."""
    with spec.context(device):
        trace = _run(spec.build, device, fake=False)
    trace.traced = "real-" + torch.device(device).type
    return trace


def fingerprint_program(spec, device: str = "cuda") -> dict:
    """Trace a catalog program (:func:`trace_program`) in its context and
    fingerprint it."""
    with spec.context(device):
        return fingerprint_trace(trace_program(spec.build, device,
                                               real_because=spec.real_because))


def diff_fingerprints(golden: dict, current: dict) -> list:
    """Readable operator-level differences, empty when identical.  A schema
    or torch-version mismatch is one line saying to regenerate."""
    for key, what in (("version", "fingerprint schema version"), ("torch", "torch version")):
        if golden.get(key) != current.get(key):
            return [f"{what} {golden.get(key)} != {current.get(key)}: regenerate goldens with "
                    "`disco-torch-trace --update`"]
    out: list[str] = []
    for key in ("traced", "in_avals", "out_avals", "kernel_ops", "host_syncs", "copy_churn",
                "f64", "readback"):
        if golden.get(key) != current.get(key):
            out.append(f"{key}: {golden.get(key)} -> {current.get(key)}")
    go, co = golden.get("ops", {}), current.get("ops", {})
    for name in sorted(set(go) | set(co)):
        a, b = go.get(name, 0), co.get(name, 0)
        if a != b:
            out.append(f"op {name}: {a} -> {b} ({b - a:+d})")
    if not out and golden.get("sequence_sha256") != current.get("sequence_sha256"):
        out.append("operator sequence reordered (same multiset, different order): "
                   f"{golden.get('sequence_sha256', '')[:12]} -> "
                   f"{current.get('sequence_sha256', '')[:12]}")
    return out


#: the parts of a fingerprint that do not move with the torch version —
#: what the card's run of a program is held to (chip_smoke.py phase 3n)
PORTABLE_KEYS = ("kernel_ops", "out_avals", "host_syncs", "f64")


def portable_diff(golden: dict, current: dict, keys=PORTABLE_KEYS) -> list:
    """Differences on :data:`PORTABLE_KEYS` only: the kernel ops and their
    counts, the output signature, the host syncs, and the float64 tensors
    on the device (each by operator, dtype and shape).  A golden traced on
    CPU tensors (a program that cannot run on fake ones) counts no
    device-to-host copies, so only its scalar reads are compared."""
    out = []
    for key in keys:
        a, b = golden.get(key), current.get(key)
        if key == "host_syncs" and not str(golden.get("traced", "")).startswith("fake"):
            a, b = a.get("scalar_reads"), b.get("scalar_reads")
        if a != b:
            out.append(f"{key}: {a} -> {b}")
    return out


def dumps(fp: dict) -> str:
    """Canonical JSON text of a fingerprint (sorted keys, indented)."""
    return json.dumps(fp, indent=2, sort_keys=True) + "\n"
