"""Training engine (counterpart of ``disco_tpu/nn/training.py``; reference
dnn/engine/train.py, dnn/engine/callbacks.py, dnn/utils.py:155-294).

The step is the reference's per-batch logic — forward, frame-aligned
masked MSE, RMSprop step (dnn/utils.py:249-294) — over a small
:class:`TrainState` (the module, which holds the parameters and the
BatchNorm statistics; its optimizer, which holds ``nu``; the step count;
a generator for dropout).  Where the JAX package returns a new state, the
port's ``train_step`` updates the state in place and returns it.  The
epoch loop, best-model gate (:class:`SaveAndStop`), loss histories and
checkpoint/resume follow train.py:110-158 and callbacks.py:4-56 as the
JAX package does.

Checkpoints are the JAX package's files: the msgpack tree that
``flax.serialization.to_bytes`` writes,

    {params, batch_stats, opt_state, step, train_loss, val_loss, epochs_done}

with ``params``/``batch_stats`` in the flax module's layout
(:func:`~disco_tpu_torch.nn.convert.flax_from_state_dict`) and
``opt_state`` optax's: ``{'0': {'nu': <params tree>}, '1': {}, '2': {}}``
for RMSprop, nested as ``{'0': {}, '1': <that>}`` behind
``clip_by_global_norm``.  A checkpoint written by either package resumes in
the other (:mod:`.serialization` reads and writes them without msgpack or
flax).

Data parallelism (``mesh``, a :class:`~torch.distributed.device_mesh.
DeviceMesh` with a ``batch`` dim; ``parallel.make_mesh``): every rank holds
the same state (:func:`replicate_to_mesh`), is given the same global batch
and steps on its slice of it; BatchNorm normalizes by the global batch's
statistics (``bricks.global_batch_statistics``), dropout draws the global
batch's mask and each rank takes its rows, and the gradients are summed
over the ranks before the optimizer clips them, so each step is the
one-process step on the global batch up to the order of its sums (and bit
for bit at one rank).  Only rank 0 writes checkpoints, loss files and the
ledger.

Not carried over: the JAX package memoizes its jitted step pair and offers
``clear_step_fn_caches``; both exist against jit retraces, and an eager
step has nothing to retrace (each ``make_step_fns`` pair counts its own
call signatures under the ``train_step``/``eval_step`` labels,
``obs.accounting.counted_jit``).

``fit`` records the JAX package's telemetry: the ``train_steps`` counter,
the ``train_loss``/``val_loss`` gauges, ``train_empty_epochs`` with its
``warning`` event, one ``epoch`` event an epoch (``steps``,
``val_batches``, ``dur_s`` and ``recompiles``, the new signatures of the
two step labels), the ``promotion`` events of a publish and the ``note``
of a graceful stop.  The losses are read back once an epoch, never once a
step.

The promotion seams are the JAX package's: :func:`publish_checkpoint`
stages a checkpoint in a :class:`~disco_tpu_torch.promote.store.
GenerationStore`, and ``fit(promote_dir=..., promote_arch=...)`` publishes
every improved checkpoint after its epoch's ledger record.

Determinism.  Some cuDNN backward algorithms reduce with atomics, so two
runs of one step could differ in their last bits, and a resumed run could
drift from an uninterrupted one.  Every step therefore runs with
``torch.backends.cudnn.deterministic = True`` and ``benchmark = False``,
set around the step and restored after it (:func:`deterministic_cudnn`),
never at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
import string
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from disco_tpu_torch.device import check_module_device, prefetch_to_device, resolve_device
from disco_tpu_torch.nn.bricks import global_batch_statistics
from disco_tpu_torch.nn.convert import (
    flax_absent,
    flax_from_state_dict,
    params_from_flax,
    state_dict_from_flax,
)
from disco_tpu_torch.nn.losses import reconstruction_loss
from disco_tpu_torch.nn.optim import RMSprop
from disco_tpu_torch.nn.serialization import packb, unpackb
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs.accounting import counted_jit, recompile_count
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.ops.resolve import compute_dtype, resolve_precision


@dataclasses.dataclass
class TrainState:
    """What a training step reads and writes: ``model`` (parameters and
    BatchNorm running statistics), ``optimizer`` (an
    :class:`~disco_tpu_torch.nn.optim.RMSprop` over the model's parameters,
    holding ``nu``), ``step`` (steps taken) and ``generator`` (a CPU
    ``torch.Generator`` that seeds each step's dropout, the counterpart of
    the JAX state's ``dropout_rng``)."""

    model: nn.Module
    optimizer: RMSprop
    step: int = 0
    generator: torch.Generator | None = None


def create_train_state(model: nn.Module, tx: RMSprop, sample_input=None,
                       seed: int = 0) -> TrainState:
    """The training state of ``model`` and its optimizer ``tx``
    (:func:`~disco_tpu_torch.nn.optim.build_optimizer`).  The JAX package
    initializes the parameters here from ``seed``; the port's modules are
    initialized by their constructors (seed torch before building them, or
    load weights), and ``seed`` seeds the dropout generator.
    ``sample_input``, when given, runs once through the model in eval mode
    without gradients, which checks its shape and changes nothing."""
    owned = {id(p) for p in model.parameters()}
    given = [p for group in tx.param_groups for p in group["params"]]
    if {id(p) for p in given} != owned or len(given) != len(owned):
        raise ValueError("the optimizer must hold exactly the model's parameters")
    if sample_input is not None:
        dev = next(model.parameters()).device
        was_training = model.training
        with torch.no_grad():
            model.eval()(_as_tensor(sample_input, dev))
        model.train(was_training)
    return TrainState(model=model, optimizer=tx, step=0,
                      generator=torch.Generator().manual_seed(int(seed)))


def _x_for_loss(x, bounds, n_freq=257):
    """Frame-align a tensor for the loss: first channel of 4-D inputs, frame
    slice, freq crop; single frames squeezed (reference
    dnn/utils.py:212-246)."""
    ff, lf = bounds
    if x.ndim == 4:
        x = x[:, 0]
    x = x[:, ff:lf, :n_freq]
    return x[:, 0, :] if lf - ff == 1 else x


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    """A batch array as a float32 tensor on ``dev``: numpy is copied there,
    a tensor must already lie on ``dev``."""
    if isinstance(a, torch.Tensor):
        if a.device.type != dev.type:
            raise ValueError(f"a batch on {a.device} given to a step on {dev}")
        return a
    return torch.as_tensor(np.asarray(a), device=dev)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms and no autotuning for the body;
    the previous settings come back after it."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def replicate_to_mesh(state: TrainState, mesh) -> TrainState:
    """Make every rank's ``state`` rank 0's — parameters, BatchNorm
    statistics, the optimizer's ``nu``, the step count and the dropout
    generator, broadcast over the world — then verify it: a digest of the
    whole state, gathered from every rank, must be one value.  The
    data-parallel step keeps the replicas equal from there (counterpart of
    the JAX package's ``replicate_to_mesh``; reference: none)."""
    import hashlib

    import torch.distributed as dist

    from disco_tpu_torch.parallel.mesh import mesh_device

    mesh_device(mesh)
    model, opt = state.model, state.optimizer
    for p in model.parameters():
        if "nu" not in opt.state[p]:
            opt.state[p]["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    tensors = ([p.data for p in model.parameters()] + list(model.buffers())
               + [opt.state[p]["nu"] for p in model.parameters()])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    gen = state.generator.get_state() if state.generator is not None else None
    meta = [int(state.step), None if gen is None else gen.numpy().tobytes()]
    dist.broadcast_object_list(meta, src=0)
    state.step = meta[0]
    if meta[1] is not None:
        state.generator.set_state(torch.frombuffer(bytearray(meta[1]), dtype=torch.uint8))
    digest = hashlib.sha256()
    for t in tensors:
        # disco-torch-lint: disable=DL002 -- once at mesh setup, not a hot loop: digests every replicated tensor of any dtype (to_host carries float32/complex64 only) to prove the broadcast
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    digest.update(repr(meta).encode())
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, digest.hexdigest())
    if len(set(seen)) != 1:
        raise RuntimeError(f"replicate_to_mesh: the ranks' states differ after the broadcast "
                           f"({len(set(seen))} distinct digests)")
    return state


def _batch_lane(mesh):
    """(group, ranks, this rank's place) of a data-parallel mesh's batch
    dim; ValueError without one, RuntimeError unless the world is the
    mesh's."""
    from disco_tpu_torch.parallel.mesh import dim_size, mesh_device

    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel.make_mesh); "
                        f"got {type(mesh).__name__}")
    if "batch" not in names:
        raise ValueError(f"data-parallel training needs a mesh with a 'batch' axis; got axes "
                         f"{names}")
    mesh_device(mesh)
    return mesh.get_group("batch"), dim_size(mesh, "batch"), mesh.get_local_rank("batch")


def _all_reduce_grads(params, group) -> None:
    """Sum the gradients over ``group`` in one flat ``all_reduce``."""
    import torch.distributed as dist

    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


@contextlib.contextmanager
def _global_dropout(model: nn.Module, n: int, lo: int, hi: int):
    """Each active ``nn.Dropout`` of ``model`` draws the mask of the GLOBAL
    batch of ``n`` rows (from the same generator state on every rank) and
    applies its rows ``[lo, hi)`` to this rank's slice, as the JAX
    package's data-parallel step does; a rank never draws a mask of its own
    shape."""
    import torch.nn.functional as F

    patched = [m for m in model.modules() if isinstance(m, nn.Dropout) and m.p > 0]

    def ones_laid_out_as(x):
        # the global batch's ones in x's memory order: dropout fills its mask
        # in memory order (``empty_like`` keeps the strides), and a GRU's
        # batch-first output is a transposed (time, batch, features) buffer
        order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
        shape = (n,) + tuple(x.shape[1:])
        buf = torch.ones([shape[d] for d in order], dtype=x.dtype, device=x.device)
        return buf.permute([order.index(d) for d in range(x.ndim)])

    def forward_of(m):
        def forward(x):
            if not m.training:
                return x
            return x * F.dropout(ones_laid_out_as(x), m.p, True)[lo:hi]
        return forward

    for m in patched:
        m.forward = forward_of(m)
    try:
        yield
    finally:
        for m in patched:
            del m.forward


@contextlib.contextmanager
def _dropout_seeded(state: TrainState, dev: torch.device, active: bool):
    """Seed torch's generator of ``dev`` from the state's generator for one
    step's dropout, restoring the global generator after it.  A model
    without active dropout draws nothing."""
    if not active:
        yield
        return
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.generator))
    devices = [dev.index if dev.index is not None else torch.cuda.current_device()] \
        if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


def make_step_fns(model: nn.Module, output_frames="all", n_freq=None, mesh=None,
                  precision: str = "f32"):
    """(train_step, eval_step) over a :class:`TrainState` and (x, y)
    batches (reference dnn/utils.py:249-294).  ``train_step(state, x, y)``
    takes one RMSprop step, updates ``state`` in place and returns
    ``(state, loss)``; ``eval_step(state, x, y)`` returns the loss in eval
    mode without gradients.  Batches are numpy arrays (copied to the
    model's device) or tensors on it; the loss is a 0-d float32 tensor on
    the device, never read back by the step.

    ``output_frames``: 'all' | 'mid' | 'last' | an int, the frames that
    enter the loss (:meth:`~disco_tpu_torch.nn.crnn.CRNN.loss_frames`).

    ``precision``: ``'f32'`` (default) or ``'bf16'``, the JAX package's
    mixed-precision lane (training.py:189-209): the forward runs on bf16
    copies of the float32 master parameters
    (``torch.func.functional_call``) and on bf16 inputs, so the gradients
    land on the float32 masters; the estimate is cast to float32 before the
    loss; BatchNorm's running statistics and the optimizer's ``nu`` stay
    float32.  (``autocast`` is not used: its op-by-op casting rules are not
    the JAX lane's.)

    The gradients of the rows flax does not have (:func:`~disco_tpu_torch.
    nn.convert.flax_absent`) are zeroed before the update, so those rows
    stay 0.

    ``mesh``: the data-parallel lane (module docstring) — a collective
    step: every rank of the mesh calls it with the same global batch and
    the same state (:func:`replicate_to_mesh`) and steps on its slice; the
    batch must divide over the mesh's ``batch`` dim, or the step raises.
    Each rank's slice loss is weighted by its share of the batch, the
    weighted gradients are summed over the ranks before
    ``clip_by_global_norm`` sees them, and the loss returned is the global
    one.
    """
    lane = None if mesh is None else _batch_lane(mesh)
    precision = resolve_precision(precision)
    in_bounds, out_bounds = model.loss_frames(output_frames)
    n_freq = n_freq or model.input_shape[-1]
    cdtype = compute_dtype(precision)
    params = dict(model.named_parameters())
    absent = [(params[name], rows) for name, rows in flax_absent(model)]
    dropout = any(isinstance(m, nn.Dropout) and m.p > 0 for m in model.modules())

    def forward(x):
        if precision == "bf16":
            copies = {k: v.to(cdtype) for k, v in params.items()}
            return functional_call(model, copies, (x.to(cdtype),)).float()
        return model(x)

    def loss_of(x, y):
        est = forward(x)
        return reconstruction_loss(
            _x_for_loss(y, in_bounds, n_freq),
            _x_for_loss(est, out_bounds, n_freq),
            _x_for_loss(x, in_bounds, n_freq),
        )

    def rank_slice(x, y):
        """This rank's rows of the global batch, its share of the batch, and
        the sharing contexts of its forward."""
        if lane is None:
            return x, y, None, contextlib.nullcontext()
        group, n_ranks, r = lane
        n = x.shape[0]
        if n % n_ranks:
            raise ValueError(f"a batch of {n} does not divide over the mesh's 'batch' dim "
                             f"({n_ranks} ranks)")
        per = n // n_ranks
        lo, hi = r * per, (r + 1) * per
        shared = contextlib.ExitStack()
        shared.enter_context(global_batch_statistics(group, n_ranks))
        if dropout and n_ranks > 1:
            shared.enter_context(_global_dropout(model, n, lo, hi))
        return x[lo:hi], y[lo:hi], per / n, shared

    def global_loss(loss, share):
        import torch.distributed as dist

        loss = loss.detach() * share
        dist.all_reduce(loss, group=lane[0])
        return loss

    @counted_jit(label="train_step")
    def train_step(state: TrainState, x, y):
        dev = next(iter(params.values())).device
        x, y = _as_tensor(x, dev), _as_tensor(y, dev)
        x, y, share, shared = rank_slice(x, y)
        model.train()
        with deterministic_cudnn():
            with _dropout_seeded(state, dev, dropout), shared:
                loss = loss_of(x, y)
            state.optimizer.zero_grad(set_to_none=True)
            (loss if share is None else loss * share).backward()
            if lane is not None:
                _all_reduce_grads(params.values(), lane[0])
            with torch.no_grad():
                for p, rows in absent:
                    if p.grad is not None:
                        p.grad[rows] = 0.0
            state.optimizer.step()
        state.step += 1
        return state, loss.detach() if share is None else global_loss(loss, share)

    @counted_jit(label="eval_step")
    def eval_step(state: TrainState, x, y):
        dev = next(iter(params.values())).device
        x, y = _as_tensor(x, dev), _as_tensor(y, dev)
        x, y, share, _ = rank_slice(x, y)
        model.eval()
        with torch.no_grad(), deterministic_cudnn():
            loss = loss_of(x, y)
        return loss if share is None else global_loss(loss, share)

    return train_step, eval_step


class SaveAndStop:
    """Best-model gate + early stopping (reference callbacks.py:4-56, its
    SyntaxError at :51 not reproduced, as in the JAX package)."""

    def __init__(self, patience=np.inf, mode="min", delta=0):
        if mode not in ("min", "max"):
            raise ValueError('`mode` can be only "min" or "max"')
        self.waited = 0
        self.patience = patience
        self.mode = mode
        self.delta = delta
        self.current_value = np.inf if mode == "min" else -np.inf

    def save_model_query(self, value):
        improved = (
            value < self.current_value - self.delta
            if self.mode == "min"
            else value > self.current_value + self.delta
        )
        if improved:
            self.current_value = value
            self.waited = 0
        else:
            self.waited += 1
        return improved

    def early_stop_query(self):
        return self.waited > self.patience


def get_model_name(model_name=None):
    """4-char pseudo-random run name; '_retrain' suffix on resume
    (reference dnn/utils.py:178-186)."""
    if model_name is None:
        chars = string.ascii_letters + string.digits
        seed = int(str(time.time()).replace(".", "")[-4:])
        return "".join(chars[(seed + 7 * i) % len(chars)] for i in range(4))
    return Path(model_name).name.split("_model")[0] + "_retrain"


# -- checkpointing ----------------------------------------------------------
class CheckpointError(RuntimeError):
    """A checkpoint file could not be restored (missing, truncated, or not
    a compatible payload).  The message names the path."""


def _rms_state(nu: dict) -> dict:
    return {"0": {"nu": nu}, "1": {}, "2": {}}


def _opt_state_tree(state: TrainState) -> dict:
    """The optimizer's state as optax's ``opt_state`` of the JAX package's
    ``tx``, in flax's state-dict form."""
    named = {}
    for name, p in state.model.named_parameters():
        nu = state.optimizer.state.get(p, {}).get("nu")
        named[name] = nu if nu is not None else torch.zeros_like(p)
    tree = _rms_state(flax_from_state_dict(named, state.model)["params"])
    return {"0": {}, "1": tree} if state.optimizer.clip_norm is not None else tree


def _nu_of(opt_state: dict, clipped: bool) -> dict:
    """The ``nu`` tree out of an ``opt_state`` of the optimizer's shape;
    ValueError when the chain differs (clipping in one and not the other)."""
    rms = opt_state
    if clipped:
        if set(opt_state) != {"0", "1"} or opt_state["0"] != {}:
            raise ValueError("the checkpoint's optimizer has no clip_by_global_norm; "
                             "this one clips")
        rms = opt_state["1"]
    if set(rms) != {"0", "1", "2"} or set(rms["0"]) != {"nu"}:
        raise ValueError("the checkpoint's optimizer state is not rmsprop's"
                         + ("" if clipped else " (does it clip? this optimizer does not)"))
    return rms["0"]["nu"]


def save_checkpoint(path, state: TrainState, train_losses, val_losses,
                    epochs_done: int | None = None):
    """Write the model, optimizer state and loss histories to one msgpack
    file, the JAX package's checkpoint (the torch.save dict of reference
    train.py:147-156), atomically (``disco_tpu_torch.io.atomic``).

    ``epochs_done`` is the number of completed epochs that the
    zero-padded loss histories cover, stored explicitly; None records the
    histories' length with trailing zeros trimmed."""
    from disco_tpu_torch.io.atomic import write_bytes_atomic

    if epochs_done is None:
        epochs_done = int(np.trim_zeros(np.asarray(train_losses), "b").size)
    variables = flax_from_state_dict(state.model.state_dict(), state.model)
    payload = {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": _opt_state_tree(state),
        "step": np.asarray(int(state.step), np.int32),
        "train_loss": np.asarray(train_losses, np.float64),
        "val_loss": np.asarray(val_losses, np.float64),
        "epochs_done": np.asarray(int(epochs_done), np.int32),
    }
    write_bytes_atomic(path, packb(payload))


def load_checkpoint(path, state: TrainState):
    """Restore a checkpoint (written by either package) into ``state``;
    returns (state, train_losses, val_losses) cut to the completed-epoch
    count (reference dnn/utils.py:155-175).

    The count is the payload's ``epochs_done`` when present; older
    checkpoints fall back to trimming trailing zeros from the history, as
    the JAX package does.  Raises :class:`CheckpointError` naming ``path``
    when the file is missing, truncated or does not fit the model and
    optimizer."""
    try:
        raw = Path(path).read_bytes()
    except OSError as e:
        raise CheckpointError(f"checkpoint {path}: cannot read: {e}") from e
    model, opt = state.model, state.optimizer
    try:
        payload = unpackb(raw)
        missing = {"params", "batch_stats", "opt_state", "step", "train_loss",
                   "val_loss"} - set(payload)
        if missing:
            raise ValueError(f"missing {sorted(missing)}")
        sd = state_dict_from_flax({"params": payload["params"],
                                   "batch_stats": payload["batch_stats"]}, model)
        nu = params_from_flax(_nu_of(payload["opt_state"], opt.clip_norm is not None), model)
        step = int(payload["step"])
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path}: corrupt or incompatible payload ({type(e).__name__}: {e}); the "
            f"file may be truncated by a crashed writer: delete it or point at an intact "
            f"checkpoint") from e
    model.load_state_dict(sd)
    for name, p in model.named_parameters():
        opt.state[p]["nu"] = nu[name].to(device=p.device, dtype=p.dtype)
    state.step = step
    train_hist = np.asarray(payload["train_loss"])
    val_hist = np.asarray(payload["val_loss"])
    if "epochs_done" in payload:
        n = max(0, min(int(payload["epochs_done"]), train_hist.size))
        return state, train_hist[:n], val_hist[: min(n, val_hist.size)]
    return state, np.trim_zeros(train_hist, "b"), np.trim_zeros(val_hist, "b")


def load_params_for_inference(path, state: TrainState) -> TrainState:
    """Weights-only restore for enhancement-time mask estimation
    (reference tango.py:133-134)."""
    state, _, _ = load_checkpoint(path, state)
    return state


def publish_checkpoint(promote_dir, ckpt_path, *, arch: dict, ledger=None,
                       source: str | None = None):
    """The publish seam between training and live promotion: stage one
    :func:`save_checkpoint` file (of either package) as an immutable weight
    generation under ``promote_dir``
    (:meth:`~disco_tpu_torch.promote.store.GenerationStore.stage_checkpoint`).
    ``arch``: the ``build_crnn`` kwargs the weights were trained with;
    ``ledger``: the training run's ledger (path or
    :class:`~disco_tpu_torch.runs.RunLedger`) — a run whose latest
    ``epoch:*`` unit is still ``in_flight`` is refused with
    :class:`~disco_tpu_torch.promote.store.PublishRefused` naming the unit.
    Returns the staged :class:`~disco_tpu_torch.promote.store.Generation`."""
    from disco_tpu_torch.promote.store import GenerationStore

    ledger_path = getattr(ledger, "path", ledger)
    return GenerationStore(promote_dir).stage_checkpoint(
        ckpt_path, arch=arch, ledger=ledger_path, source=source or str(ckpt_path))


# -- the epoch loop ---------------------------------------------------------
def _prefetch_host_batches(make_batches):
    """Double-buffered host batch feed: batch N+1's numpy prep runs on a
    :class:`~disco_tpu_torch.enhance.pipeline.ChunkPrefetcher` loader
    thread while step N runs, and each batch's stall and busy time land in
    the ``prefetch_stall_ms`` / ``overlap_efficiency`` gauges
    (:func:`~disco_tpu_torch.enhance.pipeline.note_chunk_overlap`), as the
    corpus engine's chunks do.  The loader is
    closed on unwind."""
    from disco_tpu_torch.enhance.pipeline import ChunkPrefetcher, note_chunk_overlap

    pf = ChunkPrefetcher(((b,) for b in make_batches()), lambda b: b, depth=2)
    try:
        last = time.perf_counter()
        for batch, stall_s in pf:
            busy_s = max(time.perf_counter() - last - stall_s, 0.0)
            note_chunk_overlap(stall_s, busy_s)
            yield batch
            last = time.perf_counter()
    finally:
        pf.close()


def fit(
    model,
    state: TrainState,
    train_batches,
    val_batches,
    n_epochs: int,
    save_path: str = "models/",
    run_name: str | None = None,
    output_frames: str = "all",
    resume_from: str | None = None,
    patience: float | None = None,
    verbose: bool = True,
    ledger=None,
    mesh=None,
    precision: str = "f32",
    promote_dir=None,
    promote_arch: dict | None = None,
    device=None,
):
    """Full training loop (reference train.py:110-158): per-epoch train +
    no-grad validation, loss histories saved every epoch, the best model's
    checkpoint gated by :class:`SaveAndStop`, optional early stop and
    resume.  Returns (state, train_losses, val_losses, run_name).

    ``train_batches`` / ``val_batches`` are callables returning an iterator
    of (x, y) numpy batches (a fresh shuffle each epoch), such as
    :meth:`~disco_tpu_torch.flywheel.ShardDataset.batch_fn`.  A callable
    with a ``set_start_epoch(epoch)`` method is told the first epoch before
    the loop (a resumed run's data epochs then line up with its training
    epochs).  Each epoch's batches ride the double-buffered host feed
    (:func:`_prefetch_host_batches`) into
    :func:`~disco_tpu_torch.device.prefetch_to_device`, so batch prep,
    host-to-device copies and steps overlap; the losses are summed on the
    device and read back once an epoch.

    ``device``: ``"cuda"`` when None (RuntimeError without a CUDA device),
    or ``"cpu"``; the model must lie there already, and ``state`` must be
    its training state.  ``precision``: see :func:`make_step_fns`.

    Crash safety (``disco_tpu_torch.runs``): checkpoints and loss
    histories are written atomically; an optional ``ledger``
    (:class:`~disco_tpu_torch.runs.RunLedger` or path) records each
    ``epoch:<e>`` unit in_flight, then done with its losses; the
    ``mid_epoch`` chaos seam fires after an epoch's training pass, before
    anything of it is written; a graceful stop (SIGTERM/SIGINT) is honoured
    between epochs and leaves a run that ``resume_from`` continues.

    ``promote_dir`` (with ``promote_arch``, the ``build_crnn`` kwargs): the
    live publish seam — every improved checkpoint is also staged as a weight
    generation (:func:`publish_checkpoint`) after its epoch's ledger record
    lands; a refusal is recorded as a ``promotion`` event and training goes
    on.

    ``mesh``: the data-parallel lane (:func:`make_step_fns`) — every rank
    of the mesh calls ``fit`` with the same arguments and batch sources;
    the state is made rank 0's first (:func:`replicate_to_mesh`), every
    batch must divide over the mesh's ``batch`` dim, a graceful stop on any
    rank stops all of them between epochs, and rank 0 alone writes the loss
    files, the checkpoints and the ledger and publishes.  Every rank
    returns the same losses.
    """
    from disco_tpu_torch.io.atomic import file_digest, savez_atomic
    from disco_tpu_torch.runs import chaos as run_chaos
    from disco_tpu_torch.runs import interrupt as run_interrupt
    from disco_tpu_torch.runs.ledger import RunLedger, unit_epoch

    if promote_dir is not None and promote_arch is None:
        raise ValueError("fit(promote_dir=...) needs promote_arch (the build_crnn "
                         "kwargs) to stage generations with")
    dev = resolve_device(device)
    check_module_device(model, dev)
    if state.model is not model:
        raise ValueError("state is not the training state of model")
    writer = True
    if mesh is not None:
        import torch.distributed as dist

        _batch_lane(mesh)
        writer = dist.get_rank() == 0
        if not writer:
            ledger, promote_dir, verbose = None, None, False
    if ledger is not None and not isinstance(ledger, RunLedger):
        ledger = RunLedger(ledger)
    train_step, eval_step = make_step_fns(model, output_frames, mesh=mesh,
                                          precision=precision)
    save_dir = Path(save_path)
    save_dir.mkdir(parents=True, exist_ok=True)

    if resume_from is not None:
        state, train_hist, val_hist = load_checkpoint(resume_from, state)
        first_epoch = len(train_hist)
        train_losses = np.concatenate([train_hist, np.zeros(n_epochs)])
        val_losses = np.concatenate([val_hist, np.zeros(n_epochs)])
        run_name = run_name or get_model_name(resume_from)
    else:
        first_epoch = 0
        train_losses, val_losses = np.zeros(n_epochs), np.zeros(n_epochs)
        run_name = run_name or get_model_name()
    if mesh is not None:
        # data-parallel invariant: every rank starts from rank 0's state
        # (and rank 0's run name)
        state = replicate_to_mesh(state, mesh)
        named = [run_name]
        dist.broadcast_object_list(named, src=0)
        run_name = named[0]

    def stop_requested() -> bool:
        stop = run_interrupt.stop_requested()
        if mesh is None:
            return stop
        flag = torch.tensor(int(stop), device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    for cb in (train_batches, val_batches):
        hook = getattr(cb, "set_start_epoch", None)
        if hook is not None:
            hook(first_epoch)

    gate = SaveAndStop(patience=patience if patience is not None else n_epochs, mode="min")
    # the two step labels' counts, not the process-wide total: a signature
    # counted elsewhere in the process is not this fit's
    def fit_recompiles():
        return recompile_count("train_step") + recompile_count("eval_step")

    recompiles0 = fit_recompiles()
    interrupted = False
    for epoch in range(first_epoch, first_epoch + n_epochs):
        if stop_requested():
            interrupted = True
            break  # graceful stop between epochs: all on disk, resumable
        if ledger is not None:
            ledger.mark_in_flight(unit_epoch(epoch))
        t_epoch = time.perf_counter()
        # losses summed on the device, one readback an epoch
        tr, nb = torch.zeros((), device=dev), 0
        for x, y in prefetch_to_device(_prefetch_host_batches(train_batches), dev):
            state, loss = train_step(state, x, y)
            tr = tr + loss
            nb += 1
        # crash with the train pass done but nothing persisted: the whole
        # epoch is redone on resume, never half of it
        run_chaos.tick("mid_epoch", epoch=int(epoch))
        va, nv = torch.zeros((), device=dev), 0
        for x, y in prefetch_to_device(_prefetch_host_batches(val_batches), dev):
            va = va + eval_step(state, x, y)
            nv += 1
        if nb == 0:
            # an epoch with NO training batches is an operator error (an
            # empty dataset, or a reused ledger that marks every shard
            # consumed): loud, or an untrained model is checkpointed as best
            obs_registry.counter("train_empty_epochs").inc()
            obs_events.record(
                "warning", stage="train", epoch=int(epoch),
                reason="epoch yielded ZERO training batches — empty "
                       "dataset, or a reused dataset ledger already marks "
                       "every shard consumed for this epoch",
            )
            if verbose:
                print(f"epoch {epoch}\tWARNING: zero training batches "
                      "(empty dataset or fully-consumed dataset ledger)")
        train_losses[epoch] = float(tr) / nb if nb else 0.0
        val_losses[epoch] = float(va) / nv if nv else 0.0
        obs_registry.counter("train_steps").inc(nb)
        obs_registry.gauge("train_loss").set(train_losses[epoch])
        obs_registry.gauge("val_loss").set(val_losses[epoch])
        if obs_events.enabled():
            recompiles = fit_recompiles()
            obs_events.record(
                "epoch", stage="train", epoch=int(epoch),
                train_loss=train_losses[epoch], val_loss=val_losses[epoch],
                steps=nb, val_batches=nv,
                dur_s=round(time.perf_counter() - t_epoch, 6),
                recompiles=recompiles - recompiles0,
            )
            recompiles0 = recompiles
        if verbose:
            print(f"epoch {epoch}\tTrain\t{train_losses[epoch]:.6f}\t"
                  f"Val\t{val_losses[epoch]:.6f}")
        ckpt_path = save_dir / f"{run_name}_model.msgpack"
        improved = gate.save_model_query(val_losses[epoch])
        if not writer:
            if gate.early_stop_query():
                break
            continue
        losses_path = savez_atomic(save_dir / f"{run_name}_losses.npz",
                                   train_loss=train_losses, val_loss=val_losses)
        if improved:
            save_checkpoint(ckpt_path, state, train_losses, val_losses,
                            epochs_done=int(epoch) + 1)
        if ledger is not None:
            # state-only records: the losses and the best checkpoint are
            # shared files that later epochs overwrite
            ledger.record(
                unit_epoch(epoch), "done",
                train_loss=float(train_losses[epoch]),
                val_loss=float(val_losses[epoch]), improved=improved,
                losses=str(losses_path),
                ckpt=str(ckpt_path) if improved else None,
                ckpt_digest=file_digest(ckpt_path) if improved else None,
            )
        if improved and promote_dir is not None:
            # publish AFTER the epoch's done record: staging reads this
            # run's ledger, and an in_flight unit would refuse the checkpoint
            from disco_tpu_torch.promote.store import PublishRefused

            try:
                gen = publish_checkpoint(promote_dir, ckpt_path, arch=promote_arch,
                                         ledger=ledger)
                obs_events.record("promotion", stage="train", action="published",
                                  gen=gen.gen_id, epoch=int(epoch))
            except PublishRefused as e:
                obs_events.record("promotion", stage="train", action="refused",
                                  unit=e.unit, reason=str(e))
        if gate.early_stop_query():
            break
    if interrupted:
        obs_events.record(
            "note", stage="train",
            reason="graceful stop: training wound down between epochs; "
                   "resume with --weights on the saved checkpoint",
        )
    return state, train_losses, val_losses, run_name
