"""The canonical hot-path program catalog the port's trace and meter gates
read (counterpart of ``disco_tpu/analysis/trace/programs.py``).

The same fifteen programs as the JAX catalog, built from the port's entry
points at the same tiny shapes (K=2 nodes, C=2 mics, F=5 bins, T=8
frames, a batch of B=2): the offline steps (``tango_step1``/``2``, their
fused and eigh forms, the whole clip), the streaming programs (the
chained super-tick, the per-block body with and without a carried state,
the scanned super-tick), the scene factory, the CRNN train step on its
1-rank mesh, and the corpus driver's two batch runners.

Where the JAX catalog pins a backend-independent lane (``'fused-xla'``,
``cov_impl='xla'``, ``stft_impl='xla'``), the port takes its default
route, the one the card runs: the hand-written kernels (``'fused'``,
``'auto'``).  Solvers with no kernel (``'power'``, ``'eigh'``) are the
JAX catalog's.  A ``build(device)`` returns ``(fn, args, kwargs)`` with
:class:`~.fingerprint.Struct` leaves in ``args``; the tracer makes them
fake ``cuda`` tensors, or real tensors from a seed.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from disco_tpu_torch.analysis.trace.fingerprint import Struct

K = 2          #: nodes
C = 2          #: mics per node
F = 5          #: frequency bins
T = 8          #: frames per block (a multiple of UPDATE_EVERY)
B = 2          #: clip batch of the corpus runners
UPDATE_EVERY = 4
BLOCKS_PER_DISPATCH = 2  #: super-tick width of the scanned program

#: the solver the JAX catalog pins for the steps and runners (no kernel)
SOLVER = "power"
#: the port's default routes: the hand-written kernels
COV_IMPL = "auto"
FUSED = "fused"

#: time-domain lengths of the chained-clip programs (the STFT grid is
#: 512/256, so F = 257 there): CLIP_L gives 5 frames, WINDOW_L the 8 frames
#: of one BLOCKS_PER_DISPATCH x UPDATE_EVERY super-tick window
CLIP_L = 1024
WINDOW_L = (BLOCKS_PER_DISPATCH * UPDATE_EVERY - 1) * 256
STFT_F = 257


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One catalog program: ``build(device) -> (fn, args, kwargs)``.

    ``donate``: None or the JAX catalog's donation declaration (``arg``,
    the positional index of the carried state; ``must_alias``; ``note``),
    which the port checks by what donation buys (:mod:`.audits`).
    ``context``: what the program needs around its call (the 1-rank world
    of the train step's mesh).  ``real_because``: why the program is traced
    on real CPU tensors rather than for the card on fake ones (None: it is
    traced for the card).
    """

    name: str
    summary: str
    build: callable
    donate: dict | None = None
    context: callable = contextlib.nullcontext
    real_because: str | None = None


def _c64(*shape):
    return Struct(tuple(shape), torch.complex64)


def _f32(*shape):
    return Struct(tuple(shape), torch.float32)


def _state_structs():
    """The streaming continuation carry as declared inputs — exactly
    ``initial_stream_state``'s structure (the serve session carry)."""
    from disco_tpu_torch.enhance.streaming import initial_stream_state

    state = initial_stream_state(K, C, F, update_every=UPDATE_EVERY)
    dtypes = {np.dtype(np.complex64): torch.complex64, np.dtype(bool): torch.bool}

    def leaf(x):
        return Struct(tuple(x.shape), dtypes[x.dtype])

    return _tree(state, leaf)


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_tree(v, leaf) for v in x)
    return leaf(x)


def _step2_args():
    all_z = {key: _c64(K, F, T) for key in ("z_y", "z_s", "z_n", "zn", "z_t1_s", "z_t1_n")}
    return (_c64(C, F, T), _c64(C, F, T), _c64(C, F, T), _f32(F, T),
            Struct((), torch.int32),                  # node index k, a tensor
            all_z, _f32(K, F, T), _c64(K, F, T), _c64(K, F, T))


def _build_tango_step1(device):
    from disco_tpu_torch.enhance.tango import tango_step1

    args = (_c64(C, F, T), _c64(C, F, T), _c64(C, F, T), _f32(F, T))
    return tango_step1, args, {"solver": SOLVER, "cov_impl": COV_IMPL}


def _step2(solver):
    def build(device):
        from disco_tpu_torch.enhance.tango import tango_step2

        return tango_step2, _step2_args(), {"policy": "local", "solver": solver,
                                            "cov_impl": COV_IMPL}
    return build


def _step1_all(solver):
    def build(device):
        from disco_tpu_torch.enhance.zexport import compute_z_signals

        def step1_all(Y, S, N, m):
            return compute_z_signals(None, None, None, Y=Y, S=S, N=N, masks_z=m,
                                     solver=solver, cov_impl=COV_IMPL, device=device)

        args = (_c64(K, C, F, T), _c64(K, C, F, T), _c64(K, C, F, T), _f32(K, F, T))
        return step1_all, args, {}
    return build


def _build_tango_clip_fused(device):
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    args = (_f32(K, C, CLIP_L), _f32(K, C, CLIP_L), _f32(K, C, CLIP_L))
    return tango_clip_fused.__wrapped__, args, {
        "solver": FUSED, "cov_impl": COV_IMPL, "stft_impl": "auto", "device": device}


def _build_streaming_clip_fused(device):
    from disco_tpu_torch.enhance.fused import streaming_clip_fused

    t = BLOCKS_PER_DISPATCH * UPDATE_EVERY

    def fn(y, mz, mw):
        return streaming_clip_fused.__wrapped__(
            y, None, None, mz, mw, update_every=UPDATE_EVERY,
            blocks_per_dispatch=BLOCKS_PER_DISPATCH, solver=FUSED, stft_impl="auto",
            device=device)

    return fn, (_f32(K, C, WINDOW_L), _f32(K, STFT_F, t), _f32(K, STFT_F, t)), {}


def _streaming_args():
    return (_c64(K, C, F, T), _f32(K, F, T), _f32(K, F, T))


def _build_streaming_tango(device):
    from disco_tpu_torch.enhance import streaming

    return (streaming.streaming_tango.__wrapped__, _streaming_args(),
            {"update_every": UPDATE_EVERY, "solver": "eigh", "device": device})


def _build_streaming_tango_state(device):
    from disco_tpu_torch.enhance import streaming

    def with_state(Y, mz, mw, state):
        return streaming.streaming_tango.__wrapped__(
            Y, mz, mw, update_every=UPDATE_EVERY, solver="eigh", state=state, device=device)

    return with_state, (*_streaming_args(), _state_structs()), {}


def _build_streaming_tango_scan(device):
    from disco_tpu_torch.enhance import streaming

    n = BLOCKS_PER_DISPATCH
    args = (_c64(K, C, F, n * T), _f32(K, F, n * T), _f32(K, F, n * T))
    return (streaming.streaming_tango_scan.__wrapped__, args,
            {"update_every": UPDATE_EVERY, "solver": "eigh", "blocks_per_dispatch": n,
             "device": device})


def _batch_args(with_masks: bool):
    stack = (_c64(B, K, C, F, T),) * 3
    return stack + ((_f32(B, K, F, T), _f32(B, K, F, T)) if with_masks else ())


#: tiny scene-batch statics: 2 scenes x 2 sources x 3 mics, a 512-tap RIR
#: bucket at order 2, 1024-sample dry clips
SCENE_B, SCENE_S, SCENE_M = 2, 2, 3
SCENE_RIR_LEN, SCENE_ORDER, SCENE_L = 512, 2, 1024


def _build_scene_batch(device):
    from disco_tpu_torch.scenes.batched import _scene_batch_program

    args = (_f32(SCENE_B, 3), _f32(SCENE_B, SCENE_S, 3), _f32(SCENE_B, SCENE_M, 3),
            _f32(SCENE_B), _f32(SCENE_B, SCENE_S, SCENE_L), _f32(SCENE_B))
    return _scene_batch_program.__wrapped__, args, {
        "max_order": SCENE_ORDER, "rir_len": SCENE_RIR_LEN, "fs": 16000}


#: the tiny CRNN of the train_step program: one conv layer, one GRU,
#: sigmoid FF — the step's whole shape (forward, loss, backward, RMSprop)
TRAIN_WIN = 5
TRAIN_FREQ = 8
TRAIN_BATCH = 4


def _train_model(device="cpu"):
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer

    torch.manual_seed(0)
    with torch.device(device):   # made where it runs (a fake tensor cannot be moved there)
        model = build_crnn(n_ch=1, win_len=TRAIN_WIN, n_freq=TRAIN_FREQ, cnn_filters=(2,),
                           pool_kernels=((1, 2),), conv_padding=((0, 1),), rnn_units=(4,),
                           ff_units=(TRAIN_FREQ,), rnn_dropouts=0.0)
    return model, build_optimizer(model)


def _mesh_device(device) -> str:
    """The train step's mesh: NCCL on a real card, else gloo on the host (a
    trace for the card on fake tensors runs the collectives' fake
    implementations, which send nothing)."""
    from disco_tpu_torch.device import tracing_for_card

    real_card = (torch.device(device).type == "cuda" and torch.cuda.is_available()
                 and not tracing_for_card())
    return "cuda" if real_card else "cpu"


def _train_world(device="cpu"):
    """The 1-rank world of the train step's mesh (:func:`_mesh_device`)."""
    from disco_tpu_torch.parallel.multihost import single_rank_world

    return single_rank_world(_mesh_device(device))


def _build_train_step(device):
    from disco_tpu_torch.nn.training import create_train_state, make_step_fns
    from disco_tpu_torch.parallel.mesh import make_mesh

    from torch._subclasses.fake_tensor import unset_fake_temporarily

    model, tx = _train_model(device)
    with unset_fake_temporarily():   # the mesh is set-up, made of real tensors
        mesh = make_mesh(n_node=1, n_batch=1, device=_mesh_device(device))
    train_step, _eval_step = make_step_fns(model, "all", mesh=mesh)
    state = create_train_state(model, tx, seed=0)
    args = (state, _f32(TRAIN_BATCH, TRAIN_WIN, TRAIN_FREQ),
            _f32(TRAIN_BATCH, TRAIN_WIN, TRAIN_FREQ))
    return train_step.__wrapped__, args, {}


def _runner(with_masks: bool):
    def build(device):
        from disco_tpu_torch.enhance.driver import make_batch_runners

        runners = make_batch_runners(mask_type="irm1", mu=1.0, policy="local", solver=SOLVER,
                                     cov_impl=COV_IMPL, n_nodes=K, device=device)
        return runners[int(with_masks)].__wrapped__, _batch_args(with_masks), {}
    return build


#: name -> ProgramSpec, in the JAX catalog's order
PROGRAMS: dict = {
    spec.name: spec
    for spec in (
        ProgramSpec("tango_step1", "offline step-1 local MWF at one node (enhance/tango.py)",
                    _build_tango_step1),
        ProgramSpec("tango_step2",
                    "offline step-2 global MWF on [y_k ‖ z_j≠k] (enhance/tango.py)",
                    _step2(SOLVER)),
        ProgramSpec("tango_step2_fused",
                    "offline step-2 with the fused rank-1 GEVD-MWF solve (the kernel op "
                    "disco_torch::fused_mwf) — no pencil-shaped output escapes",
                    _step2(FUSED)),
        ProgramSpec("tango_step2_eigh",
                    "offline step-2 with the separate-stage eigh solver — the fused solve's "
                    "traffic baseline (meter cross-budget)", _step2("eigh")),
        ProgramSpec("tango_step1_fused",
                    "step-1 local MWF over ALL K nodes as one fused solve "
                    "(enhance/zexport.py compute_z_signals)", _step1_all(FUSED)),
        ProgramSpec("tango_step1_eigh",
                    "step-1 local MWF over all K nodes, separate-stage eigh — the fused "
                    "step-1's traffic baseline (meter cross-budget)", _step1_all("eigh")),
        ProgramSpec("tango_clip_fused",
                    "whole offline clip: STFT → masks → both MWF steps → ISTFT "
                    "(enhance/fused.py) — no spectrogram-shaped output escapes",
                    _build_tango_clip_fused),
        ProgramSpec("streaming_clip_fused",
                    "streaming chained super-tick: time-domain window + masks in, enhanced "
                    "window + continuation state out (enhance/fused.py)",
                    _build_streaming_clip_fused),
        ProgramSpec("streaming_tango",
                    "per-block streaming body, warm start (enhance/streaming.py)",
                    _build_streaming_tango),
        ProgramSpec("streaming_tango_state",
                    "per-block streaming body with continuation state — what the serve "
                    "scheduler dispatches every tick", _build_streaming_tango_state,
                    donate={"arg": 3, "must_alias": True,
                            "note": "the JAX serve step donates the session carry; the port "
                                    "keeps no reference to the old carry"}),
        ProgramSpec("streaming_tango_scan",
                    f"scanned super-tick driver, N={BLOCKS_PER_DISPATCH} "
                    "(enhance/streaming.py)", _build_streaming_tango_scan),
        ProgramSpec("scene_batch",
                    "batched scenario factory: ISM RIRs → FFT convolve → SNR mix → "
                    "reference-mic STFT magnitudes + IRM mask (scenes/batched.py)",
                    _build_scene_batch),
        ProgramSpec("train_step",
                    "CRNN train step on a 1-rank data-parallel mesh (nn/training.py "
                    "make_step_fns: summed gradients, in-place RMSprop)",
                    _build_train_step,
                    real_because="the backward pass and cuDNN's GRU need the CUDA runtime, "
                                 "which a torch build without CUDA aborts on, fake tensors "
                                 "or not",
                    donate={"arg": None, "must_alias": True,
                            "note": "the JAX mesh lane donates the TrainState; the port "
                                    "updates the parameters and nu in place"},
                    context=_train_world),
        ProgramSpec("run_batch",
                    "corpus per-chunk batch program, oracle masks (enhance/driver.py "
                    "make_batch_runners)", _runner(False),
                    donate={"arg": None, "must_alias": False,
                            "note": "the JAX driver donates the STFT stacks off-CPU; the port "
                                    "drops its references once a runner returns"}),
        ProgramSpec("run_batch_with_masks",
                    "corpus per-chunk batch program, masks passed in (enhance/driver.py "
                    "make_batch_runners)", _runner(True),
                    donate={"arg": None, "must_alias": False,
                            "note": "the JAX driver donates the STFT stacks off-CPU; the port "
                                    "drops its references once a runner returns"}),
    )
}
