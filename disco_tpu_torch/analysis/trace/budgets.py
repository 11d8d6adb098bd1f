"""Retrace budgets: an exact per-label count of the call signatures the
miniature workload makes (counterpart of
``disco_tpu/analysis/trace/budgets.py``).

The port compiles no program per call signature, so there is no retrace
to pay for; what ``counted_jit`` (``obs/accounting.py``) counts is what
would make the JAX package trace a new program — a new shape, dtype, scalar type or
static value at an entry point.  The gate runs the JAX workload through
the port's entry points on the CPU with cleared signature sets and holds
every label to an exact count: one more means a new signature seam (the
``mu=1`` trap: an int where a float was), one fewer means the workload no
longer exercises the entry point.

Where the port's count differs from the JAX package's ``BUDGETS``
(``disco_tpu/analysis/trace/budgets.py``), :data:`DIFFERS` names the label
and why.
"""
from __future__ import annotations

from disco_tpu_torch.analysis.trace.programs import (
    B,
    BLOCKS_PER_DISPATCH,
    C,
    CLIP_L,
    COV_IMPL,
    FUSED,
    K,
    SOLVER,
    STFT_F,
    T,
    TRAIN_BATCH,
    TRAIN_FREQ,
    TRAIN_WIN,
    UPDATE_EVERY,
    WINDOW_L,
)

#: label -> exact number of signatures the miniature workload makes
BUDGETS: dict = {
    "streaming_tango": 4,
    "streaming_step1": 2,
    "streaming_tango_scan": 1,
    "run_batch": 1,
    "run_batch_with_masks": 1,
    "run_batch_chained": 1,
    "tango_clip_fused": 2,
    "streaming_clip_fused": 2,
    "train_step": 4,
    "eval_step": 4,
}

#: label -> why the port's count is not the JAX package's
DIFFERS: dict = {
    "streaming_tango": (
        "the JAX host wrapper canonicalizes the precision token before its jit, so "
        "precision=' F32 ' is the 'f32' program there; the port's counted_jit keys the "
        "static precision value as it is passed, so the spelling variant is one more "
        "signature (no program is built for it: the port compiles nothing) — 4 against 3"
    ),
    "train_step": (
        "make_step_fns memoizes its step functions on the canonical key in the JAX "
        "package; the port builds new counted step functions at every factory call, so "
        "the second f32 factory call (precision=' F32 ') counts its signature afresh"
    ),
    "eval_step": "as train_step: the port's make_step_fns does not memoize",
}


def _inputs(rng, t):
    import numpy as np

    Y = (rng.standard_normal((K, C, 5, t)) +
         1j * rng.standard_normal((K, C, 5, t))).astype(np.complex64)
    mz = rng.uniform(0.1, 0.9, (K, 5, t)).astype(np.float32)
    mw = rng.uniform(0.1, 0.9, (K, 5, t)).astype(np.float32)
    return Y, mz, mw


def _entries():
    """The entry points the workload clears before it runs."""
    from disco_tpu_torch.enhance import fused, streaming

    return (streaming.streaming_tango, streaming.streaming_step1,
            streaming.streaming_tango_scan, fused.tango_clip_fused,
            fused.streaming_clip_fused)


def run_workload(extra=None) -> None:
    """The miniature workload on the CPU route, from cleared signature sets.

    ``extra``: optional callable run after the canonical calls, given the
    streaming module and one block's inputs — the tests push one more call
    through a fresh call site (an int ``mu``) and expect the gate to fail.
    """
    import numpy as np

    from disco_tpu_torch.enhance import streaming
    from disco_tpu_torch.enhance.driver import make_batch_runners

    for entry in _entries():
        entry.clear_cache()
    cpu = {"device": "cpu"}
    rng = np.random.default_rng(0)
    Y, mz, mw = _inputs(rng, T)

    out = streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, lambda_cor=0.99, mu=1.0,
                              **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, state=out["state"], **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, precision="f32", **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, precision=" F32 ", **cpu)
    streaming.streaming_tango(Y, mz, mw, update_every=UPDATE_EVERY, precision="bf16", **cpu)

    s1 = streaming.streaming_step1(Y[0], mz[0], update_every=UPDATE_EVERY, **cpu)
    streaming.streaming_step1(Y[0], mz[0], update_every=UPDATE_EVERY, **cpu)
    streaming.streaming_step1(Y[0], mz[0], update_every=UPDATE_EVERY,
                              state=(s1["Rss"], s1["Rnn"], s1["w"]), **cpu)

    n = BLOCKS_PER_DISPATCH
    Y2, mz2, mw2 = _inputs(rng, n * T)
    streaming.streaming_tango_scan(Y2, mz2, mw2, update_every=UPDATE_EVERY,
                                   blocks_per_dispatch=n, **cpu)

    run_batch, run_batch_with_masks = make_batch_runners(
        mask_type="irm1", mu=1.0, policy="local", solver=SOLVER, cov_impl=COV_IMPL,
        n_nodes=K, **cpu)
    import torch

    Yb, Sb, Nb = (torch.as_tensor(np.stack([_inputs(rng, T)[0] for _ in range(B)]))
                  for _ in range(3))
    run_batch(Yb, Sb, Nb)
    run_batch(Yb, Sb, Nb)  # the same signature
    Mz = torch.as_tensor(np.stack([_inputs(rng, T)[1] for _ in range(B)]))
    run_batch_with_masks(Yb, Sb, Nb, Mz, Mz)

    _chained_workload(rng)
    _train_workload(rng)

    if extra is not None:
        extra(streaming, Y, mz, mw)


def _chained_workload(rng) -> None:
    """The chained programs: the whole clip in its two static shapes
    (deployment and export), the streaming super-tick warm and continued,
    the chained corpus runner."""
    import numpy as np

    from disco_tpu_torch.enhance import fused
    from disco_tpu_torch.enhance.driver import make_batch_runners

    cpu = {"device": "cpu"}
    yt, st, nt = (rng.standard_normal((K, C, CLIP_L)).astype(np.float32) for _ in range(3))
    fused.tango_clip_fused(yt, st, nt, solver=FUSED, cov_impl=COV_IMPL, **cpu)
    fused.tango_clip_fused(yt, st, nt, solver=FUSED, cov_impl=COV_IMPL, **cpu)
    fused.tango_clip_fused(yt, st, nt, mu=1.0, solver=FUSED, cov_impl=COV_IMPL, **cpu)
    fused.tango_clip_fused(yt, st, nt, solver=FUSED, cov_impl=COV_IMPL, export=True, **cpu)

    t = BLOCKS_PER_DISPATCH * UPDATE_EVERY
    yw = rng.standard_normal((K, C, WINDOW_L)).astype(np.float32)
    mzw = rng.uniform(0.1, 0.9, (K, STFT_F, t)).astype(np.float32)
    kw = {"update_every": UPDATE_EVERY, "blocks_per_dispatch": BLOCKS_PER_DISPATCH, **cpu}
    out = fused.streaming_clip_fused(yw, masks_z=mzw, **kw)
    fused.streaming_clip_fused(yw, masks_z=mzw, **kw)
    fused.streaming_clip_fused(yw, masks_z=mzw, state=out["state"], **kw)

    run_batch_chained, _none = make_batch_runners(
        mask_type="irm1", mu=1.0, policy="local", solver=FUSED, cov_impl=COV_IMPL,
        stft_impl="auto", n_nodes=K, chained=True, **cpu)
    ytb, stb, ntb = (np.stack([rng.standard_normal((K, C, CLIP_L)).astype(np.float32)
                               for _ in range(B)]) for _ in range(3))
    run_batch_chained(ytb, stb, ntb)
    run_batch_chained(ytb, stb, ntb)  # the same signature


def _train_workload(rng) -> None:
    """The training lanes: f32 on one device, f32 on the 1-rank mesh (gloo),
    bf16; repeat steps, a second factory call with a non-canonical
    precision spelling."""
    import numpy as np

    from disco_tpu_torch.analysis.trace.programs import _train_model
    from disco_tpu_torch.nn import training
    from disco_tpu_torch.parallel.mesh import make_mesh
    from disco_tpu_torch.parallel.multihost import single_rank_world

    x = rng.standard_normal((TRAIN_BATCH, TRAIN_WIN, TRAIN_FREQ)).astype(np.float32)
    y = rng.uniform(0.1, 0.9, x.shape).astype(np.float32)

    model, tx = _train_model()
    state0 = training.create_train_state(model, tx, x[:1], seed=0)
    train_step, eval_step = training.make_step_fns(model, "all")
    s, _ = train_step(state0, x, y)
    s, _ = train_step(s, x, y)
    eval_step(s, x, y)
    eval_step(s, x, y)
    again_t, again_e = training.make_step_fns(model, "all", precision=" F32 ")
    again_t(s, x, y)
    again_e(s, x, y)

    with single_rank_world("cpu"):
        mesh = make_mesh(n_node=1, n_batch=1, device="cpu")
        mt, me = training.make_step_fns(model, "all", mesh=mesh)
        ms = training.replicate_to_mesh(training.create_train_state(model, tx, seed=0), mesh)
        ms, _ = mt(ms, x, y)
        ms, _ = mt(ms, x, y)
        me(ms, x, y)

    bt, be = training.make_step_fns(model, "all", precision="bf16")
    bs, _ = bt(state0, x, y)
    bs, _ = bt(bs, x, y)
    be(bs, x, y)


def check_budgets(extra=None) -> tuple:
    """Run the workload and diff the per-label counts against
    :data:`BUDGETS`: ``(findings, counts)``."""
    from disco_tpu_torch.obs.accounting import recompile_count

    before = {label: recompile_count(label) for label in BUDGETS}
    run_workload(extra=extra)
    counts = {label: recompile_count(label) - before[label] for label in BUDGETS}
    findings = []
    for label, budget in BUDGETS.items():
        n = counts[label]
        if n > budget:
            findings.append(
                f"label {label!r} counted {n} signatures, budget {budget}: a new signature "
                "seam (the mu=1 trap — check argument types at new call sites)")
        elif n < budget:
            findings.append(
                f"label {label!r} counted {n} signatures, budget {budget}: the workload no "
                "longer exercises this entry point (update budgets.py)")
    return findings, counts
