"""The per-block oracle of the scanned streaming path (counterpart of
``disco_tpu/enhance/stream_check.py::per_block_reference``).

Inside the port, a stream driven through ``streaming_tango_scan`` super
ticks is bit-identical to the same stream driven block by block through
``streaming_tango`` with the state carried; this loop is that per-block
side, the one calling convention the checks compare against.
:func:`check_readback_invariant` is the serve scheduler's half: its
super-ticks read back once a super-tick and deliver what the per-block
scheduler delivers.
"""
from __future__ import annotations

import numpy as np
import torch

from disco_tpu_torch.enhance.streaming import streaming_tango


def per_block_reference(Y, m, *, block: int, update_every: int, state, plan=None,
                        solver: str = "eigh", precision: str = "f32", device=None):
    """``streaming_tango`` block by block over (K, C, F, T) spectra ``Y``
    and (K, F, T) masks ``m`` (both steps use ``m``): blocks of ``block``
    frames, the explicit ``state`` carried from call to call, and per-block
    ``z_avail`` columns of ``plan`` ((K, T // update_every), all ones when
    None).

    Returns (yf (K, F, T // block * block), the final state)."""
    K, T = Y.shape[0], Y.shape[-1]
    per = block // update_every
    outs = []
    for i in range(T // block):
        lo, hi = i * block, (i + 1) * block
        avail = (np.ones((K, per), np.float32) if plan is None
                 else plan[:, i * per:(i + 1) * per])
        o = streaming_tango(Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi],
                            update_every=update_every, state=state, z_avail=avail,
                            solver=solver, precision=precision, device=device)
        state = o["state"]
        outs.append(o["yf"])
    return torch.cat(outs, dim=-1), state


def check_readback_invariant(failures: list, Y, m, *, block: int, update_every: int,
                             n_super: int = 4, device=None) -> dict:
    """The serve scheduler's readback half (counterpart of
    ``disco_tpu/enhance/stream_check.py::_check_readback_invariant``): the
    stream (K, C, F, T) ``Y`` with masks ``m`` through a per-block
    scheduler and through one with ``blocks_per_super_tick=n_super``,
    driven tick by tick on the calling thread.  The super-tick run's
    batched readbacks (``device_get_batches``) are at most one a super-tick
    plus the per-block tail, fewer than the per-block run's, and both
    deliver the same blocks bit for bit.  Appends what is wrong to
    ``failures``; returns both runs' readback counts."""
    from disco_tpu_torch.obs.accounting import device_get_count
    from disco_tpu_torch.serve.scheduler import Scheduler
    from disco_tpu_torch.serve.session import SessionConfig

    K, C, F, T = Y.shape
    cfg = SessionConfig(n_nodes=K, mics_per_node=C, n_freq=F, block_frames=block,
                        update_every=update_every)
    n_blocks = -(-T // block)

    def run(sched):
        s = sched.open_session(cfg)
        outs, i = {}, 0
        gets0 = device_get_count()
        while i < n_blocks:
            for _ in range(sched.blocks_per_super_tick):
                if i < n_blocks:
                    lo, hi = i * block, min((i + 1) * block, T)
                    sched.push_block(s, i, Y[..., lo:hi], m[..., lo:hi], m[..., lo:hi])
                    i += 1
            outs.update({seq: yf for _s, seq, yf, _lat in sched.tick()})
        while sched.pending_blocks():
            outs.update({seq: yf for _s, seq, yf, _lat in sched.tick()})
        if len(outs) != n_blocks:
            failures.append(f"scheduler delivered {len(outs)}/{n_blocks} blocks")
            return None, 0
        return (np.concatenate([outs[j] for j in range(n_blocks)], axis=-1),
                device_get_count() - gets0)

    ref, gets_block = run(Scheduler(max_sessions=2, max_queue_blocks=2 * n_super,
                                    device=device))
    got, gets_scan = run(Scheduler(max_sessions=2, max_queue_blocks=2 * n_super,
                                   blocks_per_super_tick=n_super, device=device))
    if ref is None or got is None:
        return {}
    if not np.array_equal(got, ref):
        failures.append("super-tick scheduler output differs from the per-block scheduler "
                        f"(max abs diff {np.abs(got - ref).max():g})")
    full = n_blocks - 1 if T % block else n_blocks
    expected = full // n_super + (full % n_super) + (1 if T % block else 0)
    if gets_scan > expected:
        failures.append(f"readback invariant: {gets_scan} batched readbacks for {n_blocks} "
                        f"blocks at N={n_super} (expected <= {expected})")
    if gets_scan >= gets_block:
        failures.append(f"super-ticks did not reduce readbacks: {gets_scan} vs "
                        f"{gets_block} per-block")
    return {"blocks": n_blocks, "readbacks_per_block_path": gets_block,
            "readbacks_supertick_path": gets_scan}
