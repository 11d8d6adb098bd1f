#!/usr/bin/env python3
"""SI-SDR of the JAX package's ``streaming_clip_fused`` on the streaming
scene of ``chip_smoke.py``, as a witness for the PyTorch port's windows.

The scene (8 nodes x 4 mics, 16 kHz, seed 0), the window length and the
number of windows are ``chip_smoke.py``'s own (imported from it, so the
inputs are the same numpy arrays).  The windows run one after another
with the state carried, under ``solver='jacobi'``: the fixed-sweep Jacobi
schedule of ``'jacobi-pallas'`` compiled by XLA (the Pallas kernel has no
CPU lowering, and its interpreter is far too slow at C = 11).  Each
window is one 64-frame block (``blocks_per_dispatch=1``): the JAX scan
unrolls its N bodies, and 16 unrolled bodies of the C = 11 Jacobi solve
take XLA on the CPU more than ten minutes and 10 GB to compile.  The
recursion is the same; only roundoff differs from 16 blocks of 4 frames.
The script prints, for node 0:

* the SI-SDR gain over the noisy reference mic after t = 1, 2, 3 s, as
  ``chip_smoke.py`` reads it for the port's windows;
* the same gain with the samples within one hop of a window boundary
  left out, which separates the per-window framing of the boundary (each
  window's STFT is centred and reflect-padded on its own) from the rest.

With ``--framing`` it instead runs one recursion (``streaming_tango``,
``solver='eigh'``, 64 frames a call with the state carried) on three
framings of the same nine windows, and prints each one's gains:

* ``full clip``: the frames of one whole-clip STFT, 63 hops a window;
* ``full-clip frames, 64 a window``: the same frames, but each window
  takes 64 of them, so its last frame is the next window's first (as
  with the windows' own STFTs); the duplicate's output is dropped;
* ``window STFTs``: each window's own reflect-padded STFT and masks, and
  an ISTFT per window: the framing of ``streaming_clip_fused``.

Run on the CPU from the repo root (each takes about ten minutes)::

    JAX_PLATFORMS=cpu python3 exp/stream_windows_witness.py
    JAX_PLATFORMS=cpu python3 exp/stream_windows_witness.py --framing
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (numpy-only helpers and the scene's constants)

HOP = 256


def framing() -> dict:
    """SI-SDR gains of one streaming recursion over three framings of the
    nine windows (see the module docstring)."""
    import jax.numpy as jnp

    from disco_tpu.core.dsp import istft
    from disco_tpu.core.masks import tf_mask_mag
    from disco_tpu.enhance.streaming import initial_stream_state, streaming_tango
    from disco_tpu.ops.stft_ops import stft_with_mag

    L = int(cs.DUR_S * cs.FS)
    y, s, n = cs.scene(cs.K, cs.C, L, noise_scale=cs.NOISE_SCALE)
    Tw = 1 + cs.LW // HOP                       # frames a window: 64
    Lc = cs.N_WINDOWS * cs.LW
    F = 257
    # one compiled program for every call: the warm start without the hold carries
    st0 = {k: v for k, v in initial_stream_state(cs.K, cs.C, F).items() if k != "hold"}

    def run(chunks):
        """streaming_tango over (Y, m) chunks of Tw frames, the state carried."""
        state, outs = st0, []
        for Y, m in chunks:
            o = streaming_tango(Y, m, m, solver="eigh", state=state)
            state = {k: v for k, v in o["state"].items() if k != "hold"}
            outs.append(np.asarray(o["yf"]))
        return outs

    def spectra(x):
        spec, mag = stft_with_mag(jnp.asarray(np.stack(x)))
        return np.asarray(spec[0]), np.asarray(tf_mask_mag(mag[1][:, 0], mag[2][:, 0], "irm1"))

    Yf, mf = spectra((y, s, n))
    outs = {}
    # the whole clip's frames, 63 hops a window
    o = run((Yf[..., a:a + Tw], mf[..., a:a + Tw]) for a in range(0, Tw * cs.N_WINDOWS, Tw))
    outs["full clip"] = np.asarray(istft(jnp.asarray(np.concatenate(o, -1)), length=L))[:, :Lc]
    # the same frames, 64 a window: each window's last is the next one's first
    starts = [w * (Tw - 1) for w in range(cs.N_WINDOWS)]
    o = run((Yf[..., a:a + Tw], mf[..., a:a + Tw]) for a in starts)
    kept = np.concatenate([x[..., :Tw - 1] for x in o] + [o[-1][..., Tw - 1:]], -1)
    outs["full-clip frames, 64 a window"] = np.asarray(istft(jnp.asarray(kept), length=Lc))
    # each window's own reflect-padded STFT, an ISTFT per window
    win = [spectra(tuple(a[..., w * cs.LW:(w + 1) * cs.LW] for a in (y, s, n)))
           for w in range(cs.N_WINDOWS)]
    o = run(win)
    outs["window STFTs"] = np.concatenate(
        [np.asarray(istft(jnp.asarray(x), length=cs.LW)) for x in o], -1)
    clean, noisy = s[0, 0, :Lc], y[0, 0, :Lc]
    return {k: cs.sdr_gains(clean, noisy, v[0]) for k, v in outs.items()}


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from disco_tpu.enhance.fused import streaming_clip_fused

    if "--framing" in sys.argv[1:]:
        t0 = time.perf_counter()
        print(json.dumps({"what": "JAX streaming_tango, solver='eigh', node 0, SI-SDR gain over "
                                  "the noisy reference mic after t s, by framing",
                          "gain_db": framing(), "seconds": time.perf_counter() - t0}))
        return 0

    L = int(cs.DUR_S * cs.FS)
    y, s, n = cs.scene(cs.K, cs.C, L, noise_scale=cs.NOISE_SCALE)
    state, outs = None, []
    t0 = time.perf_counter()
    for w in range(cs.N_WINDOWS):
        sl = slice(w * cs.LW, (w + 1) * cs.LW)
        o = streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=state,
                                 solver="jacobi", blocks_per_dispatch=1)
        state = o["state"]
        outs.append(np.asarray(o["yf"]))
        print(f"window {w + 1}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    out = np.concatenate(outs, axis=-1)
    assert out.shape == (cs.K, cs.N_WINDOWS * cs.LW) and np.isfinite(out).all()
    Lc = out.shape[-1]
    clean, noisy, out0 = s[0, 0, :Lc], y[0, 0, :Lc], out[0]
    print(json.dumps({
        "what": "JAX streaming_clip_fused, solver='jacobi', node 0, SI-SDR gain over the "
                "noisy reference mic after t s",
        "windows": cs.N_WINDOWS, "window_samples": cs.LW,
        "blocks_per_dispatch": 1,
        "gain_db": cs.sdr_gains(clean, noisy, out0),
        "gain_db_without_window_edges": cs.sdr_gains(clean, noisy, out0, cs.window_interior(Lc)),
        "seconds": time.perf_counter() - t0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
