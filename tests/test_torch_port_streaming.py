"""The port's streaming two-step TANGO (``disco_tpu_torch.enhance.streaming``,
``enhance.fused.streaming_clip_fused``, ``enhance.stream_check``) against the
JAX package on the same numpy inputs, and its scan-vs-per-block contract.

Tolerance: 1e-4 of the output scale (max |a - b| / max |b|), the
streaming-twin and chained-clip bound of ``doc/source/performance.rst``.

Where the comparison starts matters.  The warm start is ``R0 = 1e-6 I``;
at the scene's natural level (STFT bins of power ~1e2) the first refresh
sees two rank-1 pencils ``1e-6 I + 0.01 x x^H`` in the same direction x,
conditioned ~1e6, and at step 2 its dominant generalized eigenvalue is
(D-1)-fold degenerate when the mask is below 1/2: its filter is set by
roundoff in either framework, and the difference (larger than the
output scale in the first block) stays in the step-2 covariances with
weight 0.99^t.  So the tests compare (a) from the warm start on the
scene scaled by 1e-3, where ``R0`` is not negligible and only step 2's
first refresh block (``update_every`` frames) stays degenerate and is
skipped; and (b) at the natural level from a state warmed up by the
other framework (``state_from_numpy`` / ``state_to_numpy``), over every
frame.

Inside the port, scanned super ticks and the per-block loop
(``per_block_reference``) run the same function on the same inputs, and
are held bit for bit (``torch.equal``).
"""
import numpy as np
import pytest
import torch

from disco_tpu.core import dsp as jdsp
from disco_tpu.enhance import fused as jfused
from disco_tpu.enhance import streaming as jstream
from disco_tpu.enhance.tango import oracle_masks as j_oracle_masks
from disco_tpu_torch.enhance import fused as tfused
from disco_tpu_torch.enhance import streaming as tstream
from disco_tpu_torch.enhance.stream_check import per_block_reference
from tests.torch_port_helpers import max_rel, scene, to_np

TOL = 1e-4
K, C, U = 3, 2, 4
T = 64
L = 256 * (T - 1)      # T STFT frames
T_WARM = 32            # (b): frames of the warm-up call, then T - T_WARM continued
QUIET = 1e-3


@pytest.fixture(scope="module")
def spectra():
    """(K, C, F, T) mixture / speech / noise STFTs and two different soft
    oracle masks (a binary step-2 mask leaves the step-2 noise covariances
    rank-deficient)."""
    y, s, n = scene(K, C, L, seed=1, noise_scale=0.5)
    Y, S, N = (np.asarray(jdsp.stft(a)) for a in (y, s, n))
    mz = np.asarray(j_oracle_masks(S, N, "irm1"))
    mw = np.asarray(j_oracle_masks(S, N, "irm2"))
    assert Y.shape[-1] == T
    return Y, S, N, mz, mw


def _close(ours, ref, keys, frames=slice(None)):
    for key in keys:
        a, b = to_np(ours[key])[..., frames], np.asarray(ref[key])[..., frames]
        assert a.shape == b.shape, key
        assert max_rel(a, b) <= TOL, (key, max_rel(a, b))


def test_initial_stream_state_matches_jax():
    ours = tstream.initial_stream_state(K, C, 257, update_every=U, ref_mic=1)
    ref = jstream.initial_stream_state(K, C, 257, update_every=U, ref_mic=1)
    assert sorted(ours) == sorted(ref) and sorted(ours["hold"]) == sorted(ref["hold"])
    for a, b in zip(tstream.state_leaves(ours), tstream.state_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hold_last_good_matches_jax_exactly():
    """A pure select: equal bit for bit, with a fallback, a carry, a padded
    tail block and the (K,) shorthand."""
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((K, 257, 30)) + 1j * rng.standard_normal((K, 257, 30))).astype(
        np.complex64)
    fb = (0.5 * z[:, :, ::-1]).copy()
    avail = np.ones((K, 8), np.float32)       # ceil(30 / 4) blocks
    avail[0, 0:2] = 0                          # leading loss -> fallback
    avail[1, 3:6] = 0                          # mid-stream loss -> last good block
    avail[2, 7] = 0                            # the padded tail block
    carry = ((rng.standard_normal((K, 257, U)) + 0j).astype(np.complex64),
             np.array([True, False, True]))
    zt, fbt = torch.from_numpy(z), torch.from_numpy(fb)
    for kw, tkw in (({}, {}),
                    ({"fallback": fb}, {"fallback": fbt}),
                    ({"fallback": fb, "carry": carry},
                     {"fallback": fbt, "carry": tuple(torch.from_numpy(c) for c in carry)})):
        ours, (last, seen) = tstream.hold_last_good(zt, avail, U, return_carry=True, **tkw)
        ref, (j_last, j_seen) = jstream.hold_last_good(z, avail, U, return_carry=True, **kw)
        np.testing.assert_array_equal(to_np(ours), np.asarray(ref))
        np.testing.assert_array_equal(to_np(last), np.asarray(j_last))
        np.testing.assert_array_equal(to_np(seen), np.asarray(j_seen))
    shorthand = np.array([1.0, 0.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        to_np(tstream.hold_last_good(zt, shorthand, U, fallback=fbt)),
        np.asarray(jstream.hold_last_good(z, shorthand, U, fallback=fb)))


@pytest.mark.parametrize("solver,diag", [("eigh", False), ("jacobi-pallas", True)])
def test_streaming_step1_matches_jax(spectra, solver, diag):
    """One node's step 1 from the warm start, on the quiet scene: every
    frame (step 1's first refresh is not degenerate at C = 2)."""
    Y, S, N, mz, _ = (a[1] for a in spectra)
    Yq, Sq, Nq = Y * QUIET, S * QUIET, N * QUIET
    kw = dict(S=Sq, N=Nq, with_diagnostics=True) if diag else {}
    ref = jstream.streaming_step1(Yq, mz, solver=solver, **kw)
    ours = tstream.streaming_step1(Yq, mz, solver=solver, device="cpu", **kw)
    keys = ("z_y", "zn", "Rss", "Rnn", "w") + (("z_s", "z_n") if diag else ())
    _close(ours, ref, keys)


# (solver, policy, with_diagnostics, also checked from a warmed-up state
# at the natural level)
STREAM_CASES = [("eigh", "local", False, True), ("eigh", "none", True, False),
                ("eigh", "distant", False, False), ("jacobi-pallas", "local", True, False),
                ("jacobi-pallas", "none", False, False),
                ("jacobi-pallas", "distant", False, True)]


@pytest.mark.parametrize("solver,policy,diag,warm", STREAM_CASES)
def test_streaming_tango_matches_jax(spectra, solver, policy, diag, warm):
    Y, S, N, mz, mw = (a[..., :T_WARM] for a in spectra)
    kw = dict(solver=solver, policy=policy)
    dkw = dict(S=S * QUIET, N=N * QUIET, with_diagnostics=True) if diag else {}
    keys = ("yf", "z_y", "zn") + (("sf", "nf", "z_s", "z_n") if diag else ())
    # (a) from the warm start, quiet scene, step 2's first refresh block skipped
    ref = jstream.streaming_tango(Y * QUIET, mz, mw, **kw, **dkw)
    ours = tstream.streaming_tango(Y * QUIET, mz, mw, device="cpu", **kw, **dkw)
    _close(ours, ref, ("z_y", "zn") + (("z_s", "z_n") if diag else ()))
    _close(ours, ref, keys, frames=slice(U, None))
    for a, b in zip(tstream.state_leaves(tstream.state_to_numpy(ours["state"])), tstream.state_leaves(ref["state"])):
        assert max_rel(a, np.asarray(b)) <= TOL
    if not warm:
        return
    # (b) natural level: JAX warms up, both continue from its state
    Y, S, N, mz, mw = spectra
    first = jstream.streaming_tango(Y[..., :T_WARM], mz[..., :T_WARM], mw[..., :T_WARM], **kw)
    state = {k: tuple(np.asarray(x) for x in v) for k, v in first["state"].items()}
    rest = (a[..., T_WARM:] for a in (Y, mz, mw))
    Yr, mzr, mwr = rest
    ref = jstream.streaming_tango(Yr, mzr, mwr, state=state, **kw)
    ours = tstream.streaming_tango(Yr, mzr, mwr, state=tstream.state_from_numpy(state, "cpu"),
                                   device="cpu", **kw)
    _close(ours, ref, ("yf", "z_y", "zn"))


def test_port_state_continues_in_jax(spectra):
    """The other direction: the port warms up, ``state_to_numpy`` hands its
    state to JAX, and both continue alike."""
    Y, _, _, mz, mw = spectra
    first = tstream.streaming_tango(Y[..., :T_WARM], mz[..., :T_WARM], mw[..., :T_WARM],
                                    solver="eigh", device="cpu")
    state = tstream.state_to_numpy(first["state"])
    assert sorted(state) == ["step1", "step2"]
    assert all(isinstance(x, np.ndarray) for x in tstream.state_leaves(state))
    rest = [a[..., T_WARM:] for a in (Y, mz, mw)]
    ref = jstream.streaming_tango(*rest, state=state, solver="eigh", policy="local")
    ours = tstream.streaming_tango(*rest, state=first["state"], solver="eigh", device="cpu")
    _close(ours, ref, ("yf", "z_y", "zn"))


def test_streaming_clip_fused_matches_jax():
    """Two super-tick windows (16 frames = 4 blocks each) of the quiet
    scene, the state carried; the first refresh block's samples of the
    first window are skipped (see the module docstring)."""
    Lw = 256 * 15
    y, s, n = (a * QUIET for a in scene(K, C, 2 * Lw, seed=4, noise_scale=0.5))
    # without the hold carries: the pytree every window returns, so that
    # both JAX windows run one compiled program
    st0 = {k: v for k, v in tstream.initial_stream_state(K, C, 257, update_every=U).items()
           if k != "hold"}
    j_state, t_state = st0, st0
    j_out, t_out = [], []
    for w in range(2):
        sl = slice(w * Lw, (w + 1) * Lw)
        ref = jfused.streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=j_state,
                                          blocks_per_dispatch=4, solver="jacobi-pallas")
        ours = tfused.streaming_clip_fused(y[..., sl], s[..., sl], n[..., sl], state=t_state,
                                           blocks_per_dispatch=4, solver="jacobi-pallas",
                                           device="cpu")
        j_state, t_state = ref["state"], ours["state"]
        j_out.append(np.asarray(ref["yf"]))
        t_out.append(to_np(ours["yf"]))
    a, b = np.concatenate(t_out, -1), np.concatenate(j_out, -1)
    assert a.shape == (K, 2 * Lw) and a.dtype == np.float32
    skip = 2 * U * 256
    assert max_rel(a[:, skip:], b[:, skip:]) <= TOL, max_rel(a[:, skip:], b[:, skip:])
    masks = np.asarray(j_oracle_masks(*(np.asarray(jdsp.stft(x[..., :Lw])) for x in (s, n))))
    ours = tfused.streaming_clip_fused(y[..., :Lw], masks_z=masks, blocks_per_dispatch=4,
                                       device="cpu")
    ref = jfused.streaming_clip_fused(y[..., :Lw], masks_z=masks, blocks_per_dispatch=4)
    assert max_rel(ours["yf"][:, skip:], np.asarray(ref["yf"])[:, skip:]) <= TOL


# -- inside the port: scanned super ticks == the per-block loop, bit for bit
@pytest.fixture(scope="module")
def port_spectra(spectra):
    Y, S, N, m, _ = (torch.from_numpy(np.ascontiguousarray(a)) for a in spectra)
    return Y, S, N, m


def _scan_windows(Y, m, window, n, solver, plan=None, S=None, N=None):
    st = tstream.initial_stream_state(K, C, Y.shape[-2], update_every=U)
    outs = []
    cols = window // U
    diag = S is not None
    for w in range(Y.shape[-1] // window):
        sl = slice(w * window, (w + 1) * window)
        avail = np.ones((K, cols), np.float32) if plan is None else plan[:, w * cols:(w + 1) * cols]
        o = tstream.streaming_tango_scan(
            Y[..., sl], m[..., sl], m[..., sl], state=st, z_avail=avail, blocks_per_dispatch=n,
            solver=solver, device="cpu", with_diagnostics=diag,
            S=S[..., sl] if diag else None, N=N[..., sl] if diag else None)
        st = o.pop("state")
        outs.append(o)
    return {k: torch.cat([o[k] for o in outs], -1) for k in outs[0]}, st


def _equal_states(a, b):
    la, lb = tstream.state_leaves(a), tstream.state_leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("solver", ["eigh", "jacobi-pallas"])
@pytest.mark.parametrize("faulted", [False, True])
def test_scan_bit_identical_to_per_block(port_spectra, solver, faulted):
    """Super ticks of N = 4 blocks of 8 frames against 8-frame per-block
    calls: output and continuation state; the fault plan loses blocks
    across a super-tick edge, before the first delivery and mid-window."""
    Y, _, _, m = port_spectra
    plan = None
    if faulted:
        plan = np.ones((K, T // U), np.float32)
        plan[1, 6:11] = 0
        plan[2, 0:2] = 0
        plan[0, 13] = 0
    ref, ref_state = per_block_reference(Y, m, block=8, update_every=U, plan=plan,
                                         state=tstream.initial_stream_state(K, C, 257), solver=solver,
                                         device="cpu")
    got, state = _scan_windows(Y, m, 32, 4, solver, plan)
    assert torch.equal(got["yf"], ref)
    _equal_states(state, ref_state)


def test_scan_tail_and_diagnostics_bit_identical(port_spectra):
    """Two super ticks of 3 blocks, then the per-block path for the two
    blocks left; and a scan with diagnostics against per-block calls with
    diagnostics."""
    Y, S, N, m = port_spectra
    ref, _ = per_block_reference(Y, m, block=8, update_every=U,
                                 state=tstream.initial_stream_state(K, C, 257), device="cpu")
    head, st = _scan_windows(Y[..., :48], m[..., :48], 24, 3, "eigh")
    outs = [head["yf"]]
    for i in range(6, 8):
        sl = slice(8 * i, 8 * (i + 1))
        o = tstream.streaming_tango(Y[..., sl], m[..., sl], m[..., sl], state=st,
                                    z_avail=np.ones((K, 2), np.float32), device="cpu")
        st = o["state"]
        outs.append(o["yf"])
    assert torch.equal(torch.cat(outs, -1), ref)

    got, _ = _scan_windows(Y, m, 32, 4, "eigh", S=S, N=N)
    st = tstream.initial_stream_state(K, C, 257)
    per = []
    for i in range(8):
        sl = slice(8 * i, 8 * (i + 1))
        o = tstream.streaming_tango(Y[..., sl], m[..., sl], m[..., sl], state=st, S=S[..., sl],
                                    N=N[..., sl], with_diagnostics=True,
                                    z_avail=np.ones((K, 2), np.float32), device="cpu")
        st = o.pop("state")
        per.append(o)
    for key in ("yf", "sf", "nf", "z_y", "zn", "z_s", "z_n"):
        assert torch.equal(got[key], torch.cat([o[key] for o in per], -1)), key


def test_scan_default_state_matches_default_call(port_spectra):
    """``state=None`` is the warm start in both entry points: one scanned
    window equals the one-shot default call."""
    Y, _, _, m = port_spectra
    ref = tstream.streaming_tango(Y[..., :32], m[..., :32], m[..., :32], device="cpu")
    got = tstream.streaming_tango_scan(Y[..., :32], m[..., :32], m[..., :32],
                                       blocks_per_dispatch=4, device="cpu")
    assert torch.equal(got["yf"], ref["yf"])
    _equal_states(got["state"], ref["state"])


def test_streaming_validates_its_inputs(port_spectra):
    Y, _, _, m = port_spectra
    with pytest.raises(ValueError, match="does not split"):
        tstream.streaming_tango_scan(Y[..., :12], m[..., :12], m[..., :12],
                                     blocks_per_dispatch=5, device="cpu")
    with pytest.raises(ValueError, match="multiple of update_every"):
        tstream.streaming_tango_scan(Y[..., :10], m[..., :10], m[..., :10],
                                     blocks_per_dispatch=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tstream.streaming_tango_scan(Y[..., :4], m[..., :4], m[..., :4],
                                     blocks_per_dispatch=0, device="cpu")
    with pytest.raises(ValueError, match="does not cover the window"):
        tstream.streaming_tango_scan(Y[..., :16], m[..., :16], m[..., :16],
                                     blocks_per_dispatch=2, z_avail=np.ones((K, 3)),
                                     device="cpu")
    with pytest.raises(ValueError, match="offline-only"):
        tstream.streaming_tango(Y, m, m, policy="use_oracle_refs", device="cpu")
    with pytest.raises(ValueError, match="needs S and N"):
        tstream.streaming_tango(Y, m, m, with_diagnostics=True, device="cpu")
    with pytest.raises(ValueError, match="either pass masks_z"):
        tfused.streaming_clip_fused(np.zeros((K, C, 3840), np.float32), device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        tstream.streaming_tango(Y, m, m, precision="fp8", device="cpu")


def test_streaming_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, port_spectra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Y, _, _, m = port_spectra
    for call in (lambda: tstream.streaming_tango(Y, m, m),
                 lambda: tstream.streaming_tango_scan(Y, m, m),
                 lambda: tstream.streaming_step1(Y[0], m[0]),
                 lambda: tfused.streaming_clip_fused(np.zeros((K, C, 3840), np.float32),
                                                     masks_z=np.ones((K, 257, 16)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
