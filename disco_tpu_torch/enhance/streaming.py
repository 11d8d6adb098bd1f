"""Streaming (frame-recursive) two-step TANGO (counterpart of
``disco_tpu/enhance/streaming.py``; reference
se_utils/internal_formulas.py:84-103, the online covariance recursion).

Per node and frame the smoothed covariances follow
``R <- lam R + (1 - lam) (m x)(m x)^H`` from the warm start
``R0 = 1e-6 I``; the filter is refreshed once per block of
``update_every`` frames, from the covariances after the block's first
frame, and applied to that block's frames.  As in the JAX package, a scan
over the blocks carries the covariances and emits one checkpoint per block
(the block's other frames advance the carry in closed form, one weighted
product), then ALL refresh GEVDs of a step run as one batched solve: here
one call over every (node, block, bin) pencil, so one eigensolver launch
per step under ``solver='jacobi-pallas'``.  A refresh whose filter is not
finite is skipped: the previous block's filter is held (the ffill guard),
the ref-mic selector before the first good refresh.

Everything runs on the tensors' device; the entry points
(:func:`streaming_step1`, :func:`streaming_tango`,
:func:`streaming_tango_scan`) resolve it with ``device.resolve_device``.
:func:`streaming_tango_scan` runs :func:`_streaming_tango_body`, the
per-block function of :func:`streaming_tango`, once per block, so scanned
and per-block streams are bit-identical inside the port.

The JAX package folds an omitted float default at trace time and traces a
passed one in float32 (``_float_kw``); the port has no trace, and computes
every power of ``lambda_cor`` through :func:`_lam_pow`, in float64 on the
host, so that all its paths scale by the same float32 numbers.  Under
``precision='bf16'`` the blocks' tail accumulation rounds its frames and
weights to bf16 and contracts in float32 (``ops.cov_ops.outer_acc_bf16``,
as the JAX package's lane); the refresh frame's outer product stays
float32, and the solve takes the lane only under the ``'fused*'``
solvers.  The ``between_blocks`` chaos seam (``runs.chaos``) fires at
the start of every chunk-continuation call of :func:`streaming_tango` and
:func:`streaming_tango_scan`, a call that carries a state.  Each entry
point counts its call signatures under the JAX package's jit label
(``obs.accounting.counted_jit``); internal callers use ``__wrapped__``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from disco_tpu_torch.beam.filters import rank1_gevd
from disco_tpu_torch.device import resolve_device
from disco_tpu_torch.enhance.tango import others_index
from disco_tpu_torch.obs.accounting import counted_jit
from disco_tpu_torch.ops.cov_ops import outer_acc_bf16
from disco_tpu_torch.ops.resolve import resolve_precision
from disco_tpu_torch.runs import chaos

#: Default filter-refresh block length (frames).
DEFAULT_UPDATE_EVERY = 4
#: Default smoothing factor and speech-distortion tradeoff.
DEFAULT_LAMBDA_COR = 0.99
DEFAULT_MU = 1.0

#: the warm-start loading of the smoothed covariances, R0 = eps I
_WARM_EPS = 1e-6
_STREAM_POLICIES = ("local", "none", None, "distant")


def _lam_pow(lam: float, k: int) -> float:
    """``lam ** k`` as every path of the port computes it: in float64 on
    the host, rounded to float32 where it scales a tensor (the value the
    JAX package folds for an omitted default)."""
    return float(lam) ** k


def _outer(x: torch.Tensor) -> torch.Tensor:
    """(..., F, D) frame -> (..., F, D, D) outer product ``x x^H``."""
    return x[..., :, None] * x[..., None, :].conj()


def _seed_filter_state(lead: tuple, n_freq: int, D: int, ref: int, dtype=np.complex64):
    """(Rss, Rnn, w) numpy warm start with leading shape ``lead``:
    ``1e-6 I`` covariances and the ref-channel one-hot filter."""
    R = np.broadcast_to(_WARM_EPS * np.eye(D, dtype=dtype), lead + (n_freq, D, D)).copy()
    w = np.zeros(lead + (n_freq, D), dtype)
    w[..., ref] = 1.0
    return R, R.copy(), w


def initial_stream_state(n_nodes: int, n_mics: int, n_freq: int,
                         update_every: int = DEFAULT_UPDATE_EVERY, ref_mic: int = 0, dtype=None):
    """The warm-start continuation state of :func:`streaming_tango` as host
    (numpy) arrays — the pytree of the JAX function of the same name:
    ``step1``/``step2`` ``(Rss, Rnn, w)`` triples with a leading node axis
    (D = C and C + K - 1) and the ``hold`` carries of the exchanged
    ``z_y``/``zn`` streams, in ``dtype`` (complex64 when None, the dtype
    the entry points cast the spectra to).  ``state=None`` in the entry
    points means this state."""
    dtype = np.complex64 if dtype is None else np.dtype(dtype)
    K, C, F, u = int(n_nodes), int(n_mics), int(n_freq), int(update_every)

    def hold_carry():
        return np.zeros((K, F, u), dtype), np.zeros((K,), bool)

    return {
        "step1": _seed_filter_state((K,), F, C, ref_mic, dtype),
        "step2": _seed_filter_state((K,), F, C + K - 1, ref_mic, dtype),
        "hold": {"z_y": hold_carry(), "zn": hold_carry()},
    }


def _map_state(state, leaf):
    """``leaf`` applied to every array of a state, dict keys in sorted
    order, the structure kept."""
    if isinstance(state, dict):
        return {k: _map_state(state[k], leaf) for k in sorted(state)}
    if isinstance(state, (tuple, list)):
        return tuple(_map_state(v, leaf) for v in state)
    return leaf(state)


def state_leaves(state) -> list:
    """The arrays of a continuation state (the port's or the JAX
    package's, as numpy arrays) in one fixed order."""
    leaves = []
    _map_state(state, leaves.append)
    return leaves


def state_from_numpy(state, device=None):
    """A continuation state — the JAX package's pytree as numpy arrays
    (``step1``/``step2`` triples, ``hold`` carries), or the port's own —
    as tensors on ``device`` (``"cuda"`` when None), so that a stream
    started in either framework continues in the port."""
    dev = resolve_device(device)
    return _map_state(state, lambda x: torch.as_tensor(
        x if isinstance(x, torch.Tensor) else np.array(x), device=dev))


def state_to_numpy(state):
    """The port's continuation state as numpy arrays, in the pytree layout
    of the JAX package."""
    # disco-torch-lint: disable=DL003 -- a user-called export of a whole state to the JAX layout, never on a serve tick (the scheduler's checkpoints read back through serve.session.fetch_state_host's one to_host); bool leaves cannot ride to_host's float payload
    return _map_state(state, lambda x: x.detach().cpu().numpy())


def _block_covariances(XSb, XNb, lam: float, Rss0, Rnn0, precision: str = "f32"):
    """Scan over frame blocks, emitting the refresh-point covariances.

    Args:
      XSb, XNb: (..., B, u, F, D) speech / noise statistic frame blocks.
      lam: smoothing factor.
      Rss0, Rnn0: (..., F, D, D) covariances the recursion starts from.
      precision: the lane of the blocks' tail accumulation (module
        docstring).

    Returns:
      ((Rss_end, Rnn_end), (Rss_ref, Rnn_ref)): the end-of-stream carry and
      the (..., B, F, D, D) covariances after each block's first frame.
    """
    B, u = XSb.shape[-4], XSb.shape[-3]
    decay = _lam_pow(lam, u - 1)
    tail_w = torch.tensor([_lam_pow(lam, k) for k in range(u - 2, -1, -1)],
                          dtype=torch.float32, device=XSb.device)

    def acc_tail(x):  # (..., u-1, F, D) -> sum_t w_t x_t x_t^H, (..., F, D, D)
        if precision == "bf16":
            return outer_acc_bf16(tail_w, x)
        return torch.einsum("...tfc,...tfd->...fcd", tail_w[:, None, None] * x, x.conj())

    Rss, Rnn = Rss0, Rnn0
    ref_s, ref_n = [], []
    for b in range(B):
        xs, xn = XSb[..., b, :, :, :], XNb[..., b, :, :, :]
        Rss = lam * Rss + (1.0 - lam) * _outer(xs[..., 0, :, :])
        Rnn = lam * Rnn + (1.0 - lam) * _outer(xn[..., 0, :, :])
        ref_s.append(Rss)
        ref_n.append(Rnn)
        if u > 1:
            Rss = decay * Rss + (1.0 - lam) * acc_tail(xs[..., 1:, :, :])
            Rnn = decay * Rnn + (1.0 - lam) * acc_tail(xn[..., 1:, :, :])
    return (Rss, Rnn), (torch.stack(ref_s, dim=-4), torch.stack(ref_n, dim=-4))


def _ffill(w: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The skipped-refresh guard: every (block, bin) whose filter is not
    finite takes the last finite filter of an earlier block, or ``seed``
    before the first.  (..., B, F, D) filters, (..., F, D) seed.

    A gather (the index of the last good block by a running max) rather
    than the JAX package's scan over blocks: both only select, so the
    result is the same bit for bit, and the gather is a few launches where
    a loop would be a few per block."""
    B, D = w.shape[-3], w.shape[-1]
    ok = torch.isfinite(w).all(dim=-1)                           # (..., B, F)
    pos = torch.arange(1, B + 1, device=w.device)[:, None]
    last = torch.where(ok, pos, 0).cummax(dim=-2).values          # 0: none yet
    cand = torch.cat([seed.unsqueeze(-3), w], dim=-3)            # (..., B+1, F, D)
    return torch.take_along_dim(cand, last[..., None].expand(last.shape + (D,)), dim=-3)


def _stream_filter(X, XS, XN, lam: float, u: int, mu: float, ref: int, extras, init_state,
                   solver: str, precision: str):
    """The streaming filter of every leading-axis stream over (..., T, F, D)
    frames (counterpart of ``_stream_filter``, batched over the nodes).

    ``X`` is the stream the filter is applied to; ``XS``/``XN`` the
    speech / noise statistic streams; ``ref`` the channel of the warm-up
    selector; ``extras`` optional streams filtered with the same per-block
    filters (diagnostics); ``init_state`` the (Rss, Rnn, w) carry.

    Returns (out (..., T, F), w_last (..., F, D), Rss_end, Rnn_end,
    filtered extras).
    """
    T, F, D = X.shape[-3:]
    pad = (-T) % u
    B = (T + pad) // u

    def blocks(a):  # (..., T, F, D) -> (..., B, u, F, D), zero-padded
        # always a fresh contiguous tensor, as the padded branch's cat is:
        # the CPU's elementwise complex products take a vectorized or a
        # scalar loop by memory layout, and the two differ in the last bit,
        # so a stream whose length needs no padding would otherwise compute
        # its blocks apart from one that does
        if pad:
            a = torch.cat([a, a.new_zeros(a.shape[:-3] + (pad, F, D))], dim=-3)
        return a.contiguous().reshape(a.shape[:-3] + (B, u, F, D))

    Rss0, Rnn0, w_seed = init_state
    (Rss_e, Rnn_e), (Rss_ref, Rnn_ref) = _block_covariances(blocks(XS), blocks(XN), lam,
                                                            Rss0, Rnn0, precision)
    if pad:
        # padded zero frames only decay the carry: undo it
        undo = _lam_pow(lam, -pad)
        Rss_e, Rnn_e = Rss_e * undo, Rnn_e * undo
    # ALL refresh GEVDs of the step at once; sanitize=False so that a
    # degenerate refresh is non-finite and the guard holds the previous filter
    w, _ = rank1_gevd(Rss_ref, Rnn_ref, mu=mu, solver=solver, sanitize=False,
                      precision=precision)                       # (..., B, F, D)
    w = _ffill(w, w_seed)
    wc = w.conj()

    def apply(E):
        # one product a refresh block, each of the same shape and layout:
        # cuBLAS picks its kernel by the batch, so one product over all the
        # blocks made a stream cut into 8-frame blocks differ from the whole
        # clip in the last bit on the card (exp/serve_parity_probe.py)
        x = blocks(E)
        y = torch.stack([torch.einsum("...fd,...ufd->...uf", wc[..., b, :, :].contiguous(),
                                      x[..., b, :, :, :].contiguous()) for b in range(B)],
                        dim=-3)
        return y.reshape(y.shape[:-3] + (B * u, F))[..., :T, :]

    return apply(X), w[..., -1, :, :], Rss_e, Rnn_e, [apply(E) for E in extras or ()]


def _tfc(a: torch.Tensor) -> torch.Tensor:
    """(..., C, F, T) -> (..., T, F, C)."""
    return a.movedim(-1, -3).transpose(-1, -2)


def _step1(Y, mask_z, lam, u, mu, ref_mic, S, N, with_diagnostics, state, solver, precision):
    """:func:`streaming_step1` on tensors of one device, batched over the
    leading axes."""
    X = _tfc(Y)
    M = mask_z.transpose(-1, -2)[..., None]  # (..., T, F, 1)
    extras = [_tfc(S), _tfc(N)] if with_diagnostics else None
    z, w, Rss, Rnn, ex = _stream_filter(X, M * X, (1.0 - M) * X, lam, u, mu, ref_mic, extras,
                                        state, solver, precision)
    z_y = z.transpose(-1, -2)
    out = {"z_y": z_y, "zn": Y[..., ref_mic, :, :] - z_y, "Rss": Rss, "Rnn": Rnn, "w": w}
    if with_diagnostics:
        out["z_s"], out["z_n"] = ex[0].transpose(-1, -2), ex[1].transpose(-1, -2)
    return out


def _as_complex(a, dev):
    return None if a is None else torch.as_tensor(a, dtype=torch.complex64, device=dev)


def _as_real(a, dev):
    return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)


@partial(counted_jit, label="streaming_step1",
         static_argnames=("update_every", "ref_mic", "with_diagnostics", "solver", "precision"))
def streaming_step1(Y, mask_z, lambda_cor: float = DEFAULT_LAMBDA_COR,
                    update_every: int = DEFAULT_UPDATE_EVERY, mu: float = DEFAULT_MU,
                    ref_mic: int = 0, S=None, N=None, with_diagnostics: bool = False,
                    state=None, solver: str = "eigh", precision: str = "f32", device=None):
    """Streaming local MWF: recursive covariance smoothing with a filter
    refresh every ``update_every`` frames, for one node or a leading batch
    of nodes.

    Args:
      Y: (..., C, F, T) complex mixture STFT.
      mask_z: (..., F, T) step-1 mask.
      S, N: clean components, filtered with the same online filter under
        ``with_diagnostics=True`` (z_s / z_n).
      state: optional (Rss, Rnn, w) continuation state; None is the warm
        start.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device),
        ``"cpu"`` for the plain versions on the host.

    Returns:
      dict with z_y and zn = y_ref - z_y (..., F, T), the final Rss, Rnn
      (..., F, C, C) and w (..., F, C), and z_s/z_n with diagnostics.
    """
    precision = resolve_precision(precision)
    dev = resolve_device(device)
    Y, S, N = (_as_complex(a, dev) for a in (Y, S, N))
    mask_z = _as_real(mask_z, dev)
    if with_diagnostics and (S is None or N is None):
        raise ValueError("with_diagnostics=True needs S and N")
    if state is None:
        state = _seed_filter_state(tuple(Y.shape[:-3]), Y.shape[-2], Y.shape[-3], ref_mic)
    state = state_from_numpy(state, dev)
    return _step1(Y, mask_z, lambda_cor, update_every, mu, ref_mic, S, N, with_diagnostics,
                  state, solver, precision)


def hold_last_good(z, avail, update_every: int, fallback=None, carry=None,
                   return_carry: bool = False):
    """Last-good-z hold over refresh blocks (counterpart of
    ``hold_last_good``): a block whose z was not delivered
    (``avail[k, b] == 0``) is bridged with the most recent delivered
    block's frames; blocks lost before any delivery take the matching
    ``fallback`` block, or keep their own frames with ``fallback=None``.
    Only selects, so it equals the JAX function bit for bit.

    Args:
      z: (K, F, T) exchanged stream.
      avail: (K, B) per-block availability, B = ceil(T / update_every), or
        (K,) constant over blocks.
      fallback: optional (K, F, T) stream for leading losses.
      carry: optional ``(last_block (K, F, u), seen (K,))`` from a previous
        chunk's ``return_carry=True`` call.

    Returns:
      (K, F, T) held stream — and the end-of-stream carry when
      ``return_carry``.
    """
    K, F, T = z.shape
    u = update_every
    pad = (-T) % u
    B = (T + pad) // u
    avail = torch.as_tensor(avail, device=z.device)
    if avail.ndim == 1:  # (K,) shorthand: constant over blocks
        avail = avail[:, None]
    ok = (avail > 0).expand(K, B)

    def blocks(a):  # (K, F, T) -> (K, F, B, u)
        if pad:
            a = torch.cat([a, a.new_zeros((K, F, pad))], dim=-1)
        return a.reshape(K, F, B, u)

    zb = blocks(z)
    fb = blocks(fallback) if fallback is not None else zb
    if carry is None:
        last, seen = torch.zeros_like(zb[:, :, 0]), torch.zeros(K, dtype=torch.bool, device=z.device)
    else:
        last, seen = carry
    held = []
    for b in range(B):
        a = ok[:, b]
        subst = torch.where(seen[:, None, None], last, fb[:, :, b])
        last = torch.where(a[:, None, None], zb[:, :, b], subst)
        seen = seen | a
        held.append(last)
    out = torch.stack(held, dim=2).reshape(K, F, B * u)[..., :T]
    return (out, (last, seen)) if return_carry else out


def _stream_stats(Y, all_z, zn, mask_w, oth, policy):
    """Step-2 speech / noise statistic streams per node under the
    mask-for-z policy: (K, C+K-1, F, T) each.

    - 'local':   the consumer mask m_k on the local mics and every z.
    - 'distant': the producer mask m_j on z_j; the consumer mask locally.
    - 'none'/None: z unmasked for the speech statistics, the producer's
      zn = y_ref - z for the noise statistics; the consumer mask locally.
    """
    m = mask_w[:, None]
    y_s, y_n = m * Y, (1.0 - m) * Y
    z_oth = all_z[oth]  # (K, K-1, F, T)
    if policy == "local":
        zs_stat, zn_stat = m * z_oth, (1.0 - m) * z_oth
    elif policy is None or policy == "none":
        zs_stat, zn_stat = z_oth, zn[oth]
    else:  # 'distant'
        mw_oth = mask_w[oth]
        zs_stat, zn_stat = mw_oth * z_oth, (1.0 - mw_oth) * z_oth
    return torch.cat([y_s, zs_stat], dim=1), torch.cat([y_n, zn_stat], dim=1)


def _check_stream_policy(policy) -> None:
    if policy not in _STREAM_POLICIES:
        raise ValueError(
            f"streaming mask-for-z policy {policy!r} not supported; "
            "one of 'local', 'distant', 'none' (other policies are offline-only)"
        )


def _streaming_tango_body(Y, masks_z, mask_w, lam, u, mu, ref_mic, S, N, with_diagnostics,
                          policy, state, solver, z_avail, precision):
    """The one-block state transition of :func:`streaming_tango` on tensors
    of one device: (K, C, F, T) inputs, the full ``state`` pytree.  The
    scanned path runs this same function once per block."""
    # one memory layout whatever view the caller sliced, so that a block
    # cut from a window and the same block on its own compute alike
    Y, masks_z, mask_w = Y.contiguous(), masks_z.contiguous(), mask_w.contiguous()
    if with_diagnostics:
        S, N = S.contiguous(), N.contiguous()
    K = Y.shape[0]
    s1 = _step1(Y, masks_z, lam, u, mu, ref_mic, S, N, with_diagnostics, state["step1"],
                solver, precision)
    all_z, zn = s1["z_y"], s1["zn"]
    z_s, z_n = s1.get("z_s"), s1.get("z_n")
    hold_state = None
    if z_avail is not None:
        # degraded-mode delivery: lost blocks reuse the last good z (the zn
        # estimate before the first delivery); zn and the diagnostics are
        # held with the same availability; the carries ride the state
        hin = state.get("hold") or {}
        all_z, h_zy = hold_last_good(all_z, z_avail, u, fallback=zn, carry=hin.get("z_y"),
                                     return_carry=True)
        zn, h_zn = hold_last_good(zn, z_avail, u, carry=hin.get("zn"), return_carry=True)
        hold_state = {"z_y": h_zy, "zn": h_zn}
        if with_diagnostics:
            z_s, hold_state["z_s"] = hold_last_good(z_s, z_avail, u, carry=hin.get("z_s"),
                                                    return_carry=True)
            z_n, hold_state["z_n"] = hold_last_good(z_n, z_avail, u, carry=hin.get("z_n"),
                                                    return_carry=True)

    oth = torch.as_tensor(others_index(K), device=Y.device)  # (K, K-1)

    def stacked(base, z_streams):  # -> (K, T, F, C+K-1)
        return _tfc(torch.cat([base, z_streams[oth]], dim=1))

    XS, XN = _stream_stats(Y, all_z, zn, mask_w, oth, policy)
    extras = [stacked(S, z_s), stacked(N, z_n)] if with_diagnostics else None
    yf, w2, Rss2, Rnn2, filt = _stream_filter(stacked(Y, all_z), _tfc(XS), _tfc(XN), lam, u,
                                              mu, ref_mic, extras, state["step2"], solver,
                                              precision)
    out_state = {"step1": (s1["Rss"], s1["Rnn"], s1["w"]), "step2": (Rss2, Rnn2, w2)}
    if hold_state is not None:
        out_state["hold"] = hold_state
    out = {"yf": yf.transpose(-1, -2), "z_y": all_z, "zn": zn, "state": out_state}
    if with_diagnostics:
        out.update(sf=filt[0].transpose(-1, -2), nf=filt[1].transpose(-1, -2), z_s=z_s, z_n=z_n)
    return out


def _chaos_between_blocks(state) -> None:
    """The ``between_blocks`` chaos seam (``runs.chaos``), fired on every
    chunk-continuation call: a call that carries a state."""
    if state is not None:
        chaos.tick("between_blocks")


def _stream_inputs(Y, masks_z, mask_w, S, N, with_diagnostics, policy, state, update_every,
                   ref_mic, precision, device):
    """Validate and place the inputs of the streaming entry points; a None
    state is :func:`initial_stream_state`."""
    precision = resolve_precision(precision)
    _check_stream_policy(policy)
    if with_diagnostics and (S is None or N is None):
        raise ValueError("with_diagnostics=True needs S and N")
    dev = resolve_device(device)
    Y = _as_complex(Y, dev)
    S, N = (_as_complex(a, dev) if with_diagnostics else None for a in (S, N))
    masks_z, mask_w = _as_real(masks_z, dev), _as_real(mask_w, dev)
    K, C, F, _ = Y.shape
    if state is None:
        state = initial_stream_state(K, C, F, update_every=update_every, ref_mic=ref_mic)
    return Y, masks_z, mask_w, S, N, state_from_numpy(state, dev), precision, dev


@partial(counted_jit, label="streaming_tango",
         static_argnames=("update_every", "ref_mic", "with_diagnostics", "policy", "solver",
                          "precision"))
def streaming_tango(Y, masks_z, mask_w, lambda_cor: float = DEFAULT_LAMBDA_COR,
                    update_every: int = DEFAULT_UPDATE_EVERY, mu: float = DEFAULT_MU,
                    ref_mic: int = 0, S=None, N=None, with_diagnostics: bool = False,
                    policy: str | None = "local", state=None, solver: str = "eigh",
                    z_avail=None, precision: str = "f32", device=None):
    """Full two-step streaming TANGO over all nodes: step 1 streams every
    node, the z-exchange is indexing, step 2 streams the stacked
    ``[y_k ‖ z_{j!=k}]`` under the 'local', 'distant' or 'none' policy.

    Args:
      Y: (K, C, F, T) mixture STFTs.
      masks_z, mask_w: (K, F, T) step-1 / step-2 masks.
      S, N: (K, C, F, T) clean components, filtered with the same online
        filters under ``with_diagnostics=True`` (sf/nf/z_s/z_n).
      state: continuation state (the previous chunk's ``state``, numpy or
        tensors); None is :func:`initial_stream_state`.
      solver: rank-1 GEVD solver spec; ``'jacobi-pallas'`` runs the
        eigensolver kernel, one launch per step.
      z_avail: optional (K, B) or (K,) per-block availability of the
        exchanged streams (:func:`hold_last_good`); the hold carries ride
        the returned state.
      device: ``"cuda"`` when None (RuntimeError without a CUDA device),
        ``"cpu"`` for the plain versions on the host.

    Returns:
      dict with yf, z_y, zn (K, F, T), ``state`` and, with diagnostics,
      sf, nf, z_s, z_n.
    """
    _chaos_between_blocks(state)
    Y, masks_z, mask_w, S, N, state, precision, dev = _stream_inputs(
        Y, masks_z, mask_w, S, N, with_diagnostics, policy, state, update_every, ref_mic,
        precision, device)
    z_avail = _as_real(z_avail, dev)
    return _streaming_tango_body(Y, masks_z, mask_w, lambda_cor, update_every, mu, ref_mic, S, N,
                                 with_diagnostics, policy, state, solver, z_avail, precision)


@partial(counted_jit, label="streaming_tango_scan",
         static_argnames=("blocks_per_dispatch", "update_every", "ref_mic", "with_diagnostics",
                          "policy", "solver", "precision"))
def streaming_tango_scan(Y, masks_z, mask_w, lambda_cor: float = DEFAULT_LAMBDA_COR,
                         update_every: int = DEFAULT_UPDATE_EVERY, mu: float = DEFAULT_MU,
                         ref_mic: int = 0, S=None, N=None, with_diagnostics: bool = False,
                         policy: str | None = "local", state=None, solver: str = "eigh",
                         z_avail=None, blocks_per_dispatch: int = 1, precision: str = "f32",
                         device=None):
    """The super-tick loop: ``blocks_per_dispatch`` (N) equal
    refresh-aligned blocks of the window, each through
    :func:`_streaming_tango_body` — the per-block function of
    :func:`streaming_tango` — with the state carried from block to block,
    so the result is bit-identical to N :func:`streaming_tango` calls.

    Args (beyond :func:`streaming_tango`'s):
      Y: (K, C, F, T) with T = N * Tc and Tc a multiple of
        ``update_every``.
      z_avail: optional (K, T // update_every) availability over all the
        window's refresh blocks, or (K,).
      blocks_per_dispatch: N.

    Returns:
      the :func:`streaming_tango` dict stitched over the N blocks, with the
      end-of-window ``state``.
    """
    n = int(blocks_per_dispatch)
    if n < 1:
        raise ValueError(f"blocks_per_dispatch must be >= 1, got {blocks_per_dispatch}")
    T = Y.shape[-1]
    u = update_every
    if T % n:
        raise ValueError(
            f"streaming_tango_scan: T={T} frames does not split into "
            f"blocks_per_dispatch={n} equal blocks (run the remainder through "
            "the per-block path)"
        )
    Tc = T // n
    _chaos_between_blocks(state)
    if Tc % u:
        raise ValueError(
            f"streaming_tango_scan: per-dispatch block length {Tc} must be a "
            f"multiple of update_every={u} (refresh-aligned blocks)"
        )
    Y, masks_z, mask_w, S, N, state, precision, dev = _stream_inputs(
        Y, masks_z, mask_w, S, N, with_diagnostics, policy, state, update_every, ref_mic,
        precision, device)
    K = Y.shape[0]
    za = _as_real(z_avail, dev)
    if za is not None:
        Bc = Tc // u
        if za.ndim == 1:
            za = za[:, None].expand(K, n * Bc)
        if tuple(za.shape) != (K, n * Bc):
            raise ValueError(
                f"z_avail shape {tuple(za.shape)} does not cover the window: "
                f"expected ({K}, {n * Bc}) refresh-block columns"
            )
    outs = []
    for i in range(n):
        sl = slice(i * Tc, (i + 1) * Tc)
        out = _streaming_tango_body(
            Y[..., sl], masks_z[..., sl], mask_w[..., sl], lambda_cor, u, mu, ref_mic,
            S[..., sl] if with_diagnostics else None, N[..., sl] if with_diagnostics else None,
            with_diagnostics, policy, state, solver,
            None if za is None else za[:, i * (Tc // u):(i + 1) * (Tc // u)], precision)
        state = out.pop("state")
        outs.append(out)
    res = {key: torch.cat([o[key] for o in outs], dim=-1) for key in outs[0]}
    res["state"] = state
    return res
