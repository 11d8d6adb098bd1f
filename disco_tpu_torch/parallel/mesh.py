"""Node-, frame- and batch-sharded TANGO over a device mesh (counterpart of
``disco_tpu/parallel/mesh.py``).

The reference's "distributed" processing is one process: nodes are list
indices and the inter-node link is ``np.concatenate`` (reference
tango.py:142-155).  Here the node axis is a dim of a
:class:`~torch.distributed.device_mesh.DeviceMesh`, one process a rank:
each rank runs step 1 on its own nodes, and the DANSE z-exchange (every
node sends one compressed (F, T) stream to all the others) is one
``all_gather`` over the ``node`` dim's process group, or the same bytes in
K-1 neighbour hops (:func:`ring_all_gather`).  Only compressed streams
cross the link, never the raw mics.

The STFT frame axis can be sharded too, over a ``frame`` dim (sequence
parallelism): the covariances' frame means become local sums and one
``all_reduce`` over the frame group
(:func:`~disco_tpu_torch.beam.covariance.frame_mean_covariance`), so that
path takes the materializing einsum covariances and no covariance kernel,
as the JAX package's does.  A ``batch`` dim shards clips (the reference's
``--rirs`` data parallelism).

The entry points are collective calls in SPMD style: every rank of the
mesh calls them with ITS shard — nodes ``[r K_loc, (r + 1) K_loc)`` on
``node``, its frames on ``frame``, its clips on ``batch``, as the body of
the JAX package's ``shard_map`` sees them — and gets its shard of the
result back.  :func:`shard_of` cuts a rank's shard from a global array,
:func:`gather_result` assembles the global :class:`TangoResult` on every
rank, or on one.  Each rank's launches are those of the one-process ``tango`` on its
shard: the same kernels, run on the rank's card.

The JAX module's ``shard_map_compat`` and ``axis_size_compat`` are seams
of the JAX API and have no counterpart: the collectives are plain
``torch.distributed`` calls on the mesh's groups, and a dim's size is
``DeviceMesh.size(dim)`` (:func:`dim_size`).

Contract (``tests/test_torch_port_parallel*.py`` on gloo ranks; on the card
``chip_smoke.py`` phase 3m at one rank): the sharded pipelines equal the
one-process ``tango`` on the assembled arrays — bit for bit where each
rank's arithmetic is the one-process arithmetic on its shard, within the
JAX package's 1e-4 of scale on the frame path, whose covariance sums are
split across ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from disco_tpu_torch.enhance.tango import (
    TangoResult,
    _check_policy,
    finite_z_guard,
    tango_step1,
    tango_step2,
)
from disco_tpu_torch.parallel.multihost import check_world, device_mesh, hybrid_mesh, world_size

_Z_KEYS = ("z_y", "z_s", "z_n", "zn")


# -- meshes -----------------------------------------------------------------
def dim_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name`` (1 when the mesh has no such
    dim)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _coord(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def make_mesh(n_node: int | None = None, n_batch: int = 1, device=None):
    """A ``(batch, node)`` mesh over the world; ``n_node=None`` gives
    ``node`` every rank that ``batch`` leaves.  ``device``: ``"cuda"``
    when None (NCCL), or ``"cpu"`` (gloo)."""
    if n_node is None:
        n_node = world_size() // n_batch
    return device_mesh((n_batch, n_node), ("batch", "node"), device)


def make_mesh_2d(n_node: int, n_frame: int, device=None):
    """A ``(node, frame)`` mesh: nodes over one dim, STFT frames (sequence
    parallelism) over the other."""
    return device_mesh((n_node, n_frame), ("node", "frame"), device)


def mesh_from_config(cfg, device=None):
    """The mesh a :class:`~disco_tpu_torch.config.MeshConfig` (or the root
    config's ``.mesh``) describes: node-only, node x frame, or the hybrid
    3-dim layout when a batch dim is asked for.  ``n_node=None`` means
    every rank the other dims leave, on every path."""
    cfg = getattr(cfg, "mesh", cfg)
    n_node = cfg.n_node
    if n_node is None:
        n_node = max(1, world_size() // (max(cfg.n_batch, 1) * max(cfg.n_frame, 1)))
    if cfg.n_batch > 1:
        return hybrid_mesh(n_batch_dcn=cfg.n_batch, n_node=n_node, n_frame=cfg.n_frame,
                           device=device)
    if cfg.n_frame > 1:
        return make_mesh_2d(n_node=n_node, n_frame=cfg.n_frame, device=device)
    return make_mesh(n_node=n_node, n_batch=cfg.n_batch, device=device)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shard: its card on a ``cuda`` mesh, the
    host on a ``cpu`` one.  Raises unless the world is the mesh's."""
    dev_type = check_world(mesh.size(), mesh.device_type)
    if dev_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- shards -----------------------------------------------------------------
def shard_of(x, mesh, spec=("node",)):
    """This rank's shard of a global array: ``spec`` names, per leading
    axis, the mesh dim it is split over (None: not split), as a JAX
    ``PartitionSpec`` does — ``("node",)`` for (K, ...) stacks,
    ``("node", None, None, "frame")`` for (K, C, F, T) spectra on a
    frame-sharded mesh, ``("batch", "node")`` for (B, K, ...) batches.
    Every split axis must divide evenly.  numpy in, numpy out (contiguous);
    a tensor in, a tensor out."""
    sl = []
    for axis, name in enumerate(spec):
        if name is None:
            sl.append(slice(None))
            continue
        n, r = dim_size(mesh, name), _coord(mesh, name)
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"axis {axis} of length {size} does not divide over the mesh's "
                             f"{name!r} dim ({n})")
        step = size // n
        sl.append(slice(r * step, (r + 1) * step))
    out = x[tuple(sl)]
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    return np.ascontiguousarray(out)


def node_sharding(mesh):
    """The node-axis placement of (K, ...) stacks: a function giving this
    rank's shard (:func:`shard_of` on ``node``), the counterpart of the JAX
    package's ``NamedSharding(mesh, P('node'))``."""
    return lambda x: shard_of(x, mesh, ("node",))


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``axis`` in group
    rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A real view of ``t`` for point-to-point transfers."""
    return torch.view_as_real(t) if t.is_complex() else t


def ring_all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """All-gather over ``group`` in K-1 neighbour hops: each rank sends
    what it last received to the next rank of the ring and receives from
    the previous one (``dist.batch_isend_irecv``), so each hop moves one
    shard over one link.  The pieces are put back in group rank order
    along ``axis``: the same bytes as an ``all_gather``.

    Args:
      x: this rank's shard.
      group: the process group to gather over (``mesh.get_group('node')``).
      axis: the axis the shards are concatenated along.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    x = x.contiguous()
    if n == 1:
        return x
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    pieces, cur = [x], x
    for _ in range(n - 1):
        got = torch.empty_like(cur)
        ops = [dist.P2POp(dist.isend, _wire(cur), nxt, group=group),
               dist.P2POp(dist.irecv, _wire(got), prv, group=group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        pieces.append(got)
        cur = got
    # pieces[j] came from rank (idx - j) mod n
    by_source = [pieces[(idx - src) % n] for src in range(n)]
    return torch.cat(by_source, dim=axis)


def _gather_fn(group, z_exchange: str):
    if z_exchange == "ring":
        return lambda v, axis: ring_all_gather(v, group, axis)
    if z_exchange == "all_gather":
        return lambda v, axis: _all_gather(v, group, axis)
    raise ValueError(f"unknown z_exchange {z_exchange!r}; expected 'all_gather' or 'ring'")


def _gather_to(x: torch.Tensor, group, dst: int, axis: int) -> torch.Tensor | None:
    """Every rank's ``x`` of ``group`` concatenated along ``axis`` in group
    rank order on global rank ``dst`` alone (None on the others)."""
    x = x.contiguous()
    parts = ([torch.empty_like(_wire(x)) for _ in range(dist.get_world_size(group))]
             if dist.get_rank() == dst else None)
    dist.gather(_wire(x), parts, dst=dst, group=group)
    if parts is None:
        return None
    if x.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=axis)


def gather_result(res: TangoResult, mesh, dst: int | None = None) -> TangoResult | None:
    """The global :class:`TangoResult` of a sharded call, assembled on every
    rank by ``all_gather``: frames over ``frame`` (the last axis), nodes
    over ``node`` (axis -3) and, for a batched result (4-D fields), clips
    over ``batch`` (axis -4).  A collective: every rank calls it.

    ``dst``: a global rank that alone assembles the result, by one
    ``gather`` a dim (each over the ranks that hold the dims gathered
    before it); every other rank gets None."""
    mesh_device(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    dims = [(name, axis) for name, axis in (("frame", -1), ("node", -3), ("batch", -4))
            if name in names]
    if dst is not None:
        me = mesh.get_coordinate()
        target = [int(c) for c in (mesh.mesh == dst).nonzero()[0]]

    def full(t):
        done = []
        for name, axis in dims:
            d = names.index(name)
            if dst is not None and any(me[j] != target[j] for j in done):
                return None
            if t.ndim >= -axis and (name != "batch" or t.ndim >= 4):
                if dst is None:
                    t = _all_gather(t, mesh.get_group(name), axis)
                else:
                    at = list(me)
                    at[d] = target[d]
                    t = _gather_to(t, mesh.get_group(name), int(mesh.mesh[tuple(at)]), axis)
            done.append(d)
        return None if dst is not None and dist.get_rank() != dst else t

    out = {f: full(getattr(res, f)) for f in TangoResult.__dataclass_fields__}
    return None if dst is not None and dist.get_rank() != dst else TangoResult(**out)


# -- the sharded pipelines --------------------------------------------------
def _as_inputs(dev, Y, S, N, masks_z, mask_w):
    Y, S, N = (torch.as_tensor(a, dtype=torch.complex64, device=dev) for a in (Y, S, N))
    masks_z = torch.as_tensor(masks_z, dtype=torch.float32, device=dev)
    mask_w = torch.as_tensor(mask_w, dtype=torch.float32, device=dev)
    return Y, S, N, masks_z, mask_w


def _tango_on_mesh(Y, S, N, masks_z, mask_w, mesh, frame: bool, mu, policy, ref_mic,
                   mask_type, oracle_step1_stats, z_exchange="all_gather", solver="power",
                   cov_impl="auto", z_mask=None, z_mask_rows=None, z_nan=None) -> TangoResult:
    """The shared body of the sharded pipelines, on this rank's shard
    (..., K_loc, C, F, T_loc) — the same calls as ``tango`` on it, with the
    z-exchange a gather over the node group.

    ``z_mask``: the (..., K_loc) availability flags of this rank's own
    nodes as sources; they ride the z-exchange and are multiplied by the
    finiteness guard of the gathered streams, which under ``frame`` is
    combined by ``all_reduce(MIN)`` over the frame group (a stream
    non-finite in one frame shard is excluded in all of them).
    ``z_mask_rows``: instead, the availability as this rank's consumers see
    it, (..., K_loc, K) (the batched (B, K, K) form cut to the rank's
    rows).  ``z_nan``: the (..., K_loc) flags of this rank's nodes whose
    exchanged streams turn NaN after step 1."""
    _check_policy(policy)
    if "node" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the sharded pipelines need a mesh with a 'node' dim; got dims "
                         f"{mesh.mesh_dim_names}")
    dev = mesh_device(mesh)
    Y, S, N, masks_z, mask_w = _as_inputs(dev, Y, S, N, masks_z, mask_w)
    gather = _gather_fn(mesh.get_group("node"), z_exchange)
    frame_group = mesh.get_group("frame") if frame else None
    K_loc = Y.shape[-4]
    K = K_loc * dim_size(mesh, "node")
    ks = torch.arange(K_loc, device=dev) + _coord(mesh, "node") * K_loc

    local = tango_step1(Y, S, N, masks_z, mu=mu, oracle_stats=oracle_step1_stats,
                        ref_mic=ref_mic, solver=solver, cov_impl=cov_impl,
                        frame_group=frame_group)
    if z_nan is not None:
        # this rank's corrupted nodes send NaN in every stream, as in tango
        bad = (torch.as_tensor(z_nan, device=dev) > 0)[..., None, None]
        nanc = torch.full((), complex(float("nan"), float("nan")), dtype=torch.complex64,
                          device=dev)
        local = {key: torch.where(bad, nanc, val) for key, val in local.items()}
    # THE z-exchange: one compressed stream a node crosses the link
    all_z = {key: gather(local[key], -3) for key in _Z_KEYS}
    all_masks_w = gather(mask_w, -3)
    all_S_ref = gather(S[..., ref_mic, :, :], -3)
    all_N_ref = gather(N[..., ref_mic, :, :], -3)

    avail = None
    if z_mask is not None or z_mask_rows is not None or z_nan is not None:
        fin = finite_z_guard(all_z["z_y"])                              # (..., K) by source
        if z_mask is not None:
            zm = torch.as_tensor(z_mask, dtype=torch.float32, device=dev)
            if zm.shape[-1] != K_loc:
                raise ValueError(f"the sharded pipelines take this rank's (K_loc,) = "
                                 f"({K_loc},) z_mask flags; got {tuple(zm.shape)}")
            src = gather(zm.contiguous(), -1) * fin                    # rides the exchange
        else:
            src = fin
        if frame_group is not None:
            dist.all_reduce(src, op=dist.ReduceOp.MIN, group=frame_group)
        src = src[..., None, :]                                        # (..., 1, K)
        if z_mask_rows is not None:
            rows = torch.as_tensor(z_mask_rows, dtype=torch.float32, device=dev)
            avail = rows * src
        else:
            avail = src.expand(src.shape[:-2] + (K_loc, K))
    yf, sf, nf = tango_step2(
        Y, S, N, mask_w, ks, all_z, all_masks_w, all_S_ref, all_N_ref, mu=mu, policy=policy,
        ref_mic=ref_mic, mask_type=mask_type, solver=solver, cov_impl=cov_impl,
        z_avail=avail, frame_group=frame_group)
    return TangoResult(yf=yf, sf=sf, nf=nf, z_y=local["z_y"], z_s=local["z_s"],
                       z_n=local["z_n"], zn=local["zn"], masks_z=masks_z, mask_w=mask_w)


def tango_sharded(Y, S, N, masks_z, mask_w, mesh, mu: float = 1.0, policy="local",
                  ref_mic: int = 0, mask_type: str = "irm1", oracle_step1_stats: bool = False,
                  z_exchange: str = "all_gather", solver: str = "power",
                  cov_impl: str = "auto", z_mask=None) -> TangoResult:
    """Two-step TANGO with the node axis sharded over ``mesh``'s ``node``
    dim.  A collective: every rank calls it with its shard.

    Args:
      Y, S, N: this rank's (K_loc, C, F, T) STFT stacks (``shard_of(Y,
        mesh)``); K = K_loc x the node dim.
      masks_z, mask_w: this rank's (K_loc, F, T) step-1 / step-2 masks.
      z_exchange: ``'all_gather'`` (one collective) or ``'ring'`` (K-1
        neighbour hops, :func:`ring_all_gather`): the same bytes.
      z_mask: optional per-source availability of this rank's nodes'
        streams, (K_loc,) (the global (K,) flags cut by :func:`shard_of`);
        it rides the z-exchange and arms the finiteness guard, as
        ``tango(z_mask=...)`` does.

    Returns this rank's shard of the result, (K_loc, F, T) fields
    (:func:`gather_result` assembles them).  Step 1 is node-parallel; the
    one exchange before step 2 gathers the compressed streams, the step-2
    masks and the reference-mic S/N over the node group.
    """
    return _tango_on_mesh(Y, S, N, masks_z, mask_w, mesh, False, mu, policy, ref_mic,
                          mask_type, oracle_step1_stats, z_exchange, solver, cov_impl,
                          z_mask=z_mask)


def tango_frame_sharded(Y, S, N, masks_z, mask_w, mesh, mu: float = 1.0, policy="local",
                        ref_mic: int = 0, mask_type: str = "irm1",
                        oracle_step1_stats: bool = False, solver: str = "power",
                        z_mask=None) -> TangoResult:
    """Two-step TANGO sharded over the node AND the STFT frame axis — the
    sequence-parallel mode.  A collective: every rank calls it with its
    shard.

    Args:
      Y, S, N: this rank's (K_loc, C, F, T_loc) stacks (``shard_of(Y,
        mesh, ("node", None, None, "frame"))``).
      masks_z, mask_w: (K_loc, F, T_loc).
      z_mask: optional (K_loc,) availability of this rank's nodes (see
        :func:`tango_sharded`); the finiteness verdict is combined over the
        frame shards by ``all_reduce(MIN)``.

    Every covariance is a frame-sum ``all_reduce``d over the frame group
    (the materializing einsum: no covariance kernel, as in the JAX
    package); filters come out the same on every frame shard and apply to
    its frames.  Equal to ``tango`` within 1e-4 of the output scale.
    """
    if "frame" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"tango_frame_sharded needs a mesh with a 'frame' dim; got dims "
                         f"{mesh.mesh_dim_names}")
    return _tango_on_mesh(Y, S, N, masks_z, mask_w, mesh, True, mu, policy, ref_mic,
                          mask_type, oracle_step1_stats, solver=solver, z_mask=z_mask)


def tango_batch_sharded(Yb, Sb, Nb, masks_z_b, mask_w_b, mesh, mu: float = 1.0,
                        policy="local", ref_mic: int = 0, mask_type: str = "irm1",
                        solver: str = "power", cov_impl: str = "auto", z_mask_b=None,
                        z_nan_b=None) -> TangoResult:
    """Corpus-scale TANGO on a ``(batch, node)`` mesh: clips over ``batch``
    (the reference's ``--rirs`` data parallelism as a mesh dim), nodes over
    ``node``.  A collective: every rank calls it with its shard.  Clips are
    independent, so the batch dim needs no collective; the z-exchange is
    the node group's, as in :func:`tango_sharded`.

    Args:
      Yb, Sb, Nb: this rank's (B_loc, K_loc, C, F, T) stacks
        (``shard_of(Yb, mesh, ("batch", "node"))``).
      masks_z_b, mask_w_b: (B_loc, K_loc, F, T).
      z_mask_b: optional per-clip z availability of this rank's clips with
        every node: (B_loc, K) per source, or (B_loc, K, K) with row k what
        consumer k received (``tango``'s ``z_mask`` with a clip axis; cut
        by ``shard_of(z_mask_b, mesh, ("batch",))``).
      z_nan_b: optional (B_loc, K) NaN-corruption flags of this rank's
        clips (``tango``'s ``z_nan``).

    Equal to the one-process batched ``tango`` on the assembled arrays.
    """
    if "batch" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"tango_batch_sharded needs a mesh with a 'batch' dim; got dims "
                         f"{mesh.mesh_dim_names}")
    rows = nan = None
    if z_mask_b is not None or z_nan_b is not None:
        dev = mesh_device(mesh)
        B_loc, K_loc = Yb.shape[0], Yb.shape[1]
        K = K_loc * dim_size(mesh, "node")
        ks = torch.arange(K_loc, device=dev) + _coord(mesh, "node") * K_loc
        zm = (torch.ones((B_loc, K), device=dev) if z_mask_b is None
              else torch.as_tensor(z_mask_b, dtype=torch.float32, device=dev))
        rows = zm[:, ks, :] if zm.ndim == 3 else zm[:, None, :].expand(B_loc, K_loc, K)
        if z_nan_b is not None:
            nan = torch.as_tensor(z_nan_b, device=dev)[:, ks]
    return _tango_on_mesh(Yb, Sb, Nb, masks_z_b, mask_w_b, mesh, False, mu, policy, ref_mic,
                          mask_type, False, solver=solver, cov_impl=cov_impl,
                          z_mask_rows=rows, z_nan=nan)
