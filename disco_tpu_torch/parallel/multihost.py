"""The multi-process runtime and the multi-host mesh (counterpart of
``disco_tpu/parallel/multihost.py``).

The JAX package runs one process per host, and ``jax.distributed`` joins
the hosts' devices into one global device view.  The port runs one process
per card (a *rank*), joined by ``torch.distributed``: rank r drives
``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo when the caller asks
for the CPU.  :func:`distributed_init` is ``init_process_group``;
:func:`hybrid_mesh` is the 3-dim ``(batch, node, frame)``
:class:`~torch.distributed.device_mesh.DeviceMesh`, with ``batch`` across
hosts and ``node``/``frame`` inside a host: NVLink takes the place of the
TPU's ICI links, the network takes the place of DCN.

There is no one-process fallback: a mesh names a world of ranks, and every
function that takes one raises unless ``torch.distributed`` is
initialised with exactly that world (:func:`check_world`).  A 1-rank world
is a real process group too (:func:`single_rank_world`), so a 1-rank mesh
runs the same collectives as a wider one.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

#: environment signals that this process is one of a multi-process job,
#: checked without touching ``torch.distributed`` (the JAX module's
#: ``_env_says_multiprocess``, plus torchrun's)
_ADDRESS_ENV = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)
_COUNT_ENV = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
_RANK_ENV = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_HOSTLIST_ENV = ("TPU_WORKER_HOSTNAMES",)  # a single host sets 'localhost'

DIMS = ("batch", "node", "frame")


def _env_int(names) -> int | None:
    for var in names:
        try:
            return int(os.environ[var])
        except (KeyError, ValueError):
            continue
    return None


def _env_says_multiprocess() -> bool:
    if any(os.environ.get(v) for v in _ADDRESS_ENV):
        return True
    for var in _COUNT_ENV:
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    # a hostname LIST (comma-separated) means a real multi-worker job
    return any("," in os.environ.get(v, "") for v in _HOSTLIST_ENV)


def backend_for(device) -> str:
    """The collective backend of a mesh on ``device``: NCCL on ``cuda``
    (RuntimeError without a CUDA device or without NCCL), gloo on
    ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {dev}; expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda' needs a CUDA device on every rank; this rank has "
                           "none (pass device='cpu' for gloo ranks on the host)")
    if not dist.is_nccl_available():
        raise RuntimeError("a mesh on 'cuda' needs NCCL, and this torch has no NCCL backend")
    return "nccl"


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; the
    global rank when the launcher sets none)."""
    lr = _env_int(("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"))
    return lr if lr is not None else (dist.get_rank() if dist.is_initialized() else 0)


def _bind_card(device) -> None:
    """Rank r drives ``cuda:LOCAL_RANK``; RuntimeError when the host has
    fewer cards than that."""
    if torch.device(device).type != "cuda":
        return
    lr, n = local_rank(), torch.cuda.device_count()
    if lr >= n:
        raise RuntimeError(f"rank with LOCAL_RANK {lr} has no card: this host has {n} CUDA "
                           "device(s), and a mesh on 'cuda' needs one for every rank")
    torch.cuda.set_device(lr)


def distributed_init(coordinator_address=None, num_processes=None, process_id=None,
                     device=None) -> bool:
    """Join the multi-process runtime (``torch.distributed.
    init_process_group``).

    With no arguments it initialises only when the environment says this
    is a multi-process job (torchrun's ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``, SLURM, OpenMPI, a coordinator address); a
    single-process run returns False and leaves ``torch.distributed``
    untouched.  ``coordinator_address`` (``host:port``), ``num_processes``
    and ``process_id`` name the world explicitly, as ``jax.distributed.
    initialize`` takes them.  ``device``: ``"cuda"`` when None (NCCL, each
    rank bound to ``cuda:LOCAL_RANK``) or ``"cpu"`` (gloo).  Returns True
    once the process is part of the world (also when it already was).
    """
    explicit = coordinator_address is not None or (num_processes or 0) > 1
    if not explicit and not _env_says_multiprocess():
        return False
    if dist.is_initialized():
        return True
    backend = backend_for("cuda" if device is None else device)
    _bind_card("cuda" if device is None else device)
    world = num_processes if num_processes is not None else _env_int(_COUNT_ENV)
    rank = process_id if process_id is not None else _env_int(_RANK_ENV)
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and \
            os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):
        # torchrun: its agent already holds the store at MASTER_PORT
        dist.init_process_group(backend, init_method="env://")
        return True
    address = coordinator_address or next(
        (os.environ[v] for v in _ADDRESS_ENV if os.environ.get(v)), None)
    if address is None or world is None or rank is None:
        raise ValueError(
            "distributed_init: a multi-process job needs a coordinator address, a world size "
            f"and this process's rank (got address={address!r}, world={world}, rank={rank}); "
            "launch with torchrun or pass them")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    return True


@contextlib.contextmanager
def single_rank_world(device=None):
    """A 1-rank ``torch.distributed`` world for the body, on ``device``
    (NCCL on ``cuda``, the default; gloo on ``cpu``), over an in-process
    store, torn down after it; a process already in a world keeps it and
    nothing is torn down.  The 1-rank mesh lanes (``--mesh 1 1``,
    ``--data-parallel 1``) run in it."""
    if dist.is_initialized():
        yield
        return
    dev = "cuda" if device is None else device
    backend = backend_for(dev)
    _bind_card(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in this process's world (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def check_world(n_ranks: int, device) -> str:
    """Raise unless ``torch.distributed`` is initialised with exactly
    ``n_ranks`` ranks on a backend that serves ``device``; returns the
    device type."""
    dev_type = torch.device(device).type
    backend_for(dev_type)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n_ranks} rank(s) needs torch.distributed initialised with that world: "
            "launch the ranks with torchrun (then distributed_init()), or run a 1-rank mesh "
            "inside single_rank_world()")
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"the mesh names {n_ranks} rank(s); the torch.distributed world has "
                         f"{dist.get_world_size()}")
    backend = str(dist.get_backend())
    want = "nccl" if dev_type == "cuda" else "gloo"
    if want not in backend:
        raise RuntimeError(f"a mesh on {dev_type!r} needs the {want} backend; the world runs "
                           f"{backend!r}")
    if dev_type == "cuda" and torch.cuda.device_count() <= local_rank():
        raise RuntimeError(f"rank with LOCAL_RANK {local_rank()} has no card of its own")
    return dev_type


def device_mesh(shape: tuple, names: tuple, device=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``shape``
    over the whole world, dims named ``names``; every rank calls it (it
    makes one process group a dim)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    dev_type = check_world(n, "cuda" if device is None else device)
    return DeviceMesh(dev_type, torch.arange(n).reshape(tuple(int(s) for s in shape)),
                      mesh_dim_names=tuple(names))


def hybrid_mesh(n_batch_dcn: int | None = None, n_node: int = 4, n_frame: int = 1,
                device=None):
    """A ``(batch, node, frame)`` mesh: ``batch`` over the network between
    hosts, ``node`` and ``frame`` over NVLink inside one.  Hosts play the
    role of the JAX package's TPU slices, and there is no ``slice_index``:
    ranks are numbered host by host (torchrun's rank order), so the row-
    major layout keeps each ``(node, frame)`` block inside a host whenever
    a host holds a whole number of them.

    With ``n_batch_dcn=None`` the batch dim takes every rank the others
    leave: ``world // (n_node * n_frame)``.  The mesh must cover the world
    exactly (:func:`check_world`)."""
    per_batch = n_node * n_frame
    if n_batch_dcn is None:
        n_batch_dcn = max(1, world_size() // per_batch)
    return device_mesh((n_batch_dcn, n_node, n_frame), DIMS, device)


def spawn_world(fn, world: int, device=None, args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined in
    one ``torch.distributed`` world (a file rendezvous in a temporary
    directory; NCCL with rank r on ``cuda:r`` when ``device`` is None or
    ``'cuda'``, gloo on ``'cpu'``), and wait for all of them; an exception
    in any rank is raised here.  ``fn`` must be importable by name (a
    module-level function).  For launching ranks from one process (gates,
    tests); a job of several hosts uses torchrun and
    :func:`distributed_init`."""
    import tempfile

    import torch.multiprocessing as mp

    dev = "cuda" if device is None else device
    backend_for(dev)
    with tempfile.TemporaryDirectory() as rdv:
        mp.start_processes(_spawned, args=(fn, world, dev, rdv, tuple(args)), nprocs=world,
                           join=True, start_method="spawn")


def _spawned(rank: int, fn, world: int, device, rdv: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    backend = backend_for(device)
    _bind_card(device)
    dist.init_process_group(backend, init_method=f"file://{rdv}/rendezvous", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
