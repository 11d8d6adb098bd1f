"""Rank bodies of the port's multi-process tests (``tests/test_torch_port_
parallel*.py``).  This module imports torch and numpy only, never JAX: it
runs in the gloo ranks that :func:`spawn` starts.

Each test file calls :func:`spawn` at most once a world size: the ranks
rendezvous through a file in a temporary directory (never a fixed TCP
port, since several test workers run at once), each runs on one torch
thread and one BLAS thread at a lower priority, reads the numpy inputs the
test process wrote (``inputs.npz``) and runs ONE body of this module, and
rank 0 writes what it assembled to ``<body>_w<world>.npz`` for the test
process to compare.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

POLICIES = ("local", "none", "distant", "use_oracle_zs")
FIELDS = ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn")
#: the availability of the fault contracts (tests/test_fault.py:310-370)
Z_MASK = np.array([1.0, 0.0, 1.0, 1.0], np.float32)


def spawn(world: int, body: str, io: Path, **kw) -> dict:
    """Run ``body`` on ``world`` gloo ranks (``parallel.multihost.
    spawn_world``) over the files in ``io``; returns rank 0's output
    (``{name: array}``, plus ``"json"`` when the body wrote one)."""
    from disco_tpu_torch.parallel.multihost import spawn_world

    io = Path(io)
    spawn_world(_entry, world, "cpu", (body, str(io), kw))
    out = dict(np.load(io / f"{body}_w{world}.npz", allow_pickle=False))
    extra = io / f"{body}_w{world}.json"
    if extra.exists():
        out["json"] = json.loads(extra.read_text())
    return out


def _entry(rank: int, world: int, body: str, io: str, kw: dict) -> None:
    import os

    # the ranks are extra processes beside the runner's workers: below them
    # in priority, so the suite's host-timed serving tests keep their pace
    os.nice(10)
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from tests.torch_port_helpers import _openblas_thread_setters

    torch.set_num_threads(1)
    for _get, put in _openblas_thread_setters():
        put(1)
    io = Path(io)
    out, extra = globals()[body](rank, world, io, **kw)
    if rank == 0:
        np.savez(io / f"{body}_w{world}.npz", **out)
        if extra is not None:
            (io / f"{body}_w{world}.json").write_text(json.dumps(extra))


def _inputs(io: Path) -> dict:
    return dict(np.load(io / "inputs.npz"))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fields(prefix: str, res, out: dict, fields=FIELDS) -> None:
    for f in fields:
        out[f"{prefix}/{f}"] = _np(getattr(res, f))


# -- node-sharded TANGO, the ring, the meshes --------------------------------
def node_sharded(rank: int, world: int, io: Path):
    """Every policy through ``tango_sharded`` (and the one-process ``tango``
    on the assembled inputs), the ring exchange, the fault mask, the ring's
    node order and the mesh shapes, at this world size."""
    from disco_tpu_torch.config import MeshConfig
    from disco_tpu_torch.enhance.tango import tango
    from disco_tpu_torch.parallel import (
        gather_result,
        hybrid_mesh,
        make_mesh,
        make_mesh_2d,
        mesh_from_config,
        node_sharding,
        ring_all_gather,
        shard_of,
        tango_sharded,
    )
    from disco_tpu_torch.parallel.mesh import _all_gather

    d = _inputs(io)
    Y, S, N, m = (torch.as_tensor(d[k]) for k in ("Y", "S", "N", "m"))
    mesh = make_mesh(n_node=world, device="cpu")
    sh = node_sharding(mesh)
    out = {}
    for policy in POLICIES:
        res = tango_sharded(sh(Y), sh(S), sh(N), sh(m), sh(m), mesh, policy=policy)
        _fields(f"sharded/{policy}", gather_result(res, mesh), out)
        if rank == 0:
            _fields(f"one/{policy}", tango(Y, S, N, m, m, policy=policy, device="cpu"), out)
    ring = tango_sharded(sh(Y), sh(S), sh(N), sh(m), sh(m), mesh, z_exchange="ring")
    _fields("ring/local", gather_result(ring, mesh), out)
    zm = torch.as_tensor(Z_MASK)
    fault = tango_sharded(sh(Y), sh(S), sh(N), sh(m), sh(m), mesh, solver="eigh",
                          z_mask=sh(zm))
    out["fault/yf"] = _np(gather_result(fault, mesh).yf)
    if rank == 0:
        out["fault_one/yf"] = _np(tango(Y, S, N, m, m, solver="eigh", z_mask=zm,
                                        device="cpu").yf)
    # the ring's node order with two rows a shard
    x = shard_of(torch.arange(2 * world, dtype=torch.float32).reshape(2 * world, 1), mesh)
    group = mesh.get_group("node")
    out["order/ring"] = _np(ring_all_gather(x, group))
    out["order/all_gather"] = _np(_all_gather(x, group, 0))

    def shape(msh):
        return {n: int(msh.size(i)) for i, n in enumerate(msh.mesh_dim_names)}

    shapes = {
        "make_mesh": shape(make_mesh(device="cpu")),
        "make_mesh_b2": shape(make_mesh(n_node=world // 2, n_batch=2, device="cpu")),
        "make_mesh_2d": shape(make_mesh_2d(world // 2, 2, device="cpu")),
        "hybrid": shape(hybrid_mesh(n_node=1, n_frame=2, device="cpu")),
        "hybrid_b1": shape(hybrid_mesh(n_batch_dcn=1, n_node=world // 2, n_frame=2,
                                       device="cpu")),
        "config_node": shape(mesh_from_config(MeshConfig(n_node=world), device="cpu")),
        "config_frame": shape(mesh_from_config(MeshConfig(n_frame=2), device="cpu")),
        "config_batch": shape(mesh_from_config(MeshConfig(n_node=1, n_frame=2,
                                                          n_batch=world // 2), device="cpu")),
    }
    return out, shapes


# -- frame- and batch-sharded TANGO ------------------------------------------
FRAME_POLICIES = ("local", "none", "distant")


def _assembled_on(res, mesh, dst: int) -> np.ndarray:
    """1 when ``gather_result(res, mesh, dst=dst)`` is the all-gathered
    result on rank ``dst`` and None on every other rank, over all ranks."""
    import torch.distributed as dist

    from disco_tpu_torch.parallel import gather_result

    full, at = gather_result(res, mesh), gather_result(res, mesh, dst=dst)
    if dist.get_rank() != dst:
        ok = at is None
    else:
        ok = all(np.array_equal(_np(getattr(at, f)), _np(getattr(full, f)), equal_nan=True)
                 for f in FIELDS)
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return flag.numpy()


def frame_and_batch(rank: int, world: int, io: Path):
    """``tango_frame_sharded`` on a (node 2, frame 2) mesh for three
    policies and with the fault mask, and ``tango_batch_sharded`` on a
    (batch 2, node 2) mesh, plain and with per-clip masks and NaN flags;
    each beside the one-process ``tango`` on the assembled inputs."""
    from disco_tpu_torch.enhance.tango import tango
    from disco_tpu_torch.parallel import (
        gather_result,
        make_mesh,
        make_mesh_2d,
        shard_of,
        tango_batch_sharded,
        tango_frame_sharded,
    )

    d = _inputs(io)
    Y, S, N, m = (torch.as_tensor(d[k]) for k in ("Y", "S", "N", "m"))
    out = {}
    mesh = make_mesh_2d(2, 2, device="cpu")
    spec4, spec3 = ("node", None, None, "frame"), ("node", None, "frame")
    Ys, Ss, Ns = (shard_of(a, mesh, spec4) for a in (Y, S, N))
    ms = shard_of(m, mesh, spec3)
    for policy in FRAME_POLICIES:
        res = tango_frame_sharded(Ys, Ss, Ns, ms, ms, mesh, policy=policy)
        _fields(f"frame/{policy}", gather_result(res, mesh), out)
        if rank == 0:
            _fields(f"one/{policy}", tango(Y, S, N, m, m, policy=policy, device="cpu"), out)
    # assembled on the last rank alone: its gathers run over groups that
    # do not hold rank 0
    out["dst/frame"] = _assembled_on(res, mesh, world - 1)
    zm = torch.as_tensor(Z_MASK)
    res = tango_frame_sharded(Ys, Ss, Ns, ms, ms, mesh, solver="eigh",
                              z_mask=shard_of(zm, mesh))
    out["frame_fault/yf"] = _np(gather_result(res, mesh).yf)
    if rank == 0:
        out["frame_fault_one/yf"] = _np(tango(Y, S, N, m, m, solver="eigh", z_mask=zm,
                                              device="cpu").yf)

    bmesh = make_mesh(n_node=2, n_batch=2, device="cpu")
    Yb, Sb, Nb, mb = (torch.as_tensor(d[k]) for k in ("Yb", "Sb", "Nb", "mb"))
    cut = [shard_of(a, bmesh, ("batch", "node")) for a in (Yb, Sb, Nb, mb)]
    res = tango_batch_sharded(*cut, cut[3], bmesh, policy="local")
    _fields("batch", gather_result(res, bmesh), out)
    out["dst/batch"] = _assembled_on(res, bmesh, 0)
    if rank == 0:
        _fields("batch_one", tango(Yb, Sb, Nb, mb, mb, policy="local", device="cpu"), out)
    # the per-clip fault seam (tests/test_fault.py:343-370): clip 1 at half
    # level, clip 0 with node 1 dropped, clip 1 with node 2's z NaN
    Yf, Sf, Nf = (torch.stack([a, a * 0.5]) for a in (Y, S, N))
    mf = torch.stack([m, m])
    zmb = torch.as_tensor(np.stack([Z_MASK, np.ones(4, np.float32)]))
    znb = torch.zeros((2, 4), dtype=torch.bool)
    znb[1, 2] = True
    cut = [shard_of(a, bmesh, ("batch", "node")) for a in (Yf, Sf, Nf, mf)]
    res = tango_batch_sharded(*cut, cut[3], bmesh, policy="local", solver="eigh",
                              z_mask_b=shard_of(zmb, bmesh, ("batch",)),
                              z_nan_b=shard_of(znb, bmesh, ("batch",)))
    out["batch_fault/yf"] = _np(gather_result(res, bmesh).yf)
    if rank == 0:
        out["batch_fault_one/yf"] = np.stack([
            _np(tango(Y, S, N, m, m, solver="eigh", z_mask=zmb[0], device="cpu").yf),
            _np(tango(Y * 0.5, S * 0.5, N * 0.5, m, m, solver="eigh", z_nan=znb[1],
                      device="cpu").yf)])
    return out, None


# -- data-parallel training ---------------------------------------------------
#: the flywheel gate's tiny CRNN (disco_tpu/flywheel/check.py:54-66) at the
#: served F, and a 2-layer GRU twin with dropout between its layers
WIN, NF, STEPS = 4, 257, 6
TINY = dict(n_ch=1, win_len=WIN, n_freq=NF, cnn_filters=(4,), pool_kernels=((1, 4),),
            conv_padding=((0, 1),), rnn_units=(16,), ff_units=(NF,), rnn_dropouts=0.0)
DROPOUT = dict(TINY, rnn_units=(16, 16), rnn_dropouts=0.5)
CLIP = 1.0  # clip_by_global_norm: the clip must see the global gradient


def train_model(kind: str, sd: dict):
    """(model, state) of ``kind`` with the state dict ``sd`` loaded."""
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state

    model = build_crnn(**(TINY if kind == "tiny" else DROPOUT))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model, create_train_state(model, build_optimizer(model, 1e-3, CLIP), seed=5)


def run_steps(kind: str, sd: dict, batches: list, mesh=None) -> dict:
    """The losses, the eval loss and the final state dict of STEPS train
    steps from ``sd`` (on ``mesh``, or meshless)."""
    from disco_tpu_torch.nn.training import make_step_fns, replicate_to_mesh

    model, state = train_model(kind, sd)
    if mesh is not None:
        state = replicate_to_mesh(state, mesh)
    step, evaluate = make_step_fns(model, "all", mesh=mesh)
    losses = [float(step(state, x, y)[1]) for x, y in batches]
    out = {"losses": np.asarray(losses), "eval": np.asarray(float(evaluate(state, *batches[0])))}
    out.update({f"sd/{k}": _np(v) for k, v in model.state_dict().items()})
    return out


def train_steps(rank: int, world: int, io: Path):
    """Both models' steps on a (batch ``world``, node 1) mesh and, on rank
    0, meshless."""
    from disco_tpu_torch.parallel import make_mesh

    d = _inputs(io)
    batches = [(d[f"x{i}"], d[f"y{i}"]) for i in range(STEPS)]
    mesh = make_mesh(n_node=1, n_batch=world, device="cpu")
    out = {}
    for kind in ("tiny", "dropout"):
        sd = {k[len(kind) + 4:]: v for k, v in d.items() if k.startswith(f"{kind}/sd/")}
        for lane, m in (("mesh", mesh), ("meshless", None)):
            if lane == "meshless" and rank:
                continue
            got = run_steps(kind, sd, batches, m)
            out.update({f"{kind}/{lane}/{k}": v for k, v in got.items()})
    return out, None


# -- the corpus driver's mesh lane -------------------------------------------
def driver_mesh(rank: int, world: int, io: Path):
    """``enhance_rirs_batched`` over the corpus under ``io/corpus`` on a
    (batch ``world``, node 1) mesh (its results ``<rir>/<key>``, its tree
    under ``io/mesh``) and on a (batch 1, node ``world``) mesh (``node/
    <rir>/<key>``, ``io/mesh_node``); rank 0 returns the results, the
    others none."""
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched
    from disco_tpu_torch.parallel import make_mesh
    from disco_tpu_torch.runs.check import NOISE, RIRS, SNR_RANGE

    out = {}
    for prefix, tree, mesh in (
            ("", "mesh", make_mesh(n_node=1, n_batch=world, device="cpu")),
            ("node/", "mesh_node", make_mesh(n_node=world, n_batch=1, device="cpu"))):
        res = enhance_rirs_batched(str(io / "corpus"), "living", list(RIRS), NOISE,
                                   snr_range=SNR_RANGE, n_nodes=4, mics_per_node=2,
                                   out_root=str(io / tree), save_fig=False, max_batch=2,
                                   score_workers=1, ledger=str(io / f"{tree}.jsonl"),
                                   mesh=mesh)
        if rank:
            assert res == {}, sorted(res)
        out.update({f"{prefix}{rir}/{k}": v for rir, r in res.items() for k, v in r.items()})
    return out, None
