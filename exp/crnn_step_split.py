"""Where one train step of the canonical CRNN differs between a CUDA card
and the host, and which side is nearer the exact step.

``chip_smoke.py``'s phase 3f holds one RMSprop step of the canonical
n_ch = 4 CRNN at batch 500 on the card against the same step on the host
(``TRAIN_TOL``).  This script takes phase 3f's batch (the same corpus,
``PostGenerator`` and ``export_z`` on the card, the same lists, dataset and
draw) and the CRNN that phase builds from ``TRAIN_SEED``, in two initial
weight draws:

* ``flax``: as the port's constructors draw it (``torch.manual_seed(seed)``
  then ``build_crnn``: lecun-normal kernels, orthogonal recurrent kernels,
  zero biases);
* ``torch``: the same generator state redrawn in torch's default scheme
  (``exp/crnn_milestone_parity.py::torch_default_init``), the CRNN the
  port built before it took flax's scheme.

Each model takes the step these ways: on the card in float32 as the port
runs it (``card``: cuDNN's deterministic algorithms, no autotuning), on
the card with cuDNN's free choice (``card_free``: not deterministic, no
autotuning), on the card with cuDNN off (``card_native``: PyTorch's own
CUDA convolutions and recurrences), on the card in float32 with TF32
allowed in cuBLAS and cuDNN (``card_tf32``, a deliberately degraded card
step: what a card-only precision fault looks like), on the host in
float32 (``host``) and on the host in float64 (``exact``, the step's
reference), and on the host in float32 and float64 with each max pool
routing its window to the element the card's pool chose
(``host_replay``, ``exact_replay``; ``host_replay_tf32`` takes the TF32
card step's choices), through ``chip_smoke.pool_choices``: the pool's
output is its input gathered at the card's indices, so the gradient goes
where the card's went.  A replay counts the windows where its own pool
would have chosen another element than the card's (``flips``) and how far
apart the two elements are there (``gap_max``, against the pool input's
largest magnitude ``scale``); with its card way's parameters
(``params_to_source``) these are the readings of phase 3f's step check,
for the sound card step and for the TF32 one.  Each card way's step is
also timed (CUDA events, median of ``TIMED`` steps after one).  For every
parameter tensor it prints the gradients' and the updated parameters'
max-abs distances between the ways and to the float64 step, the largest
gradient, and where the card's parameters differ most
from the host's: the element, its gradient on each side and in float64,
and RMSprop's first-step update there.  RMSprop's first update from
``nu = 0`` is ``lr g / sqrt((1 - decay) g^2 + eps)``: flat (``~10 lr``) for
``|g| >> sqrt(eps / (1 - decay)) = 1e-3`` and ``lr / sqrt(eps) = 10`` times
the gradient below it, so a gradient's rounding moves the parameter ten
times as far where the gradient itself is small.

Run from the repo root on a machine with the card:

    python exp/crnn_step_split.py [--ways card_tf32,host_replay,...] \
        [--schemes flax,torch] [--out crnn_step_split.json]

It writes ``chiprun_out/<--out>``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "exp"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from crnn_milestone_parity import torch_default_init  # noqa: E402

WAYS = ("card", "card_free", "card_native", "card_tf32", "host", "exact", "host_replay",
        "exact_replay", "host_replay_tf32")
#: a replay way -> the card way whose max-pool choices it takes
REPLAYS = {"host_replay": "card", "exact_replay": "card", "host_replay_tf32": "card_tf32"}
#: timed steps of each card way
TIMED = 5


def phase3f_batch(build: Path):
    """Phase 3f's first batch (x, y) of 500 windows, made as that phase
    makes it."""
    from disco_tpu_torch.datagen.postgen import PostGenerator
    from disco_tpu_torch.enhance.zexport import export_z
    from disco_tpu_torch.nn.data import DiscoDataset, get_input_lists

    snr = [0, 6]
    with tempfile.TemporaryDirectory(prefix="split-", dir=build) as tmp:
        root = Path(tmp) / "corpus"
        cs.training_corpus(root)
        pg = PostGenerator(cs.TRAIN_RIRS[0], len(cs.TRAIN_RIRS), "random", "ssn", snr,
                           str(root), rng=np.random.default_rng(0))
        assert pg.post_process() == list(cs.TRAIN_RIRS)
        for r in cs.TRAIN_RIRS:
            assert export_z(str(root), "random", r, "ssn", snr_range=tuple(snr), n_nodes=4,
                            mics_per_node=4)
        lists = get_input_lists(str(root), list(cs.TRAIN_RIRS), scenes="random",
                                z_sigs=["zs_hat"], rng=np.random.default_rng(0))
        ds = DiscoDataset(lists, stack_axis=2, rng=np.random.default_rng(0))
        return next(cs.EpochBatches(ds, 99)())


def initial_model(scheme: str):
    """The canonical CRNN of phase 3f's seed on the host, in ``scheme``."""
    from disco_tpu_torch.nn.crnn import build_crnn

    torch.manual_seed(cs.TRAIN_SEED)
    model = build_crnn(n_ch=4)
    if scheme == "torch":
        torch_default_init(model)
    return model


@contextlib.contextmanager
def way_flags(way: str):
    """The cuDNN and TF32 settings of ``way`` around a step (``make_step_fns``
    sets cuDNN's determinism around each step itself, so ``card_free``
    replaces that setter for the step)."""
    from disco_tpu_torch.nn import training

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = way == "card_tf32"
    setter = training.deterministic_cudnn
    if way == "card_free":
        training.deterministic_cudnn = contextlib.nullcontext
    try:
        with torch.backends.cudnn.flags(enabled=way != "card_native", benchmark=False,
                                        deterministic=False, allow_tf32=way == "card_tf32"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        training.deterministic_cudnn = setter


def one_step(model0, way: str, x, y, card_pools=None) -> dict:
    """One train step of a copy of ``model0`` the way ``way`` says:
    the loss, and the gradients and updated parameters in float64 on the
    host, by parameter name; a card way's max-pool choices, a replay's
    flips (from ``card_pools``); for a card way also
    the step's milliseconds (CUDA events, the median of ``TIMED`` steps on
    another copy)."""
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, make_step_fns

    dev = "cuda" if way.startswith("card") else "cpu"
    dtype = torch.float64 if way.startswith("exact") else torch.float32
    np_dtype = np.float64 if way.startswith("exact") else np.float32
    xs, ys = x.astype(np_dtype), y.astype(np_dtype)

    def fresh():
        model = copy.deepcopy(model0).to(dev, dtype)
        state = create_train_state(model, build_optimizer(model))
        return model, state, make_step_fns(model, "all")[0]

    model, state, train_step = fresh()
    pools, flips = [], []
    replay = card_pools if way in REPLAYS else None
    with way_flags(way), cs.pool_choices(model, record=pools if dev == "cuda" else None,
                                         replay=replay, ties=flips):
        state, loss = train_step(state, xs, ys)
        loss = float(loss)
    named = dict(model.named_parameters())
    out = {"loss": loss, "pools": pools, "flips": flips,
           "grad": {k: p.grad.detach().double().cpu() for k, p in named.items()},
           "param": {k: p.detach().double().cpu() for k, p in named.items()},
           "nu": {k: state.optimizer.state[p]["nu"].double().cpu() for k, p in named.items()}}
    if dev == "cuda":
        _, tstate, tstep = fresh()
        xt, yt = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
        ms = []
        with way_flags(way):
            tstep(tstate, xt, yt)
            for _ in range(TIMED):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                tstep(tstate, xt, yt)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
        out["ms"] = sorted(ms)[len(ms) // 2]
    return out


def mabs(a, b) -> float:
    return float((a - b).abs().max())


def split(model0, steps: dict) -> dict:
    """Per tensor: the largest float64 gradient, each way's gradient and
    updated parameters against the exact step's (max-abs), the card's
    parameters against the host's, and the element where those differ
    most.  Per way: the loss, the parameters' largest distance to the exact
    step's and to the host's, and a card way's milliseconds."""
    before = {k: p.detach().double() for k, p in model0.named_parameters()}
    exact, ways = steps["exact"], [w for w in steps if w != "exact"]
    tensors = []
    for k in before:
        dp = (steps["card"]["param"][k] - steps["host"]["param"][k]).abs()
        i = int(dp.argmax())

        def el(t):
            return float(t.reshape(-1)[i])

        tensors.append({
            "tensor": k, "shape": list(dp.shape),
            "grad_max": float(exact["grad"][k].abs().max()),
            "grad_to_exact": {w: mabs(steps[w]["grad"][k], exact["grad"][k]) for w in ways},
            "param_to_exact": {w: mabs(steps[w]["param"][k], exact["param"][k]) for w in ways},
            "param_card_host": float(dp.max()),
            "worst": {"index": [int(j) for j in np.unravel_index(i, dp.shape)],
                      "grad": {w: el(steps[w]["grad"][k]) for w in steps},
                      "update": {w: el(steps[w]["param"][k] - before[k]) for w in steps}},
        })
    per_way = {w: {"loss": steps[w]["loss"], "ms": steps[w].get("ms"), "flips": steps[w]["flips"],
                   "params_to_exact": max(t["param_to_exact"][w] for t in tensors),
                   "params_to_host": max(mabs(steps[w]["param"][k], steps["host"]["param"][k])
                                         for k in before)} for w in ways}
    for w, src in REPLAYS.items():
        if w in steps:
            per_way[w]["params_to_source"] = max(
                mabs(steps[w]["param"][k], steps[src]["param"][k]) for k in before)
            per_way[w]["tie"] = max(f["gap_max"] / f["scale"] for f in steps[w]["flips"])
    return {"ways": per_way, "exact_loss": exact["loss"], "tensors": tensors}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ways", default=",".join(WAYS),
                   help="comma-separated, from " + ", ".join(WAYS) + " (card, host and exact "
                        "are always run)")
    p.add_argument("--schemes", default="flax,torch")
    p.add_argument("--out", default="crnn_step_split.json", help="file under chiprun_out/")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    asked = set(args.ways.split(",")) | {"card", "host", "exact"}
    asked |= {REPLAYS[w] for w in asked if w in REPLAYS}
    ways = [w for w in WAYS if w in asked]
    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    x, y = phase3f_batch(build)
    print(f"batch {x.shape} {y.shape} in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"card": smi, "torch": torch.__version__, "schemes": {}}
    for scheme in args.schemes.split(","):
        model0 = initial_model(scheme)
        steps = {}
        for w in ways:
            src = steps.get(REPLAYS.get(w))
            steps[w] = one_step(model0, w, x, y, src["pools"] if src else None)
        rep = split(model0, steps)
        out["schemes"][scheme] = rep
        print(f"{scheme}: exact loss {rep['exact_loss']}; " + json.dumps(rep["ways"]),
              flush=True)
        for t in sorted(rep["tensors"], key=lambda t: -t["param_card_host"]):
            print(f"  {scheme} {json.dumps(t)}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
