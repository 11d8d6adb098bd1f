"""The promotion contract's legs, as functions of a device (the port's
counterpart of ``disco_tpu/promote/check.py``).

Each leg runs an in-process :class:`~disco_tpu_torch.serve.EnhanceServer`
with a :class:`~disco_tpu_torch.promote.PromotionController` on loopback,
drives ``masks="model"`` sessions with numpy
:class:`~disco_tpu_torch.serve.ServeClient` clients in paced rounds (each
round sends every client's next block, then receives them; a generation
swap therefore lands between rounds and every block runs under exactly one
generation), appends what it finds wrong to ``failures`` and returns its
numbers.  The CPU tests call them on ``device="cpu"`` with a tiny CRNN, and
``chip_smoke.py`` on the card at the north-star width with the canonical
CRNN, so the contract is written once:

1. :func:`check_rollback` — a zeroed candidate (every mask sigmoid(0) =
   0.5) is canaried onto part of the sessions; the harness, playing the
   external scorer, offers canary SDR far below the incumbent's; the gate
   fails on ``canary_sdr_db`` and rolls the canaries back.  The flight
   recorder dumps a ``demotion`` post-mortem naming the metric, and the
   rollout ledger lands ``failed`` with the same reason.
2. :func:`check_promote` — a perturbed candidate dropped into the
   controller's watch directory as a checkpoint is staged, canaried,
   passes the SDR + SLO gate and is promoted to every session; ``ACTIVE``
   flips, ``model_promotions``, ``weight_generation`` and
   ``tap_to_promotion_ms`` are recorded.
3. :func:`check_pre_swap` — a ``ChaosCrash`` at the dispatch thread's
   ``pre_swap`` seam kills the server mid-rollout after one canary swapped
   and checkpointed.  No torn generation, checkpoint or temp file; ACTIVE
   is still the incumbent and the rollout ``in_flight``.  A restarted
   server rolls the rollout back from the ledger, resumes the checkpointed
   session on the incumbent and promotes a fresh candidate.
4. :func:`check_controller_crash` — ``mid_canary`` and ``post_gate``
   crashes kill the controller thread alone; serving goes on, the crash is
   surfaced in ``PromotionController.crashed``, and a fresh controller's
   ledger replay rolls the orphaned rollout back.
5. :func:`check_model_sessions` — model sessions beside a time-domain
   client-mask session, with the corpus tap on: every stream bit-exact, one
   batched readback a tick, every model block tapped with the masks the
   oracle computes, and (given the kernels' launch counters) the launches
   of serving equal to those of the oracle's calls.

In every leg each session's delivered stream is held bit for bit against
its per-generation oracle (:func:`gen_oracle`): per-block
:func:`~disco_tpu_torch.promote.lane.block_masks` under the generation
each block ran under, chained block by block through ``streaming_tango``
with the state carried — the calls the server makes, one at a time, on the
same device.

:func:`main` runs legs 1-4 as a command (``python -m
disco_tpu_torch.promote.check``, on ``cuda`` unless given ``--device
cpu``) and reads its event log back with the JAX gate's checks: the
staged, promoted, canary and rollback events, exactly 2 ``crashed``
rollback events, and one ``fault`` event with ``fault="chaos_crash"`` (the
chaos harness records it, ``runs/chaos.py``) for each crash injected.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: the small size of the CPU checks: nodes, mics, refresh length, block
K, C, U = 3, 2, 4
BLOCK = 2 * U
WIN = BLOCK // 2     # the tiny CRNN's window
WINDOW = 4           # canary window (blocks) of the gated legs
#: SLO targets of the gated legs: the wall-clock latency legs are relaxed
#: (a cold first block — the generation's model built and moved, the first
#: library calls — dominates the p95 of a few dozen blocks, and host speed
#: must not decide the gate), the rate legs keep their production targets
SLO_TARGETS = {"serve_p95_ms": 60000.0, "queue_wait_p95_ms": 60000.0}


# -- inputs (main thread, before any server starts) --------------------------
def scene(seed: int, n_blocks: int, *, n_nodes: int = K, n_mics: int = C,
          block: int = BLOCK, device=None) -> np.ndarray:
    """(K, C, F, n_blocks * block) complex64 host STFT of seeded white noise
    (the port's STFT on ``device``), cut to whole blocks."""
    import torch

    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.device import resolve_device, to_host

    rng = np.random.default_rng(seed)
    length = (n_blocks * block + 1) * 256
    x = rng.standard_normal((n_nodes, n_mics, length)).astype(np.float32)
    (Y,) = to_host([stft(torch.from_numpy(x).to(resolve_device(device)))])
    return np.ascontiguousarray(Y[..., :n_blocks * block])


def tiny_arch(n_freq: int, win_len: int = WIN) -> dict:
    """The checks' tiny CRNN ``build_crnn`` kwargs (the JAX gate's: conv 4,
    GRU 16, FF ``n_freq``)."""
    return dict(n_ch=1, win_len=win_len, n_freq=n_freq, cnn_filters=(4,),
                pool_kernels=((1, 4),), conv_padding=((0, 1),), rnn_units=(16,),
                ff_units=(n_freq,), rnn_dropouts=0.0)


def seeded_variables(arch: dict, seed: int) -> dict:
    """The flax-layout ``{"params", "batch_stats"}`` numpy tree of a port
    CRNN of ``arch`` built from torch's generator seeded with ``seed``,
    its BatchNorm running statistics redrawn from numpy (a fresh module's
    0/1 would hide a wrong statistics mapping)."""
    import torch

    from disco_tpu_torch.nn.convert import flax_from_state_dict
    from disco_tpu_torch.promote.store import model_for_arch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = model_for_arch(arch)
    variables = flax_from_state_dict(model.state_dict(), model)
    rng = np.random.default_rng(seed)

    def redraw(tree):
        return {k: redraw(v) if isinstance(v, dict) else
                ((0.5 + rng.random(v.shape)) if k == "var" else 0.1 * rng.standard_normal(v.shape)
                 ).astype(np.float32) for k, v in tree.items()}

    variables["batch_stats"] = redraw(variables["batch_stats"])
    return variables


def _map_params(variables: dict, fn) -> dict:
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else fn(v).astype(v.dtype)
                for k, v in tree.items()}

    return {"params": walk(variables["params"]), "batch_stats": variables["batch_stats"]}


def perturbed(variables: dict, eps: float) -> dict:
    """A 'good candidate': the incumbent's parameters plus ``eps`` — another
    digest, comparable numbers."""
    return _map_params(variables, lambda a: a + np.float32(eps))


def zeroed(variables: dict) -> dict:
    """The worse-on-purpose candidate: zeroed parameters, every mask
    sigmoid(0) = 0.5."""
    return _map_params(variables, lambda a: a * np.float32(0))


def model_config(n_freq: int, *, n_nodes: int = K, n_mics: int = C, block: int = BLOCK,
                 update_every: int = U, **kw):
    """A ``masks="model"`` :class:`~disco_tpu_torch.serve.SessionConfig`."""
    from disco_tpu_torch.serve import SessionConfig

    return SessionConfig(n_nodes=n_nodes, mics_per_node=n_mics, n_freq=n_freq,
                         block_frames=block, update_every=update_every, masks="model", **kw)


# -- the oracle (no server running) ------------------------------------------
def gen_oracle(Y, gens: list, store, config, *, device=None, state=None) -> np.ndarray:
    """The offline replay of one served model session: block i's masks by
    :func:`~disco_tpu_torch.promote.lane.block_masks` under ``gens[i]``
    (loaded through the store, digest-verified: loading doubles as the
    no-torn-file check), and ``streaming_tango`` block by block with the
    state carried, as the scheduler calls them, from ``state`` (a fresh
    session's when None).  A host array."""
    import torch

    from disco_tpu_torch.device import resolve_device, to_host
    from disco_tpu_torch.enhance.streaming import streaming_tango
    from disco_tpu_torch.promote.lane import block_masks

    dev = resolve_device(device)
    cfg, bf = config, config.block_frames
    models: dict = {}
    outs = []
    for i, g in enumerate(gens):
        if g not in models:
            models[g] = store.load(g, device=dev)[0]
        Yb = Y[..., i * bf:(i + 1) * bf]
        m = block_masks(Yb, models[g], ref_mic=cfg.ref_mic)
        n_ref = -(-Yb.shape[-1] // cfg.update_every)
        o = streaming_tango(Yb, m, m, lambda_cor=cfg.lambda_cor, update_every=cfg.update_every,
                            mu=cfg.mu, ref_mic=cfg.ref_mic, policy=cfg.policy, state=state,
                            solver=cfg.solver, z_avail=np.ones((Y.shape[0], n_ref), np.float32),
                            device=dev)
        state = o["state"]
        outs.append(o["yf"])
    return to_host([torch.cat(outs, dim=-1)])[0]


def assert_stream(failures: list, label: str, delivered: dict, gen_of: dict, Y, store,
                  config, *, device=None, want_gens=None) -> list:
    """Stitch one session's delivered frames and hold them bit for bit
    against :func:`gen_oracle`; returns the per-block generations."""
    n = max(delivered) + 1 if delivered else 0
    if sorted(delivered) != list(range(n)):
        failures.append(f"{label}: delivered seqs have holes ({sorted(delivered)})")
        return []
    gens = [gen_of.get(i) for i in range(n)]
    if None in gens:
        failures.append(f"{label}: enhanced frames missing generation tags at seqs "
                        f"{[i for i, g in enumerate(gens) if g is None]}")
        return gens
    if want_gens is not None and set(gens) != set(want_gens):
        failures.append(f"{label}: generations {sorted(set(gens))} delivered, expected "
                        f"exactly {sorted(set(want_gens))}")
    if n == 0:
        return gens
    got = np.concatenate([delivered[i] for i in range(n)], axis=-1)
    ref = gen_oracle(Y, gens, store, config, device=device)
    if got.shape != ref.shape or not np.array_equal(got, ref):
        diff = np.abs(got - ref).max() if got.shape == ref.shape else f"shape {got.shape}"
        failures.append(f"{label}: stream not bit-exact vs the per-generation offline "
                        f"oracle (max abs diff {diff})")
    return gens


def rollout_record(store, gen_id):
    """The rollout ledger's latest record of ``gen_id``'s rollout, or None."""
    from disco_tpu_torch.promote.controller import rollout_unit

    led = store.rollout_ledger()
    try:
        return led.replay().get(rollout_unit(gen_id))
    finally:
        led.close()


# -- paced rounds ------------------------------------------------------------
class Pacer:
    """Paced rounds over a set of clients: :meth:`round` sends every
    client's next block, then receives each, so a swap lands between
    rounds.  Keeps the delivered frames, the per-block latency (send to
    receive, host clock) and the serving wall time."""

    def __init__(self, clients, clips, block: int, score=None, timeout_s: float = 120.0):
        self.clients, self.clips, self.block = clients, clips, block
        self.score, self.timeout_s = score, timeout_s
        self.cursors = [0] * len(clients)
        self.delivered = [{} for _ in clients]
        self.latency_ms: list = []
        self.seconds = 0.0

    def round(self) -> None:
        idx = range(len(self.clients))
        t0 = time.perf_counter()
        sent = {}
        for j in idx:
            i, lo = self.cursors[j], self.cursors[j] * self.block
            self.clients[j].send_block(self.clips[j][..., lo:lo + self.block])
            sent[j] = time.perf_counter()
        for j in idx:
            i = self.cursors[j]
            self.delivered[j][i] = self.clients[j].recv_enhanced(i, timeout_s=self.timeout_s)
            self.latency_ms.append((time.perf_counter() - sent[j]) * 1e3)
            self.cursors[j] = i + 1
            if self.score is not None:
                self.score(j, i, self.clients[j].gen_of.get(i))
        self.seconds += time.perf_counter() - t0

    @property
    def blocks(self) -> int:
        return sum(len(d) for d in self.delivered)


def _open_clients(addr, configs, prefix: str):
    from disco_tpu_torch.serve import ServeClient

    clients = []
    for j, cfg in enumerate(configs):
        cl = ServeClient(addr)
        cl.open(cfg, session_id=f"{prefix}{j}")
        clients.append(cl)
    return clients


def _close(clients) -> None:
    for cl in clients:
        cl.close()
        cl.shutdown()


def fresh_gate_metrics() -> None:
    """Zero the process-wide registry.  The SLO gate reads it (tap drops
    over offers, evictions over finished sessions, latency percentiles),
    and a leg judges its own server's traffic: the drops or evictions of
    anything the process ran before (another leg, another test) must not
    decide its rollout."""
    from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry

    obs_registry.reset()


def _stage_incumbent(store, arch, variables):
    inc = store.stage_variables(variables, arch=arch, source="check-incumbent")
    store.set_active(inc.gen_id)
    return inc


# -- the legs ----------------------------------------------------------------
def check_rollback(failures: list, root, clips, configs, arch: dict, variables: dict, *,
                   device=None) -> dict:
    """Leg 1: a zeroed candidate is canaried onto half the sessions, the SDR
    gate fails and every canary rolls back; each stream bit-exact to its
    oracle, a canary's history incumbent -> candidate -> incumbent.
    ``clips``/``configs``: one (K, C, F, T) block stream and one
    ``masks="model"`` config a session (at least two sessions)."""
    from disco_tpu_torch.obs import flight as obs_flight
    from disco_tpu_torch.promote import GenerationStore, PromotionController
    from disco_tpu_torch.serve import EnhanceServer

    fresh_gate_metrics()
    root = Path(root)
    store = GenerationStore(root / "store")
    inc = _stage_incumbent(store, arch, variables)
    bf = configs[0].block_frames
    n_blocks = min(c.shape[-1] for c in clips) // bf
    flight_dir = root / "flight"
    obs_flight.enable(dump_dir=flight_dir, capacity=64)
    ctl = PromotionController(store, canary_frac=0.5, sdr_gate_db=1.0, slo_gate=True,
                              slo_targets=SLO_TARGETS, window_blocks=WINDOW, min_scores=2,
                              gate_timeout_s=60.0, poll_s=0.01)
    srv = EnhanceServer(max_sessions=max(4, len(configs)), promote=ctl, device=device)
    cand_id = [None]

    def score(j, i, gen):
        # the bad candidate's blocks measure far below the incumbent's
        ctl.offer_score(f"m{j}", i, 2.0 if gen == cand_id[0] else 10.0, gen=gen)

    try:
        addr = srv.start()
        clients = _open_clients(addr, configs, "m")
        pacer = Pacer(clients, clips, bf, score)
        for _ in range(2):                      # incumbent warm-up
            pacer.round()
        cand = store.stage_variables(zeroed(variables), arch=arch, source="check-bad")
        cand_id[0] = cand.gen_id
        while pacer.cursors[0] < n_blocks - 2:
            rec = rollout_record(store, cand.gen_id)
            if rec is not None and rec["state"] == "failed":
                break
            pacer.round()
        for _ in range(2):                      # service after the rollback
            pacer.round()
        _close(clients)
        srv.stop(timeout_s=120)
    finally:
        obs_flight.disable()

    rec = rollout_record(store, cand.gen_id)
    if rec is None or rec["state"] != "failed":
        failures.append(f"rollback: the bad candidate's rollout never resolved to failed "
                        f"within {pacer.cursors[0]} paced blocks "
                        f"(ledger: {None if rec is None else rec['state']})")
    elif "canary_sdr_db" not in str((rec.get("attrs") or {}).get("error", "")):
        failures.append(f"rollback: the ledger's reason {rec.get('attrs')} does not name "
                        "the failing metric canary_sdr_db")
    if store.active() != inc.gen_id:
        failures.append(f"rollback: ACTIVE moved to {store.active()}")
    dumps = sorted(flight_dir.glob("flight-*-demotion.json"))
    if not dumps:
        failures.append("rollback: no demotion flight dump was written")
    elif "canary_sdr_db" not in dumps[-1].read_text():
        failures.append(f"rollback: demotion dump {dumps[-1].name} does not name the metric")
    canaries = 0
    for j, cl in enumerate(clients):
        gens = assert_stream(failures, f"rollback m{j}", pacer.delivered[j], cl.gen_of, clips[j],
                             store, configs[j], device=device)
        if cand.gen_id in gens:
            canaries += 1
            flips = [i for i in range(1, len(gens)) if gens[i] != gens[i - 1]]
            if len(flips) != 2 or gens[0] != inc.gen_id or gens[-1] != inc.gen_id:
                failures.append(f"rollback: canary m{j}'s generation history has {len(flips)} "
                                "transitions, expected incumbent -> candidate -> incumbent")
    if canaries != max(1, round(0.5 * len(clients))):
        failures.append(f"rollback: {canaries} sessions ran the candidate, expected "
                        f"{max(1, round(0.5 * len(clients)))}")
    return {"blocks": pacer.blocks, "rounds": pacer.cursors[0], "candidate": cand.gen_id,
            "incumbent": inc.gen_id, "dumps": len(dumps), "latency_ms": pacer.latency_ms,
            "seconds": pacer.seconds, "store": store,
            "streams": [(pacer.delivered[j], dict(cl.gen_of)) for j, cl in enumerate(clients)]}


def check_promote(failures: list, root, clips, configs, arch: dict, variables: dict, *,
                  device=None) -> dict:
    """Leg 2: a perturbed candidate, written as a checkpoint into the
    controller's watch directory, is staged by the controller, passes the
    gate and is promoted to every session."""
    from disco_tpu_torch.io.atomic import write_bytes_atomic
    from disco_tpu_torch.nn.serialization import packb
    from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
    from disco_tpu_torch.promote import GenerationStore, PromotionController
    from disco_tpu_torch.serve import EnhanceServer

    fresh_gate_metrics()
    root = Path(root)
    store = GenerationStore(root / "store")
    watch = root / "incoming"
    watch.mkdir(parents=True, exist_ok=True)
    inc = _stage_incumbent(store, arch, variables)
    bf = configs[0].block_frames
    n_blocks = min(c.shape[-1] for c in clips) // bf
    ctl = PromotionController(store, canary_frac=0.5, sdr_gate_db=1.0, slo_gate=True,
                              slo_targets=SLO_TARGETS, window_blocks=WINDOW, min_scores=2,
                              gate_timeout_s=60.0, poll_s=0.01, watch_dir=watch)
    srv = EnhanceServer(max_sessions=max(4, len(configs)), promote=ctl, device=device)
    cand_id = [None]

    def score(j, i, gen):
        ctl.offer_score(f"m{j}", i, 10.5 if gen == cand_id[0] else 10.0, gen=gen)

    promotions0 = obs_registry.peek_counter("model_promotions")
    addr = srv.start()
    clients = _open_clients(addr, configs, "m")
    pacer = Pacer(clients, clips, bf, score)
    try:
        for _ in range(2):
            pacer.round()
        # the publish seam of a trainer in another process: a finished
        # checkpoint dropped into the watch dir is staged by the controller
        cand_vars = perturbed(variables, 1e-3)
        write_bytes_atomic(watch / "candidate.msgpack", packb(
            {"params": cand_vars["params"], "batch_stats": cand_vars["batch_stats"]}))
        deadline = time.monotonic() + 30.0
        while len(store.list_ids()) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        staged = [g for g in store.list_ids() if g != inc.gen_id]
        if not staged:
            failures.append("promote: the watch-dir candidate was never staged")
            return {"blocks": pacer.blocks}
        cand_id[0] = staged[0]
        while pacer.cursors[0] < n_blocks - 2:
            rec = rollout_record(store, cand_id[0])
            if rec is not None and rec["state"] == "done":
                break
            pacer.round()
        for _ in range(2):                          # service after the promotion
            pacer.round()
    finally:
        _close(clients)
        srv.stop(timeout_s=120)

    rec = rollout_record(store, cand_id[0])
    if rec is None or rec["state"] != "done":
        failures.append(f"promote: the good candidate's rollout never resolved to done within "
                        f"{pacer.cursors[0]} paced blocks "
                        f"(ledger: {None if rec is None else rec['state']})")
    if store.active() != cand_id[0]:
        failures.append(f"promote: ACTIVE is {store.active()}, expected {cand_id[0]}")
    promoted = obs_registry.peek_counter("model_promotions") - promotions0
    if promoted != 1:
        failures.append(f"promote: model_promotions moved by {promoted}, expected 1")
    snap = obs_registry.snapshot()
    if snap["gauges"].get("weight_generation") != store.get(cand_id[0]).serial:
        failures.append(f"promote: weight_generation gauge is "
                        f"{snap['gauges'].get('weight_generation')}, expected the "
                        f"candidate's serial {store.get(cand_id[0]).serial}")
    hist = snap["histograms"].get("tap_to_promotion_ms") or {}
    if not hist.get("count"):
        failures.append("promote: tap_to_promotion_ms was never observed")
    for j, cl in enumerate(clients):
        gens = assert_stream(failures, f"promote m{j}", pacer.delivered[j], cl.gen_of, clips[j],
                             store, configs[j], device=device,
                             want_gens={inc.gen_id, cand_id[0]})
        if gens and gens[-1] != cand_id[0]:
            failures.append(f"promote: m{j} ended on {gens[-1]}, not the promoted candidate")
    return {"blocks": pacer.blocks, "rounds": pacer.cursors[0], "candidate": cand_id[0],
            "incumbent": inc.gen_id, "latency_ms": pacer.latency_ms,
            "seconds": pacer.seconds, "tap_to_promotion_ms": hist.get("p50"),
            "store": store,
            "streams": [(pacer.delivered[j], dict(cl.gen_of)) for j, cl in enumerate(clients)]}


def temp_litter(*dirs) -> list:
    """Atomic-write temp files left under ``dirs`` (a torn write's trace)."""
    from disco_tpu_torch.io.atomic import TMP_SUFFIX

    return [str(p) for d in dirs if Path(d).is_dir() for p in Path(d).rglob(f"*{TMP_SUFFIX}.*")]


def check_pre_swap(failures: list, root, clips, configs, arch: dict, variables: dict, *,
                   device=None) -> dict:
    """Leg 3: a ``pre_swap`` crash on the dispatch thread mid-rollout (the
    first session swapped and checkpointed, the second not), then a
    restart that rolls the rollout back, resumes the checkpointed session on
    the incumbent and promotes a fresh candidate.  Two sessions."""
    from disco_tpu_torch.promote import GenerationStore, PromotionController, PublishRefused
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, ServeError
    from disco_tpu_torch.serve.session import probe_session_state

    fresh_gate_metrics()
    root = Path(root)
    state_dir = root / "state"
    store = GenerationStore(root / "store")
    inc = _stage_incumbent(store, arch, variables)
    clips, configs = clips[:2], configs[:2]
    bf = configs[0].block_frames
    n_blocks = min(c.shape[-1] for c in clips) // bf

    def controller():
        return PromotionController(store, canary_frac=1.0, sdr_gate_db=None, slo_gate=True,
                                   slo_targets=SLO_TARGETS, window_blocks=2,
                                   gate_timeout_s=60.0, poll_s=0.01)

    srv = EnhanceServer(max_sessions=4, promote=controller(), state_dir=state_dir,
                        device=device)
    addr = srv.start()
    clients = _open_clients(addr, configs, "m")
    pacer = Pacer(clients, clips, bf, timeout_s=30.0)
    for _ in range(2):
        pacer.round()
    # canary_frac=1.0: both sessions get canary requests, applied in one
    # tick; the first checkpoint + swap succeeds, the second hit dies
    chaos.configure("pre_swap", after=2)
    crashes = 0
    cand = store.stage_variables(perturbed(variables, 2e-3), arch=arch, source="check-crashee")
    try:
        while pacer.cursors[0] < n_blocks:
            pacer.round()
        failures.append("pre_swap: the crash never fired")
    except ServeError:
        pass                  # the connection died with the server
    finally:
        chaos.disable()
    try:
        srv.wait(timeout_s=60)
        failures.append("pre_swap: the dispatch thread survived the crash")
    except chaos.ChaosCrash:
        crashes += 1
    for cl in clients:
        cl.shutdown()

    if store.active() != inc.gen_id:
        failures.append(f"pre_swap: ACTIVE moved to {store.active()} through the crash")
    for gen_id in store.list_ids():
        try:
            store.read_variables(gen_id)
        except PublishRefused as e:
            failures.append(f"pre_swap: generation {gen_id} torn after the crash: {e}")
    litter = temp_litter(store.root, state_dir)
    if litter:
        failures.append(f"pre_swap: atomic-write temp litter after the crash: {litter}")
    rec = rollout_record(store, cand.gen_id)
    if rec is None or rec["state"] != "in_flight":
        failures.append(f"pre_swap: the interrupted rollout is "
                        f"{None if rec is None else rec['state']!r}, expected in_flight")
    ckpt = state_dir / "session_m0.state.msgpack"
    if not ckpt.is_file() or not probe_session_state(ckpt):
        failures.append("pre_swap: the swapped canary's boundary checkpoint is missing or "
                        "fails its probe")

    srv2 = EnhanceServer(max_sessions=4, promote=controller(), state_dir=state_dir,
                         device=device)
    addr2 = srv2.start()
    rec = rollout_record(store, cand.gen_id)
    if rec is None or rec["state"] != "failed":
        failures.append(f"pre_swap: the restart left the interrupted rollout "
                        f"{None if rec is None else rec['state']!r}, expected failed")
    cl = ServeClient(addr2)
    cl.open(configs[0], resume="m0")
    k = len(pacer.delivered[0])
    if cl.blocks_done != k:
        failures.append(f"pre_swap: the resume landed at blocks_done={cl.blocks_done}, "
                        f"expected {k}")
        k = cl.blocks_done
    pacer2 = Pacer([cl], clips[:1], bf)
    pacer2.cursors = [k]
    pacer2.delivered = [dict(pacer.delivered[0])]
    try:
        for _ in range(2):
            pacer2.round()
        cand2 = store.stage_variables(perturbed(variables, 3e-3), arch=arch,
                                      source="check-post-crash")
        while pacer2.cursors[0] < n_blocks - 2:
            rec2 = rollout_record(store, cand2.gen_id)
            if rec2 is not None and rec2["state"] == "done":
                break
            pacer2.round()
        for _ in range(2):
            pacer2.round()
    finally:
        _close([cl])
        srv2.stop(timeout_s=120)
    rec2 = rollout_record(store, cand2.gen_id)
    if rec2 is None or rec2["state"] != "done":
        failures.append(f"pre_swap: the post-restart candidate never promoted "
                        f"(ledger: {None if rec2 is None else rec2['state']})")
    if store.active() != cand2.gen_id:
        failures.append(f"pre_swap: post-restart ACTIVE is {store.active()}, "
                        f"expected {cand2.gen_id}")
    pre_gens = {g for c in clients for g in c.gen_of.values()}
    if pre_gens - {inc.gen_id}:
        failures.append(f"pre_swap: pre-crash frames tagged {sorted(pre_gens)}")
    gen_of = dict(clients[0].gen_of)
    gen_of.update(cl.gen_of)
    assert_stream(failures, "pre_swap resumed m0", pacer2.delivered[0], gen_of, clips[0],
                  store, configs[0], device=device, want_gens={inc.gen_id, cand2.gen_id})
    n1 = len(pacer.delivered[1])
    if n1:
        got = np.concatenate([pacer.delivered[1][i] for i in range(n1)], axis=-1)
        ref = gen_oracle(clips[1], [inc.gen_id] * n1, store, configs[1], device=device)
        if not np.array_equal(got, ref):
            failures.append("pre_swap: the unswapped session's pre-crash frames are not "
                            f"bit-exact (max abs diff {np.abs(got - ref).max():g})")
    return {"crashes_injected": crashes, "blocks_before_crash": k,
            "blocks_total": pacer2.cursors[0], "store": store}


def check_controller_crash(failures: list, root, clip, config, arch: dict, variables: dict, *,
                           device=None) -> dict:
    """Leg 4: ``mid_canary`` and ``post_gate`` crashes kill the controller
    thread alone; the server keeps serving bit-exact, and a fresh
    controller's ledger replay rolls each orphaned rollout back."""
    from disco_tpu_torch.promote import GenerationStore, PromotionController
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.serve import EnhanceServer

    root = Path(root)
    store = GenerationStore(root / "store")
    inc = _stage_incumbent(store, arch, variables)
    bf = config.block_frames
    n_blocks = clip.shape[-1] // bf
    ctl = PromotionController(store, canary_frac=1.0, sdr_gate_db=None, slo_gate=False,
                              window_blocks=2, gate_timeout_s=30.0, poll_s=0.01)
    srv = EnhanceServer(max_sessions=4, promote=ctl, device=device)
    addr = srv.start()
    (cl,) = _open_clients(addr, [config], "m")
    pacer = Pacer([cl], [clip], bf)
    crashes = 0
    try:
        pacer.round()
        chaos.configure("mid_canary", after=1)
        cand = store.stage_variables(perturbed(variables, 4e-3), arch=arch,
                                     source="check-mid-canary")
        try:
            while ctl.crashed is None and pacer.cursors[0] < n_blocks - 3:
                pacer.round()
        finally:
            chaos.disable()
        if not isinstance(ctl.crashed, chaos.ChaosCrash):
            failures.append(f"controller: the mid_canary crash never fired "
                            f"(crashed={ctl.crashed!r})")
        else:
            crashes += 1
        for _ in range(3):     # a dead controller degrades, never corrupts
            pacer.round()
    finally:
        _close([cl])
        srv.stop(timeout_s=120)
    assert_stream(failures, "controller-crash m0", pacer.delivered[0], cl.gen_of, clip, store,
                  config, device=device, want_gens={inc.gen_id, cand.gen_id})
    rec = rollout_record(store, cand.gen_id)
    if rec is None or rec["state"] != "in_flight":
        failures.append(f"controller: the orphaned rollout is "
                        f"{None if rec is None else rec['state']!r}, expected in_flight")
    replay_rollouts(store)
    rec = rollout_record(store, cand.gen_id)
    if rec is None or rec["state"] != "failed":
        failures.append("controller: the ledger replay did not roll the mid_canary rollout back")
    if store.active() != inc.gen_id:
        failures.append(f"controller: ACTIVE is {store.active()} after the mid_canary leg")

    # post_gate: the verdict is reached (the zero-traffic timeout demotes),
    # the crash lands before the ledger goes final
    chaos.configure("post_gate", after=1)
    cand2 = store.stage_variables(perturbed(variables, 5e-3), arch=arch,
                                  source="check-post-gate")
    ctl_p = PromotionController(store, canary_frac=1.0, sdr_gate_db=None, slo_gate=False,
                                window_blocks=2, gate_timeout_s=0.2, poll_s=0.01)
    try:
        ctl_p.start()
        deadline = time.monotonic() + 10.0
        while ctl_p.crashed is None and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        chaos.disable()
        ctl_p.stop()
        ctl_p.wait()
    if not isinstance(ctl_p.crashed, chaos.ChaosCrash):
        failures.append(f"controller: the post_gate crash never fired "
                        f"(crashed={ctl_p.crashed!r})")
    else:
        crashes += 1
    rec = rollout_record(store, cand2.gen_id)
    if rec is None or rec["state"] != "in_flight":
        failures.append(f"controller: the post_gate rollout is "
                        f"{None if rec is None else rec['state']!r} at the crash, "
                        "expected in_flight")
    replay_rollouts(store)
    rec = rollout_record(store, cand2.gen_id)
    if rec is None or rec["state"] != "failed":
        failures.append("controller: the ledger replay did not roll the post_gate rollout back")
    return {"crashes_injected": crashes, "blocks": pacer.cursors[0], "store": store}


def replay_rollouts(store) -> None:
    """A fresh controller's start (its ledger replay), then stop."""
    from disco_tpu_torch.promote import PromotionController

    ctl = PromotionController(store, poll_s=0.01)
    ctl.start()
    ctl.stop()
    ctl.wait()


def _zero(counters) -> None:
    for fn, attr in (counters or {}).values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in (counters or {}).items()}


def check_model_sessions(failures: list, root, clips, configs, arch: dict, variables: dict, *,
                         chained: dict | None = None, counters: dict | None = None,
                         device=None) -> dict:
    """Leg 5: the ``masks="model"`` sessions of ``configs`` on ``clips`` and,
    when given, one time-domain client-mask session (``chained``: its
    ``windows``, ``masks`` and ``config``) served together in paced rounds
    by a server with a promotion store (one generation, no rollout) and a
    corpus tap.  ``counters`` ({name: (wrapper, attribute)}, the kernels'
    launch counters) are set to 0 before serving and read after it, then
    again around the oracles' calls; the two counts must agree."""
    import torch

    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.flywheel import CorpusTap, list_shards, probe_shard, read_shard
    from disco_tpu_torch.obs.accounting import device_get_count
    from disco_tpu_torch.promote import GenerationStore, PromotionController
    from disco_tpu_torch.promote.lane import block_masks
    from disco_tpu_torch.serve import EnhanceServer, ServeClient
    from disco_tpu_torch.serve.check import chained_windows

    dev = resolve_device(device)
    root = Path(root)
    store = GenerationStore(root / "store")
    inc = _stage_incumbent(store, arch, variables)
    tap = CorpusTap(root / "tap", records_per_shard=4)
    srv = EnhanceServer(max_sessions=len(configs) + 1, promote=PromotionController(store),
                        tap=tap, device=dev)
    bf = configs[0].block_frames
    n_blocks = min(c.shape[-1] for c in clips) // bf
    addr = srv.start()
    clients = _open_clients(addr, configs, "m")
    pacer = Pacer(clients, clips, bf)
    got_t = []
    try:
        if chained is not None:
            tcl = ServeClient(addr)
            tcl.open(chained["config"], session_id="t0")
        gets0 = device_get_count()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # disco-torch-lint: disable=DL001 -- gate harness: drains the card before the counter window opens, so the window counts only the served blocks
        _zero(counters)
        for i in range(n_blocks):
            if chained is not None and i < len(chained["windows"]):
                tcl.send_block(chained["windows"][i], chained["masks"][i], chained["masks"][i])
            pacer.round()
            if chained is not None and i < len(chained["windows"]):
                got_t.append(tcl.recv_enhanced(i, timeout_s=120.0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # disco-torch-lint: disable=DL001 -- gate harness: closes the served blocks' counter window before it is read
        served = _read(counters)
        gets = device_get_count() - gets0
        ticks = srv.scheduler.ticks_with_work
        if chained is not None:
            tcl.close()
            tcl.shutdown()
        _close(clients)
    finally:
        srv.stop(timeout_s=120)
        tap_stats = tap.close()
    if gets != ticks:
        failures.append(f"model sessions: {gets} batched readbacks for {ticks} ticks")
    _zero(counters)
    for j, cl in enumerate(clients):
        assert_stream(failures, f"model session m{j} ({configs[j].solver})", pacer.delivered[j],
                      cl.gen_of, clips[j], store, configs[j], device=dev,
                      want_gens={inc.gen_id})
    if chained is not None:
        ref = chained_windows(chained["windows"], chained["masks"], device=dev,
                              update_every=chained["config"].update_every,
                              solver=chained["config"].solver)
        if len(got_t) != len(ref) or not all(np.array_equal(g, r) for g, r in zip(got_t, ref)):
            failures.append("model sessions: the time-domain session differs from its windows' "
                            "offline twin")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # disco-torch-lint: disable=DL001 -- gate harness: closes the oracles' counter window before it is read
    oracle = _read(counters)
    if served != oracle:
        failures.append(f"model sessions: served launches {served} != the oracles' {oracle}")
    # the tap: every model block once, its masks the lane's on the oracle's input
    model = store.load(inc.gen_id, device=dev)[0]
    records = [r for p in list_shards(root / "tap") if probe_shard(p) for r in read_shard(p)[1]]
    want = {(f"m{j}", i) for j in range(len(configs)) for i in range(n_blocks)}
    if tap_stats["blocks_dropped"] or {(r["session"], r["seq"]) for r in records} != want \
            or len(records) != len(want):
        failures.append(f"model sessions: the tap holds {len(records)} records "
                        f"({tap_stats['blocks_dropped']} dropped), expected {len(want)}")
    for r in records[:2 * len(configs)]:
        j, i = int(r["session"][1:]), r["seq"]
        m = block_masks(clips[j][..., i * bf:(i + 1) * bf], model, ref_mic=configs[j].ref_mic)
        m = m.cpu().numpy()
        if not (np.array_equal(r["mask_z"], m) and np.array_equal(r["mask_w"], m)):
            failures.append(f"model sessions: tapped masks of {r['session']}:{i} differ from "
                            "the lane's")
    return {"blocks": pacer.blocks + len(got_t), "model_blocks": pacer.blocks,
            "seconds": pacer.seconds, "latency_ms": pacer.latency_ms, "ticks": ticks,
            "batched_readbacks": gets, "served_launches": served, "oracle_launches": oracle,
            "tap": tap_stats, "records": len(records), "incumbent": inc.gen_id, "store": store}


# -- the command ------------------------------------------------------------
def event_log_failures(events: list, crashes: int) -> list:
    """The JAX gate's event-log checks (``disco_tpu/promote/check.py:
    691-720``), letter for letter; ``crashes``: the chaos crashes the legs
    injected."""
    failures = []

    def count(kind, action):
        return sum(1 for e in events if e["kind"] == kind
                   and e["attrs"].get("action") == action)

    if not count("promotion", "staged"):
        failures.append("event log missing the watch-dir staged event")
    if count("promotion", "promoted") < 2:
        failures.append("event log missing promoted events (clean + "
                        "post-crash promotion)")
    if not count("canary", "assign") or not count("canary", "swap"):
        failures.append("event log missing canary assign/swap events")
    if not count("rollback", "begin") or not count("rollback", "done"):
        failures.append("event log missing the demotion begin/done events")
    if count("rollback", "resume") < 1:
        failures.append("event log missing the crash-resume rollback "
                        "event")
    if count("rollback", "crashed") != 2:
        failures.append(
            f"event log carries {count('rollback', 'crashed')} "
            "controller-crash events, expected 2 (mid_canary + post_gate)")
    chaos_events = [e for e in events if e["kind"] == "fault"
                    and e["attrs"].get("fault") == "chaos_crash"]
    if len(chaos_events) != crashes:
        failures.append(
            f"event log carries {len(chaos_events)} chaos_crash events, "
            f"expected {crashes}")
    return failures


def main(argv=None) -> int:
    """Run the promotion gate (the port's ``make promote-check``): legs 1-4
    on ``--device`` (``cuda`` by default; RuntimeError without a GPU) at
    the checks' tiny size, then the event log read back; exit 1 on a
    failure, else print one JSON line."""
    import argparse

    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.promote.check",
                                 description="the live weight-promotion gate")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        obs_log = tmp / "promote_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="promote-check")
            clips = [scene(71 + i, 14, device=dev) for i in range(2)]
            F = clips[0].shape[-2]
            configs = [model_config(F), model_config(F, solver="fused")]
            arch = tiny_arch(F)
            variables = seeded_variables(arch, 1)
            rollback = check_rollback(failures, tmp / "rollback", clips, configs, arch,
                                      variables, device=dev)
            promote = check_promote(failures, tmp / "promote", clips, configs, arch,
                                    variables, device=dev)
            chaos_stats = check_pre_swap(failures, tmp / "pre_swap", clips, configs, arch,
                                         variables, device=dev)
            ctl_stats = check_controller_crash(failures, tmp / "controller", clips[0],
                                               configs[0], arch, variables, device=dev)
            obs.record("counters", **obs.REGISTRY.snapshot())
        events = obs.read_events(obs_log)
        crashes = chaos_stats["crashes_injected"] + ctl_stats["crashes_injected"]
        failures.extend(event_log_failures(events, crashes))
    if failures:
        for f in failures:
            print(f"promote-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({
        "promote_check": "ok",
        "rollback_blocks": rollback["blocks"],
        "promote_blocks": promote["blocks"],
        "canary_window": WINDOW,
        "blocks_before_crash": chaos_stats["blocks_before_crash"],
        "crashes_injected": crashes,
        "device": dev.type,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
