"""The continuous flywheel's endurance legs, as functions of a device (the
port's counterpart of ``disco_tpu/runs/endure.py``).

One campaign runs the whole closed loop in one process: a server
delivering ``masks="model"`` blocks, the corpus tap spooling every
delivered block into shards, the co-resident trainer
(:class:`~disco_tpu_torch.flywheel.ResidentTrainer`) consuming them in
slices of steps on the dispatch thread and publishing a generation each
epoch, and the promotion controller rolling each one out (canary, gate,
promote) — while a component is crash-drilled at its seam each leg:

* ``mid_epoch`` — the trainer dies at an epoch boundary with the train
  pass done and nothing persisted; the restart re-enters the epoch and
  consumes no shard unit twice.
* ``pre_publish`` — the trainer dies with the checkpoint and the epoch
  record durable but the generation not staged; the restart drains the
  interrupted ``publish:<e>`` unit first (``resumed=True``).
* ``between_generations`` — a clean boundary death right after a
  generation lands.
* ``pre_swap`` — the dispatch thread dies mid-rollout; the restart rolls
  the interrupted rollout back from the ledger.
* ``mid_canary`` — the controller thread alone dies mid-gate; serving goes
  on, and a fresh controller's replay rolls the orphan back.

After every leg: each delivered frame bit-exact to the per-generation
oracle (``promote.check.gen_oracle``), every generation digest-verified,
the trainer's rolling checkpoint equal to the digest its latest epoch
record holds, no atomic-write temp litter.  After the campaign: at least
``min_generations`` promotions in a strictly monotone serial lineage ending
at ``ACTIVE``, no shard-epoch unit consumed twice (over the raw ledger),
the tap manifest replayed with no digest drift, and the serve SLO green in
every sample taken while the trainer ran.  A leg's recovery is bounded in
paced rounds, never by the wall clock.

The CPU tests run the campaign at a tiny size; ``chip_smoke.py`` runs legs
at the north-star width with the canonical CRNN.  :func:`main` runs the
whole campaign as a command (``python -m disco_tpu_torch.runs.endure``, on
``cuda`` unless given ``--device cpu``) and reads its event log back with
the JAX gate's checks: generation-published and promoted events reaching
:data:`MIN_GENERATIONS`, the trainer's ``run_resume`` event, and one
``fault`` event with ``fault="chaos_crash"`` (recorded by the chaos
harness, ``runs/chaos.py``) for each crash injected.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

#: the crash schedule of the full campaign: one leg a seam — trainer (the
#: first three), serve dispatch, controller — and a final clean leg
SEAM_LEGS = ("mid_epoch", "pre_publish", "between_generations", "pre_swap", "mid_canary", None)
#: promoted generations the full campaign must reach
MIN_GENERATIONS = 3
#: paced-round bound on a leg's recovery: a fresh promotion must land
#: within this many rounds of the leg's start
REC_ROUNDS = 16
#: the canary window (blocks), the trainer's steps a tick and batch, the
#: tap's records a shard and the trainer's window of newest shards
WINDOW, STEPS_PER_TICK, BATCH_SIZE, RECORDS_PER_SHARD, RECENT_SHARDS = 2, 4, 4, 2, 6
#: SLO targets while training runs: wall-clock latency legs relaxed (cold
#: first blocks poison a cumulative p95 on a slow host), rate legs kept
SLO_TARGETS = {"serve_p95_ms": 60000.0, "queue_wait_p95_ms": 60000.0}


def _done_rollouts(store) -> list:
    """[(t, gen_id)] of rollouts decided done, in promotion order."""
    led = store.rollout_ledger()
    try:
        latest = led.replay()
    finally:
        led.close()
    return sorted((rec["t"], unit.split(":", 1)[1]) for unit, rec in latest.items()
                  if unit.startswith("rollout:") and rec["state"] == "done")


def _raw_done_counts(led_path: Path, prefix: str) -> dict:
    """{unit: number of done appends} over the raw ledger file: the
    no-re-consumed-unit contract counts appends, not the latest state."""
    counts: dict = {}
    if not led_path.is_file():
        return counts
    for line in led_path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("unit", "").startswith(prefix) and rec.get("state") == "done":
            counts[rec["unit"]] = counts.get(rec["unit"], 0) + 1
    return counts


def _trainer_ckpt_intact(failures: list, label: str, train_dir: Path) -> None:
    """The rolling checkpoint must equal the digest of the latest done
    epoch's record (it is saved before the record, and every drilled seam
    lands outside that pair)."""
    from disco_tpu_torch.flywheel.resident import CKPT_NAME, LEDGER_NAME
    from disco_tpu_torch.io.atomic import file_digest
    from disco_tpu_torch.runs.ledger import RunLedger

    led = train_dir / LEDGER_NAME
    if not led.is_file():
        return
    done = [(int(u.split(":", 1)[1]), rec) for u, rec in RunLedger(led).replay().items()
            if u.startswith("epoch:") and rec["state"] == "done"]
    if not done:
        return
    want = (max(done, key=lambda d: d[0])[1].get("attrs") or {}).get("ckpt_digest")
    ckpt = train_dir / CKPT_NAME
    if not ckpt.is_file():
        failures.append(f"{label}: epochs are done but the rolling checkpoint is missing")
    elif want and file_digest(ckpt) != want:
        failures.append(f"{label}: the rolling checkpoint's digest drifted from the latest "
                        "done epoch's record (torn checkpoint)")


def campaign(failures: list, root, clip_for, config, arch: dict, variables: dict, *,
             legs=SEAM_LEGS, min_generations: int = MIN_GENERATIONS,
             batch_size: int = BATCH_SIZE, device=None) -> dict:
    """Run the legs ``legs`` (seams of :data:`SEAM_LEGS`, None = the clean
    final leg that serves until ``min_generations`` promotions) over one
    shared tap, trainer, store and state directory under ``root``.

    ``clip_for(leg)``: the (K, C, F, T) STFT block stream leg ``leg``
    serves (host numpy, made before the campaign); ``config``: the
    ``masks="model"`` session config; ``arch``/``variables``: the
    incumbent's ``build_crnn`` kwargs and flax-layout weights;
    ``batch_size``: the trainer's (its windows are the arch's).  The
    trainer runs without an epoch bound (the JAX gate gives it 3 a leg): at
    these sizes an epoch of the newest shards ends within a few ticks, so a
    bound could be spent before a leg's seam is armed.  Returns the
    campaign's numbers (promotions, crashes, SLO samples, blocks, serving
    seconds and block latencies, train steps, shards written and dropped)."""
    from disco_tpu_torch.flywheel import CorpusTap
    from disco_tpu_torch.flywheel.resident import LEDGER_NAME, ResidentTrainer
    from disco_tpu_torch.promote import GenerationStore, PromotionController, PublishRefused
    from disco_tpu_torch.promote.check import (Pacer, assert_stream, fresh_gate_metrics,
                                               replay_rollouts, temp_litter)
    from disco_tpu_torch.promote.controller import rollout_unit
    from disco_tpu_torch.runs import chaos
    from disco_tpu_torch.runs.ledger import RunLedger
    from disco_tpu_torch.serve import EnhanceServer, ServeClient, ServeError
    from disco_tpu_torch.serve.status import evaluate_slo, status_payload

    fresh_gate_metrics()
    root = Path(root)
    tap_dir, train_dir, state_dir = root / "tap", root / "train", root / "state"
    store = GenerationStore(root / "promote")
    gen0 = store.stage_variables(variables, arch=arch, source="endure-gen0")
    store.set_active(gen0.gen_id)
    bf = config.block_frames
    crashes, slo_breaches, slo_samples = 0, 0, 0
    blocks, serve_s, latency_ms, steps = 0, 0.0, [], 0
    shards_written, blocks_dropped = 0, 0
    interrupted_swap = None     # the pre_swap leg's orphaned rollout
    for leg, seam in enumerate(legs):
        clip = clip_for(leg)
        n_blocks = clip.shape[-1] // bf
        tap = CorpusTap(tap_dir, records_per_shard=RECORDS_PER_SHARD)
        ctl = PromotionController(store, canary_frac=1.0, sdr_gate_db=None, slo_gate=True,
                                  slo_targets=SLO_TARGETS, window_blocks=WINDOW,
                                  gate_timeout_s=60.0, poll_s=0.01)
        tr = ResidentTrainer(tap_dir, train_dir, promote_dir=store.root, arch=arch,
                             batch_size=batch_size, steps_per_tick=STEPS_PER_TICK,
                             publish="always", publish_every=1, recent_shards=RECENT_SHARDS,
                             device=device)
        srv = EnhanceServer(max_sessions=4, tap=tap, promote=ctl, resident=tr,
                            state_dir=state_dir, device=device)
        srv.start()
        if interrupted_swap is not None:
            rec = store.rollout_ledger().replay().get(rollout_unit(interrupted_swap))
            if rec is None or rec["state"] != "failed":
                failures.append(f"leg {leg}: the pre_swap-interrupted rollout is "
                                f"{None if rec is None else rec['state']!r} after the restart, "
                                "expected failed (rolled back from the ledger)")
            interrupted_swap = None
        cl = ServeClient(srv.address)
        cl.open(config, session_id=f"e{leg}")
        pacer = Pacer([cl], [clip], bf, timeout_s=1.0)

        def pace() -> bool:
            """One paced round; False once the server is gone or the clip
            is spent.  The receive polls in 1-s slices watching
            ``srv.crashed``: a dispatch-thread death ends the round in
            about a second."""
            i = pacer.cursors[0]
            if i >= n_blocks or srv.crashed is not None:
                return False
            deadline = time.monotonic() + 120.0
            try:
                pacer.round()
                return True
            except ServeError:
                pass
            while srv.crashed is None and time.monotonic() < deadline:
                try:
                    pacer.delivered[0][i] = cl.recv_enhanced(i, timeout_s=1.0)
                    pacer.cursors[0] = i + 1
                    return True
                except ServeError:
                    continue
            return False

        def sample_slo() -> None:
            nonlocal slo_samples, slo_breaches
            slo = evaluate_slo(status_payload(srv.scheduler), SLO_TARGETS)
            slo_samples += 1
            slo_breaches += 0 if slo["verdict"] == "OK" else 1

        # -- phase 1: recover and promote within the round bound -------------
        before = len(_done_rollouts(store))
        promoted_round = None
        for r in range(REC_ROUNDS):
            if not pace():
                break
            if len(_done_rollouts(store)) > before:
                promoted_round = r
                break
            if tr.stats()["steps_total"] or tr.stats()["epochs_done"]:
                sample_slo()
        if promoted_round is None:
            failures.append(f"leg {leg} ({seam or 'final'}): no promotion within {REC_ROUNDS} "
                            f"paced rounds of the restart (trainer: {tr.stats()}, "
                            f"rollouts: {_done_rollouts(store)}, store: {store.list_ids()})")
        if leg > 0 and legs[leg - 1] == "pre_publish":
            led = RunLedger(train_dir / LEDGER_NAME)
            pubs = [rec for u, rec in led.replay().items()
                    if u.startswith("publish:") and rec["state"] == "done"
                    and (rec.get("attrs") or {}).get("resumed")]
            led.close()
            if not pubs:
                failures.append(f"leg {leg}: no publish unit carries resumed=True after the "
                                "pre_publish crash")
        # -- phase 2: crash the leg's component at its seam -------------------
        if seam is None:
            while len(_done_rollouts(store)) < min_generations and pacer.cursors[0] < n_blocks:
                if not pace():
                    break
                sample_slo()
            if len(_done_rollouts(store)) < min_generations:
                failures.append(f"final leg: {len(_done_rollouts(store))} generations promoted "
                                f"within the clip, need >= {min_generations}")
            cl.close()
            cl.shutdown()
            srv.stop(timeout_s=120)
        elif seam == "mid_canary":
            chaos.configure(seam, after=1)
            try:
                while ctl.crashed is None and pacer.cursors[0] < n_blocks - 3:
                    if not pace():
                        break
            finally:
                chaos.disable()
            if not isinstance(ctl.crashed, chaos.ChaosCrash):
                failures.append(f"leg {leg}: the mid_canary crash never fired "
                                f"(crashed={ctl.crashed!r})")
            else:
                crashes += 1
            orphan = ctl.current_candidate()
            for _ in range(2):        # a dead controller degrades, never corrupts
                pace()
            cl.close()
            cl.shutdown()
            srv.stop(timeout_s=120)
            if orphan is not None:
                replay_rollouts(store)
                rec = store.rollout_ledger().replay().get(rollout_unit(orphan))
                if rec is None or rec["state"] != "failed":
                    failures.append(f"leg {leg}: the ledger replay left the orphaned rollout "
                                    f"{None if rec is None else rec['state']!r}")
        else:
            # dispatch-thread seams: the trainer's three and the server's
            # pre_swap — the whole process 'dies'
            chaos.configure(seam, after=1)
            fired = False
            try:
                while pacer.cursors[0] < n_blocks:
                    if not pace():
                        fired = srv.crashed is not None
                        break
                else:
                    failures.append(f"leg {leg}: the {seam} crash never fired within "
                                    f"{n_blocks} paced rounds")
            finally:
                chaos.disable()
            if fired:
                try:
                    srv.wait(timeout_s=60)
                    failures.append(f"leg {leg}: the dispatch thread survived the {seam} crash")
                except chaos.ChaosCrash:
                    crashes += 1
            else:
                try:
                    srv.stop(timeout_s=120)
                except chaos.ChaosCrash:
                    crashes += 1
            # a real process death takes the controller thread with it
            ctl.stop()
            ctl.wait(timeout_s=30)
            cl.shutdown()
            if seam == "pre_swap":
                interrupted_swap = ctl.current_candidate()
        st = tap.close()
        shards_written += st["shards_written"]
        blocks_dropped += st["blocks_dropped"]
        blocks += pacer.blocks
        serve_s += pacer.seconds
        latency_ms += pacer.latency_ms
        steps += tr.stats()["steps_total"]
        # -- standing asserts after every leg ----------------------------------
        assert_stream(failures, f"leg {leg} ({seam or 'final'})", pacer.delivered[0], cl.gen_of,
                      clip, store, config, device=device)
        for gen_id in store.list_ids():
            try:
                store.read_variables(gen_id)
            except PublishRefused as e:
                failures.append(f"leg {leg}: generation {gen_id} torn: {e}")
        _trainer_ckpt_intact(failures, f"leg {leg}", train_dir)
        litter = temp_litter(store.root, train_dir, tap_dir, state_dir)
        if litter:
            failures.append(f"leg {leg}: atomic-write temp litter: {litter}")
    return {"crashes": crashes, "promoted": _done_rollouts(store), "slo_breaches": slo_breaches,
            "slo_samples": slo_samples, "store": store, "train_dir": train_dir,
            "tap_dir": tap_dir, "blocks": blocks, "serve_seconds": serve_s,
            "latency_ms": latency_ms, "train_steps": steps,
            "shards_written": shards_written, "blocks_dropped": blocks_dropped}


def campaign_end_asserts(failures: list, stats: dict, *,
                         min_generations: int = MIN_GENERATIONS) -> None:
    """The campaign-wide contract over :func:`campaign`'s numbers."""
    from disco_tpu_torch.flywheel import MANIFEST_NAME
    from disco_tpu_torch.flywheel.resident import LEDGER_NAME
    from disco_tpu_torch.runs.ledger import RunLedger

    store, promoted = stats["store"], stats["promoted"]
    if len(promoted) < min_generations:
        failures.append(f"the campaign promoted {len(promoted)} generations, need "
                        f">= {min_generations}")
    serials = [store.get(g).serial for _, g in promoted]
    if serials != sorted(serials) or len(set(serials)) != len(serials):
        failures.append(f"the promotion lineage is not strictly monotone by serial: {serials}")
    if promoted and store.active() != promoted[-1][1]:
        failures.append(f"ACTIVE is {store.active()}, expected the last promoted generation "
                        f"{promoted[-1][1]}")
    dupes = {u: n for u, n in _raw_done_counts(stats["train_dir"] / LEDGER_NAME,
                                                 "shard:").items() if n != 1}
    if dupes:
        failures.append(f"shard units consumed more than once: {dupes}")
    led = RunLedger(stats["tap_dir"] / MANIFEST_NAME)
    _done, requeued = led.verified_done(requeue=False)
    led.close()
    if requeued:
        failures.append(f"the tap manifest re-queued {len(requeued)} shards — a restarted tap "
                        "overwrote or tore a shard")
    if stats["slo_samples"] == 0:
        failures.append("the SLO was never sampled while the trainer ran")
    elif stats["slo_breaches"]:
        failures.append(f"the SLO was breached in {stats['slo_breaches']}/"
                        f"{stats['slo_samples']} samples while training ran")


# -- the command ------------------------------------------------------------
def event_log_failures(events: list, crashes: int, *,
                       min_generations: int = MIN_GENERATIONS) -> list:
    """The JAX gate's event-log checks (``disco_tpu/runs/endure.py:
    518-545``), letter for letter; ``crashes``: the crashes the campaign
    injected."""
    failures = []

    def count(kind, action=None):
        return sum(1 for e in events if e["kind"] == kind
                   and (action is None
                        or e["attrs"].get("action") == action))

    if count("generation", "published") < min_generations:
        failures.append(
            f"event log carries {count('generation', 'published')} "
            f"generation-published events, need >= {min_generations}")
    if count("promotion", "promoted") < min_generations:
        failures.append(
            f"event log carries {count('promotion', 'promoted')} "
            f"promoted events, need >= {min_generations}")
    if count("run_resume") < 1:
        failures.append("event log missing the trainer's run_resume "
                        "event (ledger resume never happened)")
    n_crash_ev = sum(1 for e in events if e["kind"] == "fault"
                     and e["attrs"].get("fault") == "chaos_crash")
    if n_crash_ev != crashes:
        failures.append(f"event log carries {n_crash_ev} chaos_crash "
                        f"events, expected {crashes}")
    return failures


def main(argv=None) -> int:
    """Run the endurance gate (the port's ``make endure-check``): the whole
    campaign of :data:`SEAM_LEGS` on ``--device`` (``cuda`` by default;
    RuntimeError without a GPU) at the checks' tiny size, then the event
    log read back; exit 1 on a failure, else print one JSON line."""
    import argparse

    from disco_tpu_torch import obs
    from disco_tpu_torch.device import resolve_device
    from disco_tpu_torch.promote import check as pc

    ap = argparse.ArgumentParser(prog="python -m disco_tpu_torch.runs.endure",
                                 description="the continuous-flywheel endurance gate")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        obs_log = tmp / "endure_check.jsonl"
        with obs.recording(obs_log):
            obs.write_manifest(tool="endure-check")
            clips = [pc.scene(131 + i, 24, device=dev) for i in range(len(SEAM_LEGS))]
            F = clips[0].shape[-2]
            arch = pc.tiny_arch(F)
            stats = campaign(failures, tmp / "campaign", lambda leg: clips[leg],
                             pc.model_config(F), arch, pc.seeded_variables(arch, 6), device=dev)
            campaign_end_asserts(failures, stats)
            obs.record("counters", **obs.REGISTRY.snapshot())
        events = obs.read_events(obs_log)
        failures.extend(event_log_failures(events, stats["crashes"]))
    if failures:
        for f in failures:
            print(f"endure-check FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({
        "endure_check": "ok",
        "legs": len(SEAM_LEGS),
        "crash_seams": [s for s in SEAM_LEGS if s],
        "crashes_injected": stats["crashes"],
        "min_generations": MIN_GENERATIONS,
        "canary_window": WINDOW,
        "device": dev.type,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
