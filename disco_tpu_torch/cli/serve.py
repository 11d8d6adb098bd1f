"""``disco-serve`` — the online enhancement service CLI (the port's; the
counterpart of ``disco_tpu/cli/serve.py``).

Binds the continuous-batching enhancement server
(:mod:`disco_tpu_torch.serve`) on a TCP or unix socket and serves streaming
sessions on ``--device`` until interrupted.  The production seams are the
shared ones from :mod:`disco_tpu_torch.cli.common`:

* ``--preflight`` probes the device before the server claims it for its
  whole lifetime (a wedged device fails in seconds, not after clients
  connect);
* the first SIGINT/SIGTERM triggers a graceful drain
  (:class:`~disco_tpu_torch.runs.interrupt.GracefulInterrupt`): admission
  stops, every queued block is enhanced and delivered, live sessions are
  checkpointed under ``--state-dir`` (atomic msgpack + digest) and closed
  with their resume coordinates — zero truncated or lost frames;
* ``--obs-log`` records the session lifecycle, the
  ``sessions_active``/``queue_depth``/``batch_occupancy`` gauges,
  ``admission_reject``/``session_evicted`` counters and the
  ``serve_block_latency_ms`` histogram, rendered with percentiles by
  ``disco-obs report``;
* ``--fault-spec`` expands a per-session seeded fault plan at admission
  (``disco_tpu_torch.fault``) — degraded-mode beamforming flows through the
  service unchanged;
* ``--tap-dir`` arms the flywheel corpus tap (``disco_tpu_torch.flywheel``):
  every delivered block's (noisy, enhanced, mask) tuple is spooled into
  rotating training shards on a host-only background thread — overflow
  drops-and-counts, serving never backpressures; train on the shards
  with ``disco-train --shards``.
* ``--train`` closes the loop inside ONE process: the co-resident trainer
  (``disco_tpu_torch.flywheel.resident``) consumes the ``--tap-dir`` shards
  as bounded train-step slices interleaved on the dispatch thread,
  publishes generations into ``--promote-dir`` on a cadence, throttles
  under ladder distress and resumes from its ledger after any crash.

No reference counterpart: the reference pipeline is strictly offline
(SURVEY.md §2).
"""
from __future__ import annotations

import argparse

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_fault_args,
    add_obs_log_arg,
    add_preflight_arg,
    add_tap_args,
    obs_session,
    resolve_fault_spec,
    resolve_tap,
    run_preflight,
)
from disco_tpu_torch.device import resolve_device


def build_parser():
    """Build the ``disco-serve`` argument parser."""
    p = argparse.ArgumentParser(
        description="Online TANGO enhancement service: continuous batching "
                    "of concurrent streaming sessions on one device"
    )
    p.add_argument("--host", default="127.0.0.1",
                   help="TCP bind address (loopback by default; the protocol "
                        "is unauthenticated)")
    p.add_argument("--port", type=int, default=7433,
                   help="TCP port (0 = ephemeral, printed at startup)")
    p.add_argument("--unix", default=None, metavar="PATH",
                   help="bind a unix domain socket at PATH instead of TCP")
    p.add_argument("--max-sessions", type=int, default=16,
                   help="admission bound on concurrently live sessions; "
                        "opens past it get a clean 'capacity' error frame")
    p.add_argument("--max-queue-blocks", type=int, default=8,
                   help="per-session input-queue bound (backpressure error "
                        "frames instead of unbounded host memory)")
    p.add_argument("--max-backlog", type=int, default=64,
                   help="per-connection output-frame bound: a client that "
                        "stops reading its socket is evicted once this many "
                        "enhanced frames are backed up")
    p.add_argument("--max-blocks-per-tick", type=int, default=64,
                   help="blocks enhanced per scheduler tick across all "
                        "sessions (bounds one tick's device queue and its "
                        "single batched readback)")
    p.add_argument("--blocks-per-super-tick", type=int, default=1,
                   help="N: dispatch each run of N consecutive full queued "
                        "blocks of a session as ONE scanned on-device "
                        "call (streaming_tango_scan), amortizing a "
                        "readback's fixed cost across N blocks; sub-N "
                        "remainders (and ragged final "
                        "blocks) fall back to the per-block path.  Raises "
                        "per-block latency by up to N-1 blocks of admission "
                        "wait in exchange for ~N× dispatch throughput — "
                        "results stay bit-exact either way (1 = per-block "
                        "serving, the default; must be <= "
                        "--max-blocks-per-tick)")
    p.add_argument("--no-chained-sessions", dest="allow_chained",
                   action="store_false", default=True,
                   help="do not admit chained (domain='time') sessions — "
                        "clients that stream raw audio windows through the "
                        "chained twin (enhance.fused.streaming_clip_fused, "
                        "one readback per window)")
    p.add_argument("--no-overlap-readback", dest="overlap_readback",
                   action="store_false", default=None,
                   help="disable the double-buffered tick state (with "
                        "super-ticks, tick T+1's dispatch normally overlaps "
                        "tick T's batched readback; this forces read-after-"
                        "dispatch within each tick)")
    p.add_argument("--tick-interval", type=float, default=0.002,
                   metavar="SECONDS",
                   help="dispatch-thread sleep between idle ticks")
    p.add_argument("--state-dir", default=None,
                   help="directory for live-session checkpoints: a graceful "
                        "drain saves every open session here (atomic msgpack "
                        "+ sha256 digest) and a later server resumes them "
                        "(client opens with resume=<session id>); parked "
                        "sessions checkpoint here too, so a reattach "
                        "survives even a server death in between")
    p.add_argument("--park-ttl", type=float, default=60.0, metavar="SECONDS",
                   help="how long a session parked by a dropped connection "
                        "waits for its client to reattach (resume token + "
                        "bit-exact replay) before the slot is reclaimed; "
                        "parked sessions count toward --max-sessions")
    p.add_argument("--no-park", dest="park_on_disconnect",
                   action="store_false", default=True,
                   help="evict on connection drop instead of parking "
                        "(pre-survival-layer behavior)")
    p.add_argument("--replay-blocks", type=int, default=64,
                   help="per-session replay-buffer depth: how many delivered "
                        "blocks a reattaching client can have missed and "
                        "still stitch bit-exact")
    p.add_argument("--dispatch-retries", type=int, default=2,
                   help="transport-error retry budget per dispatch/readback "
                        "(seeded-jitter backoff; an exhausted budget "
                        "quarantines the session instead of evicting)")
    p.add_argument("--tick-deadline", type=float, default=None,
                   metavar="SECONDS",
                   help="per-tick wall deadline: a tick that overruns is "
                        "marked suspect, the device is fenced via the "
                        "preflight probe, and the hit feeds the degradation "
                        "ladder (never kills anything — environment "
                        "contract); default: no watchdog")
    p.add_argument("--no-ladder", dest="ladder", action="store_false",
                   default=True,
                   help="disable the degradation ladder (overload control: "
                        "super-tick shrink -> tap off -> shed-to-park, "
                        "driven by queue-wait p95 and deadline hits)")
    p.add_argument("--trace", action="store_true",
                   help="enable causal tracing (disco_tpu_torch.obs.trace): every "
                        "traced block records a span chain (enqueue -> "
                        "dispatch -> readback -> deliver -> tap) into the "
                        "--obs-log, rendered by `disco-obs trace`; strict "
                        "no-op for pre-span clients")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the flight recorder (disco_tpu_torch.obs.flight): a "
                        "bounded in-memory ring of recent events/spans, "
                        "dumped atomically under DIR on quarantine, park, "
                        "watchdog trip, ladder step-up, sentinel trip or "
                        "chaos crash — post-mortems with zero steady-state "
                        "I/O")
    p.add_argument("--flight-capacity", type=int, default=256,
                   help="flight-ring depth per subsystem (entries)")
    p.add_argument("--promote-dir", default=None, metavar="DIR",
                   help="arm live model promotion (disco_tpu_torch.promote): DIR "
                        "holds the digest-addressed weight-generation store, "
                        "the ACTIVE pointer and the rollout ledger; staged "
                        "candidates are canaried onto a fraction of live "
                        "model-mask sessions at an atomic block boundary, "
                        "SDR/SLO-gated, then promoted or rolled back — "
                        "checkpoints dropped into DIR/incoming are staged "
                        "automatically")
    p.add_argument("--canary-frac", type=float, default=0.25,
                   help="fraction of live model-mask sessions canaried onto "
                        "a candidate generation (at least one session when "
                        "any exist; with --promote-dir)")
    p.add_argument("--sdr-gate-db", type=float, default=None, metavar="DB",
                   help="demote a candidate whose mean canary SDR falls more "
                        "than this many dB below the incumbent's over the "
                        "canary window (scores arrive via the promotion "
                        "controller's offer_score API); default: no SDR leg "
                        "— the gate judges SLO targets and window "
                        "completion alone")
    p.add_argument("--no-slo-gate", dest="slo_gate", action="store_false",
                   default=True,
                   help="do not judge the disco-obs slo serve targets in "
                        "the promotion gate (with --promote-dir)")
    p.add_argument("--gen-gc-keep", type=int, default=None, metavar="N",
                   help="bound the generation store after each promotion: "
                        "keep ACTIVE, the rollout's incumbent, every "
                        "generation pinned by a live session or in-flight "
                        "rollout, and the last N by staging order; collect "
                        "the rest (with --promote-dir; default: no GC — "
                        "the store grows without bound)")
    p.add_argument("--train", action="store_true",
                   help="run the co-resident trainer (disco_tpu_torch.flywheel."
                        "resident): train-step slices interleaved on the "
                        "dispatch thread between serve ticks, consuming the "
                        "--tap-dir shards with ledger-verified resume and "
                        "publishing generations into --promote-dir on a "
                        "cadence; ladder-throttled (see "
                        "--train-throttle-rung), crash-restartable from "
                        "--train-dir (requires --tap-dir)")
    p.add_argument("--train-dir", default=None, metavar="DIR",
                   help="the resident trainer's working directory (ledger "
                        "+ rolling atomic checkpoint; default: "
                        "<--tap-dir>/resident)")
    p.add_argument("--train-batch-size", type=int, default=8,
                   help="resident trainer batch size")
    p.add_argument("--train-steps-per-tick", type=int, default=4,
                   help="train-step budget per scheduler tick — the "
                        "interleaving grain against serve dispatch")
    p.add_argument("--train-publish-every", type=int, default=1,
                   metavar="EPOCHS",
                   help="publish cadence in completed epochs (with "
                        "--promote-dir)")
    p.add_argument("--train-publish", choices=["improved", "always"],
                   default="improved",
                   help="publish policy: 'improved' stages only "
                        "best-so-far epochs (the fit() gate), 'always' "
                        "stages every cadence epoch")
    p.add_argument("--train-throttle-rung", type=int, default=1,
                   help="degradation-ladder rung at/above which a tick "
                        "trains ZERO steps (serve overload pauses training "
                        "before it costs serve SLOs)")
    p.add_argument("--train-win-len", type=int, default=None,
                   help="frames per training window (default: the tapped "
                        "block length; must fit inside one block)")
    p.add_argument("--train-max-epochs", type=int, default=None,
                   help="stop training after this many completed epochs "
                        "(default: train as long as the server runs)")
    p.add_argument("--train-recent-shards", type=int, default=None,
                   metavar="N",
                   help="sliding-window corpus: each epoch consumes only "
                        "the newest N tap shards (default: the whole "
                        "directory — epoch cost then grows with uptime)")
    add_tap_args(p)
    add_fault_args(p)
    add_preflight_arg(p, what="the server")
    add_obs_log_arg(p, what="serving")
    add_device_arg(p)
    return p


def main(argv=None):
    """``disco-serve`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    args.fault_spec = resolve_fault_spec(args)
    with obs_session(args, tool="disco-serve"):
        if args.trace:
            from disco_tpu_torch.obs import trace as obs_trace

            obs_trace.enable()
        if args.flight_dir:
            from disco_tpu_torch.obs import flight as obs_flight

            obs_flight.enable(dump_dir=args.flight_dir,
                              capacity=args.flight_capacity)
        preflight = run_preflight(args)
        tap = resolve_tap(args)
        from disco_tpu_torch.runs import GracefulInterrupt
        from disco_tpu_torch.serve import EnhanceServer

        promote = None
        if args.promote_dir:
            from pathlib import Path

            from disco_tpu_torch.promote.controller import PromotionController

            promote = PromotionController(
                args.promote_dir,
                canary_frac=args.canary_frac,
                sdr_gate_db=args.sdr_gate_db,
                slo_gate=args.slo_gate,
                gc_keep_last=args.gen_gc_keep,
                watch_dir=Path(args.promote_dir) / "incoming",
            )
        resident = None
        if args.train:
            if not args.tap_dir:
                raise SystemExit("--train needs --tap-dir (the shard "
                                 "directory the trainer consumes)")
            from pathlib import Path

            from disco_tpu_torch.flywheel.resident import ResidentTrainer

            resident = ResidentTrainer(
                args.tap_dir,
                args.train_dir or Path(args.tap_dir) / "resident",
                promote_dir=args.promote_dir,
                batch_size=args.train_batch_size,
                win_len=args.train_win_len,
                steps_per_tick=args.train_steps_per_tick,
                publish_every=args.train_publish_every,
                publish=args.train_publish,
                throttle_rung=args.train_throttle_rung,
                max_epochs=args.train_max_epochs,
                recent_shards=args.train_recent_shards,
                device=device,
            )
        srv = EnhanceServer(
            host=args.host, port=args.port, unix_path=args.unix,
            max_sessions=args.max_sessions,
            max_queue_blocks=args.max_queue_blocks,
            max_blocks_per_tick=args.max_blocks_per_tick,
            blocks_per_super_tick=args.blocks_per_super_tick,
            overlap_readback=args.overlap_readback,
            allow_chained=args.allow_chained,
            max_backlog=args.max_backlog,
            tick_interval_s=args.tick_interval,
            state_dir=args.state_dir,
            fault_spec=args.fault_spec,
            tap=tap,
            park_on_disconnect=args.park_on_disconnect,
            park_ttl_s=args.park_ttl,
            replay_blocks=args.replay_blocks,
            dispatch_retries=args.dispatch_retries,
            tick_deadline_s=args.tick_deadline,
            ladder=args.ladder,
            promote=promote,
            resident=resident,
            run_info={"preflight": preflight, "state_dir": args.state_dir,
                      "promote_dir": args.promote_dir,
                      "train": bool(args.train),
                      "max_sessions": args.max_sessions,
                      "blocks_per_super_tick": args.blocks_per_super_tick,
                      "allow_chained": args.allow_chained,
                      "park_ttl_s": args.park_ttl,
                      "tick_deadline_s": args.tick_deadline,
                      "ladder": bool(args.ladder),
                      "trace": bool(args.trace),
                      "flight_dir": args.flight_dir,
                      "tap_dir": args.tap_dir},
            device=device,
        )
        try:
            with GracefulInterrupt() as stopped:
                srv.serve_forever()
        finally:
            if tap is not None:
                stats = tap.close()
                print(f"flywheel tap: {stats['shards_written']} shard(s), "
                      f"{stats['blocks_accepted']} block(s) spooled, "
                      f"{stats['blocks_dropped']} dropped under "
                      f"{args.tap_dir}")
            if resident is not None:
                st = resident.stats()
                print(f"resident trainer: {st['epochs_done']} epoch(s), "
                      f"{st['steps_total']} step(s), "
                      f"{st['generations_published']} generation(s) "
                      f"published")
        if stopped():
            n = len(srv.checkpoints)
            where = f" under {args.state_dir}" if n else ""
            print(f"interrupted — drained gracefully; {n} live session(s) "
                  f"checkpointed{where}"
                  + ("; clients resume by reopening with their session id"
                     if n else ""))
        return srv


if __name__ == "__main__":
    main()
