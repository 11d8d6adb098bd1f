"""Shared CLI conventions (the port's copy of ``disco_tpu/cli/common.py``):
the reference's ``'None'``-string -> None convention (tango.py:682-688,
train.py:63-65), the ``--rirs start count`` pair every corpus-scale CLI
takes for job arrays (SURVEY.md §2.9 DP row), and the production seams
every long-running CLI shares — ``--obs-log`` / ``--ledger`` / ``--resume``
/ ``--preflight`` / ``--fault-spec`` / ``--tap-*`` declarations and their
wiring (:func:`obs_session`, :func:`run_preflight`,
:func:`resolve_fault_spec`, :func:`resolve_tap`).

The port's one addition is ``--device`` (:func:`add_device_arg`): every
CLI resolves it with ``device.resolve_device``, so it runs on ``cuda``
unless given ``--device cpu``, and without a CUDA device it raises — it
never falls back to the CPU.
"""
from __future__ import annotations

import contextlib


def none_str(v):
    """argparse type honoring the reference's 'None' string convention."""
    return None if v in (None, "None", "none") else v


def add_device_arg(parser) -> None:
    """Attach the port's ``--device`` argument."""
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the port runs: 'cuda' (the hand-written kernels; the "
             "default — without a CUDA device the command raises, it never "
             "falls back to the CPU) or 'cpu' (the plain PyTorch versions)",
    )


def add_rirs_arg(parser, default=(1, 1)):
    """Attach the shared ``--rirs`` range argument."""
    parser.add_argument(
        "--rirs", "-r", nargs=2, type=int, default=list(default),
        help="First RIR id and number of RIRs to process (job-array sharding)",
    )


def add_scenario_arg(parser, default="random", choices=("random", "living", "meeting")):
    """Attach the shared ``--scenario`` argument."""
    parser.add_argument(
        "--scenario", "-s", type=str, choices=list(choices), default=default,
        help="Spatial configuration",
    )


def add_noise_arg(parser, default="ssn", choices=("ssn", "fs", "it")):
    """Attach the shared ``--noise`` argument."""
    parser.add_argument("--noise", "-n", type=str, choices=list(choices), default=default)


def snr_value(v: str):
    """SNR bound argparse type: int when integral so snr directory names
    match the reference's '0-6' convention (post_generator.py:66-68)."""
    f = float(v)
    return int(f) if f == int(f) else f


def solver_spec(v: str):
    """argparse type for rank-1 GEVD solver specs — delegates to the port's
    copy of the shared grammar (``disco_tpu_torch.solver_spec``): 'eigh',
    'power[:N]', 'jacobi[:N]', 'jacobi-pallas[:N]' or the fused solve
    family 'fused[:N]' / 'fused-xla[:N]' / 'fused-pallas[:N]'."""
    import argparse

    from disco_tpu_torch.solver_spec import parse_solver_spec

    try:
        parse_solver_spec(v)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return v


# -- the shared production seams (obs / ledger / preflight / faults) ---------
def add_obs_log_arg(parser, what: str = "run") -> None:
    """Attach the shared ``--obs-log`` telemetry arguments."""
    parser.add_argument(
        "--obs-log", default=None,
        help=f"record structured {what} telemetry (manifest, per-stage "
             "events, fence accounting, counters) to this JSONL file; "
             "render with `python -m disco_tpu_torch.cli.obs report PATH`",
    )
    parser.add_argument(
        "--obs-log-max-bytes", type=int, default=None, metavar="N",
        help="rotate the --obs-log file once it exceeds N bytes "
             "(events.jsonl -> events.1.jsonl, ...; `disco-obs report` "
             "spans the segments transparently) — bounds the log of a "
             "week-long serve/soak run; default: no rotation",
    )


def add_trace_dir_arg(parser) -> None:
    """Attach the shared ``--trace-dir`` profiling argument."""
    parser.add_argument(
        "--trace-dir", default=None,
        help="capture a torch.profiler trace into this directory "
             "(trace.json, for chrome://tracing or Perfetto; no-op if the "
             "profiler is unavailable)",
    )


def add_preflight_arg(parser, what: str = "the run") -> None:
    """Attach the shared ``--preflight`` device-probe flag."""
    parser.add_argument(
        "--preflight", type=float, default=0.0, metavar="SECONDS",
        help="run a bounded-deadline device health probe (one tiny fenced "
             "dispatch, utils.resilience.preflight_probe) before "
             f"{what} claims the device; fail fast with a clean error if "
             "the device is wedged (0 = off)",
    )


def add_ledger_arg(parser, unit: str, default_hint: str | None = None) -> None:
    """``--ledger``: the run-ledger JSONL path; ``unit`` names the work unit
    the records track ('clip', 'epoch', 'scene', ...)."""
    parser.add_argument(
        "--ledger", default=None,
        help=f"run-ledger JSONL path (disco_tpu_torch.runs.ledger): record "
             f"per-{unit} state + artifact digests for verified resume"
             + (f".  Default when --resume is set: {default_hint}" if default_hint else ""),
    )


def add_resume_arg(parser, unit: str = "unit", regen: str = "requeued") -> None:
    """Attach the shared ``--resume`` flag (pairs with ``--ledger``)."""
    parser.add_argument(
        "--resume", action="store_true",
        help=f"resume from the ledger: done {unit}s are VERIFIED against "
             f"their artifact digests and skipped; corrupt/missing ones are "
             f"{regen} (truncated files are never trusted).  Graceful "
             "SIGTERM/SIGINT during a run exits resumable with this flag",
    )


def add_fault_args(parser) -> None:
    """Attach the shared ``--fault-spec``/``--fault-seed`` arguments."""
    parser.add_argument(
        "--fault-spec", default=None,
        help="YAML/JSON fault scenario (disco_tpu_torch.fault.FaultSpec "
             "fields: node_dropout, dropout_prob, link_loss_prob, "
             "stale_prob, nan_z, nan_prob, seed): inject seeded faults at "
             "the z-exchange and run degraded-mode beamforming; every fault "
             "lands in the obs event log",
    )
    parser.add_argument(
        "--fault-seed", type=int, default=None,
        help="override the fault spec's seed (ablation sweeps over fault "
             "realizations without editing the file)",
    )


def add_tap_args(parser) -> None:
    """Attach the shared flywheel corpus-tap arguments (``disco-serve``)."""
    parser.add_argument(
        "--tap-dir", default=None,
        help="opt-in flywheel corpus tap (disco_tpu_torch.flywheel): spool "
             "every delivered block's (noisy, enhanced, mask) tuple into "
             "rotating training shards under this directory on a host-only "
             "background thread; overflow drops-and-counts (tap_dropped) — "
             "serving never backpressures on the tap.  Train on the shards "
             "with `disco-train --shards DIR`",
    )
    parser.add_argument(
        "--tap-records-per-shard", type=int, default=64,
        help="blocks per rotated shard file (atomic write + sha256 "
             "manifest record each rotation)",
    )
    parser.add_argument(
        "--tap-queue-blocks", type=int, default=256,
        help="bound on spooled-but-unwritten tap blocks; offers past it "
             "are dropped and counted, never queued unboundedly",
    )


def resolve_tap(args):
    """Build the :class:`~disco_tpu_torch.flywheel.CorpusTap` described by
    the ``--tap-*`` arguments (None without ``--tap-dir``).  The caller owns
    the tap's lifecycle and must ``close()`` it after the server drains."""
    if getattr(args, "tap_dir", None) is None:
        return None
    from disco_tpu_torch.flywheel import CorpusTap

    return CorpusTap(
        args.tap_dir,
        max_queue_blocks=args.tap_queue_blocks,
        records_per_shard=args.tap_records_per_shard,
    )


def resolve_fault_spec(args):
    """Load ``--fault-spec`` (with the optional ``--fault-seed`` override)
    into a FaultSpec, converting file/format errors into clean CLI errors."""
    if args.fault_spec is None:
        if args.fault_seed is not None:
            raise SystemExit("--fault-seed needs --fault-spec")
        return None
    import dataclasses

    from disco_tpu_torch.fault import load_fault_spec

    try:
        spec = load_fault_spec(args.fault_spec)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--fault-spec {args.fault_spec}: {e}")
    if args.fault_seed is not None:
        spec = dataclasses.replace(spec, seed=args.fault_seed)
    return spec


def run_preflight(args):
    """Execute the ``--preflight`` probe (no-op at the 0.0 default) on the
    command's ``--device``.  Returns the probe's result dict (it rides the
    ``run_start`` event), or exits with a clean error naming the failure —
    never a raw traceback."""
    if not getattr(args, "preflight", 0):
        return None
    from disco_tpu_torch.utils.resilience import PreflightFailed, preflight_probe

    try:
        return preflight_probe(deadline_s=args.preflight, device=args.device)
    except PreflightFailed as e:
        raise SystemExit(f"preflight: {e}")


@contextlib.contextmanager
def obs_session(args, tool: str):
    """The ``--obs-log`` wiring every production CLI shares: enable the
    recorder and write the run manifest (the full non-None arg vector as
    config) on entry; flush a final counters snapshot and release the
    recorder on exit, crash or not.  No-op without ``--obs-log``."""
    obs_log = getattr(args, "obs_log", None)
    if obs_log:
        from disco_tpu_torch import obs

        obs.enable(obs_log,
                   max_bytes=getattr(args, "obs_log_max_bytes", None))
        obs.write_manifest(
            config={k: v for k, v in vars(args).items() if v is not None},
            tool=tool,
        )
    try:
        yield
    finally:
        if obs_log:
            from disco_tpu_torch import obs

            obs.record("counters", **obs.REGISTRY.snapshot())
            obs.disable()
