"""TANGO enhancement CLI — the flagship per-RIR entry point (the port's
``disco-tango``; counterpart of ``disco_tpu/cli/tango.py``).

Mirrors reference ``speech_enhancement/tango.py:644-692`` (flags
--vad_type/--sav_dir/--rir/--scenario/--noise/--mask_z/--mods/--zsigs and
the 'None'-string convention).  ``--rir`` runs ``enhance.driver.enhance_rir``
(staged, ``--chained`` or ``--streaming``), ``--rirs`` the corpus engine
``enhance_rirs_batched``, each on ``--device``.

The JAX parser's flags all parse.  ``--mesh BATCH NODE`` runs the corpus
engine on a ``(batch, node)`` mesh of ``torch.distributed`` ranks
(``disco_tpu_torch.parallel``): one rank in this process (``--mesh 1 1``),
or several launched by ``torchrun --nproc_per_node N``, which
``distributed_init`` picks up; it refuses what the JAX CLI refuses, with
its messages.  ``--compile-cache DIR|off`` chooses the kernel build cache
in both modes (``disco_tpu_torch.utils.compile_cache``): the root the
kernel library is built under by ``nvcc`` and loaded from by later runs;
``off`` builds it into a per-process temporary directory.  ``--cov_impl
xla`` and ``--stft_impl xla`` name the plain versions, which never run on
a CUDA tensor (``ops.resolve``): on the card they exit naming the flag.
"""
from __future__ import annotations

import argparse

from disco_tpu_torch.cli.common import (
    add_device_arg,
    add_fault_args,
    add_ledger_arg,
    add_obs_log_arg,
    add_preflight_arg,
    add_resume_arg,
    add_trace_dir_arg,
    none_str,
    obs_session,
    resolve_fault_spec,
    run_preflight,
    snr_value,
    solver_spec,
)
from disco_tpu_torch.device import resolve_device

_POLICIES = ["None", "local", "distant", "compressed", "use_oracle_refs", "use_oracle_zs"]


def build_parser():
    """Build the ``disco-tango`` argument parser."""
    p = argparse.ArgumentParser(description="Two-step distributed GEVD-MWF (TANGO) enhancement")
    p.add_argument("--vad_type", "-vt", nargs=2, default=["irm1", "irm1"],
                   help="mask type per step: irm1/ibm1/iam/... (tango.py:189-225)")
    p.add_argument("--sav_dir", "-sd", default="tango", help="results subfolder")
    p.add_argument("--rir", type=int, default=None, help="RIR id of the sample to filter")
    p.add_argument("--rirs", "-r", nargs=2, type=int, default=None,
                   help="first RIR id and count: batched corpus mode (clips batched a launch)")
    p.add_argument("--batch_size", type=int, default=16, help="clips per launch in --rirs mode")
    p.add_argument("--scenario", "-scene", choices=["living", "meeting", "random"], default="living")
    p.add_argument("--noise", choices=["ssn", "it", "fs"], default="fs")
    p.add_argument("--mask_z", "-mz", choices=_POLICIES, default="local",
                   help="mask applied to the exchanged z's in step 2")
    p.add_argument("--mods", "-m", nargs=2, default=["None", "None"],
                   help="paths to trained CRNN checkpoints per step, or None for oracle")
    p.add_argument("--zsigs", "-zs", nargs="+", default=["zs_hat"])
    p.add_argument("--archi", choices=["crnn", "rnn"], default="crnn",
                   help="architecture of the checkpoints passed via --mods")
    p.add_argument("--dataset", default="dataset/disco/", help="corpus root")
    p.add_argument("--snr", nargs=2, type=snr_value, default=[0, 6])
    p.add_argument("--out_root", default=None, help="override results directory")
    p.add_argument("--streaming", action="store_true",
                   help="frame-recursive online pipeline (smoothed covariances)")
    p.add_argument("--bucket", type=int, default=None,
                   help="round clip lengths up to this many samples so ragged "
                        "corpora batch together (0 = off; ~2 dB boundary "
                        "effect; default: off for --rir, 8192 for --rirs)")
    p.add_argument("--config", default=None,
                   help="JSON or YAML config file (config.save_config layout); "
                        "its enhance.solver becomes the --solver default")
    p.add_argument("--solver", type=solver_spec, default=None,
                   help="rank-1 GEVD solver: 'eigh' (batched eigendecomposition), "
                        "'power'/'power:N' (dominant-pair power iteration), "
                        "'jacobi[:N]' or 'jacobi-pallas[:N]' (cyclic Jacobi; "
                        "'jacobi-pallas' is the eigensolver kernel on the card, "
                        "'jacobi' its plain version, host only), or "
                        "'fused[:N]'/'fused-xla[:N]'/'fused-pallas[:N]' (the "
                        "whole cov->whiten->Jacobi->filter solve in one kernel "
                        "launch, ops/mwf_ops.py; 'fused-xla' is its plain "
                        "version, host only).  Default: 'power' offline / "
                        "'eigh' with --streaming / 'fused' with --chained")
    p.add_argument("--cov_impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="masked-covariance stage: 'auto' or 'pallas' (the "
                        "covariance kernel on the card, its plain version on "
                        "the host) or 'xla' (the plain version, host only)")
    p.add_argument("--stft_impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="fused spec+magnitude STFT stage: 'auto' or 'pallas' "
                        "(the STFT kernel on the card, its plain version on "
                        "the host) or 'xla' (the plain version, host only)")
    p.add_argument("--chained", action="store_true",
                   help="run each clip (or each --rirs chunk) as ONE call — "
                        "STFT, oracle masks, both MWF steps and the scoring "
                        "ISTFTs (enhance.fused.tango_clip_fused) with one "
                        "copy to the host.  Offline oracle lane only (rejects "
                        "--streaming/--mods/--mesh/fault flags); the solver "
                        "default becomes 'fused'")
    p.add_argument("--precision", choices=["f32", "bf16"], default="f32",
                   help="compute lane of the STFT/covariance/solve kernels: "
                        "'f32' (default) or 'bf16' (bf16 operands with f32 "
                        "accumulators; the rounding points of ops/resolve.py)")
    p.add_argument("--mesh", nargs=2, type=int, default=None, metavar=("BATCH", "NODE"),
                   help="--rirs mode only: run each chunk on a (BATCH, NODE) "
                        "mesh of torch.distributed ranks (clips over BATCH, "
                        "nodes over NODE; launch BATCH x NODE > 1 ranks with "
                        "torchrun); BATCH must divide --batch_size")
    add_fault_args(p)
    add_ledger_arg(p, "clip", default_hint="<out_root or results>/"
                   "ledger_<scenario>_<sav_dir>_<noise>.jsonl")
    add_resume_arg(p, "clip")
    p.add_argument("--no-pipeline", action="store_true",
                   help="--rirs mode: disable the overlapped corpus engine "
                        "(disco_tpu_torch.enhance.pipeline — background chunk "
                        "prefetch, one copy to the host per chunk) and fall "
                        "back to the strictly sequential load→dispatch→score "
                        "loop; outputs are byte-identical either way")
    p.add_argument("--compile-cache", default=None, metavar="DIR|off",
                   help="kernel build cache directory "
                        "(disco_tpu_torch.utils.compile_cache): the kernel "
                        "library is built there by nvcc once and loaded by "
                        "later runs/resumes; 'off' builds it into a "
                        "per-process temporary directory.  Default: "
                        "$DISCO_TORCH_COMPILE_CACHE, else build/kernels/ at "
                        "the root of the checkout")
    add_preflight_arg(p, what="the run")
    add_obs_log_arg(p)
    add_trace_dir_arg(p)
    add_device_arg(p)
    return p


def _load_model(path, archi: str = "crnn", n_ch: int = 1, device=None):
    """The CRNN (or RNN) module of a checkpoint of either package on
    ``device``, in eval mode; None for the 'None' convention."""
    if none_str(path) is None:
        return None
    from disco_tpu_torch.nn.crnn import build_crnn, build_rnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, load_params_for_inference

    model = (build_crnn if archi == "crnn" else build_rnn)(n_ch=n_ch).to(resolve_device(device))
    state = create_train_state(model, build_optimizer(model))
    load_params_for_inference(path, state)
    return model.eval()


def resolve_solver(args):
    """Solver precedence: explicit --solver > enhance.solver from --config
    (only when the key is literally present in the file) > None, deferring
    to the driver's mode-aware default ('power' offline / 'eigh' streaming
    / 'fused' chained).  The raw file is inspected rather than the
    default-filled EnhanceConfig: reading the dataclass field would silently
    turn "no solver in the file" into an explicit 'power', overriding the
    streaming default the help text promises.  The file is JSON or YAML
    (``config.read_config_file``)."""
    if args.solver is not None:
        return args.solver
    if not args.config:
        return None
    import dataclasses
    import sys

    from disco_tpu_torch.config import EnhanceConfig, config_from_dict, read_config_file

    # Parse ONCE: the same dict is both validated (config_from_dict) and
    # inspected for literal key presence, so the two views can never
    # diverge.  A present-but-empty section ('enhance:\n') parses as None;
    # normalize it to {} so validation sees "section with all defaults".
    raw = read_config_file(args.config) or {}
    if not isinstance(raw, dict):
        raise SystemExit(
            f"--config {args.config}: expected a mapping of config sections "
            f"at the top level, got {type(raw).__name__}"
        )
    raw = {k: ({} if v is None and k != "root" else v) for k, v in raw.items()}
    raw_enh = raw.get("enhance", {})
    if not isinstance(raw_enh, dict):
        raise SystemExit(
            f"--config {args.config}: 'enhance' must be a mapping of fields "
            f"(e.g. 'enhance:\\n  solver: eigh'), got {raw_enh!r}"
        )
    cfg_enh = config_from_dict(raw).enhance  # full validation of the file
    # Only enhance.solver is consumed here; silently honoring part of a
    # DiscoConfig file would be a trap, so name what is being ignored.
    ignored = [
        f.name
        for f in dataclasses.fields(EnhanceConfig)
        if f.name != "solver"
        and getattr(cfg_enh, f.name) != getattr(EnhanceConfig(), f.name)
    ]
    if ignored:
        print(
            f"warning: --config {args.config}: only enhance.solver is used by "
            f"this CLI; ignoring non-default enhance fields {ignored}",
            file=sys.stderr,
        )
    if "solver" not in raw_enh:
        return None
    raw_solver = raw_enh["solver"]
    if not isinstance(raw_solver, str):
        raise SystemExit(
            f"--config {args.config}: enhance.solver: expected a solver spec "
            f"string ('eigh' | 'power[:N]' | 'jacobi[:N]' | ...), got {raw_solver!r}"
        )
    try:
        return solver_spec(raw_solver)
    except argparse.ArgumentTypeError as e:
        raise SystemExit(f"--config {args.config}: enhance.solver: {e}")


def resolve_ledger(args):
    """--ledger / --resume resolution: an explicit path wins; --resume
    without a path lands at a deterministic default under the results root
    so interrupted-then-resumed invocations agree on the file."""
    if args.ledger is None and not args.resume:
        return None
    if args.ledger is not None:
        return args.ledger
    from pathlib import Path

    return str(
        Path(args.out_root or "results")
        / f"ledger_{args.scenario}_{args.sav_dir}_{args.noise}.jsonl"
    )


def check_impl_flags(args, device) -> None:
    """``--cov_impl xla`` / ``--stft_impl xla`` on the card: a clean exit
    naming the flag (the plain versions never run on a CUDA tensor)."""
    if device.type != "cuda":
        return
    for flag in ("cov_impl", "stft_impl"):
        if getattr(args, flag) == "xla":
            raise SystemExit(
                f"--{flag} xla selects the plain version, which never runs on a CUDA "
                "tensor; use 'auto' or 'pallas' (the hand-written kernel), or --device cpu"
            )


def check_mesh(args, device) -> None:
    """``--mesh BATCH NODE``: join the ranks' world when torchrun started
    this process, then the JAX CLI's checks with its messages (the
    world's ranks are the devices)."""
    from disco_tpu_torch.parallel import distributed_init
    from disco_tpu_torch.parallel.multihost import world_size

    distributed_init(device=device.type)
    n_batch, n_node = args.mesh
    n_dev = world_size()
    if n_batch * n_node > n_dev:
        raise SystemExit(
            f"--mesh {n_batch} {n_node} needs {n_batch * n_node} devices; "
            f"{n_dev} available"
        )
    if args.batch_size % n_batch:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by the mesh "
            f"batch axis ({n_batch})"
        )
    if 4 % n_node:  # the DISCO array has 4 nodes (tango.py:30)
        raise SystemExit(f"the 4-node array is not divisible over {n_node} mesh nodes")
    if n_batch * n_node < n_dev:
        raise SystemExit(f"--mesh {n_batch} {n_node} names {n_batch * n_node} ranks; the "
                         f"torch.distributed world has {n_dev}")


def main(argv=None):
    """``disco-tango`` console entry point."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    args.solver = resolve_solver(args)
    if args.rir is None and args.rirs is None:
        raise SystemExit("one of --rir or --rirs is required")
    if args.mesh is not None and args.rirs is None:
        raise SystemExit("--mesh needs batched corpus mode (--rirs)")
    if args.mesh is not None:
        check_mesh(args, device)
    check_impl_flags(args, device)
    args.fault_spec = resolve_fault_spec(args)
    args.ledger = resolve_ledger(args)
    policy = none_str(args.mask_z) or "none"

    with obs_session(args, tool="disco-tango"):
        preflight = run_preflight(args)
        from disco_tpu_torch import obs as _obs

        _obs.record("run_start", stage="enhance", tool="disco-tango",
                    preflight=preflight, ledger=args.ledger, resume=args.resume)
        from disco_tpu_torch.runs import GracefulInterrupt

        with GracefulInterrupt() as stopped:
            out = _run(args, policy, device)
        if stopped():
            print("interrupted — run is resumable: rerun with --resume "
                  f"{'--ledger ' + args.ledger if args.ledger else ''}".rstrip())
        return out


def _run(args, policy, device):
    import contextlib

    from disco_tpu_torch.obs.metrics import trace_to

    trace_cm = trace_to(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    compile_cache = (False if args.compile_cache in ("off", "0")
                     else args.compile_cache)
    # step-2 model consumes [y_ref ‖ z exchanges]: 1 + (K-1)*len(zsigs)
    # channels (reference nodes_nbs, tango.py:492-494)
    n_ch2 = 1 + 3 * len(args.zsigs)
    models = (
        _load_model(args.mods[0], archi=args.archi, device=device),
        _load_model(args.mods[1], archi=args.archi, n_ch=n_ch2, device=device),
    )
    z_sigs = args.zsigs[0] if len(args.zsigs) == 1 else "zs&zn"
    if args.rirs is not None:
        if args.streaming:
            raise SystemExit("--streaming needs per-RIR mode (--rir)")
        from disco_tpu_torch.enhance.driver import enhance_rirs_batched
        from disco_tpu_torch.parallel import make_mesh, single_rank_world

        with trace_cm, (single_rank_world(device.type) if args.mesh is not None
                        else contextlib.nullcontext()):
            mesh = None
            if args.mesh is not None:
                mesh = make_mesh(n_batch=args.mesh[0], n_node=args.mesh[1],
                                 device=device.type)
            results = enhance_rirs_batched(
                args.dataset, args.scenario, range(args.rirs[0], args.rirs[0] + args.rirs[1]),
                args.noise, save_dir=args.sav_dir, snr_range=tuple(args.snr),
                mask_type=args.vad_type[0], policy=policy, out_root=args.out_root,
                bucket=8192 if args.bucket is None else args.bucket,
                max_batch=args.batch_size, models=models, z_sigs=z_sigs,
                solver=args.solver, cov_impl=args.cov_impl,
                stft_impl=args.stft_impl, precision=args.precision,
                chained=args.chained,
                fault_spec=args.fault_spec,
                ledger=args.ledger, resume=args.resume,
                pipeline=not args.no_pipeline, device=device, mesh=mesh,
                compile_cache=compile_cache,
            )
        print(f"{len(results)} RIRs enhanced (batched)")
        return results
    # --compile-cache applies to BOTH modes: the per-RIR path launches the
    # same kernels (disco_tpu/cli/tango.py:327-331)
    from disco_tpu_torch.enhance.driver import enhance_rir
    from disco_tpu_torch.utils import compile_cache as _compile_cache

    _compile_cache.ensure_enabled(compile_cache)
    with trace_cm:
        results = enhance_rir(
            args.dataset, args.scenario, args.rir, args.noise,
            save_dir=args.sav_dir, snr_range=tuple(args.snr),
            mask_type=args.vad_type[0], policy=policy, models=models,
            out_root=args.out_root, streaming=args.streaming, bucket=args.bucket or 0,
            z_sigs=z_sigs, solver=args.solver, cov_impl=args.cov_impl,
            stft_impl=args.stft_impl, precision=args.precision,
            chained=args.chained,
            fault_spec=args.fault_spec, ledger=args.ledger, device=device,
        )
    if results is None:
        print(f"Conf {args.rir} with {args.noise} noise already processed")
    else:
        print(f"{args.rir} done")
    return results


if __name__ == "__main__":
    main()
