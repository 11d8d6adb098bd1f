"""The thread-role registry: who runs on which thread, by declaration (the
port's copy of ``disco_tpu/analysis/race/roles.py``, declared for the
port's own spawn sites).

A **role** names one kind of thread the port deliberately runs, rooted at
the exact functions those threads execute (entry points are
``module:dotted.qualname`` — class and enclosing-function names dotted in,
no ``<locals>`` marker).  The race analyzer builds the call graph from
these roots; every ``threading.Thread(target=...)``, ``threading.Timer``,
``executor.submit``/``executor.map``, ``run_in_executor`` and
``signal.signal`` site in the port must resolve to a registered entry
point or is itself a finding (DR001) — an unregistered thread is an
unreviewed concurrency surface.

Role policy is part of the declaration:

* ``torch_ok`` — only the roles declared so may reach torch-touching code
  (DR002).  The JAX package's contract was one chip-claiming thread; the
  port's is one thread that queues work on the card: a kernel launched
  from a second thread lands on the same device and default stream in an
  order no one chose, and ``chip_smoke.py``'s launch counters and the
  serve gate's one-readback-a-tick check stop describing one tick.
  only ``main`` and ``dispatch`` are ``torch_ok`` (the JAX package also
  lets its scoring workers enter jax; the port's score host arrays only);
* ``flag_only`` — the ``signal_handler`` role runs at an arbitrary
  bytecode boundary of the main thread, possibly INSIDE a non-reentrant
  lock of the interrupted frame; its reachable code may only set flags
  (no lock acquisition, no obs emission, no I/O — checked structurally by
  DR003).

``chip_smoke.py`` phase 3o holds the running threads to this table too:
every live thread started by port code must have a target in it, and each
kernel launch must come from a ``torch_ok`` role (the runtime twin of
DR001/DR002).

No reference counterpart: the reference repo is single-threaded end to
end (SURVEY §0).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Role:
    """One declared thread role (module docstring)."""

    name: str
    #: ``module:dotted.qualname`` roots the threads of this role execute
    entry_points: tuple
    #: may code reachable from this role enter torch? (one-device-thread contract)
    torch_ok: bool = False
    #: restricted to the flag-set allowlist (signal handlers)
    flag_only: bool = False
    summary: str = ""


#: name -> Role.  Every spawn site in the port resolves into this table.
ROLES = {
    r.name: r
    for r in (
        Role(
            "main",
            entry_points=(
                # operational entry points that run on the caller's thread
                # CONCURRENTLY with the worker roles below: the card
                # script, the gate mains, the server/tap/prefetcher
                # lifecycle methods an embedding caller drives.
                "chip_smoke:main",
                "disco_tpu_torch.serve.server:EnhanceServer.start",
                "disco_tpu_torch.serve.server:EnhanceServer.stop",
                "disco_tpu_torch.serve.server:EnhanceServer.wait",
                "disco_tpu_torch.serve.server:EnhanceServer.serve_forever",
                "disco_tpu_torch.flywheel.tap:CorpusTap.start",
                "disco_tpu_torch.flywheel.tap:CorpusTap.close",
                "disco_tpu_torch.flywheel.tap:CorpusTap.stats",
                "disco_tpu_torch.enhance.pipeline:ChunkPrefetcher.__iter__",
                "disco_tpu_torch.enhance.pipeline:ChunkPrefetcher.close",
                "disco_tpu_torch.utils.resilience:DispatchDeadline.__enter__",
                "disco_tpu_torch.utils.resilience:DispatchDeadline.__exit__",
                "disco_tpu_torch.runs.interrupt:GracefulInterrupt.__enter__",
                "disco_tpu_torch.runs.interrupt:GracefulInterrupt.__exit__",
                "disco_tpu_torch.runs.interrupt:request_stop",
                "disco_tpu_torch.runs.interrupt:stop_requested",
                "disco_tpu_torch.enhance.driver:enhance_rirs_batched",
                "disco_tpu_torch.flywheel.check:main",
                "disco_tpu_torch.promote.check:main",
                "disco_tpu_torch.obs.scope:main",
                "disco_tpu_torch.runs.soak:main",
                "disco_tpu_torch.runs.endure:main",
            ),
            torch_ok=True,
            summary="the process main thread: the card script, gate mains "
                    "+ the lifecycle methods embedding callers drive",
        ),
        Role(
            "dispatch",
            entry_points=("disco_tpu_torch.serve.server:EnhanceServer._dispatch_loop",),
            torch_ok=True,
            summary="the single device thread of the serve stack: every "
                    "tick's kernels, its one readback, the co-resident "
                    "trainer's steps (the ONLY non-main thread allowed "
                    "to enter torch)",
        ),
        Role(
            "asyncio_io",
            entry_points=(
                "disco_tpu_torch.serve.server:EnhanceServer.start._run",
                "disco_tpu_torch.serve.server:EnhanceServer._handle",
            ),
            summary="the serve event-loop thread: socket framing only, "
                    "host-side, never torch",
        ),
        Role(
            "prefetch_loader",
            entry_points=("disco_tpu_torch.enhance.pipeline:ChunkPrefetcher._run",),
            summary="the corpus driver's chunk loader: disk + numpy work "
                    "overlapping device compute, never torch",
        ),
        Role(
            "device_feeder",
            entry_points=("disco_tpu_torch.device:prefetch_to_device.feeder",),
            # NOT torch_ok: the feeder only drains the host iterator into
            # the host queue; the pinned copies to the card and their
            # events run on the consumer's thread (prefetch_to_device's
            # send, a generator step of the caller), so the analyzer finds
            # no torch call here
            summary="prefetch_to_device's feeder: drains the host batch "
                    "iterator into the host queue; the copies to the card "
                    "run on the consumer's side stream — it launches no "
                    "kernel and calls no torch",
        ),
        Role(
            "tap_writer",
            entry_points=("disco_tpu_torch.flywheel.tap:CorpusTap._run",),
            summary="the corpus-tap shard writer: msgpack + io.atomic, "
                    "never torch (DL005 pins the module; DR002 pins the role)",
        ),
        Role(
            "watchdog_timer",
            entry_points=("disco_tpu_torch.utils.resilience:DispatchDeadline._fire",),
            summary="watchdog timer threads: host-only telemetry, never "
                    "interrupt or kill anything",
        ),
        Role(
            "signal_handler",
            entry_points=("disco_tpu_torch.runs.interrupt:GracefulInterrupt._handler",),
            flag_only=True,
            summary="SIGTERM/SIGINT handlers: flag-set allowlist only "
                    "(runs inside an arbitrary interrupted frame)",
        ),
        Role(
            "promote_controller",
            entry_points=(
                "disco_tpu_torch.promote.controller:PromotionController._run",
            ),
            # NOT torch_ok by design: the controller only REQUESTS swaps
            # (pending map) and reads ledgers/stores; the dispatch thread
            # loads weights onto the card and executes every swap
            summary="the promotion-rollout controller thread: watch-dir "
                    "scans, canary bookkeeping, gate verdicts, ledger "
                    "writes — never torch",
        ),
        Role(
            "client_reader",
            entry_points=("disco_tpu_torch.serve.client:ServeClient._read_loop",),
            summary="the numpy-only serve client's socket reader thread",
        ),
        Role(
            "harness_worker",
            entry_points=(
                "disco_tpu_torch.serve.check:_run_clients.run",
                "disco_tpu_torch.runs.soak:_client_worker",
            ),
            summary="gate-harness loopback clients: concurrent numpy-only "
                    "ServeClient drivers, never torch",
        ),
        Role(
            "score_worker",
            entry_points=(
                "disco_tpu_torch.enhance.driver:enhance_rirs_batched.score_unit",
            ),
            # NOT torch_ok, tighter than the JAX package's jax_ok=True: the
            # port reads every clip's scoring payload back on the caller
            # (_clip_host / pipeline.fetch_chunk_host, one to_host each),
            # on the sequential path too, so the workers score host numpy
            # only and the analyzer finds no torch call they reach
            summary="corpus scoring pool workers: metrics and the results "
                    "tree from host arrays read back on the caller, never "
                    "torch",
        ),
        Role(
            "loader_pool",
            entry_points=(
                "disco_tpu_torch.io.fastwav:_read_mono",
                "disco_tpu_torch.nn.fastload:_load_one",
            ),
            summary="reader pools of io.fastwav / nn.fastload: wav decode "
                    "and feature-file reads into host numpy buffers, "
                    "never torch",
        ),
    )
}


#: Explicit dynamic-dispatch fallbacks: call sites the module-qualified
#: resolver cannot see through (callables stored on ``self``, callback
#: parameters) mapped to their real targets BY DECLARATION, so the call
#: graph stays complete without guessing.  Key: ``caller_qual::callee
#: text`` exactly as written at the site; value: tuple of function quals.
#: An entry here is a reviewed statement of "this indirect call can only
#: ever land on these functions" — extend it when a new callback seam
#: appears (the manifest diff will prompt you).
DYNAMIC_CALLS = {
    # ChunkPrefetcher's injected loader: the corpus driver's chunk loader
    "disco_tpu_torch.enhance.pipeline:ChunkPrefetcher._run::self._load": (
        "disco_tpu_torch.enhance.driver:enhance_rirs_batched.load_chunk",
    ),
    # ChunkPrefetcher's injected stop poll (runs.interrupt.stop_requested)
    "disco_tpu_torch.enhance.pipeline:ChunkPrefetcher._run::self._stop_requested": (
        "disco_tpu_torch.runs.interrupt:stop_requested",
    ),
    # DispatchDeadline's on_expire callback: no in-port caller passes one
    # (the scheduler polls .expired after the window instead); the empty
    # tuple DECLARES that, and a future callback must be added here
    "disco_tpu_torch.utils.resilience:DispatchDeadline._fire::self.on_expire": (),
    # the scoring pool's partial(_persist_and_score, ...) thunk
    "disco_tpu_torch.enhance.driver:enhance_rirs_batched.score_unit::score_fn": (
        "disco_tpu_torch.enhance.driver:_persist_and_score",
    ),
    # the gate harness's client threads run the caller's per-client work
    "disco_tpu_torch.serve.check:_run_clients.run::work": (
        "disco_tpu_torch.serve.check:check_parity.work",
        "disco_tpu_torch.serve.check:check_overload.work",
        "disco_tpu_torch.obs.scope:check_chains_and_status.work",
    ),
    # the GracefulInterrupt scope stack: scopes popped off module-level
    # ``_active`` lose their static type, but every element is a
    # GracefulInterrupt by construction
    "disco_tpu_torch.runs.interrupt:request_stop::scope._trip": (
        "disco_tpu_torch.runs.interrupt:GracefulInterrupt._trip",
    ),
    "disco_tpu_torch.runs.interrupt:stop_requested::g._flush_telemetry": (
        "disco_tpu_torch.runs.interrupt:GracefulInterrupt._flush_telemetry",
    ),
}


#: Declared instance-attribute types the resolver cannot infer from a
#: constructor assignment (the attribute is bound from a parameter).
#: ``"module:Class.attr" -> "module:Class"`` — lets ``self.tap.offer(...)``
#: resolve through the declared type.
ATTR_TYPES = {
    "disco_tpu_torch.serve.scheduler:Scheduler.tap": "disco_tpu_torch.flywheel.tap:CorpusTap",
    "disco_tpu_torch.serve.server:EnhanceServer.scheduler":
        "disco_tpu_torch.serve.scheduler:Scheduler",
    "disco_tpu_torch.serve.server:EnhanceServer.tap": "disco_tpu_torch.flywheel.tap:CorpusTap",
    "disco_tpu_torch.serve.scheduler:Scheduler.promote":
        "disco_tpu_torch.promote.controller:PromotionController",
    "disco_tpu_torch.serve.server:EnhanceServer.promote":
        "disco_tpu_torch.promote.controller:PromotionController",
    "disco_tpu_torch.promote.controller:PromotionController.store":
        "disco_tpu_torch.promote.store:GenerationStore",
    # the co-resident trainer: driven by the dispatch thread between
    # ticks (scheduler.resident.step), lifecycle by main (server start/
    # stop) — both roles are torch_ok, which is what makes a trainer ON
    # the dispatch thread legal under the one-device-thread contract
    "disco_tpu_torch.serve.scheduler:Scheduler.resident":
        "disco_tpu_torch.flywheel.resident:ResidentTrainer",
    "disco_tpu_torch.serve.server:EnhanceServer.resident":
        "disco_tpu_torch.flywheel.resident:ResidentTrainer",
}


def entry_point_index() -> dict:
    """``entry qual -> role name`` over every registered role."""
    out = {}
    for role in ROLES.values():
        for ep in role.entry_points:
            out[ep] = role.name
    return out


def entry_point_leaves() -> frozenset:
    """The last dotted component of every registered entry point — the
    lexical surface DL015 (bare-thread lint rule) checks spawn targets
    against without building the call graph."""
    return frozenset(ep.rpartition(":")[2].rpartition(".")[2]
                     for ep in entry_point_index())
