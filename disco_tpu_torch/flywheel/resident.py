"""The co-resident trainer: continuous training inside the serve process
(the port's counterpart of ``disco_tpu/flywheel/resident.py``).

:class:`ResidentTrainer` runs training inside the server as bounded slices
of train steps on the scheduler's dispatch thread: every tick, after the
tick's serving work is dispatched and read back, the trainer takes at most
``steps_per_tick`` steps.  The dispatch thread stays the only thread that
launches device work.

Three contracts:

* **Ladder-aware** — when the degradation ladder reports a rung at or
  above ``throttle_rung`` the trainer takes zero steps that tick: a
  paused/resumed transition is a ``train_throttled`` obs event and every
  skipped tick ticks the ``train_throttled_ticks`` counter.
* **Crash-restartable** — the epoch loop is
  :func:`disco_tpu_torch.nn.training.fit` taken a slice at a time:
  per-shard consumption rides
  :meth:`~disco_tpu_torch.flywheel.dataset.ShardDataset.batches`'s
  ledger-verified units (``shard:<name>:epoch:<e>``), each finished epoch
  is an atomic checkpoint + ``epoch:<e>`` done record, and each publish is
  its own ``publish:<e>`` unit bracketing the staging call.  A crash at any
  seam (``mid_epoch`` after the train pass, ``pre_publish`` after the
  checkpoint but before staging, ``between_generations`` after a
  generation lands) resumes from the ledger with no re-consumed shard unit
  and no torn checkpoint or generation; an interrupted publish is staged
  again, idempotently (same weights -> same digest -> same generation).
* **Rollout-safe** — publishing goes through
  :func:`~disco_tpu_torch.nn.training.publish_checkpoint`, the refusal
  seam of ``fit``; an epoch with no batches never publishes, and an
  unchanged checkpoint staged again is deduplicated by digest.

The trainer opens no thread, socket or lock: :meth:`ResidentTrainer.step`
is called from the dispatch thread (or the main thread of a standalone
harness), and :meth:`ResidentTrainer.close` sets a flag.  The steps are
``nn.training.make_step_fns``'s, in either precision lane; torch is
imported at the first step.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from disco_tpu_torch.flywheel.dataset import ShardDataset, peek_geometry
from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry
from disco_tpu_torch.runs import chaos
from disco_tpu_torch.runs.ledger import RunLedger, unit_epoch

#: Checkpoint file name under ``train_dir`` (one rolling atomic file — the
#: resume source of truth together with the ledger).
CKPT_NAME = "resident_model.msgpack"

#: Ledger file name under ``train_dir``.
LEDGER_NAME = "ledger.jsonl"

_EXHAUSTED = object()


def unit_publish(epoch) -> str:
    """Ledger work-unit id of one epoch's generation publish — bracketing
    the staging call so a crash between checkpoint and store is resumable
    (an ``in_flight`` publish unit is re-staged on restart, idempotently)."""
    return f"publish:{int(epoch)}"


class ResidentTrainer:
    """Incremental co-resident trainer over a flywheel shard directory.

    Args:
      shard_dir: the CorpusTap output directory to train from (shards are
        re-listed every epoch, so freshly tapped traffic joins the next
        epoch automatically).
      train_dir: working directory for the trainer's ledger and rolling
        checkpoint (created on demand).
      promote_dir: generation store root to publish into (None = train
        without publishing).
      arch: ``build_crnn`` kwargs (doubles as the generation-store arch
        record; ``learning_rate``/``clip_grad_norm`` configure the
        optimizer); None = sized
        from the shards' geometry on first step.
      batch_size / win_len / seed: dataset + init knobs
        (:class:`~disco_tpu_torch.flywheel.dataset.ShardDataset`).
      steps_per_tick: train-step budget per :meth:`step` call — the
        interleaving grain against serve dispatch.
      publish_every: publish cadence in epochs (1 = every eligible epoch).
      publish: ``'improved'`` (best-so-far train loss, the ``fit`` gate)
        or ``'always'`` (every cadence epoch — what the endurance gate
        uses to produce a deterministic generation stream).
      throttle_rung: ladder rung at/above which a tick trains zero steps.
      max_epochs: stop training after this many completed epochs
        (None = run as long as the server does).
      recent_shards: sliding-window corpus — each epoch consumes only the
        newest this many shards (None = the whole directory).  A resident
        trainer over a live tap NEEDS a window: the directory grows for as
        long as the server serves, so an unwindowed epoch re-reads the
        entire history and training falls ever further behind serving.
      precision: training compute lane (``'f32'``/``'bf16'``).
      dataset: an alternative training feed replacing the
        :class:`~disco_tpu_torch.flywheel.dataset.ShardDataset` over
        ``shard_dir`` — anything with the same ``batches`` /
        ``peek_geometry`` surface (the scenario factory's
        :class:`~disco_tpu_torch.scenes.stream.SceneStream` is the intended
        plug: training never starves on thin serve traffic because its
        corpus is simulated on demand).
    """

    def __init__(self, shard_dir, train_dir, *, promote_dir=None,
                 arch: dict | None = None, batch_size: int = 8,
                 win_len: int | None = None, seed: int = 0,
                 steps_per_tick: int = 4, publish_every: int = 1,
                 publish: str = "improved", throttle_rung: int = 1,
                 max_epochs: int | None = None,
                 recent_shards: int | None = None, precision: str = "f32",
                 dataset=None, device=None):
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if recent_shards is not None and int(recent_shards) < 1:
            raise ValueError(f"recent_shards must be >= 1, got {recent_shards}")
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {publish_every}")
        if publish not in ("improved", "always"):
            raise ValueError(f"publish must be 'improved' or 'always', got {publish!r}")
        if throttle_rung < 0:
            raise ValueError(f"throttle_rung must be >= 0, got {throttle_rung}")
        self.shard_dir = Path(shard_dir)
        self.train_dir = Path(train_dir)
        self.promote_dir = Path(promote_dir) if promote_dir is not None else None
        self.batch_size = int(batch_size)
        self.steps_per_tick = int(steps_per_tick)
        self.publish_every = int(publish_every)
        self.publish = publish
        self.throttle_rung = int(throttle_rung)
        self.max_epochs = max_epochs
        self.recent_shards = None if recent_shards is None else int(recent_shards)
        self.precision = precision
        self.seed = int(seed)
        #: where the model and its steps run: ``"cuda"`` when None
        #: (resolved at the first step), or ``"cpu"``
        self.device = device
        self._arch = dict(arch) if arch is not None else None
        self._win_len = int(win_len) if win_len is not None else None
        self._feed = dataset       # None = ShardDataset over shard_dir
        self._ready = False
        self._closed = False       # flag-only close signal (server shutdown)
        self._failed = None        # first training Exception — trainer parks
        self._throttled = False
        self._waiting_for_shards = False
        self._ledger: RunLedger | None = None
        self._dataset: ShardDataset | None = None
        self._model = None
        self._dev = None
        self._state = None
        self._train_step = None
        self._iter = None          # current epoch's batch generator
        self._epoch = 0
        self._epoch_in_flight = False   # epoch:<e> marked (lazily, on batch 1)
        self._resumed_in_flight = False  # epoch resumed from an in_flight unit
        self._tr = None            # device-resident running loss sum
        self._nb = 0               # steps this epoch
        self._steps_total = 0
        self._epochs_done = 0
        self._published = 0
        self._pending_publish: int | None = None  # replayed in_flight publish
        self._last_published_gen: str | None = None
        self._train_losses: list = []
        self._gate = None

    # -- the per-tick slice --------------------------------------------------
    def step(self, *, tick_no: int = 0, rung: int = 0) -> int:
        """Advance training by at most ``steps_per_tick`` train steps;
        returns the number of steps actually run.  The only entry point
        that touches the device — call it from the dispatch thread (or the
        main thread of a standalone harness), never from both.

        ``rung``: the degradation ladder's current rung — at or above
        ``throttle_rung`` this tick trains nothing (the ladder-aware
        contract; serve SLOs outrank training progress).

        A :class:`~disco_tpu_torch.runs.chaos.ChaosCrash` from the trainer's
        seams propagates (a simulated process death must kill the server's
        dispatch loop exactly like a serve-side crash); any ordinary
        ``Exception`` parks the trainer permanently with a ``fault`` obs
        event instead — a training bug must never take serving down."""
        if self._closed or self._failed is not None:
            return 0
        if rung >= self.throttle_rung:
            obs_registry.counter("train_throttled_ticks").inc()
            if not self._throttled:
                self._throttled = True
                obs_events.record("train_throttled", stage="resident",
                                  action="paused", rung=int(rung),
                                  tick=int(tick_no))
            return 0
        if self._throttled:
            self._throttled = False
            obs_events.record("train_throttled", stage="resident",
                              action="resumed", rung=int(rung),
                              tick=int(tick_no))
        try:
            return self._slice()
        except chaos.ChaosCrash:
            raise
        except Exception as e:  # park, loudly — serving must survive
            self._failed = e
            obs_registry.counter("train_errors").inc()
            obs_events.record("fault", stage="resident", fault="train_error",
                              error=f"{type(e).__name__}: {e}")
            return 0

    def _slice(self) -> int:
        if not self._ensure_ready():
            return 0
        if self._pending_publish is not None:
            # crash landed between the checkpoint and the store — finish
            # the interrupted publish before anything else, including the
            # max_epochs early-out (idempotent by digest, so a publish
            # that DID land is a no-op re-stage)
            epoch, self._pending_publish = self._pending_publish, None
            self._do_publish(epoch, resumed=True)
        if self.max_epochs is not None and self._epochs_done >= self.max_epochs:
            return 0
        steps = 0
        while steps < self.steps_per_tick:
            if self._iter is None:
                self._iter = self._dataset.batches(
                    self.batch_size, epoch=self._epoch, shuffle=True,
                    ledger=self._ledger, recent=self.recent_shards)
            batch = next(self._iter, _EXHAUSTED)
            if batch is _EXHAUSTED:
                self._iter = None
                if self._epoch_in_flight or self._resumed_in_flight:
                    # one epoch boundary per tick: checkpoint + publish are
                    # the slice's whole budget
                    self._finish_epoch()
                    return steps
                # nothing consumable yet (no shards, or all already
                # consumed for this epoch) — wait for fresh traffic
                # WITHOUT burning an epoch number or a ledger unit
                if not self._waiting_for_shards:
                    self._waiting_for_shards = True
                    obs_events.record("note", stage="resident",
                                      reason="resident trainer idle: no "
                                             "unconsumed shards for epoch "
                                             f"{self._epoch}")
                return steps
            self._waiting_for_shards = False
            if not self._epoch_in_flight:
                # lazy in_flight mark: an epoch only exists once it has a
                # batch (an idle server must not grow the ledger)
                self._ledger.mark_in_flight(unit_epoch(self._epoch))
                self._epoch_in_flight = True
            x, y = batch
            self._state, loss = self._train_step(self._state, x, y)
            self._tr = self._tr + loss
            self._nb += 1
            self._steps_total += 1
            steps += 1
        return steps

    # -- lazy init + ledger resume -------------------------------------------
    def _ensure_ready(self) -> bool:
        """First-step initialization: size the model, build step fns,
        restore the checkpoint, replay the ledger.  Returns False (and
        stays cheap to re-call) while no intact shard exists to size the
        model from."""
        if self._ready:
            return True
        if self._arch is None:
            geom = (self._feed.peek_geometry() if self._feed is not None
                    else peek_geometry(self.shard_dir))
            if geom is None:
                if not self._waiting_for_shards:
                    self._waiting_for_shards = True
                    obs_events.record("note", stage="resident",
                                      reason="resident trainer idle: no "
                                             "intact shards to size the "
                                             "model from")
                return False
            from disco_tpu_torch.config import TrainConfig

            # an injected feed windows at ITS OWN win_len — the model must
            # match the windows it will actually be fed, not the feed's
            # full block length
            feed_win = getattr(self._feed, "win_len", None)
            win_len = self._win_len or feed_win or geom["block_frames"]
            self._arch = dict(n_ch=1, win_len=win_len,
                              n_freq=geom["n_freq"],
                              learning_rate=TrainConfig().lr,
                              ff_units=(geom["n_freq"],))
        self._waiting_for_shards = False
        win_len = self._win_len or int(self._arch["win_len"])
        # The feed seam: an injected dataset (e.g. scenes.SceneStream)
        # replaces the tapped-shard reader wholesale — same batches()
        # contract, so the epoch/ledger machinery below is untouched.
        self._dataset = self._feed if self._feed is not None else ShardDataset(
            self.shard_dir, win_len=win_len, seed=self.seed)
        self.train_dir.mkdir(parents=True, exist_ok=True)
        self._ledger = RunLedger(self.train_dir / LEDGER_NAME)

        import torch

        from disco_tpu_torch.device import resolve_device
        from disco_tpu_torch.nn.crnn import build_crnn
        from disco_tpu_torch.nn.optim import build_optimizer
        from disco_tpu_torch.nn.training import (
            SaveAndStop,
            create_train_state,
            load_checkpoint,
            make_step_fns,
        )

        self._dev = resolve_device(self.device)
        kw = {k: v for k, v in self._arch.items()
              if k not in ("learning_rate", "clip_grad_norm")}
        # the JAX trainer draws its initial weights from `seed`; the port's
        # constructors draw from torch's generator, seeded here (a
        # checkpoint in train_dir replaces them either way)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self._model = build_crnn(**kw).to(self._dev)
        tx = build_optimizer(self._model,
                             learning_rate=self._arch.get("learning_rate", 1e-3),
                             clip_grad_norm=self._arch.get("clip_grad_norm"))
        sample = np.zeros((1, int(self._arch.get("n_ch", 1)), win_len,
                           int(self._arch["n_freq"])), np.float32)
        self._state = create_train_state(self._model, tx, sample, seed=self.seed)
        self._train_step, _ = make_step_fns(self._model, precision=self.precision)
        self._gate = SaveAndStop(patience=np.inf, mode="min")

        latest = self._ledger.replay()
        done_epochs, inflight_epochs = set(), set()
        for unit, rec in latest.items():
            if unit.startswith("epoch:"):
                e = int(unit.split(":", 1)[1])
                if rec["state"] == "done":
                    done_epochs.add(e)
                elif rec["state"] == "in_flight":
                    inflight_epochs.add(e)
            elif unit.startswith("publish:"):
                e = int(unit.split(":", 1)[1])
                if rec["state"] == "in_flight":
                    self._pending_publish = e
                elif rec["state"] == "done":
                    gen = (rec.get("attrs") or {}).get("gen")
                    if gen and not (rec.get("attrs") or {}).get("deduped"):
                        self._published += 1
                        self._last_published_gen = gen
        self._epoch = max(done_epochs | inflight_epochs) + 1 if done_epochs | inflight_epochs else 0
        if inflight_epochs and max(inflight_epochs) not in done_epochs:
            # crash mid-epoch: re-enter the interrupted epoch — its
            # already-done shard units verify and are skipped, so only the
            # remainder (possibly nothing) is consumed, never a duplicate
            self._epoch = max(inflight_epochs)
            self._resumed_in_flight = True
        self._epochs_done = len(done_epochs)

        ckpt = self.ckpt_path
        if ckpt.is_file():
            self._state, train_hist, _val = load_checkpoint(ckpt, self._state)
            self._train_losses = [float(v) for v in train_hist]
            for v in self._train_losses:
                self._gate.save_model_query(v)  # re-prime best-so-far
        self._tr, self._nb = torch.zeros((), device=self._dev), 0
        if self._epoch or self._pending_publish is not None:
            obs_events.record(
                "run_resume", stage="resident", epoch=int(self._epoch),
                epochs_done=int(self._epochs_done),
                mid_epoch=bool(self._resumed_in_flight),
                pending_publish=self._pending_publish)
        self._ready = True
        return True

    # -- epoch boundary -------------------------------------------------------
    def _finish_epoch(self) -> None:
        import torch

        from disco_tpu_torch.io.atomic import file_digest
        from disco_tpu_torch.nn.training import save_checkpoint

        epoch, nb = self._epoch, self._nb
        # mid_epoch chaos seam (the fit() seam, interleaved): train pass
        # complete, nothing persisted — resume must redo NOTHING (shard
        # units are durable) and duplicate nothing
        chaos.tick("mid_epoch", epoch=int(epoch))
        train_loss = float(self._tr) / nb if nb else 0.0
        if nb == 0:
            obs_registry.counter("train_empty_epochs").inc()
            obs_events.record(
                "warning", stage="resident", epoch=int(epoch),
                reason="resident epoch closed with ZERO training batches "
                       "(mid-epoch resume with every shard already "
                       "consumed, or shards drained mid-epoch)")
        while len(self._train_losses) <= epoch:
            self._train_losses.append(0.0)
        self._train_losses[epoch] = train_loss
        improved = self._gate.save_model_query(train_loss) if nb else False
        losses = np.asarray(self._train_losses)
        save_checkpoint(self.ckpt_path, self._state, losses, losses,
                        epochs_done=int(epoch) + 1)
        obs_registry.counter("train_steps").inc(nb)
        obs_registry.gauge("train_loss").set(train_loss)
        obs_events.record("epoch", stage="resident", epoch=int(epoch),
                          train_loss=train_loss, steps=int(nb),
                          improved=bool(improved))
        # state-only epoch record (the fit() convention: the rolling
        # checkpoint is shared mutable state later epochs overwrite, so it
        # rides as informational attrs, never as a voiding artifact digest)
        self._ledger.record(
            unit_epoch(epoch), "done", train_loss=train_loss, steps=int(nb),
            improved=bool(improved), ckpt=str(self.ckpt_path),
            ckpt_digest=file_digest(self.ckpt_path))
        self._epochs_done += 1
        self._epoch = epoch + 1
        self._epoch_in_flight = False
        self._resumed_in_flight = False
        self._tr, self._nb = torch.zeros((), device=self._dev), 0
        if self._publish_due(epoch, improved, nb):
            self._ledger.mark_in_flight(unit_publish(epoch))
            self._do_publish(epoch)

    def _publish_due(self, epoch: int, improved: bool, nb: int) -> bool:
        if self.promote_dir is None or nb == 0:
            return False  # zero-batch epochs changed nothing — never stage
        if (epoch + 1) % self.publish_every:
            return False
        return True if self.publish == "always" else improved

    def _do_publish(self, epoch: int, resumed: bool = False) -> None:
        """Stage the rolling checkpoint as a generation, bracketed by the
        ``publish:<epoch>`` ledger unit and the ``pre_publish`` /
        ``between_generations`` chaos seams."""
        from disco_tpu_torch.nn.training import publish_checkpoint
        from disco_tpu_torch.promote.store import PublishRefused

        # pre_publish chaos seam: the checkpoint and its epoch record are
        # durable, the generation is not — the restart re-stages it
        chaos.tick("pre_publish", epoch=int(epoch))
        try:
            gen = publish_checkpoint(
                self.promote_dir, self.ckpt_path, arch=self._arch,
                ledger=self._ledger, source=f"resident:epoch:{int(epoch)}")
        except PublishRefused as e:
            self._ledger.mark_failed(unit_publish(epoch), error=str(e))
            obs_events.record("generation", stage="resident",
                              action="refused", epoch=int(epoch),
                              unit=e.unit, reason=str(e))
            return
        deduped = gen.gen_id == self._last_published_gen
        # state-only done record (artifacts=None): the generation file is
        # owned by the store and may legitimately be GC'd later
        # (GenerationStore.collect) — digesting it here would void the
        # publish record on the next verified replay
        self._ledger.record(
            unit_publish(epoch), "done", gen=gen.gen_id,
            serial=int(gen.serial), deduped=deduped, resumed=resumed)
        if not deduped:
            self._published += 1
            self._last_published_gen = gen.gen_id
            obs_registry.counter("generations_published").inc()
            obs_events.record("generation", stage="resident",
                              action="published", gen=gen.gen_id,
                              serial=int(gen.serial), epoch=int(epoch),
                              resumed=resumed)
        # between_generations chaos seam: the clean boundary — everything
        # durable, nothing in flight
        chaos.tick("between_generations", gen=gen.gen_id, epoch=int(epoch))

    # -- lifecycle -------------------------------------------------------------
    @property
    def ckpt_path(self) -> Path:
        """The rolling atomic checkpoint file under ``train_dir``."""
        return self.train_dir / CKPT_NAME

    def stats(self) -> dict:
        """Progress snapshot for run summaries and the endurance gate."""
        return {
            "epochs_done": int(self._epochs_done),
            "steps_total": int(self._steps_total),
            "generations_published": int(self._published),
            "epoch": int(self._epoch),
            "throttled": bool(self._throttled),
            "failed": f"{type(self._failed).__name__}: {self._failed}"
                      if self._failed is not None else None,
        }

    def close(self) -> None:
        """Stop stepping and release the ledger handle.  Safe from any
        thread and idempotent — a plain flag stops the next slice, and
        the ledger's own lock covers the handle close (no trainer lock)."""
        self._closed = True
        if self._ledger is not None:
            self._ledger.close()
