"""SceneStream: the scenario factory feeding training directly (counterpart
of ``disco_tpu/scenes/stream.py``).

Training batches simulated on demand by the batched scenario factory
(:mod:`disco_tpu_torch.scenes.batched`), one factory pass and one readback a
scene batch, windowed into EXACTLY the ``(x, y)`` convention the training
stack consumes (``x`` = reference-mic magnitude STFT window ``(win_len, F)``,
``y`` = the matching IRM mask window — the ``nn/data.DiscoDataset`` item
shape, reference dnn/data/datasets.py:102-162).  ``batch_fn`` drives
``nn.training.fit`` as a ``DiscoDataset``'s batches do.

* **Deterministic seeded draws** — scene batch ``i`` of epoch ``e`` is
  drawn from ``default_rng([seed, e, i])``: two runs with one seed (in
  either package) see identical scenes, geometry, SNRs and window order.
* **Ledger resume** — each scene batch is a ``scene_batch:<epoch>:<i>``
  ledger unit; on resume, ``verified_done`` skips batches that were already
  simulated AND consumed.
* **Chaos seam** — ``between_scene_batches`` ticks after each scene
  batch's windows are fully yielded (the factory's clean boundary).

The JAX package also records a ``scene`` event and ticks the
``scene_batches`` / ``scenes_simulated`` counters; the port has no event
log yet.

No reference counterpart: the reference pre-generates its corpus to disk
and trains offline (dnn/utils.py:74-140).
"""
from __future__ import annotations

import numpy as np

from disco_tpu_torch.device import resolve_device

#: STFT geometry of the factory's analysis stage (ops.stft_ops convention).
_N_FFT, _N_HOP = 512, 256


def unit_scene_batch(epoch: int, index: int) -> str:
    """Ledger work-unit id of one simulated scene batch in one epoch.

    No reference counterpart (module docstring)."""
    return f"scene_batch:{int(epoch)}:{int(index)}"


class SceneStream:
    """On-demand simulated training batches from the batched scene factory.

    Args:
      seed: base seed of every deterministic draw.
      scenes_per_batch: B — scenes simulated per factory pass.
      batches_per_epoch: scene batches per epoch (the epoch's size knob —
        an on-demand corpus has no natural directory size).
      duration_s: dry-signal duration per scene.
      scenario: geometry sampler name (``sim.make_setup``).
      snr_range: per-scene SNR draw range (``snr_cnv_range`` convention).
      max_order: ISM reflection order (reference uses 20).
      win_len / win_hop: training window length/hop in STFT frames.
      setup_overrides: ``make_setup`` keyword overrides.
      dry_fn: ``(rng, n_samples) -> (target, noise)`` dry-signal source;
        default is the synthetic pair
        (:func:`disco_tpu_torch.scenes.batched.synthetic_dry_pair`).
      device: where the factory runs: ``"cuda"`` when None (RuntimeError
        without a CUDA device), or ``"cpu"``.  The batches are numpy.

    No reference counterpart (module docstring).
    """

    def __init__(self, *, seed: int = 0, scenes_per_batch: int = 8,
                 batches_per_epoch: int = 4, duration_s: float = 1.0,
                 scenario: str = "random", snr_range: tuple = (-5.0, 10.0),
                 max_order: int = 20, fs: int = 16000, win_len: int = 8,
                 win_hop: int | None = None, setup_overrides: dict | None = None,
                 dry_fn=None, device=None):
        if scenes_per_batch < 1:
            raise ValueError(f"scenes_per_batch must be >= 1, got {scenes_per_batch}")
        if batches_per_epoch < 1:
            raise ValueError(f"batches_per_epoch must be >= 1, got {batches_per_epoch}")
        if win_len < 1:
            raise ValueError(f"win_len must be >= 1, got {win_len}")
        self.seed = int(seed)
        self.scenes_per_batch = int(scenes_per_batch)
        self.batches_per_epoch = int(batches_per_epoch)
        self.duration_s = float(duration_s)
        self.scenario = str(scenario)
        self.snr_range = tuple(snr_range)
        self.max_order = int(max_order)
        self.fs = int(fs)
        self.win_len = int(win_len)
        self.win_hop = int(win_hop) if win_hop else int(win_len)
        self.setup_overrides = dict(setup_overrides or {})
        self.dry_fn = dry_fn
        self.device = resolve_device(device)

    # -- factory calls -------------------------------------------------------
    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        """Per-(epoch, batch) rng — the determinism anchor: the draw
        depends only on (seed, epoch, index), never on consumption
        history, so a resumed epoch reproduces its remaining batches
        exactly."""
        return np.random.default_rng([self.seed, int(epoch), int(index)])

    def simulate_batch(self, epoch: int, index: int) -> dict:
        """Draw + simulate scene batch ``index`` of ``epoch``: one factory
        pass, one readback (see
        :func:`disco_tpu_torch.scenes.batched.simulate_scene_batch`).

        No reference counterpart (module docstring)."""
        from disco_tpu_torch.scenes.batched import draw_scene_batch, simulate_scene_batch

        rng = self._rng(epoch, index)
        batch = draw_scene_batch(
            rng, self.scenes_per_batch, scenario=self.scenario,
            duration_s=self.duration_s, snr_range=self.snr_range, fs=self.fs,
            setup_overrides=self.setup_overrides, dry_fn=self.dry_fn,
        )
        return simulate_scene_batch(batch, max_order=self.max_order, fs=self.fs,
                                    device=self.device)

    # -- windowing -----------------------------------------------------------
    def _windows(self, out: dict, epoch: int, index: int, shuffle: bool = True):
        """(xs, ys) window stacks of one simulated batch, in the batch's
        deterministic per-epoch order when ``shuffle`` (the permutation
        draws from ``default_rng([seed, epoch, index, 1])``)."""
        mag, mask = out["mag_noisy"], out["mask"]  # (B, F, T)
        B, _F, T = mag.shape
        xs, ys = [], []
        for b in range(B):
            for t0 in range(0, T - self.win_len + 1, self.win_hop):
                # (F, win) -> (win, F): the DiscoDataset item convention
                xs.append(mag[b, :, t0:t0 + self.win_len].T.astype(np.float32))
                ys.append(mask[b, :, t0:t0 + self.win_len].T.astype(np.float32))
        if not xs:
            return None
        if not shuffle:
            return np.stack(xs), np.stack(ys)
        order = np.random.default_rng(
            [self.seed, int(epoch), int(index), 1]).permutation(len(xs))
        return (np.stack([xs[i] for i in order]),
                np.stack([ys[i] for i in order]))

    # -- the batch stream ----------------------------------------------------
    def batches(self, batch_size: int, *, epoch: int = 0, shuffle: bool = True,
                ledger=None, drop_last: bool = True):
        """Yield ``(x, y)`` numpy batches for one epoch: batches never cross
        a scene-batch boundary, and ``ledger`` arms per-scene-batch verified
        resume (simulated-and-consumed batches are skipped on replay).  (The
        JAX package's ``recent``, ignored there, comes with the shard feed
        of the flywheel slice.)

        No reference counterpart (module docstring).
        """
        from disco_tpu_torch.runs import chaos as run_chaos
        from disco_tpu_torch.runs.ledger import RunLedger

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        own_ledger = ledger is not None and not isinstance(ledger, RunLedger)
        if own_ledger:
            ledger = RunLedger(ledger)
        try:
            done: set = set()
            if ledger is not None:
                done, _requeued = ledger.verified_done()
            for index in range(self.batches_per_epoch):
                unit = unit_scene_batch(epoch, index)
                if unit in done:
                    continue
                if ledger is not None:
                    ledger.mark_in_flight(unit)
                out = self.simulate_batch(epoch, index)
                windows = self._windows(out, epoch, index, shuffle=shuffle)
                if windows is None:
                    if ledger is not None:
                        ledger.mark_done(unit, n_windows=0)
                    continue
                xs, ys = windows
                n = len(xs)
                for start in range(0, n, batch_size):
                    if drop_last and start + batch_size > n:
                        break
                    yield xs[start:start + batch_size], ys[start:start + batch_size]
                if ledger is not None:
                    # no artifacts: the scenes live only in the yielded
                    # batches, so the done record is the consumption marker
                    ledger.mark_done(unit, n_windows=n)
                run_chaos.tick("between_scene_batches")
        finally:
            if own_ledger:
                ledger.close()

    def batch_fn(self, batch_size: int, *, shuffle: bool = True,
                 ledger=None, drop_last: bool = True):
        """A ``fit``-compatible zero-arg epoch-iterator callable with
        ``set_start_epoch(n)``: ``fit`` tells it a resumed run's first epoch,
        so the resumed epochs draw the batches an uninterrupted run would.

        No reference counterpart (module docstring).
        """
        from disco_tpu_torch.runs.ledger import RunLedger

        if ledger is not None and not isinstance(ledger, RunLedger):
            ledger = RunLedger(ledger)
        state = {"epoch": 0}

        def make():
            epoch = state["epoch"]
            state["epoch"] += 1
            return self.batches(batch_size, epoch=epoch, shuffle=shuffle,
                                ledger=ledger, drop_last=drop_last)

        def set_start_epoch(epoch: int) -> None:
            state["epoch"] = int(epoch)

        make.set_start_epoch = set_start_epoch
        return make

    def peek_geometry(self) -> dict:
        """Feed geometry without simulating anything — what sizes the model:
        the factory's shapes are known from its STFT convention (centered
        512/256 frames: ``T = 1 + L//hop``).

        No reference counterpart (module docstring)."""
        L = int(round(self.duration_s * self.fs))
        return {
            "n_nodes": 1,
            "mics_per_node": None,  # per-scenario; the feed trains on mic 0
            "n_freq": _N_FFT // 2 + 1,
            "block_frames": 1 + L // _N_HOP,
        }
