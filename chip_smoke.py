#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``disco_tpu_torch``) on one NVIDIA
Hopper GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and turned into a
pass):

1. The card's name and power limit (``nvidia-smi``); the hand-written
   kernels are built from ``disco_tpu_torch/csrc`` into ``build/kernels/``
   (one ``nvcc`` per source, all started together) and their build
   seconds, ``-Xptxas -v`` register, spill and shared-memory counts and
   SASS instruction counts (``cuobjdump -sass``) printed.  Five sources:
   the f32 STFT (a real FFT), the bf16 STFT (a tensor-core DFT product in
   tiles of 256 frames and slabs of 64 bins, the table through an mbarrier
   ring, the signal in phases by cp.async), the covariances, the fused
   solve (each with f32 and bf16 instances; the covariances' bf16 instances
   round each element once a tile) and the eigensolver.
2. Every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (K=8 nodes, C=4 mics, 10 s at 16 kHz):
   the STFT on the clip (626 frames, not a multiple of the kernel's
   32-frame tile), on one streaming window (64 frames) and on 300 samples
   (2 frames, both reaching into the reflected edges), the covariances
   and the fused solve at one clip's launches and at those of a 16-clip
   batch of distinct clips (recorded as the path hands them over, so
   that indexing across clips is checked too; the covariances also bit
   for bit from run to run, the solve's bit-identity to its plain version
   reported), the eigensolver on
   the whitened step-1 (C=4) and step-2 (C=11) matrices of the full-clip
   streaming run, on its generic path (C = 1, 2, 7, 16), a ragged batch
   and a NaN matrix, each bit-identical to its plain version.  The bf16
   lane: the STFT kernel within 1e-4 of the output scale (max-abs) of its
   plain version at the same shapes and at the 16-clip batch, the
   covariances' bf16 instances (shared and per-channel masks, C = 4 and
   11, and the batch) within 1e-5 max-rel and bit-stable, the solve's bit
   for bit at step 1, step 2 and the batch of distinct clips.  Then the
   port's ``core.dsp`` STFT/ISTFT at 1024/512 and 512/128 (the rFFT route,
   no STFT kernel launched) and 512/256 (one ``csrc/stft.cu`` launch), on
   the card against the host within 1e-5.
3. The offline path — ``tango_clip_fused(y, s, n, solver='fused')`` —
   with every launch counter set to 0 before and read after (1 STFT, 2
   covariance, 2 fused-solve launches); the output is finite, within 1e-4
   of the output scale of the same clip run with the plain versions on
   the card, and improves SI-SDR at node 0 by more than 3 dB over the
   noisy reference mic.  The same in the bf16 lane for one clip and the
   16-clip batch (1 bf16 STFT, 2 + 2 bf16 covariance and solve launches),
   its SI-SDR also within 0.1 dB of the f32 lane's; ``tango`` on the
   clip's spectra under the 'compressed', 'use_oracle_refs' and
   'use_oracle_zs' policies and with a (K, K) ``z_mask`` and a NaN node,
   each finite and within 1e-4 of its plain-version run.
3d. The CRNN-masked offline path on the same clip: two canonical CRNNs
   (conv 32/64/64, GRU 256, FF 257) of seeded random weights, made as the
   JAX package's variable tree and loaded through ``nn.convert``, step 1
   on the reference mic (``n_ch = 1``) and step 2 on it and the other
   nodes' z_y (``n_ch = K``): ``stft_with_mag`` → ``estimate_masks`` →
   ``tango(solver='fused')`` with the counters set to 0 before and read
   after (1 STFT, 3 covariance, 2 fused-solve launches); the masks finite
   and in [0, 1]; the clip within 1e-4 of the output scale of the plain
   versions fed the same masks and the STFT kernel's spectra, with the
   covariances summed in the kernel's order and arithmetic (the untrained
   CRNNs' masks leave the pencils near-degenerate, and two plain
   formulations of the STFT or of the covariances already differ by more
   than 1e-4 there: ``exp/crnn_clip_witness.py``); the distance to the
   plain versions from the signal reported; the card's CRNN masks within
   1e-4 (max-abs) of the same modules' on the host on the same inputs; the
   stream route within 1e-5 of the per-window route; a second run of the
   masks within 1e-6 (bit-identity reported); ``_batched_masks`` on the
   16 distinct clips within 1e-5 of each clip's ``estimate_masks``.
3e. The corpus driver at the same width: a 2-clip corpus (the port's
   ``runs.check._mini_corpus``: a white source through random 8-tap
   filters per mic plus white noise, K=8 x C=4 x 10 s, under ``build/``,
   deleted at the end of the phase; cut from 16 clips to 8, to 4, then to
   2 to make room for phase 3j: host scoring takes ~30-40 s a clip, and
   the script stays near half its time limit)
   through ``enhance_rirs_batched`` with ``max_batch=2``, 4 scoring
   workers and a run ledger, in the staged lane (``solver='power'``, one
   chunk: 1 STFT and 2 covariance launches), recorded with the finiteness
   sentinels and the flight ring armed, and the chained lane on two clips
   (one chunk: 1 STFT, 2 covariance and 2
   fused-solve launches): every clip done in
   the ledger, every artifact valid (``probe_artifact``), the JAX
   package's result schema in float64, every clip's mean sdr_cnv more than
   3 dB over its mean sdr_in_cnv; the staged lane's event log read back
   (schema-validated) with each clip's ``score_persist`` span and ``clip``
   event, one ``chunk_load``/``chunk_enhance``/``chunk_readback``/
   ``chunk_pipeline`` span, ``device_get_batches`` and ``chunk_readbacks``
   a chunk, ``clips_enhanced`` the clips, one sentinel check a clip (the
   batched engine checks ``istft_out`` only, as the JAX package's does)
   and no trip; one clip through ``enhance_rir(bucket=8192)`` within 1e-5
   of the output scale and 1e-3 dB of its batched run, and through the
   plain versions on the host (``device='cpu'``) within 1e-4 and 0.01 dB;
   the sequential engine (the same 4 scoring workers), unrecorded, on the
   driver's mesh lane in a 1-rank NCCL world of its own, on the two clips
   byte-identical to the recorded pipelined meshless chunk, its scores
   equal, with the same launches;
   the streaming lane (``solver='jacobi-pallas'``: 1 STFT, 2 eigensolver
   launches) finite and above its input; ``export_z`` of one clip finite.
   Each driver run's parts are timed on the host clock.
3f. The training path at full width, on a training corpus under ``build/``
   (deleted at the end of the phase) in the DISCO training geometry that
   ``PostGenerator`` and ``DiscoDataset`` hard-code: 4 nodes x 4 mics,
   11-s clips, RIRs 1-8 (the train split), convolved images of a white
   source through random 8-tap filters per mic and white ``ssn`` noise
   (~180 MB of WAV, ~1 GB once the features are written).
   ``PostGenerator`` on the card with the counters set to 0 before and
   read after (24 STFT launches: 3 an RIR), RIR 1's STFT files within
   1e-5 of the STFT's scale of the host's plain STFT of the written WAVs
   and its masks within 1e-6 of the host's mask of the same spectra;
   ``export_z`` of the 8 RIRs (24 STFT and 8 covariance launches);
   ``get_input_lists`` → ``DiscoDataset(stack_axis=2)`` (the reference
   mic and 3 z's, 608 windows of 21 frames) → ``fit`` of the canonical
   CRNN (conv 32/64/64, GRU 256, FF 257, ``n_ch`` 4, seeded weights) at
   batch 500 for 3 epochs with a run ledger: losses finite, the last
   epoch's train loss below the first's, 3 ``done`` epochs in the
   ledger, the checkpoint decoded by ``nn.serialization`` with the JAX
   package's tree; a 2-epoch run resumed from its checkpoint to the same
   last epoch bit-identical to the 3-epoch run (losses, parameters,
   statistics, ``nu``); four timed fits of 2 epochs, each epoch 8 passes
   over the 608 windows (10 steps), so that an epoch's fixed costs (a
   pass's first-batch stall, validation, the checkpoint, the loss files)
   are a small part of the timed wall; one train step on the card against
   the same step on the host, whose max pools take the card's choices
   (loss within 1e-5 relative, parameters and ``nu`` within 1e-4
   absolute, and on each device ``nu`` element by element within 1e-6 of
   the 0.01 g^2 of the step's own gradient g, so a ``nu`` of 0 or of
   another decay fails; BatchNorm statistics element by element within
   1e-5 of themselves plus 1e-5 of their conditioning: the magnitude of
   the terms their update sums, 0.9 of the old value and 0.1 of the
   batch's mean |x| for a mean or mean x^2 for a variance, x the conv
   output of that channel; every window where the host's pool would
   choose another element a tie, the two elements within 1e-5 of the pool
   input's largest magnitude: such a window's gradient lands on another
   conv output, and RMSprop's first step moves a parameter of small
   gradient by 10 times the difference, ``exp/crnn_step_split.py``); the
   bf16 lane's first loss within 2e-2
   of the f32 lane's, and one epoch of it leaving masters, statistics and
   ``nu`` float32.
3g. Simulation, scenes and corpus generation at the corpus's published
   widths (``sim.defaults``: 4 nodes x 4 mics, RT60 0.3-0.6 s, 5-10 s
   talkers after 1 s of silence, ISM order 20): the golden fixture's
   order-20 RIRs on the card within 5e-4 (relative L2 a RIR) of the float64
   fixture and 1e-6 of the port's host run, a second card run bit-identical;
   ``generate_disco_rirs_batched`` of 4 RIRs in chunks of 2 (scenario
   ``random``, ``train``, a ledger) on synthetic talkers written as a
   LibriSpeech-shaped tree under ``build/`` (``get_wavs_list``'s flat
   fallback; deleted at the end of the phase), then the same run crashed at
   ``between_scene_batches`` hit 1 and resumed, the two trees byte-identical,
   with scenes per wall-second and the ISM's and the convolutions' card ms a
   chunk (CUDA events) against the host's gating ms a chunk; ``SceneStream``
   at its defaults (8 scenes a batch, order 20, 1 s, ``random``; 21-frame
   windows for the canonical CRNN), 2 scene batches with the counters set to
   0 before and read after each (one STFT launch a batch), the magnitudes
   within 1e-5 of ``stft_matmul`` of the batch's own signals, scenes per
   second and the ISM's share of a batch, then ``fit`` of the canonical
   n_ch-1 CRNN for one epoch off ``batch_fn`` (4 STFT launches: 2 scene
   batches each for training and validation); one MEETIT room of 4
   sources facing 4 nodes of 4 mics (``simulate_meetit_room``, SIRs gated
   at -10 to 10 dB: four equal-level talkers at order 20 sit near -2.5 dB,
   under the reference's 2-14 dB classes), ``get_masks`` (one STFT launch),
   written in ``generate_meetit_rirs``' layout and read back by
   ``load_meetit_sample``, its mixture STFTs within 1e-5 of
   ``stft_matmul`` of the summed images; ``dynamic_scene_mixture`` of 4
   segments, the crossfaded boundary jumps under half the hard switch's.
   The scene gate's dispatch-budget and log legs ride the SceneStream run:
   one batched readback a batch, one new ``scene_batch`` signature a
   ``rir_len`` bucket (``obs.accounting.counted_jit``), one ``scene``
   event a batch.
3h. Online serving (``disco_tpu_torch.serve``) on the north-star clip: an
   in-process ``EnhanceServer`` on loopback with ``ServeClient`` clients on host
   threads, five concurrent sessions of 64-frame blocks (``update_every``
   4): ``jacobi-pallas``, ``jacobi-pallas`` with mu 1.2, ``fused``, ``eigh``
   with a z_mask that drops node 2, and a ``domain="time"`` session
   (``jacobi-pallas``, four 1.008-s windows).  Every offline reference is
   computed on the main thread before the server starts: each STFT-domain
   session's whole-clip ``streaming_tango``, required bit-identical to its
   per-block calls (``serve.check.per_block_stream``), and the time
   session's ``streaming_clip_fused`` window by window.  In per-block
   ticks and in super-ticks of 2 (``streaming_tango_scan``, the readback
   overlapped), every delivered stream is bit-identical to its reference,
   ``device_get_batches`` advances once a tick with work, and the launches
   (counters set to 0 before, read after) equal those of the offline
   per-block calls; blocks per second and the ``serve_block_latency_ms``
   p50/p95 with its queue-wait / dispatch split are printed.  Then a
   ``jacobi-pallas`` session drained half-fed through ``runs.interrupt``,
   checkpointed under ``build/`` and resumed on a fresh server, bit-identical
   stitched; a ``serve_tick`` crash after 3 ticks with every frame received
   before it bit-correct, and a ``mid_write`` crash in the drain checkpoint
   leaving no checkpoint at its final path.
3i. The flywheel and promotion (``disco_tpu_torch.promote.check``,
   ``disco_tpu_torch.runs.endure``) at the same width with the canonical
   CRNN (``n_ch`` 1, phase 3d's seeded weights): the generation staged
   from the card's module has the host's ``gen_id``; four ``masks="model"``
   sessions (two ``jacobi-pallas``, two ``fused``) on seeded white-noise
   spectra and a time-domain ``jacobi-pallas`` session (client masks from
   the incumbent's lane on each window's STFT: a time-domain session cannot
   be a model session, as in the JAX package) served together with the
   corpus tap on, every stream bit-identical to its oracle, one readback a
   tick, every model block tapped with the lane's masks, the launches
   (counters set to 0 before serving and read after) equal to the oracles'
   calls and nonzero for the STFT, the eigensolver and the fused solve;
   blocks per second and latency p50/p95 beside phase 3h's; the lane's ms a
   block and a resident train step's ms (CUDA events); a zeroed candidate
   demoted on ``canary_sdr_db`` and a perturbed one promoted across the four
   sessions, a ``pre_swap`` crash and restart, ``mid_canary`` and
   ``post_gate`` crashes, each stream bit-identical to its per-generation
   oracle; two endurance legs (a ``mid_epoch`` crash, then clean) in which
   the resident trainer publishes from the tap's shards and the controller
   promotes, with shards written and dropped and ``tap_to_promotion_ms``.
3j. The gates on the card, each leg a function of the device, its
   launches counted: the fault gate (``fault.check``) on the north-star
   clip with ``solver='fused'`` (a node dropped and a NaN z: the outputs
   finite and apart from the fault-free run, one ``node_dropout`` and one
   ``nan_z`` event, a ``degraded`` entry, the injections counted); the
   chaos gate (``runs.check``) and the corpus-engine gate's legs 1-3 and 5
   (``enhance.check``: artifacts byte-identical across engines, the ledger
   clean, one batched readback a chunk, the default path's kernels against
   the unfused formulations on the host) on the gates' 2-clip mini corpus
   (4 nodes x 2 mics, 2 s); the scene gate's oracle, per-scene, dynamic
   and stream legs at its size (``scenes.check``); scope (``obs.scope``)
   at the north-star width: two traced sessions and one untraced, 64-frame
   blocks, ``solver='jacobi-pallas'``, every delivered frame a complete
   causal chain, the status frame equal to the registry, the fault leg's
   quarantine dump naming the failed ``dispatch`` span and byte-stable,
   every stream bit-exact; the soak (``runs.soak``) at its size, one seed
   run twice to byte-identical summaries and the crash leg resuming
   bit-exact on a fresh server; a NaN in the north-star ``Y`` tripping one
   sentinel with its stats and one flight dump, and one ``check_finite``
   of the clean ``Y`` (41 MB) timed by CUDA events with its fences.
3k. The command line (``disco_tpu_torch.cli``, each ``main(argv)``
   in-process, the server as a process) at the CLIs' own full width: the
   DISCO array of 4 nodes x 4 mics at 16 kHz, ISM order 20, 5-10 s
   talkers, depth cut to 2 RIRs, on phase 3g's synthetic LibriSpeech-shaped
   talkers under ``build/`` (deleted at the end of the phase).
   ``disco-gen --dset train --scenario living`` and ``disco-mix``;
   ``disco-get-z``, ``disco-lists`` and ``disco-train --single_channel``
   (the canonical CRNN, batch 500, 2 epochs; its checkpoint written);
   ``disco-tango --rirs 1 2 --solver fused --obs-log`` with the counters
   set to 0 before and read after, its launches equal to those of the
   same ``enhance_rirs_batched`` call made directly into another tree and
   every artifact of the two trees byte-identical, ``disco-obs report`` of
   its log; ``disco-tango --rir 1 --streaming --solver jacobi-pallas``
   (the eigensolver launched, the scores finite); ``disco-tango --mods
   <checkpoint> None --rir 2`` (the step-1 CRNN carries the checkpoint's
   weights); ``disco-aggregate --json``; ``disco-scenes simulate`` and
   ``disco-gen-meetit``; ``python -m disco_tpu_torch.cli.serve --unix``
   with one north-star session (K=8, C=4, blocks of 64 frames,
   ``jacobi-pallas``) bit-identical to the offline ``streaming_tango``,
   ``disco-obs slo`` on its socket, and SIGINT draining it to exit 0.
   Each step's seconds, whether the figures were written and whether
   ``matplotlib`` and ``yaml`` import here are printed.
3l. The BASELINE milestones (``disco_tpu_torch.milestones``) at their own
   widths and durations: the 5-s 4-mic MVDR, DISCO step 1 and two-step
   TANGO at 4 x 4 mics for 5 s, MEETIT separation at 8 x 4 mics and 2
   sources for 5 s, 64 rooms x 8 nodes x 2 mics of 2 s at ISM order 10 with
   2048 taps, and streaming latency at 4 x 4 mics for 5 s under the
   'local', 'distant' and 'none' policies.  Cut: ``iters`` 1
   (``MILESTONE_ITERS``; the JAX package's defaults are 3, and 1 for the
   rooms), so a configuration runs 10 times (the first for its output, then
   the k=1 and k=6 slope timings with their warm-ups), the streaming one 30.
   Each prints its JSON line, and its STFT and covariance launches, counters
   set to 0 before and read after, equal those the code implies
   (``MILESTONE_LAUNCHES``: the STFTs and masks made before the timing, and
   each run's).  Gates of ``tests/test_milestones.py``: every rtf positive,
   the MVDR 3 dB over its input, DISCO step 1 and TANGO 1 dB at every node,
   the rooms' mean SI-SDR finite; separation's mean gain positive (at its
   BASELINE scale separation loses at 2 of 8 nodes in the JAX package too),
   and each node's gain positive at the JAX test's tiny scale (1 s, 4 x 2
   mics) on the card.  Then card against host: configurations 1-4 at their
   scale and 5 at 4 rooms (``MILESTONE_HOST_ROOMS``, same room shapes), the
   card's and the host's plain versions each run once (timing stubbed,
   :func:`untimed`): ``si_sdr_in`` within 1e-6 dB, ``si_sdr_out``, every
   ``delta_si_sdr`` and ``mean_si_sdr_out`` within 0.02 dB, separation's
   per-node gains within 0.2 dB (``MILESTONE_TOL``: without noise its
   interference covariances are near rank-deficient, and float32 roundoff
   alone moves a node's gain by ~0.065 dB).  Last, ``disco-torch-milestones --corpus --tiny
   --configs 1`` (2 RIRs of 4 x 4 mics at order 6, the CRNNs 2 epochs, in a
   working directory under ``build/`` deleted after): its JSON lines, the
   oracle entry's ``delta_sdr_512tap`` over 2 dB, every delta finite, the
   CRNN entry printed beside the oracle's, and its STFT and covariance
   kernels launched.
3m. Multi-GPU (``disco_tpu_torch.parallel``) at world size 1: each mesh
   lane opens a 1-rank NCCL world of its own and tears it down after it,
   as a user's run on one card does (the contract pins the card count to
   1, and NCCL takes one rank a card), and every sharded path runs its
   collectives on a
   ``(batch 1, node 1)`` mesh beside its meshless twin, the counters set to
   0 before each and read after, the twin's launches equal to its own:
   ``tango_sharded`` on the north-star clip with ``solver='fused'`` and
   ``cov_impl='auto'`` bit-identical to ``tango``, its ring exchange
   bit-identical to the ``all_gather`` one, with a ``(K,)`` ``z_mask``
   dropping node 2 and a NaN frame in node K-3's mixture (its z NaN, the
   guard excluding it) bit-identical to ``tango(z_mask=...)``, and with
   ``solver='jacobi-pallas'`` bit-identical; ``tango_frame_sharded`` on a
   ``(node 1, frame 1)`` mesh within 1e-4 of the output scale of ``tango``
   (its covariances the einsum: 0 covariance and 2 fused-solve launches);
   ``tango_batch_sharded`` on phase 3d's 16 distinct clips bit-identical
   to ``tango`` on the batch; ``fit`` of the canonical CRNN on the 1-rank
   mesh, 2 epochs over two halves of phase 3f's batch, losses, parameters
   and checkpoint bytes equal to the meshless fit's; the flywheel gate's
   data-parallel leg at one rank on three shards of seeded records, in the
   world the leg opens itself.  Phase 3e's sequential twin runs the
   driver's mesh lane, and phase 3k runs
   ``disco-torch-train --data-parallel 1`` (its checkpoint byte-identical
   to the meshless command's) and ``disco-torch-tango --rirs 1 2 --mesh 1
   1`` (its tree byte-identical, its launches equal).  The cross-rank
   exchanges are held on gloo ranks by the CPU tests.
   Phase 3n: the cost model, the fingerprints and the roofline on the
   card.  Every program of ``analysis.trace.programs`` runs on real CUDA
   tensors at the catalog's shapes under the recorder and is held to its
   committed golden (traced for the card on fake tensors): its kernel ops
   and their counts, equal to the launch counters' deltas; its output
   signature; its host syncs; its float64 tensors on the device, each by
   operator, dtype and shape, those of the golden (only ``scene_batch``
   has any).  The north-star 16-clip offline batch is held
   to its fake trace made here.  Each stage of the headline workload
   (``analysis.meter.stages``: 16 clips x 8 nodes x 4 mics x 10 s) is
   timed with CUDA events (median of 5) and joined with the meter's stage
   costs into the roofline against the card's peaks (``obs.roofline``),
   printed before the result.
   Phase 3o: the linter and the thread-contract analyzer on the card
   host's copy of the tree — ``python -m disco_tpu_torch.analysis.cli``
   and ``python -m disco_tpu_torch.analysis.race.cli`` as two processes
   started together, each required to exit 0, their findings,
   suppressions, files and seconds printed — and the runtime twin of
   DR001/DR002, recorded while phase 3i ran (serving, the tap, the
   promotion controller and the resident trainer): every thread port code
   started had a target that is an entry point of
   ``analysis/race/roles.py`` (executor workers are matched by the
   functions port code submitted to them; workers of other code's
   executors are listed and skipped), and every kernel launch came from a
   thread whose role is ``torch_ok`` (the launches are noted by
   ``ops/_build.py``'s recorder, armed for that phase only).
   Phase 3p: corpus acquisition and the kernels' build cache, in child
   processes started together (none forked from this process, which
   holds a CUDA context).  ``python -m disco_tpu_torch.cli.download
   --list-urls`` exits 0 and prints the four corpus URLs; ``--clean`` on
   a small tree with one stale csv row drops exactly that row; the
   Freesound download through ``disco-torch-download``'s ``main`` with a
   fake client (``FreesoundInquirer.from_token`` replaced in the child)
   at ``-j 2`` writes the expected files and csv.  A child with
   ``DISCO_TORCH_COMPILE_CACHE=<tmp>`` builds the kernel library under
   ``<tmp>/<digest>/`` with ``nvcc`` (its seconds printed) and launches
   the f32 STFT kernel on the north-star clip, bit for bit this process's
   launch from its own root; a child with ``off`` builds into a
   per-process temporary directory, launches the same, matches bit for
   bit and leaves no directory behind in its ``TMPDIR``.
4. The streaming path, ``solver='jacobi-pallas'``: nine 1.008-s windows
   through ``streaming_clip_fused`` with the state carried (1 STFT and
   2 x 16 eigensolver launches a window), and ``streaming_tango`` on the
   full 626-frame clip (2 eigensolver launches), each with the counters
   set to 0 before and read after; ``streaming_tango_scan`` bit-identical
   to ``per_block_reference``; the eigensolver bit-identical to its
   plain version on the matrices of one window; window 2 through the
   plain versions from the state after window 1 within 1e-4 rel-l2 and
   0.1 dB SI-SDR of the kernels' window (cut from windows 2-9 to make room
   for phases 3k, 3m and 3p; the first window from the warm start through the
   plain versions printed beside the kernels', cut from 9 to make room for
   phases 3j and 3m); the windows' SI-SDR gain at
   node 0 over the noisy reference mic within 0.2 dB of the JAX package's
   on the same windows (``JAX_WINDOWS_GAIN_DB``) after 1, 2 and 3 s; the
   full-clip stream's more than 3 dB after the recursion's first three
   seconds.  The bf16 lane's nine windows (the bf16 STFT kernel): scan
   bit-identical to the per-block loop, window 2 within 1e-4 rel-l2
   of the plain versions, the windows' SI-SDR gains within 0.1 dB of the
   f32 lane's.
5. CUDA-event times: the offline path on a 16-clip batch in both lanes, the streaming
   window's latency, and per kernel the kernel, its plain version and
   (where one exists) one PyTorch library call computing the same
   function, beside the bound from this run's shapes (the cost model's
   declared cost of each kernel op and its boundary bytes,
   ``analysis.meter.costmodel``) and the H100 SXM data-sheet peaks
   (``obs.roofline``); the eigensolver both at the full-clip stream's
   batch and at the streaming window's (2056 matrices, C=4 and C=11), the
   covariances and the fused solve both at one clip's launches and at the
   16-clip batch's, in both lanes; beside each kernel's events (which
   include the wrapper's host time) its device time under the profiler.
   The bf16 STFT's bound counts its DFT product at the dense-bf16 peak;
   its library call is one cuBLAS bf16 GEMM (``torch.matmul``, bf16 out).
   Both STFT kernels are also timed at the 16-clip batch's rows (events and
   device time; the bf16 one beside its plain version and the GEMM).  The
   CRNN-masked path on the 16 distinct clips, by part (step-1 masks,
   step-1 z, step-2 masks, ``tango``), each the median of 5, the CRNNs'
   rates by the operations of their shapes.  The corpus driver: phase
   3e's corpus clips per wall-second in each lane, and its split — load a
   clip, the launches of one loaded 8-clip chunk already on the card and
   with its host-to-card copy (CUDA events, median of 5), the wait and
   the readback of each chunk, scoring a clip.  Training: one train step
   and one eval step of the canonical CRNN at batch 500 (``n_ch`` 4 and 1,
   each lane; CUDA events, median of 5), its TFLOP/s by the CRNN's shapes
   (forward x 3), the same step with cuDNN free to choose and autotune
   (the cost of the deterministic algorithms the step pins), and phase
   3f's timed fits in training windows per second (each run, the median
   and the spread), beside the host's batch assembly alone, the steps'
   share of the wall by their event times, and the prefetch stalls.
   The f32 STFT kernel's batch row also times ``torch.stft`` on the same
   1,536 rows.
6. Where one 16-clip offline call (in both lanes), the 16-clip CRNN mask
   stage, one streaming window and three train steps spend their device
   time, by kernel (``torch.profiler``), and the device's busy share of
   their wall time.

The last two lines of standard output are one ``{"kernels": [...]}``
object and ``{"ok": true, "device": {...}}``.
"""
# disco-torch-lint: file-disable=DL001 -- the card harness: each synchronize closes a timed region or a launch-count window before its readback; the stall is the measurement, not path code
# disco-torch-lint: file-disable=DL016 -- the card harness builds the kernel library (phase 1) and holds each kernel against its plain version by name; the launches it makes to compare are not the main path's
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager, redirect_stdout, suppress
from types import SimpleNamespace

import numpy as np

FS = 16000
K, C = 8, 4              # nodes, mics per node (the north-star scene)
DUR_S = 10.0
NOISE_SCALE = 0.5
BATCH = 16               # clips per timed batch
TOL = {"stft": 1e-5, "stft_bf16": 1e-4, "masked_cov": 1e-5, "fused_mwf": 1e-5, "clip": 1e-4,
       "stream": 1e-4, "stream_sdr_db": 0.1, "sdr_gain_db": 3.0, "witness_db": 0.2,
       "bf16_lane": 1e-2, "crnn_host": 1e-4, "crnn_route": 1e-5, "crnn_batch": 1e-5,
       "crnn_rerun": 1e-6}
#: phase 3e's corpus: clips (north-star width), clips a chunk, scoring workers.
#: Cut from 4 clips (two chunks) to 2 (one chunk) to make room for phase 3j:
#: the phase measures host scoring (~30-40 s a clip), not the card's work,
#: and one chunk loses only the pipelined engine's overlap of a load with a
#: dispatch, which the CPU tests hold
CORPUS_CLIPS, CORPUS_BATCH, CORPUS_WORKERS = 2, 2, 4
#: the chained lane's clips, one chunk (cut from 4 to 2 to make room for
#: phase 3i; 2 clips keep the lane batching clips across its launches)
CORPUS_CHAINED_CLIPS = 2
#: phase 3e's bounds: each clip's mean sdr_cnv over its mean sdr_in_cnv (dB); one
#: clip through enhance_rir against its batched run (out_mix, output scale; every
#: metric, dB) and against the host's plain versions (output scale; dB)
CORPUS_TOL = {"gain_db": 3.0, "single": 1e-5, "single_db": 1e-3, "host": 1e-4, "host_db": 0.01}
#: the seeds of the two canonical CRNNs' random weights (phase 3d)
CRNN_SEEDS = {"step1": 1, "step2": 2}
LW = 16128               # streaming window: 1 + LW // 256 = 64 frames = 16 refresh blocks
N_WINDOWS = 9
#: phase 4 holds windows 2 .. PLAIN_WINDOWS against the plain versions (~9 s a
#: window there; cut from 4 to 3 for phase 3m, then to 2 for phase 3p: the
#: script took 599.8-616.2 s with phase 3p); the kernels run all N_WINDOWS
PLAIN_WINDOWS = 2
#: phase 4: the windows run from the warm start through the plain versions,
#: beside the kernels' (printed, not held to a bound).  Cut from N_WINDOWS to
#: 2 to make room for phase 3j, and to 1 for phase 3m: a window of plain
#: versions takes ~9 s on the card (32 plain eigensolver calls), and the
#: first window is where the warm start's roundoff shows most
COLD_WINDOWS = 1
BLOCKS_PER_DISPATCH = 16
STREAM_SDR_FROM_S = 3.0  # the full-clip stream's SI-SDR is read after this many seconds
#: SI-SDR gain at node 0 after t s of the JAX package's ``streaming_clip_fused``
#: on the same nine windows (``exp/stream_windows_witness.py``, JAX on the CPU,
#: ``solver='jacobi'``); the port's windows are held to it within TOL["witness_db"]
JAX_WINDOWS_GAIN_DB = {1.0: -0.6723192136432736, 2.0: 0.2787509996364008,
                       3.0: 0.6841468098197936}


def scene(n_nodes, n_mics, length, seed=0, noise_scale=0.8):
    """A broadband speech-like source convolved with random short filters
    per mic, plus white noise: (y, s, n), each (K, C, L) float32."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(length)
    s = np.stack([
        np.stack([np.convolve(src, rng.standard_normal(8) * 0.5, mode="same") for _ in range(n_mics)])
        for _ in range(n_nodes)
    ]).astype(np.float32)
    n = noise_scale * rng.standard_normal((n_nodes, n_mics, length)).astype(np.float32)
    return s + n, s, n


def si_sdr(reference, estimation) -> float:
    """Scale-invariant SDR in dB of two 1-D signals, in float64, by the
    port's ``core.metrics.si_sdr_torch``."""
    import torch

    from disco_tpu_torch.core.metrics import si_sdr_torch

    return float(si_sdr_torch(*(torch.as_tensor(np.asarray(a), dtype=torch.float64)
                                for a in (reference, estimation))))


def rel_l2(a, b) -> float:
    return float((a - b).abs().pow(2).sum().sqrt() / b.abs().pow(2).sum().sqrt())


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call over ``reps`` calls, by CUDA events
    around each call.  Before each call a write of a buffer twice the
    size of the 50 MB L2 cache evicts it, so every call starts cold, as
    in the path, where each stage reads what the one before wrote."""
    import torch

    flush = torch.empty(25 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound(flops: float, nbytes: float, bf16: bool = False) -> tuple[float, str]:
    """(least time in ms, what bounds it) at the card's data-sheet peaks
    (``obs.roofline``): the operations' (float32 outside the tensor cores,
    or dense bf16 on them) and the memory's."""
    from disco_tpu_torch.obs import roofline

    peak = roofline.PEAK_BF16 if bf16 else roofline.PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / roofline.PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def short_kernel_name(mangled: str) -> str:
    """The kernel's name and template arguments out of its mangled name."""
    short = re.search(r"(stft_rfft_kernel|stft_bf16_kernel|masked_cov_kernelILb[01]ELb[01]E"
                      r"|(?:fused_mwf|eigh)_(?:thread|group)_kernelILi\d+E(?:Lb[01]E)?)", mangled)
    return short.group(1) if short else mangled


def sass_counts(lib_path) -> dict:
    """SASS instructions per kernel of the built library (``cuobjdump
    -sass``, from the toolkit of the ``nvcc`` that built it)."""
    from pathlib import Path

    from disco_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_kernel_name(m.group(1))
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def ptxas_summary(log: str) -> list[dict]:
    """Registers, spill bytes and static shared memory per compiled kernel
    from ``-Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short_kernel_name(m.group(1))
            out.append({"kernel": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and out:
            out[-1]["smem_bytes"] = int(m.group(1))
    return out


def stft_bf16_plain(x, n_fft=512, hop=256, with_mag=False):
    """The bf16 STFT kernel's plain version, with its wrapper's arguments."""
    from disco_tpu_torch.ops import stft_ops

    return stft_ops.stft_matmul(x, n_fft, hop, with_mag, precision="bf16")


@contextmanager
def plain_kernels(stft: bool = True, cov_order: bool = False):
    """Swap each kernel wrapper for its plain version, so the same path
    runs the plain PyTorch versions on the card (the reference runs of
    phases 3 and 4), in either precision lane; ``stft=False`` keeps the STFT
    kernels, so that the plain versions downstream see the kernels'
    spectra; ``cov_order=True`` sums the covariances in the kernel's order
    and arithmetic in either lane (``cov_ops._masked_cov_sliced``)."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    def cov_sliced(y, mask, precision="f32"):
        return cov_ops._masked_cov_sliced(y, mask, precision)

    saved = (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel,
             mwf_ops.fused_mwf_kernel, eigh_ops.eigh_jacobi_kernel)
    if stft:
        stft_ops.stft_kernel = stft_ops.stft_matmul
        stft_ops.stft_bf16_kernel = stft_bf16_plain
    cov_ops.masked_cov_kernel = cov_sliced if cov_order else cov_ops.masked_covariances_plain
    mwf_ops.fused_mwf_kernel = mwf_ops.fused_mwf_plain
    eigh_ops.eigh_jacobi_kernel = eigh_ops.eigh_jacobi_unsorted
    try:
        yield
    finally:
        (stft_ops.stft_kernel, stft_ops.stft_bf16_kernel, cov_ops.masked_cov_kernel,
         mwf_ops.fused_mwf_kernel, eigh_ops.eigh_jacobi_kernel) = saved


@contextmanager
def recorded_eigh_inputs():
    """The matrices the ``'jacobi-pallas'`` eigensolve is given, in call
    order (one call per eigensolver launch)."""
    from disco_tpu_torch.ops import eigh_ops

    seam, seen = eigh_ops.eigh_jacobi_pallas, []

    def record(A, sweeps=None):
        seen.append(A)
        return seam(A, sweeps)

    eigh_ops.eigh_jacobi_pallas = record
    try:
        yield seen
    finally:
        eigh_ops.eigh_jacobi_pallas = seam


@contextmanager
def recorded_kernel_inputs():
    """The arguments the covariance and fused-solve wrappers are given, in
    call order."""
    from disco_tpu_torch.ops import cov_ops, mwf_ops

    cov, mwf = cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel
    seen = {"masked_cov": [], "fused_mwf": []}

    def record_cov(y, mask, precision="f32"):
        seen["masked_cov"].append((y, mask))
        return cov(y, mask, precision)

    def record_mwf(Rss, Rnn, mu=1.0, sweeps=None, precision="f32"):
        seen["fused_mwf"].append((Rss, Rnn, mu))
        return mwf(Rss, Rnn, mu, sweeps, precision)

    # a wrapper adds to the counter of the function its module name holds:
    # while recording, the recorder's, so recorded launches count nowhere
    record_cov.launches = record_mwf.launches = 0
    record_cov.launches_bf16 = record_mwf.launches_bf16 = 0
    cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = record_cov, record_mwf
    try:
        yield seen
    finally:
        cov_ops.masked_cov_kernel, mwf_ops.fused_mwf_kernel = cov, mwf


def kernel_counters() -> dict:
    """kernel name -> (the wrapper, the attribute that counts its launches):
    the bf16 instances of the covariance and solve kernels count apart."""
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    return {"stft": (stft_ops.stft_kernel, "launches"),
            "stft_bf16": (stft_ops.stft_bf16_kernel, "launches"),
            "masked_cov": (cov_ops.masked_cov_kernel, "launches"),
            "masked_cov_bf16": (cov_ops.masked_cov_kernel, "launches_bf16"),
            "fused_mwf": (mwf_ops.fused_mwf_kernel, "launches"),
            "fused_mwf_bf16": (mwf_ops.fused_mwf_kernel, "launches_bf16"),
            "eigh_jacobi": (eigh_ops.eigh_jacobi_kernel, "launches")}


@contextmanager
def tally(label: str, out: dict):
    """Set every launch counter to 0, run the body, read the counters into
    ``out[label]``."""
    counters = kernel_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    yield
    import torch

    torch.cuda.synchronize()
    out[label] = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    print(f"launches, {label}: {out[label]}", flush=True)


@contextmanager
def counted(label: str, expected: dict, out: dict):
    """:func:`tally`, then require ``expected`` (a kernel it does not name:
    0)."""
    with tally(label, out):
        yield
    want = {name: expected.get(name, 0) for name in kernel_counters()}
    require(out[label] == want, (label, out[label], want))


def require(ok: bool, what) -> None:
    """Fail the run (a raised error, never a pass) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase1_build() -> str:
    """The card's name and power limit; build and load the kernels."""
    from disco_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})", flush=True)
    log = _build.ptxas_log()
    print("build seconds: " + json.dumps({m.group(1): float(m.group(2)) for m in re.finditer(
        r"== (\S+) \(finished within ([0-9.]+) s of the start\)", log)}), flush=True)
    print("ptxas: " + json.dumps(ptxas_summary(log)), flush=True)
    print("SASS instructions: " + json.dumps(sass_counts(_build.build_dir() / _build.LIB_NAME)),
          flush=True)
    return smi


def phase2_kernels() -> SimpleNamespace:
    """Each kernel against its plain version at the main path's shapes;
    returns the scene, the inputs of each launch and the largest errors."""
    import torch

    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.enhance.tango import others_index
    from disco_tpu_torch.ops import stft_ops

    d = SimpleNamespace(dev=torch.device("cuda"), L=int(DUR_S * FS))
    d.y_np, d.s_np, d.n_np = scene(K, C, d.L, noise_scale=NOISE_SCALE)
    d.y, d.s, d.n = (torch.from_numpy(a).to(d.dev) for a in (d.y_np, d.s_np, d.n_np))
    d.x = torch.stack([d.y, d.s, d.n])                           # (3, K, C, L)
    d.err = {}

    # the streaming window's shape (two 32-frame tiles); 300 samples, 44 more
    # than the reflect padding needs (2 frames, both reaching into the
    # reflected edges); the offline clip's (626 frames: a ragged last tile)
    d.err["stft"] = 0.0
    for label, x in (("window", d.x[..., :LW]), ("short", d.x[..., :300]), ("clip", d.x)):
        spec_k, mag_k = stft_ops.stft_kernel(x, with_mag=True)
        spec_p, mag_p = stft_ops.stft_matmul(x, with_mag=True)
        torch.cuda.synchronize()
        r = max(rel_l2(spec_k, spec_p), rel_l2(mag_k, mag_p))
        e = max(max_abs(spec_k, spec_p), max_abs(mag_k, mag_p))
        d.err["stft"] = max(d.err["stft"], e)
        print(f"phase 2: stft {label} {tuple(x.shape)} rel-l2 {r:.3e} max-abs {e:.3e}",
              flush=True)
        require(r <= TOL["stft"], ("stft", label, r))
    d.Y, d.S, d.N = spec_p[0], spec_p[1], spec_p[2]              # (K, C, F, T)
    d.m = tf_mask_mag(mag_p[1][:, 0], mag_p[2][:, 0], "irm1")    # (K, F, T)
    del spec_k, mag_k, spec_p, mag_p

    # the bf16 lane's STFT: the same shapes and the 16-clip batch's rows
    d.err["stft_bf16"] = 0.0
    for label, x in (("window", d.x[..., :LW]), ("short", d.x[..., :300]), ("clip", d.x),
                     ("batch", torch.stack(distinct_clips(d)))):
        spec_k, mag_k = stft_ops.stft_bf16_kernel(x, with_mag=True)
        spec_p, mag_p = stft_ops.stft_matmul(x, with_mag=True, precision="bf16")
        torch.cuda.synchronize()
        e = max(max_abs(spec_k, spec_p) / float(spec_p.abs().max()),
                max_abs(mag_k, mag_p) / float(mag_p.abs().max()))
        d.err["stft_bf16"] = max(d.err["stft_bf16"], max(max_abs(spec_k, spec_p),
                                                         max_abs(mag_k, mag_p)))
        print(f"phase 2: stft_bf16 {label} {tuple(x.shape)} max-abs {e:.3e} of the output "
              f"scale", flush=True)
        require(e <= TOL["stft_bf16"], ("stft_bf16", label, e))
        del spec_k, mag_k, spec_p, mag_p

    oth = torch.as_tensor(others_index(K), device=d.dev)
    d.in_y = torch.cat([d.Y, d.Y[:, 0][oth]], dim=1)             # (K, C+K-1, F, T)
    chan_m = torch.cat([d.m[:, None].expand(K, C, *d.m.shape[1:]), d.m[oth]], dim=1)
    d.pencils = {}
    d.err["masked_cov"] = 0.0
    for label, yy, mm in (("step1", d.Y, d.m), ("step2", d.in_y, d.m),
                          ("step2-chan", d.in_y, chan_m)):
        d.pencils[label] = check_cov(d, label, yy, mm)
    # the generic C <= 16 path of the solve, off the main path
    d.pencils["generic-C7"] = tuple(p[..., :7, :7].contiguous() for p in d.pencils["step2"])
    d.err["fused_mwf"] = 0.0
    for label in ("step1", "step2", "generic-C7"):
        check_mwf(d, label, *d.pencils[label])

    # the bf16 instances: shared and per-channel masks at C = 4 and 11 (the
    # per-mic step-1 masks stand in for a per-channel C = 4 stack)
    mic_m = tf_mask_mag(d.S.abs(), d.N.abs(), "irm1")            # (K, C, F, T)
    d.pencils_bf16 = {}
    d.err["masked_cov_bf16"] = d.err["fused_mwf_bf16"] = 0.0
    for label, yy, mm in (("step1", d.Y, d.m), ("step1-chan", d.Y, mic_m),
                          ("step2", d.in_y, d.m), ("step2-chan", d.in_y, chan_m)):
        d.pencils_bf16[label] = check_cov(d, label, yy, mm, "bf16")
    for label in ("step1", "step2"):
        check_mwf(d, label, *d.pencils_bf16[label], precision="bf16")

    # the launches of a 16-clip batch, as the path hands them to the kernels;
    # its clips differ, so a kernel that read another clip's bin or pencil
    # would disagree with its plain version
    with recorded_kernel_inputs() as seen:
        tango_clip_fused(*distinct_clips(d), solver="fused")
    require(len(seen["masked_cov"]) == 2 and len(seen["fused_mwf"]) == 2,
            ("kernel launches of one batched offline call", {k: len(v) for k, v in seen.items()}))
    d.batch = seen
    for label, (yy, mm) in zip(("batch step1", "batch step2"), seen["masked_cov"]):
        check_cov(d, label, yy, mm)
    for label, (Rss, Rnn, mu) in zip(("batch step1", "batch step2"), seen["fused_mwf"]):
        check_mwf(d, label, Rss, Rnn, mu)
    with recorded_kernel_inputs() as seen:
        tango_clip_fused(*distinct_clips(d), solver="fused", precision="bf16")
    require(len(seen["masked_cov"]) == 2 and len(seen["fused_mwf"]) == 2,
            ("bf16 kernel launches of one batched offline call",
             {k: len(v) for k, v in seen.items()}))
    d.batch_bf16 = seen
    for label, (yy, mm) in zip(("batch step1", "batch step2"), seen["masked_cov"]):
        check_cov(d, label, yy, mm, "bf16")
    for label, (Rss, Rnn, mu) in zip(("batch step1", "batch step2"), seen["fused_mwf"]):
        check_mwf(d, label, Rss, Rnn, mu, "bf16")
    phase2_eigh(d)
    return d


def _lane(name: str, precision: str) -> str:
    """The kernel's name in the precision lane (the bf16 instances' rows)."""
    return name + ("_bf16" if precision == "bf16" else "")


def check_cov(d: SimpleNamespace, label: str, yy, mm, precision: str = "f32"):
    """The covariance kernel of a precision lane against its plain version
    (bit for bit in the bf16 lane, whose plain version sums in the
    kernel's order), and against its own second run bit for bit; returns
    the plain version's pair."""
    import torch

    from disco_tpu_torch.ops import cov_ops

    name = _lane("masked_cov", precision)
    ks = cov_ops.masked_cov_kernel(yy, mm, precision)
    again = cov_ops.masked_cov_kernel(yy, mm, precision)
    ps = cov_ops.masked_covariances_plain(yy, mm, precision)
    torch.cuda.synchronize()
    r = max(max_rel(ks[0], ps[0]), max_rel(ks[1], ps[1]))
    e = max(max_abs(ks[0], ps[0]), max_abs(ks[1], ps[1]))
    stable = all(torch.equal(a, b) for a, b in zip(ks, again))
    bitwise = all(torch.equal(a, b) for a, b in zip(ks, ps))
    d.err[name] = max(d.err[name], e)
    print(f"phase 2: {name} {label} {tuple(yy.shape)} mask {tuple(mm.shape)} max-rel {r:.3e} "
          f"max-abs {e:.3e} bit-stable run to run {stable} bit-identical {bitwise}", flush=True)
    require(r <= TOL["masked_cov"] and stable, (name, label, r, stable))
    require(bitwise or precision == "f32", (name, label, "bit-identical", bitwise))
    return ps


def check_mwf(d: SimpleNamespace, label: str, Rss, Rnn, mu=1.0, precision: str = "f32") -> None:
    """The fused-solve kernel of a precision lane against its plain version;
    whether the two agree bit for bit is reported, and required in the
    bf16 lane."""
    import torch

    from disco_tpu_torch.ops import mwf_ops

    name = _lane("fused_mwf", precision)
    wk, tk = mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu, precision=precision)
    wp, tp = mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu, precision=precision)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(wk).all() and torch.isfinite(wp).all())
    r = max(rel_l2(wk, wp), rel_l2(tk, tp))
    e = max(max_abs(wk, wp), max_abs(tk, tp))
    bitwise = bool(torch.equal(wk, wp) and torch.equal(tk, tp))
    d.err[name] = max(d.err[name], e)
    print(f"phase 2: {name} {label} {tuple(Rss.shape)} rel-l2 {r:.3e} max-abs {e:.3e} "
          f"finite {finite} bit-identical {bitwise}", flush=True)
    require(finite and r <= TOL["fused_mwf"], (name, label, r))
    require(bitwise or precision == "f32", (name, label, "bit-identical", bitwise))


def batch_clips(d: SimpleNamespace):
    """(y, s, n) of the timed batch: the clip repeated BATCH times."""
    return tuple(a[None].expand(BATCH, *a.shape).contiguous() for a in (d.y, d.s, d.n))


def distinct_clips(d: SimpleNamespace):
    """(y, s, n) of BATCH distinct clips: clip b is the scene circularly
    shifted by b * 1237 samples (1237 b mod 256 differs for every b < 256,
    so no two clips' frames line up)."""
    import torch

    return tuple(torch.stack([torch.roll(a, b * 1237, dims=-1) for b in range(BATCH)])
                 for a in (d.y, d.s, d.n))


def phase2_eigh(d: SimpleNamespace) -> None:
    """The eigensolver kernel against its plain version: on the whitened
    matrices of the full-clip streaming run (recorded as the path hands
    them to the kernel), on the generic path, a ragged batch and a NaN
    matrix.  Eigenvalues and eigenvectors are compared as they come."""
    import torch

    from disco_tpu_torch.enhance.streaming import streaming_tango
    from disco_tpu_torch.ops import eigh_ops

    with recorded_eigh_inputs() as seen:
        streaming_tango(d.Y, d.m, d.m, solver="jacobi-pallas")
    require(len(seen) == 2, ("eigensolver launches of one streaming_tango call", len(seen)))
    d.whitened = {"step1": seen[0], "step2": seen[1]}
    D = seen[1].shape[-1]
    flat2 = seen[1].reshape(-1, D, D)
    gen = torch.Generator(device=d.dev).manual_seed(0)
    X = torch.randn((20000, 16, 16), dtype=torch.complex64, device=d.dev, generator=gen)
    C1 = seen[0].shape[-1]
    ragged = seen[0].reshape(-1, C1, C1)[:130].clone()
    ragged[7] = float("nan")
    ragged2 = flat2[:131].clone()
    ragged2[130] = float("nan")
    cases = [("step1", seen[0]), ("step2", seen[1])]
    cases += [(f"generic-C{c}", flat2[:20000, :c, :c].contiguous()) for c in (1, 2, 7)]
    cases += [("generic-C16", X @ X.mH), ("ragged-130-with-NaN", ragged),
              ("ragged-131-with-NaN", ragged2)]
    d.err["eigh_jacobi"] = 0.0
    for label, A in cases:
        c = A.shape[-1]
        lk, Vk = eigh_ops.eigh_jacobi_kernel(A)
        lp, Vp = eigh_ops.eigh_jacobi_unsorted(A)
        torch.cuda.synchronize()
        lk, lp = lk.reshape(-1, c), lp.reshape(-1, c)
        Vk, Vp = Vk.reshape(-1, c, c), Vp.reshape(-1, c, c)
        ok = torch.isfinite(A.reshape(-1, c * c)).all(-1)
        r_lam, r_V = rel_l2(lk[ok], lp[ok]), rel_l2(Vk[ok], Vp[ok])
        e = max(max_abs(lk[ok], lp[ok]), max_abs(Vk[ok], Vp[ok]))
        d.err["eigh_jacobi"] = max(d.err["eigh_jacobi"], e)
        bitwise = bool(torch.equal(lk.nan_to_num(), lp.nan_to_num())
                       and torch.equal(Vk.nan_to_num(), Vp.nan_to_num()))
        nan_pairs = bool(torch.isnan(lk[~ok]).all() and (c == 1 or torch.isnan(Vk[~ok]).all()))
        print(f"phase 2: eigh_jacobi {label} {tuple(A.shape)} eigenvalues rel-l2 {r_lam:.3e}, "
              f"eigenvectors rel-l2 {r_V:.3e}, max-abs {e:.3e}, bit-identical {bitwise}, "
              f"{int((~ok).sum())} non-finite matrices -> NaN pairs {nan_pairs}", flush=True)
        require(bitwise and nan_pairs, ("eigh", label, "bit-identical", bitwise, "NaN", nan_pairs))


def phase2_sizes(d: SimpleNamespace) -> None:
    """The port's STFT and ISTFT (``core.dsp``) at sizes the kernels do not
    compute, on the card against the same on the host: 1024/512 and 512/128
    take the rFFT route and launch no STFT kernel; 512/256 launches
    ``csrc/stft.cu`` once.  Rows of the clip stack, 1e-5 rel-l2 (the STFT)
    and 1e-5 of the output scale (the ISTFT, and its reconstruction of the
    signal)."""
    import torch

    from disco_tpu_torch.core import dsp
    from disco_tpu_torch.ops import stft_ops

    x = d.x.reshape(-1, d.L)[:8, :48000].contiguous()
    for n_fft, hop, launches in ((1024, 512, 0), (512, 128, 0), (512, 256, 1)):
        before = stft_ops.stft_kernel.launches, stft_ops.stft_bf16_kernel.launches
        spec = dsp.stft(x, n_fft, hop)
        y = dsp.istft(spec, x.shape[-1], n_fft, hop)
        torch.cuda.synchronize()
        got = (stft_ops.stft_kernel.launches - before[0],
               stft_ops.stft_bf16_kernel.launches - before[1])
        host = dsp.stft(x.cpu(), n_fft, hop)
        y_host = dsp.istft(host, x.shape[-1], n_fft, hop)
        e_spec = rel_l2(spec.cpu(), host)
        e_y, e_rec = max_rel(y.cpu(), y_host), max_rel(y.cpu(), x.cpu())
        print(f"phase 2: core.dsp stft/istft {n_fft}/{hop} on {tuple(x.shape)}: STFT kernel "
              f"launches {got}, card vs host STFT rel-l2 {e_spec:.3e}, ISTFT {e_y:.3e} of the "
              f"output scale, reconstruction {e_rec:.3e}", flush=True)
        require(got == (launches, 0), ("stft route", n_fft, hop, got))
        require(max(e_spec, e_y, e_rec) <= TOL["stft"], ("stft sizes", n_fft, hop, e_spec, e_y,
                                                         e_rec))


def phase3_offline_path(d: SimpleNamespace) -> None:
    """The offline path through its entry point, with the launch counters."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused

    with counted("offline clip", {"stft": 1, "masked_cov": 2, "fused_mwf": 2, "eigh_jacobi": 0},
                 d.launches):
        out = tango_clip_fused(d.y, d.s, d.n, solver="fused")
    require(out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "non-finite or misshapen output")
    with plain_kernels():
        ref = tango_clip_fused(d.y, d.s, d.n, solver="fused")
    torch.cuda.synchronize()
    clip_err = max_rel(out, ref)
    sdr_in = si_sdr(d.s_np[0, 0], d.y_np[0, 0])
    sdr_out = si_sdr(d.s_np[0, 0], out[0].cpu().numpy())
    print(f"phase 3: clip vs plain-version clip {clip_err:.3e} of output scale; SI-SDR node 0 "
          f"{sdr_in:.2f} -> {sdr_out:.2f} dB (gain {sdr_out - sdr_in:.2f})", flush=True)
    require(clip_err <= TOL["clip"], ("clip", clip_err))
    require(sdr_out - sdr_in > TOL["sdr_gain_db"], ("sdr gain", sdr_out - sdr_in))
    d.sdr_f32 = sdr_out
    phase3_bf16_clip(d)
    phase3_policies_and_faults(d)


def phase3_bf16_clip(d: SimpleNamespace) -> None:
    """The offline path in the bf16 lane: one clip and the 16-clip batch,
    with the launch counters, against the bf16 plain-version clip; SI-SDR
    at node 0 within 0.1 dB of the f32 lane's and +3 dB over the input.

    The lane rounds to bf16 after the STFT (the covariances' spectra) and
    after the covariances (the solve's pencils).  Where the kernels and the
    plain versions sum in other orders before such a point, a value near a
    rounding boundary lands one bf16 step (2^-8) apart, and an
    ill-conditioned bin's filter moves with it.  The covariance and solve
    kernels are bit for bit their plain versions in this lane, and the STFT
    kernel is held to its plain version in phase 2; so the clip is held
    within 1e-4 of the plain versions fed the STFT kernel's spectra, and
    against the plain versions from the signal (the STFT's order too)
    within the lane's 1e-2 rel-l2 and 0.1 dB of SI-SDR.

    Against the f32 lane: the lane of the STFT and the covariances (the
    bf16 kernels, ``solver='eigh'``, whose solve stays float32) within the
    JAX package's 0.1 dB gate (``tests/test_tango.py``); the whole lane's
    SI-SDR cost with the fused solve, whose pencils are rounded to bf16
    too, is printed: at the north-star scene's 11-channel step 2 it
    exceeds 0.1 dB in the plain versions as in the kernels, and in the
    JAX package's lane too (``exp/bf16_sdr_cost.py``, PERF.md)."""
    import torch

    from disco_tpu_torch.enhance.fused import tango_clip_fused

    with counted("offline clip bf16", {"stft_bf16": 1, "masked_cov_bf16": 2,
                                       "fused_mwf_bf16": 2}, d.launches):
        out = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    require(out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "non-finite or misshapen bf16 output")
    yb, sb, nb = batch_clips(d)
    with counted("offline batch bf16", {"stft_bf16": 1, "masked_cov_bf16": 2,
                                        "fused_mwf_bf16": 2}, d.launches):
        batch = tango_clip_fused(yb, sb, nb, solver="fused", precision="bf16")
    del yb, sb, nb
    with plain_kernels(stft=False):
        fed = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    with plain_kernels():
        ref = tango_clip_fused(d.y, d.s, d.n, solver="fused", precision="bf16")
    torch.cuda.synchronize()
    clip_err = max_rel(out, fed)
    batch_err = max(max_rel(batch[b], fed) for b in range(BATCH))
    full_err, full_l2 = max_rel(out, ref), rel_l2(out, ref)
    sdr_in = si_sdr(d.s_np[0, 0], d.y_np[0, 0])
    sdr_out = si_sdr(d.s_np[0, 0], out[0].cpu().numpy())
    sdr_ref = si_sdr(d.s_np[0, 0], ref[0].cpu().numpy())
    print(f"phase 3: bf16 clip vs the bf16 plain versions fed the STFT kernel's spectra "
          f"{clip_err:.3e} (bit-identical {bool(torch.equal(out, fed))}), every clip of the "
          f"{BATCH}-clip batch {batch_err:.3e} of output scale; vs the bf16 plain versions from "
          f"the signal {full_err:.3e} of output scale, rel-l2 {full_l2:.3e}, SI-SDR node 0 "
          f"{sdr_ref:.4f}; SI-SDR node 0 {sdr_in:.4f} -> {sdr_out:.4f} dB (f32 lane "
          f"{d.sdr_f32:.4f}, difference {sdr_out - d.sdr_f32:+.4f})", flush=True)
    require(clip_err <= TOL["clip"] and batch_err <= TOL["clip"], ("bf16 clip", clip_err,
                                                                    batch_err))
    require(full_l2 <= TOL["bf16_lane"] and abs(sdr_out - sdr_ref) <= TOL["stream_sdr_db"],
            ("bf16 clip vs the plain versions from the signal", full_l2, sdr_out, sdr_ref))
    require(sdr_out - sdr_in > TOL["sdr_gain_db"], ("bf16 sdr gain", sdr_out - sdr_in))
    with counted("offline clip bf16, solver='eigh'", {"stft_bf16": 1, "masked_cov_bf16": 2},
                 d.launches):
        cov_lane = tango_clip_fused(d.y, d.s, d.n, solver="eigh", precision="bf16")
    f32_eigh = tango_clip_fused(d.y, d.s, d.n, solver="eigh")
    sdr_cov = si_sdr(d.s_np[0, 0], cov_lane[0].cpu().numpy())
    sdr_f32_eigh = si_sdr(d.s_np[0, 0], f32_eigh[0].cpu().numpy())
    print(f"phase 3: SI-SDR node 0 against the f32 lane: the STFT and covariance lane "
          f"(solver='eigh') {sdr_cov:.4f} vs {sdr_f32_eigh:.4f} dB (difference "
          f"{sdr_cov - sdr_f32_eigh:+.4f}); the whole lane with the fused solve {sdr_out:.4f} vs "
          f"{d.sdr_f32:.4f} dB (difference {sdr_out - d.sdr_f32:+.4f})", flush=True)
    require(abs(sdr_cov - sdr_f32_eigh) <= TOL["stream_sdr_db"],
            ("bf16 covariance lane vs f32 SI-SDR", sdr_cov, sdr_f32_eigh))


def phase3_policies_and_faults(d: SimpleNamespace) -> None:
    """``tango`` on the clip's spectra under the three policies that
    substitute other signals for z, and with a (K, K) link mask and a NaN
    node, each against its plain-version run."""
    import torch

    from disco_tpu_torch.enhance.tango import tango

    zm = np.ones((K, K), np.float32)
    zm[0, 1] = zm[3, 5] = zm[7, 0] = 0.0        # three dead links
    z_nan = np.zeros(K)
    z_nan[6] = 1                                 # node 6's streams corrupted
    cases = [(p, dict(policy=p), {"masked_cov": 1, "fused_mwf": 2})
             for p in ("compressed", "use_oracle_refs", "use_oracle_zs")]
    cases.append(("local, (K, K) z_mask and a NaN node", dict(z_mask=zm, z_nan=z_nan),
                  {"masked_cov": 2, "fused_mwf": 2}))
    for label, kw, launches in cases:
        with counted(f"tango {label}", launches, d.launches):
            res = tango(d.Y, d.S, d.N, d.m, d.m, solver="fused", **kw)
        with plain_kernels():
            ref = tango(d.Y, d.S, d.N, d.m, d.m, solver="fused", **kw)
        torch.cuda.synchronize()
        err = max(max_rel(getattr(res, f), getattr(ref, f)) for f in ("yf", "sf", "nf"))
        finite = bool(torch.isfinite(res.yf).all())
        print(f"phase 3: tango {label}: vs its plain-version run {err:.3e} of output scale, "
              f"finite {finite}", flush=True)
        require(finite and err <= TOL["clip"], ("tango", label, err, finite))


def seeded_crnn_variables(n_ch: int, seed: int) -> dict:
    """The variable tree of the JAX package's canonical CRNN
    (``CRNN(input_shape=(n_ch, 21, 257))``: ``params``/``batch_stats`` of
    ``CNN2d_0`` (three Conv/BatchNorm pairs), ``RNN_0/GRUCell_0`` and
    ``FF_0/Dense_0``) drawn from a seeded numpy generator: kernels at the
    scale of flax's default initializer (variance 1/fan_in), biases and
    BatchNorm shifts and means N(0, 0.1), scales 1 + N(0, 0.1), variances in
    [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def kernel(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def small(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    cnn, stats = {}, {}
    chans = (n_ch, 32, 64, 64)
    for i in range(3):
        c = chans[i + 1]
        cnn[f"Conv_{i}"] = {"kernel": kernel(3, 3, chans[i], c), "bias": small(c)}
        cnn[f"BatchNorm_{i}"] = {"scale": small(c, 1.0), "bias": small(c)}
        stats[f"BatchNorm_{i}"] = {"mean": small(c),
                                   "var": (0.5 + rng.random(c)).astype(np.float32)}
    gru = {g: {"kernel": kernel(256, 256), "bias": small(256)} for g in ("ir", "iz", "in", "hn")}
    gru.update({g: {"kernel": kernel(256, 256)} for g in ("hr", "hz")})
    return {"params": {"CNN2d_0": cnn, "RNN_0": {"GRUCell_0": gru},
                       "FF_0": {"Dense_0": {"kernel": kernel(256, 257), "bias": small(257)}}},
            "batch_stats": {"CNN2d_0": stats}}


def canonical_crnn(n_ch: int, seed: int, device):
    """The port's canonical CRNN holding :func:`seeded_crnn_variables`,
    loaded through ``nn.convert``, on ``device``."""
    from disco_tpu_torch.nn.convert import state_dict_from_flax
    from disco_tpu_torch.nn.crnn import build_crnn

    model = build_crnn(n_ch=n_ch)
    model.load_state_dict(state_dict_from_flax(seeded_crnn_variables(n_ch, seed), model))
    return model.to(device).eval()


def phase3d_crnn_masked_clip(d: SimpleNamespace) -> None:
    """The CRNN-masked offline path on the north-star clip, with two
    canonical CRNNs of seeded random weights (step 1 on the reference mic,
    ``n_ch = 1``; step 2 on it and the other nodes' z_y, ``n_ch = K``):
    ``stft_with_mag`` of the [y, s, n] stack → ``estimate_masks`` →
    ``tango(solver='fused')`` → ISTFT."""
    import torch

    from unittest import mock

    from disco_tpu_torch.core.dsp import istft, stft
    from disco_tpu_torch.enhance import inference
    from disco_tpu_torch.enhance.driver import _batched_masks, _z_for_mask_device, estimate_masks
    from disco_tpu_torch.enhance.tango import tango
    from disco_tpu_torch.enhance.zexport import compute_z_signals
    from disco_tpu_torch.ops.stft_ops import stft_with_mag

    t0 = time.perf_counter()
    d.crnn = [canonical_crnn(1, CRNN_SEEDS["step1"], d.dev),
              canonical_crnn(K, CRNN_SEEDS["step2"], d.dev)]
    with counted("crnn-masked clip", {"stft": 1, "masked_cov": 3, "fused_mwf": 2}, d.launches):
        spec, mag = stft_with_mag(d.x)
        Y = spec[0]
        masks_z, mask_w = estimate_masks(Y, spec[1], spec[2], d.crnn, "irm1", K, z_sigs="zs_hat",
                                         mags=(mag[1], mag[2]))
        out = istft(tango(Y, spec[1], spec[2], masks_z, mask_w, solver="fused").yf, d.L)
    masks = torch.stack([masks_z, mask_w])
    in_range = bool(torch.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1)
    print(f"phase 3d: masks finite and in [0, 1]: {in_range}; step-1 mean {float(masks_z.mean())} "
          f"std {float(masks_z.std())}, step-2 mean {float(mask_w.mean())} std "
          f"{float(mask_w.std())}", flush=True)
    require(in_range and out.shape == (K, d.L) and bool(torch.isfinite(out).all()),
            "crnn-masked clip: masks out of [0, 1] or a non-finite clip")

    # The same clip through the plain versions, fed the same masks and the
    # STFT kernel's spectra (the STFT kernel is held to its plain version in
    # phase 2), the covariances summed in the kernel's order and arithmetic
    # (``_masked_cov_sliced``): the untrained CRNNs' masks (~0.5 +- 0.17)
    # leave the GEVD pencils near-degenerate, and two plain formulations of
    # the STFT or of the covariances move this clip by more than 1e-4 of its
    # scale (exp/crnn_clip_witness.py).  The distance to the plain versions
    # from the signal is reported.
    with plain_kernels(stft=False, cov_order=True):
        ref = istft(tango(Y, spec[1], spec[2], masks_z, mask_w, solver="fused").yf, d.L)
    with plain_kernels():
        spec_p, _ = stft_with_mag(d.x)
        ref_p = istft(tango(spec_p[0], spec_p[1], spec_p[2], masks_z, mask_w, solver="fused").yf,
                      d.L)
    clip_err, full_err = max_rel(out, ref), max_rel(out, ref_p)
    print(f"phase 3d: CRNN-masked clip vs the plain versions fed the same masks and the STFT "
          f"kernel's spectra, the covariances in the kernel's order: {clip_err:.3e} of output "
          f"scale (bit-identical {bool(torch.equal(out, ref))}); vs the plain versions from the "
          f"signal {full_err:.3e}; SI-SDR node 0 {si_sdr(d.s_np[0, 0], d.y_np[0, 0]):.2f} -> "
          f"{si_sdr(d.s_np[0, 0], out[0].cpu().numpy()):.2f} dB", flush=True)
    require(clip_err <= TOL["clip"], ("crnn-masked clip", clip_err))
    del ref, ref_p, spec_p

    # the card's CRNNs against the same modules on the host, on the same inputs
    zs = _z_for_mask_device(*(compute_z_signals(None, None, None, Y=Y, masks_z=masks_z)[k]
                              for k in ("z_y", "zn")), K, "zs_hat")
    host = [canonical_crnn(1, CRNN_SEEDS["step1"], "cpu"),
            canonical_crnn(K, CRNN_SEEDS["step2"], "cpu")]
    card_w = inference.crnn_masks_batched(Y[:, 0], d.crnn[1], zs=zs)
    host_z = inference.crnn_masks_batched(Y[:, 0].cpu(), host[0], device="cpu")
    host_w = inference.crnn_masks_batched(Y[:, 0].cpu(), host[1], zs=zs.cpu(), device="cpu")
    host_err = max(max_abs(masks_z.cpu(), host_z), max_abs(card_w.cpu(), host_w))
    print(f"phase 3d: card CRNN masks vs the host's on the same spectra and weights: max-abs "
          f"{host_err:.3e} (step 2 recomputed from the same z: {max_abs(card_w, mask_w):.3e} from "
          f"the path's)", flush=True)
    require(host_err <= TOL["crnn_host"], ("crnn card vs host", host_err))

    # the stream route (convs hoisted) against the per-window route, on the card
    with mock.patch.object(inference, "_conv_stream_safe", lambda model: False):
        window_w = inference.crnn_masks_batched(Y[:, 0], d.crnn[1], zs=zs)
    route_err = max_abs(card_w, window_w)
    print(f"phase 3d: stream route vs per-window route (step 2, {K} streams): max-abs "
          f"{route_err:.3e}", flush=True)
    require(route_err <= TOL["crnn_route"], ("crnn routes", route_err))
    del window_w

    # a second card run of the mask stage
    again = estimate_masks(Y, None, None, d.crnn, "irm1", K, z_sigs="zs_hat")
    identical = all(torch.equal(a, b) for a, b in zip(again, (masks_z, mask_w)))
    rerun_err = max(max_abs(a, b) for a, b in zip(again, (masks_z, mask_w)))
    print(f"phase 3d: second card run of the masks: bit-identical {identical}, max-abs "
          f"{rerun_err:.3e}", flush=True)
    require(rerun_err <= TOL["crnn_rerun"], ("crnn rerun", rerun_err))

    # the 16 distinct clips as one batch against each clip alone
    d.crnn_batch = tuple(stft(a) for a in distinct_clips(d))           # (B, K, C, F, T) each
    Mz, Mw = _batched_masks(*d.crnn_batch, d.crnn, "irm1", 1.0, K, "zs_hat")
    batch_err = 0.0
    for b in range(BATCH):
        mz, mw = estimate_masks(d.crnn_batch[0][b], None, None, d.crnn, "irm1", K)
        batch_err = max(batch_err, max_abs(Mz[b], mz), max_abs(Mw[b], mw))
    print(f"phase 3d: _batched_masks on {BATCH} distinct clips vs each clip's estimate_masks: "
          f"max-abs {batch_err:.3e}; phase 3d took {time.perf_counter() - t0:.1f} s", flush=True)
    require(batch_err <= TOL["crnn_batch"], ("crnn batch vs clips", batch_err))


@contextmanager
def corpus_timers(out: dict):
    """Time the corpus driver's parts on the host clock, in the run itself:
    ``load_s`` each clip's ``load_input_signals`` (on the prefetch thread),
    ``wait_s`` each chunk's wait for its queued launches and ``readback_s``
    its fetch (the six ISTFTs and the one copy; the chained lane's ISTFTs
    ran in its launches), ``score_s`` each clip's ``_persist_and_score`` (on
    the scoring workers); ``stall_ms`` each chunk's prefetch stall as the
    engine notes it (``pipeline.note_chunk_overlap``)."""
    import torch

    from disco_tpu_torch.enhance import driver

    real = {name: getattr(driver, name) for name in
            ("load_input_signals", "fetch_chunk_host", "fetch_chained_host", "_persist_and_score",
             "note_chunk_overlap")}
    for key in ("load_s", "wait_s", "readback_s", "score_s", "stall_ms"):
        out[key] = []

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            out[key].append(time.perf_counter() - t0)
            return r
        return wrapper

    def fetch(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            out["wait_s"].append(time.perf_counter() - t0)
            return timed("readback_s", fn)(*args, **kw)
        return wrapper

    driver.load_input_signals = timed("load_s", real["load_input_signals"])
    driver.fetch_chunk_host = fetch(real["fetch_chunk_host"])
    driver.fetch_chained_host = fetch(real["fetch_chained_host"])
    driver._persist_and_score = timed("score_s", real["_persist_and_score"])

    def note_overlap(stall_s, busy_s):
        out["stall_ms"].append(stall_s * 1e3)
        return real["note_chunk_overlap"](stall_s, busy_s)

    driver.note_chunk_overlap = note_overlap
    try:
        yield out
    finally:
        for name, fn in real.items():
            setattr(driver, name, fn)


def check_corpus_run(label: str, res: dict, out, ledger, rirs) -> None:
    """One corpus run's results: every clip done in the ledger, every
    artifact valid, the JAX package's result schema in float64, each clip's
    mean sdr_cnv more than CORPUS_TOL["gain_db"] over its mean sdr_in_cnv."""
    from disco_tpu_torch.enhance import driver
    from disco_tpu_torch.io.atomic import probe_artifact
    from disco_tpu_torch.runs.check import NOISE, SNR_RANGE
    from disco_tpu_torch.runs.ledger import RunLedger, unit_rir

    done, requeued = RunLedger(ledger).verified_done()
    require(set(res) == set(rirs) and not requeued
            and done == {unit_rir(r, NOISE) for r in rirs}, (label, "ledger", sorted(res)))
    paths = [p for r in rirs for p in driver.clip_artifacts(out, r, NOISE, SNR_RANGE, K)]
    bad = [str(p) for p in paths if not probe_artifact(p)]
    require(not bad, (label, "invalid artifacts", bad[:5]))
    keys = {"snr_in_raw", *driver._NODE_METRIC_KEYS}
    require(all(set(v) == keys and all(isinstance(a, np.ndarray) and a.dtype == np.float64
                                       and a.shape == (K,) for a in v.values())
                for v in res.values()), (label, "result schema"))
    gains = [float(np.mean(v["sdr_cnv"]) - np.mean(v["sdr_in_cnv"])) for v in res.values()]
    print(f"phase 3e: {label}: {len(rirs)} clips done in the ledger, {len(paths)} artifacts "
          f"valid; mean sdr_cnv over mean sdr_in_cnv per clip min {min(gains):.2f}, max "
          f"{max(gains):.2f} dB", flush=True)
    require(min(gains) > CORPUS_TOL["gain_db"], (label, "gain", min(gains)))


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@contextmanager
def armed(log, dump_dir):
    """The recorder (and with it the finiteness sentinels) and the flight
    ring armed for the block."""
    from disco_tpu_torch import obs

    obs.flight.enable(dump_dir=dump_dir)
    try:
        with obs.recording(log):
            yield
    finally:
        obs.flight.disable()


def check_corpus_events(log, before: dict, after: dict, rirs, n_chunks: int) -> None:
    """Phase 3e's recorded run, read back through ``read_events`` (schema-
    validated): each clip's spans and ``clip`` event, one ``chunk_readback``
    span and one ``device_get_batches`` a chunk, ``clips_enhanced`` equal to
    the clips, one sentinel check a clip (the batched engine checks
    ``istft_out`` only, as the JAX package's does) and no trip."""
    from disco_tpu_torch import obs

    events = obs.read_events(log)
    spans = {r: [e["stage"] for e in events if e["kind"] == "stage_end"
                 and e["attrs"].get("rir") == r] for r in rirs}
    chunk = {name: sum(e["kind"] == "stage_end" and e["stage"] == name for e in events)
             for name in ("chunk_load", "chunk_enhance", "chunk_readback", "chunk_pipeline")}
    delta = {k: after[k] - before.get(k, 0) for k in
             ("device_get_batches", "chunk_readbacks", "clips_enhanced", "sentinel_checks",
              "sentinel_trips")}
    clips = sorted(e["attrs"]["rir"] for e in events if e["kind"] == "clip")
    print(f"phase 3e: staged lane recorded with the sentinels and the flight ring armed: "
          f"{len(events)} events; spans a clip {spans}; chunk spans {chunk}; counters "
          f"{delta}; clip events {clips}", flush=True)
    require(all(v == ["score_persist"] for v in spans.values()) and clips == sorted(rirs),
            ("clip spans", spans, clips))
    require(all(v == n_chunks for v in chunk.values()), ("chunk spans", chunk))
    require(delta == {"device_get_batches": n_chunks, "chunk_readbacks": n_chunks,
                      "clips_enhanced": len(rirs), "sentinel_checks": len(rirs),
                      "sentinel_trips": 0}, ("corpus counters", delta))


def _metric_diff(a: dict, b: dict) -> float:
    """Largest |a[k] - b[k]| over every key and node (dB), NaN-safe."""
    return max(float(np.nanmax(np.abs(a[k] - b[k]))) for k in b)


def phase3e_corpus(d: SimpleNamespace) -> None:
    """The corpus driver at the north-star width: an 8-clip corpus through
    ``enhance_rirs_batched`` in the staged and the chained lane, one clip
    through ``enhance_rir`` against its batched run and the host, the
    engines against each other, the streaming lane and the z export."""
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.enhance import driver
    from disco_tpu_torch.enhance.zexport import export_z
    from disco_tpu_torch.io.audio import read_wav
    from disco_tpu_torch.runs.check import NOISE, SNR_RANGE, _mini_corpus

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    rirs = tuple(range(11001, 11001 + CORPUS_CLIPS))
    common = {"snr_range": SNR_RANGE, "n_nodes": K, "mics_per_node": C}
    d.corpus = {}
    with tempfile.TemporaryDirectory(prefix="corpus-", dir=build) as tmp:
        tmp = Path(tmp)
        corpus = tmp / "corpus"
        t0 = time.perf_counter()
        _mini_corpus(corpus, rirs=rirs, n_nodes=K, mics_per_node=C, seconds=DUR_S)
        print(f"phase 3e: corpus of {len(rirs)} clips ({K} nodes x {C} mics x {DUR_S} s) written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        def batched(out, clips, **kw):
            return driver.enhance_rirs_batched(str(corpus), "living", list(clips), NOISE,
                                               out_root=str(out), **common, **kw)

        # (1), (2): the two offline lanes, timed by part: the staged lane in
        # two chunks, the chained lane on CORPUS_CHAINED_CLIPS (one chunk)
        lanes = {"staged": ({}, {"stft": 1, "masked_cov": 2}, rirs),
                 "chained": ({"chained": True}, {"stft": 1, "masked_cov": 2, "fused_mwf": 2},
                             rirs[:CORPUS_CHAINED_CLIPS])}
        # The staged lane runs recorded, with the sentinels and the flight
        # ring armed; the sequential engine run of (4) stays unrecorded, so
        # its byte-identity shows that observing changes nothing on the card
        from contextlib import nullcontext

        from disco_tpu_torch import obs

        results = {}
        for lane, (kw, per_chunk, clips) in lanes.items():
            n_chunks = -(-len(clips) // CORPUS_BATCH)
            times = {"clips": len(clips)}
            observe = lane == "staged"
            before = obs.REGISTRY.snapshot()["counters"]
            with corpus_timers(times), counted(f"corpus {lane}", {
                    k: v * n_chunks for k, v in per_chunk.items()}, d.launches), (
                    armed(tmp / "events.jsonl", tmp / "flight") if observe else nullcontext()):
                t0 = time.perf_counter()
                results[lane] = batched(tmp / lane, clips, max_batch=CORPUS_BATCH,
                                        score_workers=CORPUS_WORKERS,
                                        ledger=tmp / f"{lane}.jsonl", **kw)
                torch.cuda.synchronize()
                times["wall_s"] = time.perf_counter() - t0
            check_corpus_run(f"{lane} lane ({times['wall_s']:.1f} s)", results[lane], tmp / lane,
                             tmp / f"{lane}.jsonl", clips)
            if observe:
                check_corpus_events(tmp / "events.jsonl", before,
                                    obs.REGISTRY.snapshot()["counters"], clips, n_chunks)
            d.corpus[lane] = times

        # (3): one clip through enhance_rir on the card and on the host
        rir0 = rirs[0]
        t0 = time.perf_counter()
        with counted("corpus one clip", {"stft": 1, "masked_cov": 2}, d.launches):
            single = driver.enhance_rir(str(corpus), "living", rir0, NOISE,
                                        out_root=str(tmp / "single"), bucket=8192, **common)
        t1 = time.perf_counter()
        host = driver.enhance_rir(str(corpus), "living", rir0, NOISE, out_root=str(tmp / "host"),
                                  bucket=8192, device="cpu", **common)
        t2 = time.perf_counter()

        def wav_err(tree):
            errs = []
            for k in range(K):
                rel = Path("WAV") / str(rir0) / f"out_mix-{NOISE}_Node-{k + 1}.wav"
                a, b = read_wav(tree / rel)[0], read_wav(tmp / "staged" / rel)[0]
                errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
            return max(errs)

        e_single, e_host = wav_err(tmp / "single"), wav_err(tmp / "host")
        m_single = _metric_diff(single, results["staged"][rir0])
        m_host = _metric_diff(host, results["staged"][rir0])
        print(f"phase 3e: clip {rir0} through enhance_rir on the card vs its batched run: out_mix "
              f"{e_single:.3e} of output scale, metrics within {m_single:.3e} dB; through the "
              f"plain versions on the host: {e_host:.3e}, {m_host:.3e} dB ({t1 - t0:.1f} s on the "
              f"card, {t2 - t1:.1f} s on the host)", flush=True)
        require(e_single <= CORPUS_TOL["single"] and m_single <= CORPUS_TOL["single_db"],
                ("enhance_rir vs batched", e_single, m_single))
        require(e_host <= CORPUS_TOL["host"] and m_host <= CORPUS_TOL["host_db"],
                ("enhance_rir on the host", e_host, m_host))

        # (4): the engines on two clips write byte-identical trees: the
        # staged lane's recorded pipelined chunk above against a sequential,
        # unrecorded run with the same scoring workers (scoring is host
        # numpy; the CPU tests hold inline scoring against the workers).
        # The sequential twin runs the driver's mesh lane on a (batch 1,
        # node 1) mesh of a 1-rank NCCL world (phase 3m's), so the same
        # files and scores also hold the mesh lane to the meshless run
        from disco_tpu_torch.parallel import make_mesh, single_rank_world

        t0 = time.perf_counter()
        with single_rank_world("cuda"), counted(
                "corpus sequential (unrecorded, 1-rank mesh)", lanes["staged"][1], d.launches):
            seq = batched(tmp / "sequential", rirs[:CORPUS_BATCH], max_batch=CORPUS_BATCH,
                          pipeline=False, score_workers=CORPUS_WORKERS,
                          mesh=make_mesh(device="cuda"))
        seq_tree = _tree(tmp / "sequential")
        pipe_tree = {str(p.relative_to(tmp / "staged")): p.read_bytes()
                     for r in rirs[:CORPUS_BATCH]
                     for p in driver.clip_artifacts(tmp / "staged", r, NOISE, SNR_RANGE, K)}
        same = seq_tree == pipe_tree
        scores = set(seq) == set(rirs[:CORPUS_BATCH]) and all(
            np.array_equal(seq[r][k], results["staged"][r][k]) for r in seq for k in seq[r])
        seq_launches = d.launches["corpus sequential (unrecorded, 1-rank mesh)"]
        print(f"phase 3e: sequential engine on the 1-rank mesh on {CORPUS_BATCH} clips, "
              f"unrecorded, vs the staged lane's recorded pipelined meshless chunk "
              f"({CORPUS_WORKERS} scoring workers each): {len(seq_tree)} files, trees "
              f"byte-identical {same}, scores equal {scores}, launches equal "
              f"{seq_launches == d.launches['corpus staged']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        require(same and scores and len(seq_tree) == CORPUS_BATCH * (2 + 10 * K),
                "engine trees differ")

        # (5): the streaming lane with the eigensolver kernel
        t0 = time.perf_counter()
        with counted("corpus streaming clip", {"stft": 1, "eigh_jacobi": 2}, d.launches):
            stream = driver.enhance_rir(str(corpus), "living", rir0, NOISE,
                                        out_root=str(tmp / "stream"), streaming=True,
                                        solver="jacobi-pallas", **common)
        outs = [read_wav(p)[0] for p in (tmp / "stream" / "WAV" / str(rir0)).glob("out_*.wav")]
        finite = len(outs) == 3 * K and all(np.isfinite(o).all() for o in outs) and all(
            np.isfinite(v).all() for v in stream.values())
        s_out, s_in = float(np.mean(stream["sdr_cnv"])), float(np.mean(stream["sdr_in_cnv"]))
        print(f"phase 3e: streaming clip {rir0} (jacobi-pallas): finite {finite}; mean sdr_cnv "
              f"{s_out:.2f} dB over mean sdr_in_cnv {s_in:.2f} dB ({time.perf_counter() - t0:.1f} "
              f"s)", flush=True)
        require(finite and s_out > s_in, ("streaming clip", finite, s_out, s_in))

        # (6): the z export of one clip
        with counted("corpus export_z", {"stft": 3, "masked_cov": 1}, d.launches):
            require(export_z(str(corpus), "living", rir0, NOISE, **common), "export_z did nothing")
        zfiles = sorted((corpus / "living" / "test" / "stft_z").rglob("*.npy"))
        zfinite = len(zfiles) == 4 * K and all(np.isfinite(np.load(p)).all() for p in zfiles)
        print(f"phase 3e: export_z wrote {len(zfiles)} files, all finite {zfinite}", flush=True)
        require(zfinite, "export_z files")

        # one loaded chunk of the staged lane, kept for phase 5's device times
        sigs = [driver.load_input_signals(driver.DatasetLayout(str(corpus), "living", "test"),
                                          r, NOISE, SNR_RANGE, K, C)
                for r in rirs[:CORPUS_BATCH]]
        d.corpus_chunk = tuple(np.stack([s[i] for s in sigs]) for i in range(3))
    print(f"phase 3e took {time.perf_counter() - t_phase:.1f} s (corpus deleted)", flush=True)


def phase5_corpus(d: SimpleNamespace) -> None:
    """Corpus clips per wall-second of phase 3e's two lane runs, and their
    split: load a clip; the launches of one loaded chunk already on the
    card and with its host-to-card copy (CUDA events, median of 5); each
    chunk's prefetch stall, wait and readback; scoring a clip."""
    import torch

    from disco_tpu_torch.enhance.driver import make_batch_runners
    from disco_tpu_torch.ops.stft_ops import stft_fused

    host_chunk = d.corpus_chunk
    card_chunk = [torch.as_tensor(a, device=d.dev) for a in host_chunk]
    for lane, times in d.corpus.items():
        chained = lane == "chained"
        runner = make_batch_runners(chained=chained, solver="fused" if chained else "power")[0]

        def launches(chunk):
            x = torch.stack([torch.as_tensor(a, device=d.dev) for a in chunk])
            if chained:
                return runner(x[0], x[1], x[2])
            spec = stft_fused(x)
            del x
            return runner(spec[0], spec[1], spec[2])

        runs = {}
        for label, chunk in (("device", card_chunk), ("dispatch", host_chunk)):
            launches(chunk)  # warm-up
            runs[label] = sorted(time_ms(lambda: launches(chunk), reps=1, warmup=0)
                                 for _ in range(5))
        n = times["clips"]
        split = {
            "clips": n, "wall_s": times["wall_s"], "clips_per_s": n / times["wall_s"],
            "load_s_per_clip": sum(times["load_s"]) / len(times["load_s"]),
            "chunk_clips": CORPUS_BATCH,
            "device_ms_per_chunk": runs["device"][2], "device_ms_runs": runs["device"],
            "dispatch_ms_per_chunk": runs["dispatch"][2], "dispatch_ms_runs": runs["dispatch"],
            "prefetch_stall_ms_per_chunk": times["stall_ms"],
            "wait_s_per_chunk": times["wait_s"],
            "readback_s_per_chunk": times["readback_s"],
            "score_s_per_clip": sum(times["score_s"]) / len(times["score_s"]),
            "score_s_max": max(times["score_s"]), "score_s_total": sum(times["score_s"]),
            "score_workers": CORPUS_WORKERS,
        }
        print(f"phase 5: corpus, {lane} lane: {n} clips in {times['wall_s']:.2f} s = "
              f"{split['clips_per_s']} corpus clips per wall-second; split " + json.dumps(split),
              flush=True)
    del d.corpus_chunk, card_chunk


#: phase 3f: the training corpus's RIRs (ids 1-8 are the train split), the
#: epochs of the full run, the windows of a batch (TrainConfig.batch_size)
TRAIN_RIRS, TRAIN_EPOCHS, TRAIN_BATCH = tuple(range(1, 9)), 3, 500
#: phase 3f's bounds: the card's STFT files against the host's plain STFT
#: (max-abs over the STFT's scale) and its masks against the host's mask of
#: the same spectra (max-abs); one train step on the card against the host
#: (loss relative, parameters and nu absolute, BatchNorm statistics element
#: by element relative to themselves plus their conditioning), and on each
#: device nu element by element against (1 - decay) g^2 of its own gradient
#: (relative); the bf16 lane's first loss against the f32 lane's (relative);
#: a max-pool window where the host's choice differs from the card's: the
#: two elements' distance over the pool input's largest magnitude
TRAIN_TOL = {"stft": 1e-5, "mask": 1e-6, "loss": 1e-5, "params": 1e-4, "nu": 1e-6,
             "stats": 1e-5, "bf16": 2e-2, "tie": 1e-5}
#: phase 3f's timed fits: runs, epochs a run, passes over the windows an epoch
FIT_RUNS, FIT_EPOCHS, FIT_PASSES = 4, 2, 8
#: the seed of the canonical CRNN's initial weights (phase 3f)
TRAIN_SEED = 3


class Passes:
    """``passes`` copies of a dataset's windows as one dataset: an epoch of
    several passes, shuffled together, for fits long enough to time."""

    def __init__(self, dataset, passes: int):
        self.dataset, self.passes = dataset, passes

    def __len__(self) -> int:
        return self.passes * len(self.dataset)

    def __getitem__(self, item):
        return self.dataset[item % len(self.dataset)]


class EpochBatches:
    """The batches of one dataset for ``fit``: epoch e shuffles and draws
    its windows (``passes`` times each) from generators seeded by (seed, e),
    so a resumed run gets the batches of the epochs it runs
    (``set_start_epoch``)."""

    def __init__(self, dataset, seed: int, passes: int = 1):
        self.dataset, self.seed, self.epoch, self.passes = dataset, seed, 0, passes

    def set_start_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self):
        from disco_tpu_torch.nn.data import batch_iterator

        e, self.epoch = self.epoch, self.epoch + 1
        self.dataset.rng = np.random.default_rng([self.seed, e, 1])
        windows = self.dataset if self.passes == 1 else Passes(self.dataset, self.passes)
        return batch_iterator(windows, TRAIN_BATCH, rng=np.random.default_rng([self.seed, e, 2]))


def training_corpus(root) -> None:
    """The DISCO training geometry that ``PostGenerator`` and
    ``DiscoDataset`` hard-code: 4 nodes x 4 mics, 11-s clips at 16 kHz,
    RIRs 1-8, as the convolved images ``wav_original/cnv/{target,noise}/
    {rir}_S-*_Ch-*.wav``.  Each mic gets a white source through its own
    random 8-tap filter, plus white ``ssn`` noise (seeded as
    ``runs.check._mini_corpus``)."""
    from disco_tpu_torch.io.atomic import write_wav_atomic

    rng = np.random.default_rng(7)
    base = root / "random" / "train" / "wav_original" / "cnv"
    n = 11 * FS
    for rir in TRAIN_RIRS:
        src = 0.2 * rng.standard_normal(n)
        for ch in range(1, 17):
            write_wav_atomic(base / "target" / f"{rir}_S-1_Ch-{ch}.wav",
                             np.convolve(src, rng.standard_normal(8) * 0.5, mode="same"), FS)
            write_wav_atomic(base / "noise" / f"{rir}_S-2_ssn_Ch-{ch}.wav",
                             0.1 * rng.standard_normal(n), FS)


def canonical_train_state(n_ch: int, seed: int = TRAIN_SEED, device="cuda"):
    """The canonical CRNN (conv 32/64/64, GRU 256, FF 257) for ``n_ch``
    input channels, initialized from ``seed``, with its RMSprop."""
    import torch

    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state

    torch.manual_seed(seed)
    model = build_crnn(n_ch=n_ch).to(device)
    return model, create_train_state(model, build_optimizer(model))


@contextmanager
def pool_choices(model, record=None, replay=None, ties=None):
    """Forward hooks on the CRNN's max pools.  With ``record`` (a list),
    append each pool's choices (``max_pool2d``'s argmax indices of its
    input); the pool's output is untouched.  With ``replay`` (such a list),
    each pool's output is its input gathered at those indices, so the
    gradient goes where they say, and ``ties`` gets, per pool, the windows,
    the windows where the pool's own choice differs (``flips``), the
    largest distance there between its own maximum and the element it was
    given (``gap_max``), and the pool input's largest magnitude
    (``scale``)."""
    import torch.nn.functional as F

    def hook(mod, inp, out, i):
        x = inp[0]
        own, idx = F.max_pool2d(x.detach(), mod.kernel_size, mod.stride, return_indices=True)
        if record is not None:
            record.append(idx.cpu())
        if replay is None:
            return None
        want = replay[i].to(x.device)
        got = x.flatten(2).gather(2, want.flatten(2)).view(out.shape)
        flips = idx != want
        gap = (own - got.detach())[flips]
        ties.append({"pool": i, "windows": int(idx.numel()), "flips": int(flips.sum()),
                     "gap_max": float(gap.max()) if gap.numel() else 0.0,
                     "scale": float(x.detach().abs().max())})
        return got

    handles = [pool.register_forward_hook(lambda m, a, o, i=i: hook(m, a, o, i))
               for i, pool in enumerate(model.cnn.pools)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def phase3f_training(d: SimpleNamespace) -> None:
    """The training path at full width: convolved WAVs → ``PostGenerator``
    → ``export_z`` → ``get_input_lists`` → ``DiscoDataset`` → ``fit`` of
    the canonical n_ch = 4 CRNN at batch 500, resume, the card's step
    against the host's, the bf16 lane."""
    import copy
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.core.masks import tf_mask
    from disco_tpu_torch.datagen.postgen import PostGenerator
    from disco_tpu_torch.enhance import pipeline
    from disco_tpu_torch.enhance.zexport import export_z
    from disco_tpu_torch.io.audio import read_wav
    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.nn import serialization
    from disco_tpu_torch.nn.data import DiscoDataset, get_input_lists
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, fit, make_step_fns
    from disco_tpu_torch.ops.stft_ops import stft_matmul

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    snr = [0, 6]
    with tempfile.TemporaryDirectory(prefix="train-", dir=build) as tmp:
        tmp = Path(tmp)
        root = tmp / "corpus"
        t0 = time.perf_counter()
        training_corpus(root)
        t_corpus = time.perf_counter() - t0

        # (2) the mixing pass on the card: 3 STFT launches an RIR
        t0 = time.perf_counter()
        with counted("train postgen", {"stft": 3 * len(TRAIN_RIRS)}, d.launches):
            pg = PostGenerator(TRAIN_RIRS[0], len(TRAIN_RIRS), "random", "ssn", snr, str(root),
                               rng=np.random.default_rng(0))
            require(pg.post_process() == list(TRAIN_RIRS), "PostGenerator skipped RIRs")
        t_postgen = time.perf_counter() - t0
        lay = DatasetLayout(str(root), "random", "train")
        rir = TRAIN_RIRS[0]
        e_stft, e_mask = 0.0, 0.0
        host = {}
        for kind, noise in (("target", None), ("noise", "ssn"), ("mixture", "ssn")):
            x = torch.from_numpy(np.stack([read_wav(lay.wav_processed(snr, kind, rir, ch,
                                                                      noise=noise))[0]
                                           for ch in range(1, 17)]))
            host[kind] = stft_matmul(x)
            card = torch.from_numpy(np.stack([np.load(lay.stft_processed(snr, kind, rir, ch,
                                                                         noise=noise))
                                              for ch in range(1, 17)]))
            e_stft = max(e_stft, max_abs(card, host[kind]) / float(host[kind].abs().max()))
            host[f"card_{kind}"] = card
        masks = torch.from_numpy(np.stack([np.load(lay.mask_processed(snr, rir, ch, "ssn"))
                                           for ch in range(1, 17)]))
        e_mask = max_abs(masks, tf_mask(host["card_target"], host["card_noise"]))
        e_mask_host = max_abs(masks, tf_mask(host["target"], host["noise"]))
        print(f"phase 3f: PostGenerator on {len(TRAIN_RIRS)} RIRs (4 x 4 mics x 11 s; corpus "
              f"written in {t_corpus:.1f} s) took {t_postgen:.1f} s; RIR {rir}: STFT files vs the "
              f"host's plain STFT {e_stft:.3e} of scale, masks vs the host's mask of the same "
              f"spectra {e_mask:.3e} (vs the host's own spectra {e_mask_host:.3e})", flush=True)
        require(e_stft <= TRAIN_TOL["stft"] and e_mask <= TRAIN_TOL["mask"],
                ("PostGenerator files", e_stft, e_mask))

        # (3) the z export of every RIR
        t0 = time.perf_counter()
        with counted("train export_z", {"stft": 3 * len(TRAIN_RIRS),
                                        "masked_cov": len(TRAIN_RIRS)}, d.launches):
            for r in TRAIN_RIRS:
                require(export_z(str(root), "random", r, "ssn", snr_range=tuple(snr),
                                 n_nodes=4, mics_per_node=4), ("export_z did nothing", r))
        t_export = time.perf_counter() - t0

        # (4) lists → dataset → fit: the canonical CRNN, n_ch = 4 (the
        # reference mic and 3 z's), batch 500, 3 epochs, a run ledger
        t0 = time.perf_counter()
        lists = get_input_lists(str(root), list(TRAIN_RIRS), scenes="random", z_sigs=["zs_hat"],
                                rng=np.random.default_rng(0))
        train_ds = DiscoDataset(lists, stack_axis=2, rng=np.random.default_rng(0))
        val_ds = copy.copy(train_ds)  # the same windows, drawn apart
        t_load = time.perf_counter() - t0
        n_windows = len(train_ds)
        x0, y0 = next(EpochBatches(train_ds, 99)())
        require(x0.shape == (TRAIN_BATCH, 4, 21, 257) and y0.shape == (TRAIN_BATCH, 21, 257),
                ("batch shapes", x0.shape, y0.shape))
        print(f"phase 3f: export_z of {len(TRAIN_RIRS)} RIRs {t_export:.1f} s; lists and "
              f"DiscoDataset {t_load:.1f} s: {n_windows} windows of {x0.shape[1:]}", flush=True)

        def run(name, n_epochs, passes=1, **kw):
            """``fit`` of a fresh canonical CRNN, its wall seconds (the
            model's construction not included) and its prefetch stalls."""
            model, state = canonical_train_state(4)
            stalls, note = [], pipeline.note_chunk_overlap

            def note_overlap(stall_s, busy_s):
                stalls.append(stall_s * 1e3)
                return note(stall_s, busy_s)

            pipeline.note_chunk_overlap = note_overlap
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fit(model, state, EpochBatches(train_ds, 1, passes),
                          EpochBatches(val_ds, 2), n_epochs, save_path=tmp / "models",
                          run_name=name, verbose=False, **kw)
                torch.cuda.synchronize()
            finally:
                pipeline.note_chunk_overlap = note
            return out, time.perf_counter() - t0, stalls

        def epochs_by_ledger(path):
            ledger = [json.loads(line) for line in path.read_text().splitlines()]
            return ([r["unit"] for r in ledger if r["state"] == "done"],
                    [b["t"] - a["t"] for a, b in zip(ledger[::2], ledger[1::2])])

        (state, tr, va, _), t_fit, _ = run("full", TRAIN_EPOCHS, ledger=tmp / "full.jsonl")
        done, epoch_s = epochs_by_ledger(tmp / "full.jsonl")
        ck = serialization.unpackb((tmp / "models" / "full_model.msgpack").read_bytes())
        finite = bool(np.isfinite(tr).all() and np.isfinite(va).all())
        d.train = {"windows_per_epoch": n_windows, "batch": (x0, y0)}
        print(f"phase 3f: fit, {TRAIN_EPOCHS} epochs of {n_windows} windows at batch "
              f"{TRAIN_BATCH}: train loss {tr.tolist()}, val loss {va.tolist()}, finite {finite}; "
              f"{t_fit:.2f} s, the first fit of the process (epochs {epoch_s} s by the ledger); "
              f"ledger done {done}; checkpoint epochs_done {int(ck['epochs_done'])}, step "
              f"{int(ck['step'])}, opt_state keys {sorted(ck['opt_state'])}", flush=True)
        require(finite and tr[-1] < tr[0], ("fit losses", tr.tolist()))
        require(done == [f"epoch:{e}" for e in range(TRAIN_EPOCHS)], ("ledger", done))
        require(set(ck) == {"params", "batch_stats", "opt_state", "step", "train_loss",
                            "val_loss", "epochs_done"} and set(ck["opt_state"]) == {"0", "1", "2"},
                ("checkpoint tree", sorted(ck)))

        # (5) resume: the 2-epoch run's checkpoint, resumed to the same end
        run("half", 2)
        k = int(serialization.unpackb((tmp / "models" / "half_model.msgpack").read_bytes())
                ["epochs_done"])
        model, st = canonical_train_state(4)
        st, tr2, va2, _ = fit(model, st, EpochBatches(train_ds, 1), EpochBatches(val_ds, 2),
                              TRAIN_EPOCHS - k, save_path=tmp / "models", run_name="half",
                              verbose=False, resume_from=tmp / "models" / "half_model.msgpack")
        same = np.array_equal(tr2, tr) and np.array_equal(va2, va) and all(
            torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                              st.model.state_dict().values())) and all(
            torch.equal(state.optimizer.state[p]["nu"], st.optimizer.state[q]["nu"])
            for p, q in zip(state.model.parameters(), st.model.parameters()))
        print(f"phase 3f: a 2-epoch run (checkpoint after epoch {k}) resumed for "
              f"{TRAIN_EPOCHS - k} epochs vs the {TRAIN_EPOCHS}-epoch run: losses, parameters, "
              f"statistics and nu bit-identical {same}", flush=True)
        require(same, ("resume", tr2.tolist(), tr.tolist()))

        # (5b) the end-to-end rate: fits whose epochs hold FIT_PASSES passes
        # over the windows, so that an epoch's fixed costs (a pass's
        # first-batch stall, validation, the checkpoint, the loss files) are
        # a small part of the wall; beside them the host's batch assembly
        # alone over one such epoch
        timed = []
        for i in range(FIT_RUNS):
            (_, tr_t, _, _), t_run, stalls = run(f"timed{i}", FIT_EPOCHS, FIT_PASSES,
                                                 ledger=tmp / f"timed{i}.jsonl")
            done_t, epoch_t = epochs_by_ledger(tmp / f"timed{i}.jsonl")
            require(len(done_t) == FIT_EPOCHS and np.isfinite(tr_t).all(),
                    ("timed fit", done_t, tr_t.tolist()))
            timed.append({"fit_s": t_run, "epoch_s": epoch_t, "stall_ms": stalls,
                          "windows_per_s": n_windows * FIT_PASSES * FIT_EPOCHS / t_run})
        t0 = time.perf_counter()
        n_prep = sum(len(b[0]) for b in EpochBatches(train_ds, 5, FIT_PASSES)())
        t_prep = time.perf_counter() - t0
        rates = sorted(t["windows_per_s"] for t in timed)
        d.train.update(timed=timed, host_windows_per_s=n_prep / t_prep,
                       steps_per_epoch=-(-n_windows * FIT_PASSES // TRAIN_BATCH),
                       val_steps_per_epoch=-(-n_windows // TRAIN_BATCH))
        print(f"phase 3f: {FIT_RUNS} timed fits of {FIT_EPOCHS} epochs x {FIT_PASSES} passes "
              f"over the {n_windows} windows ({d.train['steps_per_epoch']} train steps an "
              f"epoch): training windows per s {[t['windows_per_s'] for t in timed]} (median "
              f"{rates[len(rates) // 2]}, spread {rates[-1] / rates[0] - 1:.4f}); wall s "
              f"{[t['fit_s'] for t in timed]}; epochs by the ledger "
              f"{[t['epoch_s'] for t in timed]} s; the host's batch assembly alone "
              f"{n_prep} windows in {t_prep} s = {d.train['host_windows_per_s']} windows per s",
              flush=True)
    del state, st, model

    # (6) one train step on the card against the same step on the host, the
    # host's max pools taking the card's choices: a window whose two
    # largest elements tie to float32 rounding may be chosen apart, its
    # gradient then lands on another conv output, and RMSprop's first step
    # moves a parameter of small gradient by 10 times the difference
    # (exp/crnn_step_split.py); so each window chosen apart must be a tie
    x, y = d.train["batch"]
    out, pools, ties = {}, [], []
    for dev in ("cuda", "cpu"):
        model, state = canonical_train_state(4, device=dev)
        before = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        conv_out = bn_inputs(model) if dev == "cpu" else None
        train_step, _ = make_step_fns(model, "all")
        with pool_choices(model, record=pools if dev == "cuda" else None,
                          replay=pools if dev == "cpu" else None, ties=ties):
            state, loss = train_step(state, x, y)
        out[dev] = (float(loss), {k: v.cpu() for k, v in model.state_dict().items()},
                    [state.optimizer.state[p]["nu"].cpu() for p in model.parameters()],
                    [p.grad.cpu() for p in model.parameters()])
    e = compare_steps(out["cuda"], out["cpu"], before, conv_out,
                      1.0 - state.optimizer.param_groups[0]["decay"])
    e["nu_worst"]["tensor"] = [n for n, _ in model.named_parameters()][e["nu_worst"]["tensor"]]
    print(f"phase 3f: one train step at batch {TRAIN_BATCH}, card vs host: loss {e['loss']:.3e} "
          f"relative, parameters {e['params']:.3e} and nu {e['nu']:.3e} max-abs (nu's worst "
          f"tensor: {json.dumps(e['nu_worst'])}); each device's nu against 0.01 g^2 of its own "
          f"gradient {e['nu_self']:.3e} of itself; BatchNorm statistics {e['stats']:.3e} of "
          f"themselves plus their conditioning (worst: {json.dumps(e['stats_worst'])}; against "
          f"the host's value alone the worst: {json.dumps(e['stats_worst_rel'])})", flush=True)
    tie = max(t["gap_max"] / t["scale"] for t in ties)
    print(f"phase 3f: the card step's max-pool windows the host would choose apart "
          f"{json.dumps(ties)}: the two elements within {tie:.3e} of the pool input's largest "
          f"magnitude", flush=True)
    require(e["loss"] <= TRAIN_TOL["loss"] and e["params"] <= TRAIN_TOL["params"]
            and e["nu"] <= TRAIN_TOL["params"] and e["nu_self"] <= TRAIN_TOL["nu"]
            and e["stats"] <= TRAIN_TOL["stats"] and len(ties) == len(model.cnn.pools)
            and tie <= TRAIN_TOL["tie"], ("card step vs host", e, ties))

    # (7) the bf16 lane: its first loss against the f32 lane's, one epoch
    losses = {}
    for precision in ("f32", "bf16"):
        model, state = canonical_train_state(4)
        train_step, _ = make_step_fns(model, "all", precision=precision)
        losses[precision] = float(train_step(state, x, y)[1])
    e_bf16 = abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"])
    model, state = canonical_train_state(4)
    xs = [x[i:i + 100] for i in range(0, len(x), 100)]
    ys = [y[i:i + 100] for i in range(0, len(y), 100)]
    with tempfile.TemporaryDirectory(prefix="train-bf16-", dir=build) as tmp:
        state, tr, va, _ = fit(model, state, lambda: zip(xs, ys), lambda: zip(xs[:1], ys[:1]), 1,
                               save_path=tmp, run_name="bf16", verbose=False, precision="bf16")
    f32 = all(p.dtype == torch.float32 for p in model.parameters()) and all(
        b.dtype == torch.float32 for k, b in model.named_buffers() if "running" in k) and all(
        s["nu"].dtype == torch.float32 for s in state.optimizer.state.values())
    print(f"phase 3f: bf16 lane: first-step loss {losses['bf16']} vs the f32 lane's "
          f"{losses['f32']} ({e_bf16:.3e} relative); one epoch of {len(xs)} steps: train loss "
          f"{tr[0]}, val loss {va[0]}; masters, statistics and nu float32 {f32}", flush=True)
    require(e_bf16 <= TRAIN_TOL["bf16"] and f32 and np.isfinite(tr[0]),
            ("bf16 lane", e_bf16, f32, tr[0]))
    print(f"phase 3f took {time.perf_counter() - t_phase:.1f} s (corpus deleted)", flush=True)


def bn_inputs(model) -> dict:
    """Per channel mean |x| and mean x^2 of every CNN2d conv's output on the
    model's next forward (the batch its BatchNorm's statistics are taken
    over), keyed by that BatchNorm's state_dict prefix; filled in place."""
    from disco_tpu_torch.nn.bricks import CNN2d

    seen = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, CNN2d):
            continue
        for i, conv in enumerate(mod.convs):
            def hook(_m, _inp, x, key=f"{name}.bns.{i}"):
                if key not in seen:
                    xf = x.detach().float()
                    seen[key] = {"abs": xf.abs().mean((0, 2, 3)).cpu(),
                                 "sq": (xf * xf).mean((0, 2, 3)).cpu()}
            conv.register_forward_hook(hook)
    return seen


def compare_steps(card, host, before: dict, conv_out: dict, rate: float) -> dict:
    """One first train step's results on the card against the host's, each
    (loss, state_dict, nu list, gradient list): the loss's relative error,
    the parameters' and nu's max-abs; nu element by element against the
    ``rate * g^2`` of each device's own gradient (the RMSprop update from
    nu = 0, ``rate`` = 1 - decay); nu's worst tensor card against host; the
    BatchNorm statistics' error against themselves plus their conditioning
    (the statistics before the step in ``before``, the conv outputs'
    moments from :func:`bn_inputs`), its worst element, and the worst
    element against the host's value alone."""
    import torch

    (l_c, sd_c, nu_c, g_c), (l_h, sd_h, nu_h, g_h) = card, host
    r = {"loss": abs(l_c - l_h) / abs(l_h),
         "params": max(max_abs(sd_c[k], v) for k, v in sd_h.items()
                       if v.is_floating_point() and "running" not in k)}
    # nu holds (1 - decay) g^2 of the gradient the step took, element by
    # element relative to itself (a nu of 0, or of another decay, fails)
    r["nu_self"] = 0.0
    for nus, grads in ((nu_c, g_c), (nu_h, g_h)):
        for n, g in zip(nus, grads):
            want = rate * g * g
            err = (n - want).abs()
            ratio = torch.where(want > 0, err / want.clamp_min(1e-38),
                                torch.where(err > 0, math.inf, 0.0))
            r["nu_self"] = max(r["nu_self"], float(ratio.max()))
    # card against host: the gradients differ by the convolution
    # algorithms' rounding, and the gradient of a conv bias in front of a
    # BatchNorm is 0 but for roundoff, so nu is also read against the
    # model's largest nu, and each gradient against its tensor's largest
    r["nu"] = max(max_abs(a, b) for a, b in zip(nu_c, nu_h))
    top = max(float(b.abs().max()) for b in nu_h)
    nu_rel = [float(((a - b).abs() / (b.abs() + top)).max()) for a, b in zip(nu_c, nu_h)]
    grad_rel = [max_abs(a, b) / max(float(b.abs().max()), 1e-38) for a, b in zip(g_c, g_h)]
    i = int(np.argmax(nu_rel))
    r["nu_worst"] = {"tensor": i, "of_itself_plus_largest": nu_rel[i],
                     "its_gradient_err_of_its_largest": grad_rel[i],
                     "largest_nu": float(nu_h[i].abs().max()), "model_largest_nu": top}
    # a statistic's update 0.9 * old + 0.1 * batch sums terms of magnitude
    # 0.9 |old| and 0.1 mean|x| (a mean) or 0.1 mean x^2 (a variance, flax's
    # E[x^2] - E[x]^2), x that channel's conv output: its conditioning
    stats = []
    for k, v in sd_h.items():
        if "running" not in k:
            continue
        layer, kind = k.rsplit(".", 1)
        cond = 0.9 * before[k].abs() + 0.1 * conv_out[layer]["abs" if kind == "running_mean"
                                                             else "sq"]
        err = (sd_c[k] - v).abs()
        ratio = err / (v.abs() + cond)
        c = int(ratio.argmax())
        rel = err / v.abs().clamp_min(1e-30)
        j = int(rel.argmax())
        stats.append({"key": k, "channel": c, "ratio": float(ratio[c]), "err": float(err[c]),
                      "host": float(v[c]), "cond": float(cond[c]),
                      "worst_rel": {"key": k, "channel": j, "rel": float(rel[j]),
                                    "err": float(err[j]), "host": float(v[j]),
                                    "cond": float(cond[j])}})
    worst = max(stats, key=lambda e: e["ratio"])
    r["stats"] = worst["ratio"]
    r["stats_worst"] = {k: v for k, v in worst.items() if k != "worst_rel"}
    r["stats_worst_rel"] = max((e["worst_rel"] for e in stats), key=lambda e: e["rel"])
    return r


def crnn_train_cost(batch: int, n_ch: int, win: int = 21, win_out: int = 15) -> float:
    """Operations of one train step of the canonical CRNN on ``batch``
    windows: the forward (three 3x3 convs over the window, the GRU's 15
    steps, the FF on each of its 15 frames) times 3, for the backward's
    products with respect to the inputs and to the weights."""
    flops, t, f, c_in = 0.0, win, 257, n_ch
    for c_out in (32, 64, 64):
        t -= 2
        flops += 2 * batch * c_out * t * f * c_in * 9
        f, c_in = f // 4, c_out
    steps = batch * win_out
    return 3 * (flops + steps * (2 * 3 * 256 * (f * c_in + 256) + 2 * 256 * 257))


def phase5_training(d: SimpleNamespace) -> None:
    """CUDA-event times (median of 5) of one train step and one eval step
    of the canonical CRNN at batch 500, for n_ch 4 and 1 in both lanes, the
    rate by the CRNN's shapes, the cost of cuDNN's deterministic
    algorithms, and phase 3f's fit rate and prefetch stalls."""
    import torch

    from disco_tpu_torch.nn import training

    x, y = d.train["batch"]
    rows = {}
    for n_ch in (4, 1):
        xb = torch.as_tensor(np.ascontiguousarray(x[:, :n_ch]), device=d.dev)
        yb = torch.as_tensor(y, device=d.dev)
        for precision in ("f32", "bf16"):
            model, state = canonical_train_state(n_ch)
            train_step, eval_step = training.make_step_fns(model, "all", precision=precision)
            row = {}
            for label, fn in (("train_step", lambda: train_step(state, xb, yb)),
                              ("eval_step", lambda: eval_step(state, xb, yb))):
                fn()
                row[f"{label}_ms_runs"] = sorted(time_ms(fn, reps=1, warmup=0) for _ in range(5))
                row[f"{label}_ms"] = row[f"{label}_ms_runs"][2]
            fl = crnn_train_cost(TRAIN_BATCH, n_ch)
            row["train_tflop"] = fl / 1e12
            row["train_tflop_per_s"] = fl / (row["train_step_ms"] / 1e3) / 1e12
            row["windows_per_s_by_step"] = TRAIN_BATCH / (row["train_step_ms"] / 1e3)
            rows[f"n_ch {n_ch}, {precision}"] = row
            print(f"phase 5: training, n_ch {n_ch}, {precision} lane, batch {TRAIN_BATCH}: "
                  + json.dumps(row), flush=True)
            if n_ch == 4 and precision == "f32":
                # the same step with cuDNN free to pick any algorithm and autotune
                saved = training.deterministic_cudnn

                @contextmanager
                def free():
                    before = torch.backends.cudnn.benchmark
                    torch.backends.cudnn.benchmark = True
                    try:
                        yield
                    finally:
                        torch.backends.cudnn.benchmark = before
                training.deterministic_cudnn = free
                try:
                    fast_step, _ = training.make_step_fns(model, "all")
                    fn = lambda: fast_step(state, xb, yb)  # noqa: E731
                    for _ in range(3):
                        fn()
                    free_runs = sorted(time_ms(fn, reps=1, warmup=0) for _ in range(5))
                finally:
                    training.deterministic_cudnn = saved
                print(f"phase 5: training, the cost of cuDNN determinism (n_ch 4, f32): train "
                      f"step {row['train_step_ms']} ms deterministic vs {free_runs[2]} ms with "
                      f"cuDNN's free choice and autotuning (median of {free_runs})", flush=True)
            del model, state
    t = d.train
    rates = sorted(r["windows_per_s"] for r in t["timed"])
    f32 = rows["n_ch 4, f32"]
    # the steps' card time an epoch by their event medians, against its wall
    card_s = (t["steps_per_epoch"] * f32["train_step_ms"]
              + t["val_steps_per_epoch"] * f32["eval_step_ms"]) / 1e3
    epochs = [e for r in t["timed"] for e in r["epoch_s"]]
    stalls = [s for r in t["timed"] for s in r["stall_ms"]]
    print(f"phase 5: training end to end (phase 3f's {len(rates)} timed fits of {FIT_EPOCHS} "
          f"epochs x {FIT_PASSES} passes over {t['windows_per_epoch']} windows, with "
          f"validation, checkpoints and host batch assembly): {rates[len(rates) // 2]} training "
          f"windows per s (median; runs {rates}, spread {rates[-1] / rates[0] - 1:.4f}); the "
          f"host's batch assembly alone {t['host_windows_per_s']} windows per s; an epoch "
          f"{float(np.median(epochs))} s (median of {len(epochs)}) of which the steps' card "
          f"time by their events {card_s} s (share {card_s / float(np.median(epochs)):.4f}); "
          f"prefetch stall ms per batch: median {float(np.median(stalls))}, total "
          f"{sum(stalls)} over {len(stalls)} batches", flush=True)
    d.train_rows = rows


#: phase 3g: the corpus's published widths (``sim.defaults``: 4 nodes x 4
#: mics, RT60 0.3-0.6 s, 5-10 s talkers after 1 s of silence, ISM order 20);
#: the batched generator's RIRs, scenes a chunk and seed; SceneStream's scene
#: batches and the canonical n_ch-1 CRNN's batch in its fit; the talkers'
#: lengths (s: four outlast MEETIT's longest draw, 10 s)
SIM_ORDER = 20
SIM_RIRS, SIM_CHUNK, SIM_SEED = 4, 2, 17
STREAM_BATCHES, STREAM_FIT_BATCH = 2, 8
SIM_TALKERS_S = (6.0, 7.5, 8.5, 10.5, 10.5, 10.5, 11.0)
#: phase 3g's bounds: the card's order-20 RIRs against the float64 fixture
#: (the JAX package's budget, relative L2 a RIR) and against the port's host
#: run; a scene batch's magnitudes against ``stft_matmul`` of its signals
#: and the MEETIT mixture STFTs against ``stft_matmul`` of the summed images
#: (relative L2); the crossfaded boundary jumps against the hard switch's
#: (``disco_tpu/scenes/check.py``'s continuity bound)
SIM_TOL = {"golden": 5e-4, "host": 1e-6, "stft": 1e-5, "crossfade": 0.5}


def sim_corpus(root) -> None:
    """Synthetic talkers in the LibriSpeech layout ``{speaker}/1/{speaker}-1-0001.wav``
    (speech-shaped gated noise, ``SIM_TALKERS_S`` long) under ``root/talkers``,
    and two 12-s noise files under ``root/noises``."""
    from disco_tpu_torch.io.atomic import write_wav_atomic

    rng = np.random.default_rng(11)
    for i, seconds in enumerate(SIM_TALKERS_S):
        t = np.arange(int(seconds * FS)) / FS
        env = (np.sin(2 * np.pi * (1.0 + 0.15 * i) * t + i) > -0.2).astype(np.float64)
        spk = str(301 + i)
        write_wav_atomic(root / "talkers" / spk / "1" / f"{spk}-1-0001.wav",
                         0.3 * env * rng.standard_normal(len(t)), FS)
    for i in range(2):
        write_wav_atomic(root / "noises" / f"n{i}.wav", 0.2 * rng.standard_normal(12 * FS), FS)


@contextmanager
def timed_calls(module, card: dict, host: dict, out: dict):
    """Time calls of ``module``'s functions in the run itself: each name of
    ``card`` by CUDA events around the call (its launches), into
    ``out[card[name]]`` as ms; each name of ``host`` on the host clock, into
    ``out[host[name]]`` as s."""
    import torch

    real = {name: getattr(module, name) for name in (*card, *host)}
    events = {key: [] for key in card.values()}
    for key in host.values():
        out[key] = []

    def on_card(key, fn):
        def wrapper(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn(*args, **kw)
            end.record()
            events[key].append((start, end))
            return r
        return wrapper

    def on_host(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            out[key].append(time.perf_counter() - t0)
            return r
        return wrapper

    for name, key in card.items():
        setattr(module, name, on_card(key, real[name]))
    for name, key in host.items():
        setattr(module, name, on_host(key, real[name]))
    try:
        yield out
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)
        torch.cuda.synchronize()
        for key, pairs in events.items():
            out[key] = [s.elapsed_time(e) for s, e in pairs]


def phase3g_simulation(d: SimpleNamespace) -> None:
    """Simulation, scenes and corpus generation on the card at the corpus's
    published widths: the order-20 RIRs against the golden fixture, the
    host and themselves; the batched DISCO generator, crashed and resumed;
    SceneStream's scene batches (one STFT launch each) feeding ``fit``; one
    MEETIT RIR; a dynamic scene's continuity."""
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.analysis.meter.costmodel import kernel_cost
    from disco_tpu_torch.datagen import disco
    from disco_tpu_torch.datagen.disco import generate_disco_rirs_batched, get_wavs_list
    from disco_tpu_torch.datagen.meetit import (get_masks, load_meetit_sample,
                                                save_meetit_scene, simulate_meetit_room)
    from disco_tpu_torch.io.atomic import save_npy_atomic
    from disco_tpu_torch.io.audio import read_wav
    from disco_tpu_torch.io.layout import DatasetLayout
    from disco_tpu_torch.nn.training import fit
    from disco_tpu_torch.ops.stft_ops import hann_periodic, stft_kernel, stft_matmul
    from disco_tpu_torch.runs import RunLedger, chaos
    from disco_tpu_torch import obs
    from disco_tpu_torch.obs.accounting import device_get_count, recompile_count
    from disco_tpu_torch.scenes import check as scene_check
    from disco_tpu_torch.scenes import (SceneStream, boundary_jumps, dynamic_scene_mixture,
                                        piecewise_trajectory)
    from disco_tpu_torch.sim import (InterferentSpeakersSetup, SignalDefaults, SpeechAndNoiseSetup,
                                     make_setup, rir_bucket, shoebox_rirs)
    from disco_tpu_torch.sim import ism

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent

    # (1) the golden fixture's order-20 RIRs on the card, twice, and on the host
    g = np.load(here / "tests" / "data" / "golden_rir_order20.npz")
    args = (g["room_dim"].astype(np.float32), g["sources"].astype(np.float32),
            g["mics"].astype(np.float32), float(g["alpha"]))
    kw = dict(max_order=int(g["max_order"]), rir_len=int(g["rir_len"]))
    card = [shoebox_rirs(*args, **kw) for _ in range(2)]
    host = shoebox_rirs(*args, **kw, device="cpu")

    def rel_rir(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())

    e_golden = rel_rir(card[0].cpu().numpy(), g["rirs"])
    e_host = rel_rir(card[0].cpu().numpy(), host.numpy())
    same = torch.equal(card[0], card[1])
    ms = time_ms(lambda: shoebox_rirs(*args, **kw), reps=3, warmup=1)
    print(f"phase 3g: order-20 RIRs of the golden room (2 sources x 4 mics x {kw['rir_len']}) "
          f"on the card: {e_golden:.3e} from the float64 fixture, {e_host:.3e} from the host "
          f"(rel-l2 a RIR), a second card run bit-identical {same}; {ms:.3f} ms", flush=True)
    require(e_golden < SIM_TOL["golden"] and e_host <= SIM_TOL["host"] and same,
            ("golden RIRs", e_golden, e_host, same))

    build = here / "build"
    build.mkdir(exist_ok=True)
    sd = SignalDefaults()
    with tempfile.TemporaryDirectory(prefix="sim-", dir=build) as tmp:
        tmp = Path(tmp)
        sim_corpus(tmp)
        targets, talkers, noises = get_wavs_list(tmp / "talkers", tmp / "noises", dset="train",
                                                 cache_dir=tmp / "lists")
        require(len(targets) == len(SIM_TALKERS_S) and len(noises["fs"]) == 2, "corpus lists")

        def signals():
            return SpeechAndNoiseSetup(
                targets, talkers, noises, duration_range=sd.duration_range,
                var_tar=10 ** (sd.var_tar_db / 10), snr_dry_range=sd.snr_dry_range,
                snr_cnv_range=sd.snr_cnv_range, min_delta_snr=sd.min_delta_snr,
                rng=np.random.default_rng(3))

        def generate(root, rng_seed):
            return generate_disco_rirs_batched(
                "random", "train", 1, SIM_RIRS, signals(),
                DatasetLayout(str(root / "dataset"), "random", "train"),
                rng=np.random.default_rng(rng_seed), max_order=SIM_ORDER,
                ledger=str(root / "ledger.jsonl"), resume=True, batch=SIM_CHUNK, seed=SIM_SEED)

        # (2) the batched generator, then the same run crashed after its first
        # chunk and resumed: byte-identical trees
        times = {}
        t0 = time.perf_counter()
        with counted("datagen batched", {}, d.launches), timed_calls(
                disco, {"shoebox_rirs_batched": "ism_ms", "fft_convolve": "conv_ms"},
                {"get_convolved_vads": "gate_s", "snr_at_mics": "gate_s"}, times):
            done = generate(tmp / "a", 5)
        wall = time.perf_counter() - t0
        require(done == list(range(1, SIM_RIRS + 1)), ("generated", done))
        chaos.configure("between_scene_batches", after=1)
        try:
            generate(tmp / "b", 5)
            require(False, "the between_scene_batches crash never fired")
        except chaos.ChaosCrash:
            pass
        finally:
            chaos.disable()
        resumed = generate(tmp / "b", 999)
        trees = [_tree(tmp / r / "dataset") for r in ("a", "b")]
        ledger_done, _ = RunLedger(tmp / "b" / "ledger.jsonl").verified_done()
        require(resumed == list(range(SIM_CHUNK + 1, SIM_RIRS + 1)) and trees[0] == trees[1]
                and ledger_done == {f"scene:{r}" for r in done},
                ("crash and resume", resumed, sorted(set(trees[0]) ^ set(trees[1]))[:5]))
        n_chunks = -(-SIM_RIRS // SIM_CHUNK)
        print(f"phase 3g: generate_disco_rirs_batched, {SIM_RIRS} RIRs in chunks of {SIM_CHUNK} "
              f"(order {SIM_ORDER}, 4 x 4 mics, train): {wall:.2f} s = {SIM_RIRS / wall:.4f} "
              f"scenes per wall-second; {len(times['ism_ms'])} RIR engine passes "
              f"({len(times['ism_ms']) - n_chunks} redraw rounds) ISM {times['ism_ms']} ms, "
              f"convolutions {sum(times['conv_ms']):.2f} ms in {len(times['conv_ms'])} calls "
              f"({sum(times['conv_ms']) / n_chunks:.2f} a chunk), ISM + convolutions "
              f"{(sum(times['ism_ms']) + sum(times['conv_ms'])) / n_chunks:.2f} card ms a chunk "
              f"against host gating {1e3 * sum(times['gate_s']) / n_chunks:.1f} ms a chunk "
              f"({len(times['gate_s']) // 2} scenes gated); crashed after chunk 1 and resumed "
              f"({resumed}): {len(trees[0])} files byte-identical", flush=True)

        # (3) SceneStream at its defaults: one STFT launch a scene batch, the
        # magnitudes against stft_matmul of the batch's own signals, then fit
        stream = SceneStream(seed=0, batches_per_epoch=STREAM_BATCHES, win_len=21)
        B = stream.scenes_per_batch
        walls, errs, parts = [], [], {}
        # the scene gate's dispatch-budget and log legs, folded into this run:
        # one batched readback a batch, one new scene_batch signature a
        # bucket (rir_len), one scene event a batch
        budget, buckets = [], []
        with timed_calls(ism, {"shoebox_rirs_batched": "ism_ms", "fft_convolve": "conv_ms"}, {},
                         parts), obs.recording(tmp / "scene_events.jsonl"):
            for i in range(STREAM_BATCHES):
                g0, r0 = device_get_count(), recompile_count("scene_batch")
                with counted(f"scene batch {i}", {"stft": 1}, d.launches):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = stream.simulate_batch(0, i)
                    walls.append(time.perf_counter() - t0)
                budget.append((device_get_count() - g0, recompile_count("scene_batch") - r0))
                new_bucket = out["rirs"].shape[-1] not in buckets
                buckets.append(out["rirs"].shape[-1])
                require(budget[-1] == (1, int(new_bucket)), ("scene dispatch budget", budget))
                noisy = torch.as_tensor(out["noisy"][:, 0], device="cuda")
                errs.append(rel_l2(torch.as_tensor(out["mag_noisy"], device="cuda"),
                                   stft_matmul(noisy, with_mag=True)[1]))
                require(all(np.isfinite(v).all() for v in out.values())
                        and out["mask"].min() >= 0 and out["mask"].max() <= 1, "scene batch")
        require(max(errs) <= SIM_TOL["stft"], ("scene batch magnitudes", errs))
        failures: list = []
        scene_events = [e for e in obs.read_events(tmp / "scene_events.jsonl")
                        if e["kind"] == "scene"]
        scene_check.check_scene_events(failures, scene_events, datagen=False)
        require(not failures and len(scene_events) == STREAM_BATCHES, (failures, scene_events))
        print(f"phase 3g: the scene gate's dispatch budget on the stream's batches: (batched "
              f"readbacks, new scene_batch signatures) {budget} for rir_len buckets {buckets}; "
              f"{len(scene_events)} scene events", flush=True)
        # the STFT kernel at the scene batch's (3, B, L) stack, beside its
        # plain version, torch.stft and its bound
        x = torch.as_tensor(np.stack([out["noisy"][:, 0], out["clean"][:, 0],
                                      out["noisy"][:, 0] - out["clean"][:, 0]]), device="cuda")
        fl, nbytes = kernel_cost(lambda a: stft_kernel(a, with_mag=True), x)
        b_ms, b_by = bound(fl, nbytes)
        win = hann_periodic(512, device="cuda")
        d.scene_stft_x = x   # phase 5 reads its device time
        stft_ms = {"kernel": time_ms(lambda: stft_kernel(x, with_mag=True), reps=20),
                   "plain": time_ms(lambda: stft_matmul(x, with_mag=True), reps=20),
                   "torch.stft": time_ms(lambda: torch.stft(
                       x.reshape(3 * B, -1), 512, 256, window=win, center=True,
                       pad_mode="reflect", return_complex=True), reps=20)}
        print(f"phase 3g: SceneStream ({B} scenes a batch, order {stream.max_order}, "
              f"{stream.duration_s} s, {stream.scenario}): rirs {out['rirs'].shape}, one STFT "
              f"launch a batch; magnitudes vs stft_matmul of the batch's signals {max(errs):.3e} "
              f"rel-l2; batch wall {walls} s = {[B / w for w in walls]} scenes per s; ISM "
              f"{parts['ism_ms']} ms ({[m / 1e3 / w for m, w in zip(parts['ism_ms'], walls)]} "
              f"of a batch), convolution {parts['conv_ms']} ms; the STFT kernel at the "
              f"(3, {B}, {x.shape[-1]}) stack {stft_ms} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        model, state = canonical_train_state(1)
        t0 = time.perf_counter()
        with counted("scene stream fit", {"stft": 2 * STREAM_BATCHES}, d.launches):
            _, tr, va, _ = fit(model, state, stream.batch_fn(STREAM_FIT_BATCH),
                               stream.batch_fn(STREAM_FIT_BATCH, shuffle=False), 1,
                               save_path=tmp / "models", run_name="scenes", verbose=False)
        print(f"phase 3g: fit of the canonical n_ch-1 CRNN off SceneStream.batch_fn (batch "
              f"{STREAM_FIT_BATCH}, {STREAM_BATCHES} scene batches an epoch): train loss {tr}, "
              f"validation loss {va}, {time.perf_counter() - t0:.1f} s", flush=True)
        require(len(tr) == len(va) == 1 and np.isfinite(tr[0]) and np.isfinite(va[0]),
                ("scene stream fit", tr, va))

        # (4) one MEETIT RIR: 4 sources facing 4 nodes of 4 mics, one STFT
        # launch for its masks, written in generate_meetit_rirs' layout and
        # read back.  Four equal-level talkers at order 20 give node SIRs
        # near -2.5 dB, below the reference gate's 2-14 dB classes, so the
        # room is gated at -10 to 10 dB (tests/test_meetit.py's gate)
        speakers = [t for t, s in zip(sorted(targets), sorted(SIM_TALKERS_S)) if s > 10]
        lay = DatasetLayout(str(tmp / "meetit"), "meetit", "train")
        sampler = make_setup("meetit", rng=np.random.default_rng(1), n_sensors_per_node=(4,) * 4,
                             n_sources=4)
        sig = InterferentSpeakersSetup(
            speakers, duration_range=sd.duration_range, var_tar=10 ** (sd.var_tar_db / 10),
            snr_dry_range=sd.snr_dry_range, snr_cnv_range=sd.snr_cnv_range,
            min_delta_snr=sd.min_delta_snr, rng=np.random.default_rng(3))
        rng = np.random.default_rng(2)
        t0 = time.perf_counter()
        for draws in range(1, 51):
            scene = simulate_meetit_room(sampler.create_room_setup(), sig, "train", [4] * 4, [],
                                         1, max_order=SIM_ORDER, rng=rng, sir_vmin=-10.0,
                                         sir_vmax=10.0)
            if scene != "redraw_room_setup":
                break
        require(scene != "redraw_room_setup", "no MEETIT room in 50 draws")
        t_room = time.perf_counter() - t0
        with counted("meetit rir", {"stft": 1}, d.launches):
            mix, masks = get_masks(scene.images, [4] * 4)
        for ch in range(mix.shape[0]):
            save_npy_atomic(lay.ensure_dir(lay.base / "stft" / "mix" / f"1_Ch-{ch + 1}.npy"),
                            mix[ch])
            for i_s in range(masks.shape[0]):
                save_npy_atomic(lay.ensure_dir(lay.base / "mask" / f"1_S-{i_s + 1}_Ch-{ch + 1}.npy"),
                                masks[i_s, ch])
        save_meetit_scene(scene, {"sirs": scene.sirs}, 1, lay)
        Y, masks = load_meetit_sample(lay, 1, [4] * 4)
        n = Y.shape[-1]
        images = np.stack([np.sum([read_wav(lay.base / "wav" / "clean" / "cnv"
                                            / f"1_S-{s}_Ch-{ch}.wav")[0] for s in range(1, 5)], 0)
                           for ch in range(1, 17)])
        want = stft_matmul(torch.as_tensor(images, device="cuda")).reshape(4, 4, 257, n)
        e_meetit = rel_l2(torch.as_tensor(Y, device="cuda"), want)
        print(f"phase 3g: simulate_meetit_room, 4 sources x 16 mics (order {SIM_ORDER}): "
              f"{draws} room draws in {t_room:.1f} s, node SIRs {scene.sirs} dB; get_masks, "
              f"load_meetit_sample: Y {Y.shape}, masks {masks.shape}; the mixture STFTs vs "
              f"stft_matmul of the summed images {e_meetit:.3e} rel-l2", flush=True)
        require(masks.shape == (4, 4, 257, n) and np.isfinite(Y).all() and masks.min() >= 0
                and masks.max() <= 1 and e_meetit <= SIM_TOL["stft"], ("meetit", e_meetit))

    # (5) a dynamic scene of 4 segments: the crossfade removes the click
    cfg = make_setup("random", rng=np.random.default_rng(4)).create_room_setup()
    path = piecewise_trajectory(cfg.source_positions[0], cfg.source_positions[1], 4)
    _, rir_len = rir_bucket(cfg.beta, cfg.room_dim, max_order=SIM_ORDER)
    dry = np.sin(2 * np.pi * 440.0 * np.arange(FS) / FS).astype(np.float32)
    jumps = {}
    with counted("dynamic scene", {}, d.launches):
        for crossfade in (512, 0):
            mix = dynamic_scene_mixture(cfg.room_dim, path, cfg.mic_positions.T, cfg.alpha, dry,
                                        crossfade=crossfade, max_order=SIM_ORDER,
                                        rir_len=rir_len)["mixture"]
            require(mix.shape == (16, FS) and np.isfinite(mix).all(), "dynamic mixture")
            jumps[crossfade] = float(boundary_jumps(mix, 4).max())
    print(f"phase 3g: dynamic_scene_mixture, 4 segments x 16 mics (order {SIM_ORDER}, rir_len "
          f"{rir_len}): worst boundary jump {jumps[512]:.4e} crossfaded, {jumps[0]:.4e} hard "
          f"switched ({jumps[512] / jumps[0]:.3f}); phase 3g took "
          f"{time.perf_counter() - t_phase:.1f} s (corpus deleted)", flush=True)
    require(jumps[512] < SIM_TOL["crossfade"] * jumps[0], ("continuity", jumps))


#: phase 3h: serving — a block is one 1.008-s window of 64 frames (16 refreshes)
SERVE_BLOCK, SERVE_U = 64, 4
#: phase 3h: the time-domain session's windows (LW samples each) and the
#: serve_tick crash's tick
SERVE_WINDOWS, SERVE_CRASH_AFTER = 4, 3


def serve_sessions(d: SimpleNamespace) -> tuple[list, dict]:
    """The five sessions of phase 3h on the north-star clip, with their
    offline references computed here on the main thread (before any server
    runs): four STFT-domain sessions (``jacobi-pallas``; ``jacobi-pallas``
    with mu 1.2; ``fused``; ``eigh`` with a z_mask that drops node 1), each
    whole-clip ``streaming_tango`` held bit for bit to ``per_block_stream``
    (the per-block offline calls a served stream makes), and one
    ``domain="time"`` session (``jacobi-pallas``) whose reference is
    ``streaming_clip_fused`` window by window with the state carried.
    Returns the sessions and the launches of their offline per-block and
    per-window calls, by kernel."""
    import torch

    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.serve import check as sc

    Yh, mh = to_host([d.Y, d.m])
    F = Yh.shape[-2]
    z_mask = np.ones(K, np.float32)
    z_mask[1] = 0.0
    stft_specs = [("jacobi-pallas", {"solver": "jacobi-pallas"}, None),
                  ("jacobi-pallas mu 1.2", {"solver": "jacobi-pallas", "mu": 1.2}, None),
                  ("fused", {"solver": "fused"}, None),
                  ("eigh z_mask", {"solver": "eigh"}, z_mask)]
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)

    def count(fn, *args, **kw):  # fn's launches added into ``launches``
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        out = fn(*args, **kw)
        for k, (f, a) in counters.items():
            launches[k] += getattr(f, a) - before[k]
        return out

    specs = []
    for label, kw, zm in stft_specs:
        okw = dict(kw, **({} if zm is None else {"z_avail": zm}))
        ref = sc.offline_stream(Yh, mh, device=d.dev, update_every=SERVE_U, **okw)
        pb = count(sc.per_block_stream, Yh, mh, block=SERVE_BLOCK, device=d.dev,
                   update_every=SERVE_U, **okw)
        same = bool(np.array_equal(ref, pb))
        print(f"phase 3h: {label}: whole-clip streaming_tango vs the per-block calls of "
              f"{SERVE_BLOCK} frames: bit-identical {same} (max abs "
              f"{float(np.abs(ref - pb).max()):.3e})", flush=True)
        require(same, ("whole clip vs per block on the card", label))
        specs.append({"label": label, "Y": Yh, "m": mh, "ref": ref, "z_mask": zm,
                      "config": sc.session_config(F, n_nodes=K, n_mics=C,
                                                  block_frames=SERVE_BLOCK,
                                                  update_every=SERVE_U, **kw)})
    wins = [d.y_np[..., w * LW:(w + 1) * LW] for w in range(SERVE_WINDOWS)]
    masks = [mh[..., 63 * w:63 * w + SERVE_BLOCK] for w in range(SERVE_WINDOWS)]
    refs = count(sc.chained_windows, wins, masks, device=d.dev, update_every=SERVE_U,
                 solver="jacobi-pallas")
    torch.cuda.synchronize()
    specs.append({"label": "time jacobi-pallas", "windows": wins, "masks": masks,
                  "ref": np.concatenate(refs, axis=-1),
                  "config": sc.session_config(F, n_nodes=K, n_mics=C,
                                              block_frames=SERVE_BLOCK, update_every=SERVE_U,
                                              solver="jacobi-pallas", domain="time")})
    return specs, launches


def serve_latency() -> dict:
    """The serve histograms' count, p50 and p95 (ms)."""
    from disco_tpu_torch.obs import REGISTRY

    snap = REGISTRY.snapshot()["histograms"]
    return {name: {k: snap[name][k] for k in ("count", "p50", "p95")}
            for name in ("serve_block_latency_ms", "serve_queue_wait_ms", "serve_dispatch_ms")
            if name in snap}


def phase3h_serving(d: SimpleNamespace) -> None:
    """Online serving on the card: five concurrent full-width sessions
    through an in-process ``EnhanceServer`` on loopback, clients on host
    threads, in both tick modes; then drain and resume, and the chaos
    legs (``disco_tpu_torch.serve.check``)."""
    import tempfile
    from pathlib import Path

    from disco_tpu_torch.obs import REGISTRY
    from disco_tpu_torch.serve import check as sc

    t_phase = time.perf_counter()
    specs, expected = serve_sessions(d)
    print("phase 3h: launches of the sessions' offline per-block calls: " + json.dumps(expected),
          flush=True)
    failures: list = []
    rates = {}
    for mode, kw in (("per-block ticks", {}),
                     ("super-ticks of 2", {"blocks_per_super_tick": 2, "max_queue_blocks": 8})):
        for name in ("serve_block_latency_ms", "serve_queue_wait_ms", "serve_dispatch_ms"):
            REGISTRY.histogram(name).reset()
        with counted(f"serve, {mode}", expected, d.launches):
            res = sc.check_parity(failures, specs, device=d.dev, server_kw=kw,
                                  label=f"serve {mode}")
        require(not failures, failures)
        lat = serve_latency()
        rates[mode] = {"ticks": res["ticks"], "batched_readbacks": res["batched_readbacks"],
                       "blocks": res["blocks_total"], "seconds": res["seconds"],
                       "blocks_per_s": res["blocks_total"] / res["seconds"], "latency_ms": lat}
        print(f"phase 3h: serve, {mode}: {len(specs)} concurrent sessions (K={K} x C={C}, "
              f"{SERVE_BLOCK}-frame blocks) bit-identical to their offline references; "
              f"{res['ticks']} ticks with work, {res['batched_readbacks']} batched readbacks; "
              f"{res['blocks_total']} blocks in {res['seconds']:.3f} s = "
              f"{rates[mode]['blocks_per_s']} blocks per s; latency " + json.dumps(lat),
              flush=True)
    d.serve = rates

    jp = specs[0]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="serve-", dir=build) as tmp:
        tmp = Path(tmp)
        drain = sc.check_drain_resume(failures, tmp / "state", jp["Y"], jp["m"], jp["ref"],
                                      jp["config"], device=d.dev)
        require(not failures, failures)
        print(f"phase 3h: drain after {drain['blocks_before_drain']} of {drain['blocks_total']} "
              f"blocks, checkpoint {Path(drain['state_path']).name} under build/, resumed on a "
              "fresh server: the stitched stream bit-identical", flush=True)
        chaos = sc.check_chaos(failures, tmp / "chaos", jp["Y"], jp["m"], jp["ref"],
                               jp["config"], device=d.dev, crash_after=SERVE_CRASH_AFTER)
        require(not failures, failures)
        print(f"phase 3h: chaos: serve_tick crash at tick {SERVE_CRASH_AFTER} after "
              f"{chaos['blocks_before_crash']} delivered blocks, each bit-correct; a mid_write "
              f"crash in the drain checkpoint left no checkpoint at its final path "
              f"({chaos['crashes_injected']} crashes injected)", flush=True)
    print(f"phase 3h took {time.perf_counter() - t_phase:.1f} s", flush=True)


#: phase 3i: the flywheel and promotion — paced rounds of a leg's clips
#: (64-frame blocks), of the endurance campaign's clips, the canonical
#: CRNN's build_crnn kwargs and the resident trainer's batch
FLY_BLOCKS, FLY_ENDURE_BLOCKS = 14, 20
FLY_ARCH = {"n_ch": 1, "win_len": 21, "n_freq": 257}
FLY_TRAIN_BATCH = 8


def phase3i_flywheel(d: SimpleNamespace) -> None:
    """The flywheel and promotion on the card at the north-star width with
    the canonical CRNN (``disco_tpu_torch.promote.check``,
    ``disco_tpu_torch.runs.endure``): model-mask sessions beside a
    time-domain session with the tap on (launches against the oracles'),
    a zeroed candidate demoted, a perturbed one promoted, a ``pre_swap``
    crash and restart, the controller's crashes, and the resident trainer
    publishing from the tap's shards into a promotion."""
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.core.dsp import stft
    from disco_tpu_torch.nn.crnn import build_crnn
    from disco_tpu_torch.nn.optim import build_optimizer
    from disco_tpu_torch.nn.training import create_train_state, make_step_fns
    from disco_tpu_torch.obs import REGISTRY
    from disco_tpu_torch.promote import GenerationStore
    from disco_tpu_torch.promote import check as pc
    from disco_tpu_torch.promote.lane import block_masks
    from disco_tpu_torch.runs import endure
    from disco_tpu_torch.serve import check as sc

    t_phase = time.perf_counter()
    variables = seeded_crnn_variables(1, CRNN_SEEDS["step1"])
    model = canonical_crnn(1, CRNN_SEEDS["step1"], d.dev)
    F = d.Y.shape[-2]
    configs = [pc.model_config(F, n_nodes=K, n_mics=C, block=SERVE_BLOCK, update_every=SERVE_U,
                               solver=solver)
               for solver in ("jacobi-pallas", "jacobi-pallas", "fused", "fused")]
    clips = [pc.scene(300 + i, FLY_BLOCKS, n_nodes=K, n_mics=C, block=SERVE_BLOCK, device=d.dev)
             for i in range(len(configs))]
    endure_clips = [pc.scene(400 + i, FLY_ENDURE_BLOCKS, n_nodes=K, n_mics=C, block=SERVE_BLOCK,
                             device=d.dev) for i in range(2)]
    # the time-domain session: the clip's first windows, its client masks
    # the incumbent's lane on each window's STFT (the port keeps the JAX
    # package's refusal of domain='time' with masks='model')
    wins = [d.y_np[..., w * LW:(w + 1) * LW] for w in range(SERVE_WINDOWS)]
    t_masks = [block_masks(stft(torch.as_tensor(w, device=d.dev)), model).cpu().numpy()
               for w in wins]
    chained = {"windows": wins, "masks": t_masks,
               "config": sc.session_config(F, n_nodes=K, n_mics=C, block_frames=SERVE_BLOCK,
                                           update_every=SERVE_U, solver="jacobi-pallas",
                                           domain="time")}
    failures: list = []
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="flywheel-", dir=build) as tmp:
        tmp = Path(tmp)
        # a generation staged from the card's module has the host's id
        g_card = GenerationStore(tmp / "ids_card").stage_module(model, arch=FLY_ARCH)
        g_host = GenerationStore(tmp / "ids_host").stage_variables(variables, arch=FLY_ARCH)
        print(f"phase 3i: the canonical CRNN staged from the card: {g_card.gen_id}, from the "
              f"host's numpy tree: {g_host.gen_id}", flush=True)
        require(g_card.gen_id == g_host.gen_id, ("gen_id card vs host", g_card, g_host))

        for name in ("serve_block_latency_ms", "serve_queue_wait_ms", "serve_dispatch_ms"):
            REGISTRY.histogram(name).reset()
        served = pc.check_model_sessions(failures, tmp / "sessions", clips, configs, FLY_ARCH,
                                         variables, chained=chained, counters=kernel_counters(),
                                         device=d.dev)
        require(not failures, failures)
        d.launches["flywheel serve"] = served["served_launches"]
        print(f"launches, flywheel serve: {served['served_launches']}; the oracles' calls: "
              f"{served['oracle_launches']}", flush=True)
        require(all(served["served_launches"][k] > 0 for k in ("stft", "eigh_jacobi",
                                                               "fused_mwf")),
                ("phase 3i launches", served["served_launches"]))
        lat = np.asarray(served["latency_ms"])
        rate = {"blocks": served["blocks"], "seconds": served["seconds"],
                "blocks_per_s": served["blocks"] / served["seconds"],
                "latency_ms": {"p50": float(np.percentile(lat, 50)),
                               "p95": float(np.percentile(lat, 95))},
                "registry_latency_ms": serve_latency()}
        print(f"phase 3i: {len(configs)} model-mask sessions (2 jacobi-pallas, 2 fused) and a "
              f"time-domain session, tap on: every stream bit-identical to its oracle, "
              f"{served['ticks']} ticks with work, {served['batched_readbacks']} batched "
              f"readbacks, {served['records']} blocks tapped "
              f"({served['tap']['shards_written']} shards, {served['tap']['blocks_dropped']} "
              f"dropped); " + json.dumps(rate) + "; phase 3h's: " +
              json.dumps({m: {k: r[k] for k in ("blocks_per_s", "latency_ms")}
                          for m, r in d.serve.items()}), flush=True)

        Yb = torch.as_tensor(clips[0][..., :SERVE_BLOCK], device=d.dev)
        mask_ms = time_ms(lambda: block_masks(Yb, model), reps=10)
        torch.manual_seed(TRAIN_SEED)
        tmodel = build_crnn(**FLY_ARCH).to(d.dev)
        tstate = create_train_state(tmodel, build_optimizer(tmodel))
        step, _ = make_step_fns(tmodel)
        rng = np.random.default_rng(TRAIN_SEED)
        xb = torch.as_tensor(rng.random((FLY_TRAIN_BATCH, 1, 21, F), np.float32), device=d.dev)
        yb = torch.as_tensor(rng.random((FLY_TRAIN_BATCH, 21, F), np.float32), device=d.dev)
        step_ms = time_ms(lambda: step(tstate, xb, yb), reps=10)
        print(f"phase 3i: model-mask lane {mask_ms:.3f} ms a block (K={K}, {SERVE_BLOCK} frames, "
              f"CUDA events, mean of 10); resident train step {step_ms:.3f} ms at batch "
              f"{FLY_TRAIN_BATCH} (canonical CRNN, n_ch 1)", flush=True)

        legs = {}
        legs["rollback"] = pc.check_rollback(failures, tmp / "rollback", clips, configs, FLY_ARCH,
                                             variables, device=d.dev)
        require(not failures, failures)
        legs["promote"] = pc.check_promote(failures, tmp / "promote", clips, configs, FLY_ARCH,
                                           variables, device=d.dev)
        require(not failures, failures)
        legs["pre_swap"] = pc.check_pre_swap(failures, tmp / "pre_swap", clips, configs,
                                             FLY_ARCH, variables, device=d.dev)
        require(not failures, failures)
        legs["controller"] = pc.check_controller_crash(failures, tmp / "controller", clips[0],
                                                       configs[0], FLY_ARCH, variables,
                                                       device=d.dev)
        require(not failures, failures)
        print(f"phase 3i: zeroed candidate {legs['rollback']['candidate']} demoted on "
              f"canary_sdr_db after {legs['rollback']['rounds']} rounds; perturbed candidate "
              f"{legs['promote']['candidate']} promoted after {legs['promote']['rounds']} rounds "
              f"(tap_to_promotion_ms {legs['promote']['tap_to_promotion_ms']}); pre_swap crash "
              f"after {legs['pre_swap']['blocks_before_crash']} blocks, restart promoted a fresh "
              f"candidate; mid_canary and post_gate crashes rolled back "
              f"({legs['pre_swap']['crashes_injected'] + legs['controller']['crashes_injected']} "
              "crashes injected); every stream bit-identical to its per-generation oracle",
              flush=True)

        camp = endure.campaign(failures, tmp / "endure", lambda leg: endure_clips[leg],
                               configs[0], FLY_ARCH, variables, legs=("mid_epoch", None),
                               min_generations=1, batch_size=FLY_TRAIN_BATCH, device=d.dev)
        endure.campaign_end_asserts(failures, camp, min_generations=1)
        require(not failures, failures)
        hist = REGISTRY.snapshot()["histograms"].get("tap_to_promotion_ms") or {}
        print(f"phase 3i: endurance legs (mid_epoch crash, then clean): "
              f"{len(camp['promoted'])} trainer generations promoted "
              f"({[g for _, g in camp['promoted']]}), {camp['crashes']} crash, "
              f"{camp['train_steps']} train steps, {camp['shards_written']} shards written, "
              f"{camp['blocks_dropped']} dropped, {camp['blocks']} blocks in "
              f"{camp['serve_seconds']:.3f} s, SLO sampled {camp['slo_samples']} times, "
              f"tap_to_promotion_ms p50 {hist.get('p50')} p95 {hist.get('p95')} over "
              f"{hist.get('count')} promotions", flush=True)
    d.flywheel = {"serve": rate, "mask_ms": mask_ms, "train_step_ms": step_ms,
                  "tap_to_promotion_ms": hist}
    print(f"phase 3i took {time.perf_counter() - t_phase:.1f} s", flush=True)


def stream_windows(d: SimpleNamespace, first: int, last: int, state, precision: str = "f32"):
    """Windows ``first`` .. ``last - 1`` of the clip through
    ``streaming_clip_fused`` from ``state``; returns (the (K, n * LW)
    output, the state after each window)."""
    import torch

    from disco_tpu_torch.enhance.fused import streaming_clip_fused

    outs, states = [], []
    for w in range(first, last):
        sl = slice(w * LW, (w + 1) * LW)
        o = streaming_clip_fused(d.y[..., sl], d.s[..., sl], d.n[..., sl], state=state,
                                 solver="jacobi-pallas", blocks_per_dispatch=BLOCKS_PER_DISPATCH,
                                 precision=precision)
        state = o["state"]
        outs.append(o["yf"])
        states.append(state)
    return torch.cat(outs, dim=-1), states


#: phase 3j: the scope gate's north-star clients — (seed, SessionConfig
#: kwargs, traced?): two traced sessions and one that sends no trace header
SCOPE_SPECS = ((71, {}, True), (72, {"mu": 1.2}, True), (74, {}, False))
#: phase 3j: the launches each gate leg makes on the card (a kernel it does
#: not name: none)
GATE_LAUNCHES = {
    # north-star clip: 3 STFTs (y, s, n); the degraded and the clean tango,
    # each 2 covariance and 2 fused-solve launches
    "fault": {"stft": 3, "masked_cov": 4, "fused_mwf": 4},
    # six one-chunk runs of the mini corpus (the reference, the mid_write
    # crash and its resume, the between_clips crash and its resume, the
    # requeue): 1 STFT and 2 covariance launches each
    "chaos": {"stft": 6, "masked_cov": 12},
    # the two engines' chunks, then leg 5: the STFT, the covariances, one
    # fused solve, and step 1 of compute_z_signals (3 STFT, 1 covariance and
    # 1 fused-solve launch)
    "perf": {"stft": 6, "masked_cov": 6, "fused_mwf": 2},
    # one scene batch for the per-scene comparison, 8 for the stream leg
    "scene": {"stft": 9},
    # scope: the four clients' STFTs; 2 eigensolver launches for each of
    # the four offline references and for each served block (3 sessions of
    # 10 blocks, and the wounded session's 10; a faulted attempt launches
    # nothing)
    "scope": {"stft": 4, "eigh_jacobi": 88},
    # soak (the default 'eigh' solver: cuSOLVER): the STFTs of seed 201's two
    # sessions, twice, and of the crash leg's one
    "soak": {"stft": 5},
    # the sentinel leg reads back what phase 2 computed: no launch
    "sentinel": {},
}


def phase3j_gates(d: SimpleNamespace) -> None:
    """The gates on the card, each a function of the device
    (``disco_tpu_torch.{fault,runs,enhance,scenes}.check``,
    ``obs.scope``, ``runs.soak``), each with its launches counted: the
    fault gate on the north-star clip (``solver='fused'``), the chaos and
    corpus-engine gates on the gates' 2-clip mini corpus, the scene gate's
    oracle, per-scene, dynamic and stream legs at its size (its dispatch
    budget and log legs ride phase 3g's SceneStream run), scope at the
    north-star width (two traced sessions and one untraced, 64-frame
    blocks, ``solver='jacobi-pallas'``, and the fault leg's quarantine
    dump), the soak at its size (one seed twice, and the crash leg); then
    a sentinel trip on the north-star ``Y`` and the time of one
    ``check_finite`` of it."""
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch import obs
    from disco_tpu_torch.enhance import check as perf_check
    from disco_tpu_torch.fault import check as fault_check
    from disco_tpu_torch.obs import scope, sentinels
    from disco_tpu_torch.obs.accounting import device_get_count, fence_count
    from disco_tpu_torch.runs import check as chaos_check
    from disco_tpu_torch.runs import soak
    from disco_tpu_torch.scenes import check as scene_check

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    failures: list = []
    seconds = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        with counted(f"gate {name}", GATE_LAUNCHES[name], d.launches):
            out = fn()
        seconds[name] = time.perf_counter() - t0
        require(not failures, (name, failures))
        print(f"phase 3j: {name} gate passed on the card ({seconds[name]:.1f} s): "
              + json.dumps(out, default=str), flush=True)

    with tempfile.TemporaryDirectory(prefix="gates-", dir=build) as tmp:
        tmp = Path(tmp)
        leg("fault", lambda: fault_check.check_faults(
            failures, tmp / "fault", device=d.dev, n_nodes=K, n_mics=C, length=d.L,
            solver="fused"))

        def chaos():
            with obs.recording(tmp / "chaos.jsonl"):
                out = chaos_check.check_chaos(failures, tmp / "chaos", device=d.dev)
            out.update(chaos_check.check_chaos_events(
                failures, obs.read_events(tmp / "chaos.jsonl"), out["crashes_injected"]))
            return out

        leg("chaos", chaos)

        def perf():
            with obs.recording(tmp / "perf.jsonl"):
                out = perf_check.check_engine(failures, tmp / "perf", device=d.dev)
            perf_check.check_engine_events(failures, obs.read_events(tmp / "perf.jsonl"))
            return {**out, "parity": perf_check.check_fused_parity(failures, device=d.dev)}

        leg("perf", perf)

        def scene():
            out = {}
            out.update(scene_check.check_oracle_parity(failures, device=d.dev))
            out.update(scene_check.check_batched_equals_per_scene(failures, device=d.dev))
            out.update(scene_check.check_dynamic_continuity(failures, device=d.dev))
            out.update(scene_check.check_stream(failures, tmp / "scene", device=d.dev))
            return out

        (tmp / "scene").mkdir()
        leg("scene", scene)
        leg("scope", lambda: scope.run_scope(
            failures, tmp / "scope", device=d.dev, specs=SCOPE_SPECS, solver="jacobi-pallas",
            n_nodes=K, n_mics=C, block=SERVE_BLOCK, update_every=SERVE_U, length=d.L))

        def soak_legs():
            summary = soak.check_byte_stable(failures, tmp / "soak", soak.SEEDS[0], device=d.dev)
            crash = soak.crash_leg(soak.SEEDS[-1], tmp / "soak", failures, device=d.dev)
            return {"seed": summary["seed"], "blocks": summary["blocks"],
                    "all_parks_reattached": summary["all_parks_reattached"],
                    "transport_faults_injected": summary["transport_faults_injected"],
                    "quarantines": summary["quarantines"], "crash_leg": crash}

        leg("soak", soak_legs)

        def sentinel():
            """A NaN in the north-star Y trips one sentinel with its stats and
            one flight dump; a clean check of it is timed by CUDA events."""
            Y = d.Y
            nan = Y.clone()
            nan[3, 1, 100, 200] = complex(float("nan"), 0.0)
            ms, fences = [], []
            with armed(tmp / "sentinel.jsonl", tmp / "sentinel_flight"):
                g0 = device_get_count()
                for _ in range(5):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    f0 = fence_count()
                    start.record()
                    ok = sentinels.check_finite("stft_Y", Y, stage="stft")
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                    fences.append(fence_count() - f0)
                    require(ok, "the clean north-star Y tripped a sentinel")
                tripped = not sentinels.check_finite("stft_Y", nan, stage="stft")
                gets = device_get_count() - g0
            (ev,) = [e["attrs"] for e in obs.read_events(tmp / "sentinel.jsonl")
                     if e["kind"] == "sentinel"]
            dumps = list((tmp / "sentinel_flight").glob("flight-*-sentinel.json"))
            want = {"name": "stft_Y", "shape": list(Y.shape), "dtype": "complex64",
                    "n_nonfinite": 1, "n_nan": 1, "n_inf": 0}
            require(tripped and len(dumps) == 1 and gets == 0
                    and {k: ev[k] for k in want} == want, ("sentinel trip", ev, dumps, gets))
            return {"check_finite_ms": ms, "median_ms": sorted(ms)[2],
                    "bytes": Y.numel() * Y.element_size(), "fences_a_check": fences,
                    "batched_readbacks": gets, "event": ev, "dumps": len(dumps)}

        leg("sentinel", sentinel)
    total = time.perf_counter() - t_phase
    print(f"phase 3j took {total:.1f} s (legs {json.dumps(seconds)})", flush=True)


#: phase 3k: the command line at the CLIs' own full width (the DISCO array
#: of 4 nodes x 4 mics at 16 kHz, ISM order 20, 5-10 s talkers), depth cut
#: to 2 RIRs; the server's client session streams the north-star clip
CLI_ORDER, CLI_DURATION, CLI_RIRS = 20, (5, 10), 2


def stop_process(proc, timeout_s: float = 60.0) -> tuple:
    """Stop a process this script started: SIGINT (the servers' graceful
    drain) and a bounded wait; ``(stdout, stderr)``.  Only a process still
    running after the wait is killed — the script stops every process it
    starts."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        return proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()  # disco-torch-lint: disable=DL008 -- last resort after SIGINT and a bounded wait: the script must stop every process it starts
        return proc.communicate()


def serve_post_mortem(proc, client, log) -> None:
    """Print why a served session ended: the frames the client had not read
    yet (the server's error frame), the server's own output, and the error
    and eviction events of its log."""
    import queue

    frames = []
    with suppress(queue.Empty):
        while True:
            item = client._frames.get_nowait()
            if isinstance(item, dict) and item.get("type") != "enhanced":
                frames.append(item)
            elif item is None or isinstance(item, BaseException):
                frames.append(repr(item))
    print(f"disco-serve post-mortem: unread frames {frames}", flush=True)
    out, err = stop_process(proc)
    print(f"disco-serve post-mortem: exit code {proc.returncode}\n-- stdout\n{out[-8000:]}"
          f"\n-- stderr\n{err[-8000:]}", flush=True)
    if log.exists():
        lines = [ln for ln in log.read_text().splitlines()
                 if any(w in ln for w in ("error", "evict", "quarantine", "fail"))]
        print("disco-serve post-mortem: log events\n" + "\n".join(lines[-40:]), flush=True)


def cli_serve(d: SimpleNamespace, tmp) -> dict:
    """``python -m disco_tpu_torch.cli.serve`` as a process on the card: one
    north-star session (K=8, C=4, blocks of 64 frames, ``jacobi-pallas``)
    bit-identical to the offline whole-clip ``streaming_tango`` computed
    here; ``disco-obs slo`` on its socket; SIGINT drains it to exit 0."""
    import os
    import signal
    from pathlib import Path

    from disco_tpu_torch.cli import obs as obs_cli
    from disco_tpu_torch.device import to_host
    from disco_tpu_torch.serve import ServeClient
    from disco_tpu_torch.serve import check as sc

    Yh, mh = to_host([d.Y, d.m])
    ref = sc.offline_stream(Yh, mh, device=d.dev, update_every=SERVE_U, solver="jacobi-pallas")
    config = sc.session_config(Yh.shape[-2], n_nodes=K, n_mics=C, block_frames=SERVE_BLOCK,
                               update_every=SERVE_U, solver="jacobi-pallas")
    sock, log = tmp / "serve.sock", tmp / "serve.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "disco_tpu_torch.cli.serve", "--unix", str(sock),
         "--obs-log", str(log), "--state-dir", str(tmp / "serve_state"),
         "--device", d.dev.type],
        cwd=Path(__file__).resolve().parent, env={**os.environ, "PYTHONUNBUFFERED": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while not sock.exists():
            require(proc.poll() is None, ("disco-serve exited", proc.returncode))
            require(time.perf_counter() - t0 < 180, "disco-serve did not bind in 180 s")
            time.sleep(0.1)
        bound_s = time.perf_counter() - t0
        cl = ServeClient(str(sock))
        try:
            cl.open(config)
            t1 = time.perf_counter()
            got = cl.enhance_clip(Yh, mh, mh)
            stream_s = time.perf_counter() - t1
            cl.close()
        except Exception:
            serve_post_mortem(proc, cl, log)
            raise
        cl.shutdown()
        same = bool(np.array_equal(got, ref))
        try:
            verdict = obs_cli.main(["slo", str(sock)])["verdict"]
        except SystemExit:  # a violated target: the verdict, printed above
            verdict = "VIOLATED"
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            stop_process(proc)
    blocks = -(-Yh.shape[-1] // SERVE_BLOCK)
    print(f"phase 3k: disco-serve on the card: bound in {bound_s:.1f} s, {blocks} blocks of "
          f"{SERVE_BLOCK} frames in {stream_s:.2f} s ({cl.reattaches} reattaches), bit-identical "
          f"to the offline stream {same}, slo verdict {verdict}, exit code {proc.returncode} "
          f"after SIGINT", flush=True)
    require(same, "the served stream differs from the offline streaming_tango")
    require(proc.returncode == 0 and "drained gracefully" in out, ("disco-serve drain", out, err))
    return {"blocks": blocks, "bit_identical": same, "slo": verdict, "bound_s": bound_s,
            "stream_s": stream_s, "reattaches": cl.reattaches}


def phase3k_command_line(d: SimpleNamespace) -> None:
    """The reference workflow through the port's CLIs (``main(argv)``
    in-process, the server as a process) on the card: gen → mix → get-z →
    lists → train → tango (the corpus with ``--solver fused`` against the
    direct ``enhance_rirs_batched`` call, byte for byte with equal
    launches; one clip streaming with the eigensolver; one clip with the
    trained CRNN) → aggregate, then scenes, gen-meetit and serve."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.cli import (
        aggregate,
        gen_disco,
        gen_meetit,
        get_z,
        lists,
        mix,
        scenes,
        tango,
        train,
    )
    from disco_tpu_torch.cli import obs as obs_cli
    from disco_tpu_torch.enhance.driver import enhance_rirs_batched
    from disco_tpu_torch.nn.convert import state_dict_from_flax
    from disco_tpu_torch.nn.serialization import unpackb

    t_phase = time.perf_counter()
    installed = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "yaml")}
    print(f"phase 3k: importable on this machine: {json.dumps(installed)}", flush=True)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    seconds, direct = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 2)
        print(f"phase 3k: {name} ({seconds[name]:.1f} s)", flush=True)
        return out

    with tempfile.TemporaryDirectory(prefix="cli-", dir=build) as tmp:
        tmp = Path(tmp)
        sim_corpus(tmp)
        ds, talkers = str(tmp / "ds"), str(tmp / "talkers")
        common = ["--scenario", "living", "--noise", "ssn"]
        rirs = ["--rirs", "1", str(CLI_RIRS)]
        with tally("3k gen, mix", d.launches):
            done = step("disco-gen", lambda: gen_disco.main(
                ["--dset", "train", "--scenario", "living", *rirs, "--dir_out", ds,
                 "--librispeech", talkers, "--max_order", str(CLI_ORDER),
                 "--duration", *map(str, CLI_DURATION)]))
            require(done == list(range(1, CLI_RIRS + 1)), ("disco-gen", done))
            step("disco-mix", lambda: mix.main([*rirs, *common, "--dir", ds]))
        with tally("3k get-z, train", d.launches):
            n = step("disco-get-z", lambda: get_z.main([*rirs, *common, "--dataset", ds]))
            require(n == CLI_RIRS, ("disco-get-z", n))
            n_files = ["--n_files", str(CLI_RIRS + 1)]
            out = step("disco-lists", lambda: lists.main(
                ["--scene", "living", "--noise", "ssn", *n_files, "--path_data", ds,
                 "--out", str(tmp / "lists")]))
            require(len(out) == 12 and len(out[0]) == CLI_RIRS, "disco-lists")
            train_argv = ["--scene", "living", "--noise", "ssn", *n_files, "--path_data", ds,
                          "--n_epochs", "2", "--single_channel"]
            run = step("disco-train", lambda: train.main(
                train_argv + ["--save_path", str(tmp / "models")]))
        ckpt = tmp / "models" / f"{run}_model.msgpack"
        require(ckpt.exists(), ("the trained checkpoint", ckpt))
        # phase 3m's CLI twin: --data-parallel 1, in the 1-rank world the
        # command opens
        with tally("3k train --data-parallel 1", d.launches):
            run_dp = step("disco-train --data-parallel 1", lambda: train.main(
                train_argv + ["--save_path", str(tmp / "models_dp"), "--data-parallel", "1"]))
        same_ckpt = (tmp / "models_dp" / f"{run_dp}_model.msgpack").read_bytes() == \
            ckpt.read_bytes()
        print(f"phase 3m (on phase 3k's tree): disco-train --data-parallel 1 checkpoint "
              f"byte-identical to the meshless command's {same_ckpt}", flush=True)
        require(same_ckpt, "disco-train --data-parallel 1 differs from the meshless command")

        log = tmp / "tango.jsonl"
        with tally("3k tango --rirs --solver fused", d.launches):
            res = step("disco-tango --rirs --solver fused", lambda: tango.main(
                [*rirs, *common, "--dataset", ds, "--solver", "fused",
                 "--out_root", str(tmp / "res_cli"), "--obs-log", str(log)]))
        with tally("direct", direct):
            step("enhance_rirs_batched (direct)", lambda: enhance_rirs_batched(
                ds, "living", range(1, CLI_RIRS + 1), "ssn", out_root=str(tmp / "res_direct"),
                solver="fused", bucket=8192, max_batch=16))
        cli_launches = d.launches["3k tango --rirs --solver fused"]
        require(cli_launches == direct["direct"] and cli_launches["stft"] > 0
                and cli_launches["masked_cov"] > 0 and cli_launches["fused_mwf"] > 0,
                ("CLI vs direct launches", cli_launches, direct["direct"]))
        tree_cli, tree_direct = _tree(tmp / "res_cli"), _tree(tmp / "res_direct")
        same = tree_cli == tree_direct
        figs = sorted(k for k in tree_cli if k.startswith("FIG/"))
        print(f"phase 3k: disco-tango vs enhance_rirs_batched: {len(tree_cli)} artifacts, "
              f"byte-identical {same}; figures written: {figs}", flush=True)
        require(same and len(res) == CLI_RIRS, "the CLI's tree differs from the direct call's")
        # phase 3m's CLI twin: --mesh 1 1, in the 1-rank world the command
        # opens
        with tally("3k tango --rirs --mesh 1 1", d.launches):
            step("disco-tango --rirs --solver fused --mesh 1 1", lambda: tango.main(
                [*rirs, *common, "--dataset", ds, "--solver", "fused",
                 "--out_root", str(tmp / "res_mesh"), "--mesh", "1", "1"]))
        same_mesh = _tree(tmp / "res_mesh") == tree_cli
        mesh_launches = d.launches["3k tango --rirs --mesh 1 1"] == cli_launches
        print(f"phase 3m (on phase 3k's tree): disco-tango --mesh 1 1 vs the meshless command: "
              f"byte-identical {same_mesh}, launches equal {mesh_launches}", flush=True)
        require(same_mesh and mesh_launches, "disco-tango --mesh 1 1 differs")
        report = step("disco-obs report", lambda: obs_cli.main(["report", str(log)]))
        require(report["clips"] == CLI_RIRS and report["manifest"]["tool"] == "disco-tango",
                "disco-obs report of the tango log")

        with tally("3k tango --rir --streaming", d.launches):
            res = step("disco-tango --rir 1 --streaming --solver jacobi-pallas", lambda: tango.main(
                ["--rir", "1", *common, "--dataset", ds, "--streaming",
                 "--solver", "jacobi-pallas", "--out_root", str(tmp / "res_stream")]))
        require(d.launches["3k tango --rir --streaming"]["eigh_jacobi"] > 0
                and bool(np.isfinite(res["sdr_cnv"]).all()), "the streaming lane")

        loaded, real = [], tango._load_model

        def recording_load(*args, **kw):
            loaded.append(real(*args, **kw))
            return loaded[-1]

        tango._load_model = recording_load
        try:
            with tally("3k tango --rir --mods", d.launches):
                res = step("disco-tango --rir 2 --mods <checkpoint> None", lambda: tango.main(
                    ["--rir", "2", *common, "--dataset", ds, "--mods", str(ckpt), "None",
                     "--out_root", str(tmp / "res_crnn")]))
        finally:
            tango._load_model = real
        model = loaded[0]
        payload = unpackb(ckpt.read_bytes())
        want = state_dict_from_flax({"params": payload["params"],
                                     "batch_stats": payload["batch_stats"]}, model)
        have = model.state_dict()
        require(loaded[1] is None and all(torch.equal(have[k].cpu(), v.cpu())
                                          for k, v in want.items())
                and bool(np.isfinite(res["sdr_cnv"]).all()),
                "the CRNN lane did not run the trained checkpoint")

        summary = step("disco-aggregate --json", lambda: aggregate.main(
            [str(tmp / "res_cli" / "OIM"), "--json"]))
        require(summary["sdr_cnv"]["n"] == 4 * CLI_RIRS, ("disco-aggregate", summary["sdr_cnv"]))
        with tally("3k scenes, gen-meetit", d.launches):
            step("disco-scenes simulate --batches 1",
                 lambda: scenes.main(["simulate", "--batches", "1"]))
            done = step("disco-gen-meetit --rirs 1 1", lambda: gen_meetit.main(
                ["--rirs", "1", "1", "--dir_out", str(tmp / "meetit"), "--librispeech", talkers]))
        require(done == [1], ("disco-gen-meetit", done))
        step("disco-serve", lambda: cli_serve(d, tmp))
    total = time.perf_counter() - t_phase
    print(f"phase 3k took {total:.1f} s (steps {json.dumps(seconds)})", flush=True)


#: phase 3l: the milestones' timing iterations (the JAX package's defaults are
#: 3, and 1 for configuration 5; 1 here: ten runs a configuration, thirty for
#: the streaming one's three policies); the card's quality fields against the
#: host's plain versions in dB (``si_sdr_in`` scores the same numpy arrays on
#: both).  Separation (configuration 4) has no noise, so each source's
#: interference covariance is near rank-deficient and float32 roundoff alone
#: moves its per-node gains: on the host, covariances summed in float64 and
#: rounded once moved node 3's by 0.065 dB, and the card sat 0.062 dB from the
#: host there; the other configurations' gaps were under 1e-3 dB.
#: Configuration 5's rooms in that comparison (the same room shapes)
MILESTONE_ITERS = 1
MILESTONE_TOL = {"in_db": 1e-6, "out_db": 0.02, "separation_db": 0.2}
MILESTONE_HOST_ROOMS = 4
#: (STFT, covariance) launches of one call of each configuration: before its
#: timed runs, and in each run (a ``_timed`` call runs 3 + 7 x iters times)
MILESTONE_LAUNCHES = {1: ((0, 0), (1, 0)), 2: ((0, 0), (3, 1)), 3: ((1, 0), (0, 2)),
                      4: ((0, 0), (1, 2)), 5: ((0, 0), (1, 2)), 6: ((1, 0), (0, 0))}


@contextmanager
def untimed(milestones):
    """The milestones' timing stubbed (``_time_queued`` returns at once), so
    a configuration runs its pipeline once, for its output; its times are
    not read."""
    real = milestones._time_queued
    milestones._time_queued = lambda fn, *args, k=1, iters=5: float(k)
    try:
        yield
    finally:
        milestones._time_queued = real


@contextmanager
def tee_stdout(lines: list):
    """Standard output also collected into ``lines``."""
    out, parts = sys.stdout, []

    class Tee:
        def write(self, s):
            parts.append(s)
            return out.write(s)

        def flush(self):
            out.flush()

    with redirect_stdout(Tee()):
        yield
    lines.extend("".join(parts).splitlines())


def phase3l_milestones(d: SimpleNamespace) -> None:
    """The BASELINE milestones (``disco_tpu_torch.milestones``) at their own
    scales on the card, each launch counted; the card's quality fields
    against the host's plain versions; the tiny corpus milestone through
    ``disco-torch-milestones --corpus``."""
    import tempfile
    from pathlib import Path

    from disco_tpu_torch import milestones
    from disco_tpu_torch.cli import bench_milestones

    t_phase = time.perf_counter()
    seconds, card = {}, {}
    for i, fn in milestones.CONFIGS.items():
        (s0, c0), (s1, c1) = MILESTONE_LAUNCHES[i]
        runs = (3 + 7 * MILESTONE_ITERS) * (3 if i == 6 else 1)
        t0 = time.perf_counter()
        with counted(f"3l {fn.__name__}", {"stft": s0 + runs * s1, "masked_cov": c0 + runs * c1},
                     d.launches):
            card[i] = fn(iters=MILESTONE_ITERS, device=d.dev)
        seconds[fn.__name__] = round(time.perf_counter() - t0, 2)
        print(f"phase 3l: {json.dumps(card[i])}", flush=True)
    mvdr, mwf, tng, sep, batched, stream = (card[i] for i in sorted(card))
    # the JAX package's gates (tests/test_milestones.py)
    require(all(r["rtf"] > 0 for r in (mvdr, mwf, tng, sep, batched)), "a milestone's rtf")
    require(mvdr["si_sdr_out"] > mvdr["si_sdr_in"] + 3, ("MVDR improves by 3 dB", mvdr))
    require(all(x > 1 for r in (mwf, tng) for x in r["delta_si_sdr"]),
            ("MWF and TANGO improve by 1 dB at every node", mwf, tng))
    # at its BASELINE scale separation loses at 2 of the 8 nodes in the JAX
    # package too (-0.37 and -1.20 dB at nodes 5 and 7 on the CPU): the JAX
    # test gates each node at its tiny scale, run below; here the mean
    require(float(np.mean(sep["delta_si_sdr"])) > 0, ("separation improves", sep))
    require(bool(np.isfinite(batched["mean_si_sdr_out"])) and batched["rooms"] == 64,
            ("the batched run", batched))
    require(sorted(stream["policies"]) == ["distant", "local", "none"]
            and all(p["per_frame_ms"] > 0 for p in stream["policies"].values()),
            ("streaming latency", stream))

    t0 = time.perf_counter()
    rooms = {"n_rooms": MILESTONE_HOST_ROOMS}
    with untimed(milestones):
        card[5] = milestones.CONFIGS[5](**rooms, device=d.dev)
        tiny_sep = milestones.CONFIGS[4](**milestones.TINY[4], device=d.dev)
        host = {i: milestones.CONFIGS[i](**(rooms if i == 5 else {}), device="cpu")
                for i in range(1, 6)}
    seconds["card against host"] = round(time.perf_counter() - t0, 2)
    print(f"phase 3l: {json.dumps(tiny_sep)}", flush=True)
    require(all(x > 0 for x in tiny_sep["delta_si_sdr"]), ("tiny separation improves", tiny_sep))
    gaps = {}
    for i, want in host.items():
        for key in ("si_sdr_in", "si_sdr_out", "delta_si_sdr", "mean_si_sdr_out"):
            if key in want:
                gaps[f"{i} {key}"] = float(np.max(np.abs(np.subtract(card[i][key], want[key]))))
    print(f"phase 3l: card against host (dB): {json.dumps(gaps)}", flush=True)
    for name, gap in gaps.items():
        tol = ("in_db" if name.endswith("si_sdr_in")
               else "separation_db" if name.startswith("4 ") else "out_db")
        require(gap <= MILESTONE_TOL[tol], ("card against host", name, gap))

    t0 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    lines = []
    with tempfile.TemporaryDirectory(prefix="milestones-", dir=build) as tmp:
        with tally("3l corpus milestone", d.launches), tee_stdout(lines):
            results = bench_milestones.main(["--corpus", "--tiny", "--configs", "1",
                                             "--workdir", tmp, "--device", "cuda"])
    seconds["disco-torch-milestones --corpus --tiny"] = round(time.perf_counter() - t0, 2)
    printed = [json.loads(line) for line in lines if line.startswith("{")]
    corpus = printed[0]
    require(corpus["config"] == "corpus_pipeline" and printed[1:] == results
            and results[0]["config"] == "mvdr_single_clip", ("the printed lines", printed))
    oracle, crnn = corpus["tango_4node_oracle"], corpus["tango_4node_crnn"]
    print(f"phase 3l: corpus milestone, oracle {json.dumps(oracle)}; CRNN {json.dumps(crnn)}",
          flush=True)
    require(all(np.isfinite(e[k]) for e in (oracle, crnn)
                for k in ("delta_sdr_512tap", "delta_si_sdr", "delta_stoi")),
            ("a corpus delta is not finite", corpus))
    require(oracle["delta_sdr_512tap"] > 2.0, ("oracle masks on pipeline data", oracle))
    require(results[0]["si_sdr_out"] > results[0]["si_sdr_in"] + 3, ("tiny MVDR", results[0]))
    used = d.launches["3l corpus milestone"]
    require(used["stft"] > 0 and used["masked_cov"] > 0, ("the corpus milestone's launches", used))
    total = time.perf_counter() - t_phase
    print(f"phase 3l took {total:.1f} s (parts {json.dumps(seconds)})", flush=True)


#: phase 3m: the fields of a TangoResult that the sharded paths compute
MESH_FIELDS = ("yf", "sf", "nf", "z_y", "z_s", "z_n", "zn")
#: phase 3m: the fit on the 1-rank mesh — windows of phase 3f's batch in two
#: training batches and one validation batch, two epochs
MESH_FIT_EPOCHS = 2


def _same_result(a, b) -> bool:
    """Bit for bit, NaN where the other has NaN."""
    import torch

    return all(torch.equal(torch.nan_to_num(getattr(a, f), nan=0.0),
                           torch.nan_to_num(getattr(b, f), nan=0.0))
               and torch.equal(getattr(a, f).isnan(), getattr(b, f).isnan())
               for f in MESH_FIELDS)


def mesh_twin(d: SimpleNamespace, label: str, meshless, sharded, kernels) -> tuple:
    """Run the meshless call and its sharded twin with the counters set to
    0 before each and read after; the twin must launch what the meshless
    call does, and each kernel of ``kernels`` at least once."""
    import torch

    with tally(f"3m {label} (meshless)", d.launches):
        want = meshless()
    with tally(f"3m {label}", d.launches):
        got = sharded()
    torch.cuda.synchronize()
    a, b = d.launches[f"3m {label}"], d.launches[f"3m {label} (meshless)"]
    require(a == b and all(a[k] > 0 for k in kernels), ("3m launches", label, a, b))
    return got, want


def phase3m_multi_gpu(d: SimpleNamespace) -> None:
    """Multi-GPU (``disco_tpu_torch.parallel``) at world size 1 on the one
    card: a 1-rank NCCL world carries a ``(batch 1, node 1)`` mesh, and
    every sharded path runs its collectives over it and is held against
    its meshless twin on the north-star clip, launch for launch; the
    flywheel gate's data-parallel leg then opens and tears down a world of
    its own.  The cross-rank exchanges are held by the CPU tests on gloo
    ranks."""
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from disco_tpu_torch.enhance.tango import oracle_masks, tango
    from disco_tpu_torch.flywheel import write_shard
    from disco_tpu_torch.flywheel.check import check_data_parallel
    from disco_tpu_torch.nn.training import fit
    from disco_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        single_rank_world,
        tango_batch_sharded,
        tango_frame_sharded,
        tango_sharded,
    )
    from disco_tpu_torch.promote.check import tiny_arch

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=build) as tmp:
        tmp = Path(tmp)
        with single_rank_world("cuda"):
            require(dist.get_world_size() == 1 and "nccl" in str(dist.get_backend()),
                    "phase 3m needs a 1-rank NCCL world")
            mesh = make_mesh(device="cuda")
            Y, S, N, m = d.Y, d.S, d.N, d.m
            checks = {}

            # node-sharded: fused solve and covariance kernels, bit for bit
            got, want = mesh_twin(
                d, "tango_sharded fused", lambda: tango(Y, S, N, m, m, solver="fused"),
                lambda: tango_sharded(Y, S, N, m, m, mesh, solver="fused"),
                ("masked_cov", "fused_mwf"))
            checks["node fused"] = _same_result(got, want)
            ring = tango_sharded(Y, S, N, m, m, mesh, solver="fused", z_exchange="ring")
            checks["ring = all_gather"] = _same_result(ring, got)
            del ring, got, want
            # the fault mask: node 2 dropped, node K - 3's z NaN (a NaN frame
            # in its mixture makes its step-1 statistics and so its z NaN; the
            # guard excludes it)
            bad = K - 3
            Yf = Y.clone()
            Yf[bad, :, :, Y.shape[-1] // 2] = float("nan")
            zm = torch.ones(K, device=d.dev)
            zm[2] = 0.0
            got, want = mesh_twin(
                d, "tango_sharded z_mask",
                lambda: tango(Yf, S, N, m, m, solver="fused", z_mask=zm),
                lambda: tango_sharded(Yf, S, N, m, m, mesh, solver="fused", z_mask=zm),
                ("masked_cov", "fused_mwf"))
            others = [k for k in range(K) if k != bad]
            checks["z_mask"] = (_same_result(got, want)
                                and bool(torch.isfinite(got.yf[others]).all()))
            del got, want, Yf
            got, want = mesh_twin(
                d, "tango_sharded jacobi-pallas",
                lambda: tango(Y, S, N, m, m, solver="jacobi-pallas"),
                lambda: tango_sharded(Y, S, N, m, m, mesh, solver="jacobi-pallas"),
                ("masked_cov", "eigh_jacobi"))
            checks["node jacobi-pallas"] = _same_result(got, want)
            del got, want

            # frame-sharded: the einsum covariances (no covariance kernel), the
            # solve
            mesh2 = make_mesh_2d(1, 1, device="cuda")
            with tally("3m tango_frame_sharded", d.launches):
                frame = tango_frame_sharded(Y, S, N, m, m, mesh2, solver="fused")
            ref = tango(Y, S, N, m, m, solver="fused")
            frame_err = max(max_rel(getattr(frame, f), getattr(ref, f)) for f in MESH_FIELDS)
            fl = d.launches["3m tango_frame_sharded"]
            checks["frame"] = (frame_err <= TOL["clip"] and fl["masked_cov"] == 0
                               and fl["fused_mwf"] == 2)
            del frame, ref

            # batch-sharded: the 16 distinct clips of phase 3d
            Yb, Sb, Nb = d.crnn_batch
            Mb = oracle_masks(Sb, Nb, "irm1")
            got, want = mesh_twin(
                d, "tango_batch_sharded", lambda: tango(Yb, Sb, Nb, Mb, Mb, solver="fused"),
                lambda: tango_batch_sharded(Yb, Sb, Nb, Mb, Mb, mesh, solver="fused"),
                ("masked_cov", "fused_mwf"))
            checks["batch"] = _same_result(got, want)
            del got, want, Mb
            torch.cuda.empty_cache()
            t_tango = time.perf_counter() - t_phase

            # fit on the 1-rank mesh against the meshless fit: losses,
            # parameters and checkpoint bytes
            x0, y0 = (np.asarray(a) for a in d.train["batch"])
            half = len(x0) // 2
            train = [(x0[:half], y0[:half]), (x0[half:], y0[half:])]
            fits = {}
            for lane, msh in (("meshless", None), ("mesh", mesh)):
                model, state = canonical_train_state(x0.shape[1], device=d.dev)
                with tally(f"3m fit {lane}", d.launches):
                    _, tr, va, _ = fit(model, state, lambda: iter(train),
                                       lambda: iter(train[:1]), MESH_FIT_EPOCHS,
                                       save_path=tmp / lane, run_name="m3", verbose=False,
                                       mesh=msh)
                fits[lane] = (tr, va, {k: v.clone() for k, v in model.state_dict().items()},
                              (tmp / lane / "m3_model.msgpack").read_bytes())
            (tr_a, va_a, sd_a, ck_a), (tr_b, va_b, sd_b, ck_b) = fits["meshless"], fits["mesh"]
            checks["fit"] = (np.array_equal(tr_a, tr_b) and np.array_equal(va_a, va_b)
                             and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
                             and ck_a == ck_b)
        # the flywheel gate's data-parallel leg at one rank, on shards of
        # seeded records of the served geometry, in the world it opens
        rng = np.random.default_rng(16)
        tap = tmp / "tap"
        tap.mkdir()
        for i in range(3):
            def cplx(*shape):
                return (rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape)).astype(np.complex64)
            write_shard(tap / f"tap-{i + 1:06d}.shard.msgpack", [
                {"session": "m3", "seq": 2 * i + j, "t": float(j), "Y": cplx(K, C, 257, 8),
                 "yf": cplx(K, 257, 8),
                 "mask_z": rng.uniform(0.05, 0.95, (K, 257, 8)).astype(np.float32),
                 "mask_w": rng.uniform(0.05, 0.95, (K, 257, 8)).astype(np.float32)}
                for j in range(2)])
        failures = []
        leg = check_data_parallel(failures, tap, tmp, tiny_arch(257, 4), win_len=4, ranks=1,
                                  device="cuda")
        checks["flywheel data-parallel leg"] = not failures
        if failures:
            print(f"phase 3m: flywheel leg failures {failures}", flush=True)
    print(f"phase 3m: 1-rank NCCL mesh on the card: {json.dumps(checks)}; frame-sharded "
          f"within {frame_err:.3e} of scale; flywheel leg {json.dumps(leg)}; "
          f"{t_tango:.1f} s for the TANGO twins, {time.perf_counter() - t_phase:.1f} s "
          "in all", flush=True)
    require(all(checks.values()), ("phase 3m", checks))


#: phase 3n: kernel op -> the launch counters of its kernel (f32, bf16)
KERNEL_OPS = {"disco_torch::stft": ("stft",), "disco_torch::stft_bf16": ("stft_bf16",),
              "disco_torch::masked_cov": ("masked_cov", "masked_cov_bf16"),
              "disco_torch::fused_mwf": ("fused_mwf", "fused_mwf_bf16"),
              "disco_torch::eigh_jacobi": ("eigh_jacobi",)}
#: phase 3n: stage timings, CUDA events, the median of this many runs
STAGE_RUNS = 5


def held_to_fake_trace(d: SimpleNamespace, label: str, golden: dict, trace) -> dict:
    """A program's run on the card under the recorder, held to its fake
    trace on what does not move with the torch version (its kernel ops,
    equal to the launch counters' deltas; its output signature; its host
    syncs; its float64 tensors on the device, those of the golden)."""
    from disco_tpu_torch.analysis.trace import fingerprint as fpm

    fp = fpm.fingerprint_trace(trace)
    counts = d.launches[label]
    launched = {op: sum(counts[c] for c in cs) for op, cs in KERNEL_OPS.items()
                if sum(counts[c] for c in cs)}
    require(launched == fp["kernel_ops"], (label, "launches vs kernel ops", launched,
                                           fp["kernel_ops"]))
    diffs = fpm.portable_diff(golden, fp)
    require(not diffs, (label, diffs))
    return fp


def phase3n_programs(d: SimpleNamespace) -> None:
    """The cost model, the program fingerprints and the roofline on the
    card: every catalog program of ``analysis.trace.programs`` run on real
    CUDA tensors under the recorder and held to its committed golden (made
    on fake tensors for the card); the north-star 16-clip offline batch
    held to its fake trace, made here; each stage of the headline workload
    timed with CUDA events and joined with the meter's stage costs into the
    roofline."""
    import torch

    from disco_tpu_torch.analysis.meter.stages import (
        HEADLINE,
        STAGE_KEYS,
        offline_stage_costs,
        stage_programs,
    )
    from disco_tpu_torch.analysis.trace import fingerprint as fpm
    from disco_tpu_torch.analysis.trace.check import load_golden
    from disco_tpu_torch.analysis.trace.programs import PROGRAMS
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.obs import roofline

    t_phase = time.perf_counter()
    for name, spec in PROGRAMS.items():
        label = f"3n {name}"
        with tally(label, d.launches):
            trace = fpm.trace_real(spec, "cuda")
        fp = held_to_fake_trace(d, label, load_golden(name), trace)
        print(f"phase 3n: {name} on the card: {fp['n_ops']} ops, kernels {fp['kernel_ops']}, "
              f"host syncs {fp['host_syncs']}, out {fp['out_avals'][:2]}, device float64 "
              f"{len(fp['f64'])}", flush=True)

    # the north-star batch: 16 clips x 8 nodes x 4 mics x 10 s
    yb, sb, nb = batch_clips(d)

    def batch(y, s, n):
        return tango_clip_fused(y, s, n, solver="fused")

    structs = tuple(fpm.Struct(tuple(a.shape), a.dtype) for a in (yb, sb, nb))
    fake = fpm.fingerprint_trace(fpm.trace_program(lambda dev: (batch, structs, {}), "cuda"))
    with tally("3n north-star batch", d.launches):
        rec, out = fpm.record(batch, (yb, sb, nb))
    trace = fpm.Trace(rec.events, [rec.info(t) for t in (yb, sb, nb)], [rec.info(out)],
                      traced="real-cuda", device="cuda")
    fp = held_to_fake_trace(d, "3n north-star batch", fake, trace)
    print(f"phase 3n: the 16-clip batch on the card held to its fake trace: kernels "
          f"{fp['kernel_ops']}, out {fp['out_avals']}, host syncs {fp['host_syncs']}, device "
          f"float64 {len(fp['f64'])}", flush=True)
    del rec, out, trace

    # each stage of the headline workload, timed, then joined with its cost
    progs = stage_programs(HEADLINE)
    with torch.no_grad():
        spec, mag = progs["stft_x3"][0](yb, sb, nb)
        masks = progs["masks"][0](mag[1], mag[2])
        steps = (spec[0], spec[1], spec[2], masks)
        yf = progs["tango_full"][0](*steps)
        inputs = {"stft_x3": (yb, sb, nb), "masks": (mag[1], mag[2]),
                  "step1_local_mwf": steps, "step1_fused_mwf": steps, "tango_full": steps,
                  "istft": (yf,), "full_pipeline": (yb, sb, nb), "chained_clip": (yb, sb, nb)}
        stage_ms = {}
        for name, args in inputs.items():
            fn = progs[name][0]
            fn(*args)   # warm-up
            runs = sorted(time_ms(lambda: fn(*args), reps=1, warmup=0)
                          for _ in range(STAGE_RUNS))
            stage_ms[name] = runs[STAGE_RUNS // 2]
    del spec, mag, masks, steps, yf, inputs
    stage_ms["step2_exchange_mwf"] = stage_ms.pop("tango_full") - stage_ms["step1_local_mwf"]
    w = HEADLINE
    record = {"metric": "stage_ms", "stage_ms": {k: stage_ms[k] for k in STAGE_KEYS},
              "workload": {"batch": w.batch, "dur_s": w.dur_s, "fs": w.fs,
                           "n_nodes": w.n_nodes, "mics_per_node": w.mics_per_node}}
    result = roofline.stage_verdicts(record, costs=offline_stage_costs(HEADLINE))
    print(roofline.render(result), flush=True)
    print("phase 3n: roofline " + json.dumps(result), flush=True)
    require(len(result["rows"]) == len(STAGE_KEYS), ("roofline rows", result["rows"]))
    print(f"phase 3n took {time.perf_counter() - t_phase:.1f} s", flush=True)


@contextmanager
def thread_recorder():
    """Record, while armed, the threads started (``Thread.start``, Timers
    included), the functions submitted to thread pools
    (``ThreadPoolExecutor.submit``, which ``map`` calls), each with the
    module of the code that asked, and every kernel launch with its thread
    (``ops._build.record_launch_threads``)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from disco_tpu_torch.ops import _build

    rec = SimpleNamespace(started=[], submitted=[], launches=[])
    start, submit = threading.Thread.start, ThreadPoolExecutor.submit

    def asker() -> str:
        frame = sys._getframe(2)
        while frame is not None and frame.f_globals.get("__name__", "").startswith(
                ("threading", "concurrent.")):
            frame = frame.f_back
        name = "" if frame is None else frame.f_globals.get("__name__", "")
        return "chip_smoke" if name == "__main__" else name

    def recorded_start(thread):
        # the target now: a finished thread drops it
        target = getattr(thread, "_target", None) or getattr(thread, "function", None)
        rec.started.append((thread, target, asker()))
        return start(thread)

    def recorded_submit(pool, fn, /, *args, **kwargs):
        rec.submitted.append((fn, asker()))
        return submit(pool, fn, *args, **kwargs)

    threading.Thread.start = recorded_start
    ThreadPoolExecutor.submit = recorded_submit
    _build.record_launch_threads(rec.launches)
    try:
        yield rec
    finally:
        threading.Thread.start = start
        ThreadPoolExecutor.submit = submit
        _build.record_launch_threads(None)


def entry_point(fn) -> str | None:
    """A callable's ``module:dotted.qualname``, the form of the role
    registry's entry points (bound methods by their function, partials by
    theirs, no ``<locals>`` marker); None for what has no qualname."""
    import functools

    while isinstance(fn, functools.partial):
        fn = fn.func
    fn = getattr(fn, "__func__", fn)
    module, qual = getattr(fn, "__module__", None), getattr(fn, "__qualname__", None)
    if module is None or qual is None:
        return None
    module = "chip_smoke" if module == "__main__" else module
    return f"{module}:{qual.replace('.<locals>', '')}"


def phase3i_recorded(d: SimpleNamespace) -> None:
    """Phase 3i with :func:`thread_recorder` armed; phase 3o reads the
    record."""
    with thread_recorder() as rec:
        phase3i_flywheel(d)
    d.threads_3i = rec


def runtime_thread_twin(rec) -> dict:
    """The runtime twin of DR001/DR002 over phase 3i's record: each thread
    port code started must have a target among the race roles' entry
    points, each function port code submitted to a pool too, and each
    kernel launch must come from a ``torch_ok`` role's thread."""
    import threading

    from disco_tpu_torch.analysis.race.roles import ROLES, entry_point_index

    index = entry_point_index()
    role_of = {threading.main_thread(): "main"}
    threads, unregistered, skipped = {}, [], []
    for thread, target, asker in rec.started:
        ep = entry_point(target)
        if ep == "concurrent.futures.thread:_worker":
            skipped.append(f"{thread.name}: a thread-pool worker, checked through the "
                           "functions submitted to its pool")
            continue
        if not asker.startswith("disco_tpu_torch"):
            skipped.append(f"{thread.name} (started by {asker or '?'}, target {ep}): not port code")
            continue
        role = index.get(ep)
        if role is None:
            unregistered.append(f"{thread.name}: target {ep}, started by {asker}")
            continue
        role_of[thread] = role
        threads[role] = threads.get(role, 0) + 1
    submitted = {}
    for fn, asker in rec.submitted:
        ep = entry_point(fn)
        if not asker.startswith("disco_tpu_torch"):
            skipped.append(f"pool work {ep} (submitted by {asker or '?'}): not port code")
            continue
        role = index.get(ep)
        if role is None:
            unregistered.append(f"pool work {ep}, submitted by {asker}")
            continue
        submitted[role] = submitted.get(role, 0) + 1
    launches, off_role = {}, []
    for name, thread in rec.launches:
        role = role_of.get(thread)
        key = role or f"<unknown thread {thread.name}>"
        launches.setdefault(key, {})
        launches[key][name] = launches[key].get(name, 0) + 1
        if role is None or not ROLES[role].torch_ok:
            off_role.append(f"{name} on {thread.name} (role {role})")
    return {"threads": threads, "pool_work": submitted, "launches": launches,
            "unregistered": unregistered, "off_role_launches": sorted(set(off_role)),
            "skipped": skipped}


def phase3o_gates(d: SimpleNamespace) -> None:
    """disco-torch-lint and disco-torch-race on this copy of the tree (two
    processes started together; each must exit 0 with a clean report),
    then the runtime twin of DR001/DR002 over phase 3i's record."""
    from pathlib import Path

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    gates = {}
    for name, module in (("disco-torch-lint", "disco_tpu_torch.analysis.cli"),
                         ("disco-torch-race", "disco_tpu_torch.analysis.race.cli")):
        gates[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", module, "--format", "json"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for name, (t0, proc) in gates.items():
            out, err = proc.communicate(timeout=600)
            seconds = time.perf_counter() - t0
            try:
                doc = json.loads(out)
            except ValueError:
                doc = None
            require(proc.returncode == 0 and doc is not None and doc["clean"],
                    (name, proc.returncode, out[-6000:], err[-6000:]))
            counts = doc["counts"]
            print(f"phase 3o: {name} exit {proc.returncode}: {counts['findings']} findings, "
                  f"{counts['suppressed']} suppressions, {counts['files']} files, "
                  f"{seconds:.1f} s", flush=True)
    finally:
        for _, proc in gates.values():
            if proc.poll() is None:
                stop_process(proc)
    twin = runtime_thread_twin(d.threads_3i)
    print("phase 3o: runtime thread twin over phase 3i " + json.dumps(
        {k: v for k, v in twin.items() if k != "skipped"}), flush=True)
    for line in twin["skipped"]:
        print(f"phase 3o: skipped {line}", flush=True)
    require(not twin["unregistered"], ("threads with no registered role", twin["unregistered"]))
    require(not twin["off_role_launches"],
            ("kernel launches off a torch_ok role", twin["off_role_launches"]))
    dispatch = twin["launches"].get("dispatch", {})
    require(all(dispatch.get(k, 0) > 0 for k in ("disco_stft", "disco_eigh_jacobi",
                                                 "disco_fused_mwf")),
            ("phase 3i's dispatch thread launched each served kernel", twin["launches"]))
    require(twin["threads"].get("dispatch", 0) > 0 and twin["threads"].get("tap_writer", 0) > 0,
            ("phase 3i's registered threads", twin["threads"]))
    del d.threads_3i
    print(f"phase 3o took {time.perf_counter() - t_phase:.1f} s", flush=True)


#: phase 3p's fake Freesound client, run by ``disco-torch-download``'s main in
#: a child process (the pool's workers fork the child and unpickle the sounds)
DOWNLOAD_CHILD = """
import os, sys
from disco_tpu_torch.cli import download as cli
from disco_tpu_torch.datagen.download import FreesoundInquirer

class FakeSound:
    def __init__(self, sid):
        self.id, self.name = sid, "n" + sid
    def retrieve(self, output_dir, name=None):
        with open(os.path.join(output_dir, name), "wb") as fh:
            fh.write(b"RIFFfake" + name.encode())

class FakePage:
    def __init__(self, sounds, has_next):
        self.sounds, self.next = sounds, ("url" if has_next else None)
    def as_dict(self):
        return {"next": self.next}
    def __iter__(self):
        return iter(self.sounds)

class FakeClient:
    def text_search(self, page=1, **kwargs):
        return FakePage([FakeSound(str(100 * page + i)) for i in range(3)], page < 2)

FreesoundInquirer.from_token = classmethod(lambda cls, token, authentication_method="oauth":
                                           cls(FakeClient()))
sys.exit(cli.main(sys.argv[1:]))
"""

#: phase 3p's build-cache child: build and load the kernel library under the
#: root DISCO_TORCH_COMPILE_CACHE names, launch the f32 STFT kernel once
CACHE_CHILD = """
import json, os, re, sys, tempfile, time
from pathlib import Path
import numpy as np, torch
from disco_tpu_torch.ops import _build, stft_ops
from disco_tpu_torch.utils import compile_cache

clip, out = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
_build.load()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(clip)).cuda()
stft_ops.stft_kernel.launches = 0
spec = stft_ops.stft_kernel(x)
torch.cuda.synchronize()
np.save(out, spec.cpu().numpy())
print(json.dumps({"env": os.environ.get(compile_cache.ENV_VAR),
                  "cache": compile_cache.ensure_enabled(), "root": str(_build.build_dir().parent),
                  "build_dir": str(_build.build_dir()), "digest": _build.source_digest(),
                  "tmpdir": tempfile.gettempdir(), "load_s": load_s,
                  "launches": stft_ops.stft_kernel.launches,
                  "nvcc_s": {m.group(1): float(m.group(2)) for m in re.finditer(
                      r"== (\\S+) \\(finished within ([0-9.]+) s of the start\\)",
                      _build.ptxas_log())}}))
"""


def phase3p_download_and_cache(d: SimpleNamespace) -> None:
    """``disco-torch-download`` (URL list, csv cleaning, a fake-client
    Freesound download at ``-j 2``) and the kernels' build cache (a named
    root and ``off``), each in a child process, all started together."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from disco_tpu_torch.datagen.download import LIBRISPEECH_URLS, ZENODO_DISCO_NOISE_URL
    from disco_tpu_torch.ops import _build, stft_ops
    from disco_tpu_torch.utils import compile_cache

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="phase3p_") as tmp:
        tmp = Path(tmp)
        clean = tmp / "clean" / "fan"
        clean.mkdir(parents=True)
        (clean / "11.wav").write_bytes(b"x")
        (clean / "12.wav").write_bytes(b"x")
        (clean / "fan.csv").write_text("id\tname\n11\ta\n12\tb\n13\tc\n")
        (tmp / "fs.yaml").write_text("queries:\n  fan: fan vent\n  rain: [rain, drizzle]\n"
                                     "fields_to_save: [id, name]\n")
        np.save(tmp / "clip.npy", d.y_np)
        (tmp / "off_tmp").mkdir()
        env = {k: v for k, v in os.environ.items() if k != compile_cache.ENV_VAR}
        dl = [sys.executable, "-m", "disco_tpu_torch.cli.download"]
        cache_child = [sys.executable, "-c", CACHE_CHILD, str(tmp / "clip.npy")]
        children = {
            "list-urls": (dl + ["--list-urls"], env),
            "clean": (dl + ["--clean", str(tmp / "clean")], env),
            "freesound -j 2": ([sys.executable, "-c", DOWNLOAD_CHILD, "-t", "token", "-c",
                                str(tmp / "fs.yaml"), "-o", str(tmp / "fs"), "-j", "2"], env),
            "cache dir": (cache_child + [str(tmp / "spec_dir.npy")],
                          {**env, compile_cache.ENV_VAR: str(tmp / "cache")}),
            "cache off": (cache_child + [str(tmp / "spec_off.npy")],
                          {**env, compile_cache.ENV_VAR: "off", "TMPDIR": str(tmp / "off_tmp")}),
        }
        procs = {name: (time.perf_counter(), subprocess.Popen(
            argv, cwd=root, env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for name, (argv, child_env) in children.items()}
        # this process's launch from its own root (phase 1's build) meanwhile
        x = torch.from_numpy(d.y_np).to(d.dev)
        spec = stft_ops.stft_kernel(x).cpu().numpy()
        out = {}
        try:
            for name, (t0, proc) in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                out[name] = (proc.returncode, stdout, stderr)
                print(f"phase 3p: {name} exit {proc.returncode} in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                require(proc.returncode == 0, (name, proc.returncode, stdout[-4000:],
                                               stderr[-4000:]))
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    stop_process(proc)

        urls = out["list-urls"][1].splitlines()
        require(urls == LIBRISPEECH_URLS + [ZENODO_DISCO_NOISE_URL], ("--list-urls", urls))
        require(out["clean"][1] == "dropped 1 stale csv rows\n", ("--clean", out["clean"][1]))
        kept = (clean / "fan.csv").read_bytes()
        require(kept == b"id\tname\r\n11\ta\r\n12\tb\r\n", ("--clean csv", kept))
        require(out["freesound -j 2"][1] == "downloaded 18 files\n",
                ("freesound download", out["freesound -j 2"][1]))
        fs = tmp / "fs"
        wavs = sorted(str(p.relative_to(fs)) for p in fs.rglob("*.wav"))
        want = sorted(f"{c}/{p * 100 + i}.wav" for c in ("fan", "rain") for p in (1, 2)
                      for i in range(3))
        require(wavs == want, ("downloaded files", wavs))
        for c in ("fan", "rain"):
            rows = (fs / c / f"{c}.csv").read_text().splitlines()
            want_rows = ["id\tname"] + [f"{p * 100 + i}\tn{p * 100 + i}" for p in (1, 2)
                                        for i in range(3)]
            require(rows == want_rows, ("downloaded csv", c, rows))
            require((fs / c / "100.wav").read_bytes() == b"RIFFfake100.wav", ("wav bytes", c))
        print(f"phase 3p: disco-torch-download: --list-urls {len(urls)} URLs, --clean dropped "
              f"1 row, -j 2 wrote {len(wavs)} files and 2 csv", flush=True)

        digest = _build.source_digest()
        for name, spec_file in (("cache dir", "spec_dir.npy"), ("cache off", "spec_off.npy")):
            rep = json.loads(out[name][1].strip().splitlines()[-1])
            print(f"phase 3p: {name}: " + json.dumps(rep), flush=True)
            require(rep["digest"] == digest and rep["launches"] == 1, (name, rep))
            if name == "cache dir":
                require(rep["cache"] == rep["root"] == str(tmp / "cache")
                        and rep["build_dir"] == str(tmp / "cache" / digest)
                        and (tmp / "cache" / digest / _build.LIB_NAME).exists(),
                        ("the named build cache", rep))
            else:
                require(rep["cache"] is None and rep["tmpdir"] == str(tmp / "off_tmp")
                        and Path(rep["root"]).parent == tmp / "off_tmp"
                        and rep["build_dir"] == str(Path(rep["root"]) / digest),
                        ("the off build root", rep))
            require(len(rep["nvcc_s"]) == len(_build.SOURCES), (name, "nvcc", rep["nvcc_s"]))
            theirs = np.load(tmp / spec_file)
            require(theirs.dtype == spec.dtype and theirs.shape == spec.shape
                    and np.array_equal(np.ascontiguousarray(theirs).view(np.uint32),
                                       np.ascontiguousarray(spec).view(np.uint32)),
                    (name, "the STFT is not bit for bit the parent's"))
        left = sorted(os.listdir(tmp / "off_tmp"))
        print(f"phase 3p: the off child's TMPDIR after exit: {left}", flush=True)
        require(not [e for e in left if (tmp / "off_tmp" / e).is_dir()],
                ("the off build left a directory", left))
        print(f"phase 3p: parent root {_build.build_dir().parent}; both children's STFT of "
              f"the clip {tuple(spec.shape)} bit for bit the parent's", flush=True)
    print(f"phase 3p took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase4_streaming_path(d: SimpleNamespace) -> None:
    """The streaming path with the eigensolver kernel: the windows through
    ``streaming_clip_fused`` and the full clip through ``streaming_tango``,
    each with the launch counters; scan against the per-block oracle, bit
    for bit; the windows after the first against the plain versions from
    a shared state; SI-SDR."""
    import torch

    from disco_tpu_torch.core.dsp import istft
    from disco_tpu_torch.enhance.streaming import streaming_tango
    from disco_tpu_torch.ops.eigh_ops import eigh_jacobi_kernel, eigh_jacobi_unsorted

    per_window = 2 * (1 + LW // 256) // 4
    with counted("streaming windows", {"stft": N_WINDOWS, "masked_cov": 0, "fused_mwf": 0,
                                       "eigh_jacobi": N_WINDOWS * per_window}, d.launches):
        yw, states = stream_windows(d, 0, N_WINDOWS, None)
    Lc = N_WINDOWS * LW
    require(yw.shape == (K, Lc) and bool(torch.isfinite(yw).all()),
            "non-finite or misshapen streaming output")
    d.stream_state_1 = states[0]
    # the matrices one window hands the eigensolver (window 2, from the state
    # after window 1): its step-1 (C=4) and step-2 (C=11) launches of one block
    with recorded_eigh_inputs() as seen:
        stream_windows(d, 1, 2, d.stream_state_1)
    d.window_eigh = {"step1": seen[0], "step2": seen[1]}
    for label, A in d.window_eigh.items():
        lk, Vk = eigh_jacobi_kernel(A)
        lp, Vp = eigh_jacobi_unsorted(A)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(lk, lp) and torch.equal(Vk, Vp))
        print(f"phase 4: eigh_jacobi on one window's {label} launch {tuple(A.shape)}: "
              f"bit-identical {bitwise}", flush=True)
        require(bitwise, ("eigh on a window's matrices", label))
    with counted("streaming_tango full clip", {"stft": 0, "masked_cov": 0, "fused_mwf": 0,
                                               "eigh_jacobi": 2}, d.launches):
        full = streaming_tango(d.Y, d.m, d.m, solver="jacobi-pallas")
    yfull = istft(full["yf"], length=d.L)
    require(bool(torch.isfinite(yfull).all()), "non-finite full-clip stream")

    check_scan_vs_per_block(d, "f32")

    # the plain versions from the state after the first window, on windows
    # 2 to PLAIN_WINDOWS (cut from 9 to make room for phases 3k, 3m and 3p)
    with plain_kernels():
        yp, _ = stream_windows(d, 1, PLAIN_WINDOWS, states[0])
        yc, _ = stream_windows(d, 0, COLD_WINDOWS, None)
    torch.cuda.synchronize()
    yk = yw[:, LW:PLAIN_WINDOWS * LW]
    err = rel_l2(yk, yp)
    sdr = {}
    for label, out in (("kernels", yk), ("plain", yp)):
        sdr[label] = si_sdr(d.s_np[0, 0, LW:PLAIN_WINDOWS * LW], out[0].cpu().numpy())
    cold = [rel_l2(yw[:, w * LW:(w + 1) * LW], yc[:, w * LW:(w + 1) * LW])
            for w in range(COLD_WINDOWS)]
    print(f"phase 4: windows 2-{PLAIN_WINDOWS} from the state after window 1, kernels vs plain "
          f"versions: rel-l2 {err:.3e}, SI-SDR node 0 {sdr['kernels']:.4f} vs "
          f"{sdr['plain']:.4f} dB", flush=True)
    print(f"phase 4: the first {COLD_WINDOWS} windows from the warm start, kernels vs plain "
          "versions, rel-l2 per window: " + json.dumps(cold), flush=True)
    require(err <= TOL["stream"], ("stream vs plain", err))
    require(abs(sdr["kernels"] - sdr["plain"]) <= TOL["stream_sdr_db"], ("stream sdr", sdr))

    clean, noisy = d.s_np[0, 0], d.y_np[0, 0]
    yw0, yf0 = yw[0].cpu().numpy(), yfull[0].cpu().numpy()
    gains = {"windows": sdr_gains(clean, noisy, yw0),
             "windows, window edges left out": sdr_gains(clean, noisy, yw0, window_interior(Lc)),
             "full clip": sdr_gains(clean, noisy, yf0)}
    print("phase 4: SI-SDR gain at node 0 over the noisy reference mic, after t seconds: "
          + json.dumps(gains) + "; the JAX package's windows: " + json.dumps(JAX_WINDOWS_GAIN_DB),
          flush=True)
    require(all(abs(gains["windows"][t] - g) <= TOL["witness_db"]
                for t, g in JAX_WINDOWS_GAIN_DB.items()), ("windows vs JAX witness", gains))
    require(gains["full clip"][STREAM_SDR_FROM_S] > TOL["sdr_gain_db"], ("stream sdr gain", gains))
    phase4_bf16_windows(d, gains["windows"])


def check_scan_vs_per_block(d: SimpleNamespace, precision: str) -> None:
    """Scanned super ticks == the per-block loop, bit for bit, on the card,
    in a precision lane."""
    import torch

    from disco_tpu_torch.enhance.stream_check import per_block_reference
    from disco_tpu_torch.enhance.streaming import (
        initial_stream_state,
        state_leaves,
        streaming_tango_scan,
    )

    Ys, ms = d.Y[..., :64], d.m[..., :64]
    F = d.Y.shape[-2]
    ref, ref_state = per_block_reference(Ys, ms, block=8, update_every=4,
                                         state=initial_stream_state(K, C, F),
                                         solver="jacobi-pallas", precision=precision)
    st, parts = initial_stream_state(K, C, F), []
    for w in range(2):
        sl = slice(32 * w, 32 * (w + 1))
        o = streaming_tango_scan(Ys[..., sl], ms[..., sl], ms[..., sl], state=st,
                                 z_avail=torch.ones((K, 8)), blocks_per_dispatch=4,
                                 solver="jacobi-pallas", precision=precision)
        st = o["state"]
        parts.append(o["yf"])
    same_out = bool(torch.equal(torch.cat(parts, dim=-1), ref))
    same_state = all(torch.equal(a, b) for a, b in zip(state_leaves(st), state_leaves(ref_state)))
    print(f"phase 4: {precision} streaming_tango_scan vs per_block_reference, 64 frames in super "
          f"ticks of 4 blocks: output bit-identical {same_out}, state bit-identical {same_state}",
          flush=True)
    require(same_out and same_state, (precision, "scan vs per-block bit-exactness"))


def phase4_bf16_windows(d: SimpleNamespace, f32_gains: dict) -> None:
    """The streaming windows in the bf16 lane (the bf16 STFT kernel, the
    bf16 tail accumulation, the eigensolver): scan against the per-block
    loop bit for bit, window 2 against the plain versions from the state
    after window 1 (within 1e-4 fed the STFT kernel's spectra, within the
    lane's 1e-2 from the signal: see :func:`phase3_bf16_clip`), and the
    windows' SI-SDR gains within 0.1 dB of the f32 lane's."""
    import torch

    per_window = 2 * (1 + LW // 256) // 4
    with counted("streaming windows bf16", {"stft_bf16": N_WINDOWS,
                                            "eigh_jacobi": N_WINDOWS * per_window}, d.launches):
        yw, states = stream_windows(d, 0, N_WINDOWS, None, "bf16")
    Lc = N_WINDOWS * LW
    require(yw.shape == (K, Lc) and bool(torch.isfinite(yw).all()),
            "non-finite or misshapen bf16 streaming output")
    check_scan_vs_per_block(d, "bf16")
    with plain_kernels(stft=False):
        yp, _ = stream_windows(d, 1, PLAIN_WINDOWS, states[0], "bf16")
    with plain_kernels():
        yq, _ = stream_windows(d, 1, PLAIN_WINDOWS, states[0], "bf16")
    torch.cuda.synchronize()
    yk = yw[:, LW:PLAIN_WINDOWS * LW]
    err, err_full = rel_l2(yk, yp), rel_l2(yk, yq)
    gains = sdr_gains(d.s_np[0, 0], d.y_np[0, 0], yw[0].cpu().numpy())
    print(f"phase 4: bf16 windows 2-{PLAIN_WINDOWS} from the state after window 1, kernels vs plain "
          f"versions: fed the STFT kernel's spectra rel-l2 {err:.3e}, from the signal "
          f"{err_full:.3e}; SI-SDR gain at node 0 after t seconds "
          + json.dumps(gains) + " (f32 lane " + json.dumps(f32_gains) + ")", flush=True)
    require(err <= TOL["stream"], ("bf16 stream vs plain", err))
    require(err_full <= TOL["bf16_lane"], ("bf16 stream vs plain from the signal", err_full))
    require(all(abs(gains[t] - g) <= TOL["stream_sdr_db"] for t, g in f32_gains.items()),
            ("bf16 windows vs f32 windows", gains, f32_gains))


def sdr_gains(clean, noisy, out, keep=None) -> dict:
    """SI-SDR gain in dB of ``out`` over ``noisy`` against ``clean`` after
    t = 1, 2, 3 s, over the samples ``keep`` (a boolean mask; all when
    None)."""
    res = {}
    for t in (1.0, 2.0, 3.0):
        idx = np.arange(int(t * FS), len(out))
        if keep is not None:
            idx = idx[keep[idx]]
        res[t] = si_sdr(clean[idx], out[idx]) - si_sdr(clean[idx], noisy[idx])
    return res


def window_interior(length: int, hop: int = 256):
    """The samples of consecutive ``LW`` windows more than one hop from a
    window boundary: what each window's own centred, reflect-padded STFT
    frames alone do not reach."""
    pos = np.arange(length) % LW
    return (pos >= hop) & (pos < LW - hop)


def bf16_gemm_operands(frames, dev) -> tuple:
    """The bf16 STFT's library call's operands: the windowed frames and the
    [cos | sin] DFT table on ``dev``, each rounded to bf16 once."""
    import torch

    from disco_tpu_torch.ops import stft_ops

    table = torch.cat([torch.from_numpy(t) for t in stft_ops.dft_matrices(512)], dim=1).to(dev)
    # disco-torch-lint: disable=DL012 -- library_ms's cuBLAS bf16 GEMM, timed beside the kernel; its operands never reach a path
    return tuple(x.to(torch.bfloat16) for x in (frames, table))


def phase5_times(d: SimpleNamespace) -> list[dict]:
    """CUDA-event times of the paths and of each kernel, its plain version
    and its library call, with the bound of this run's shapes."""
    import torch

    from disco_tpu_torch.analysis.meter.costmodel import kernel_cost
    from disco_tpu_torch.enhance.fused import tango_clip_fused
    from disco_tpu_torch.ops import cov_ops, eigh_ops, mwf_ops, stft_ops

    yb, sb, nb = batch_clips(d)
    audio_s = BATCH * K * DUR_S
    for precision in ("f32", "bf16"):
        def path():
            return tango_clip_fused(yb, sb, nb, solver="fused", precision=precision)

        path()  # warm-up
        runs = sorted(time_ms(path, reps=1, warmup=0) for _ in range(5))
        path_ms = runs[2]
        print(f"phase 5: offline path, {precision} lane, {BATCH} clips {path_ms} ms (median of "
              f"{runs}) = {audio_s / (path_ms / 1e3)} enhanced audio-s per s", flush=True)
    del yb, sb, nb
    phase5_crnn_mask_stage(d)
    phase5_corpus(d)
    phase5_training(d)

    # streaming: windows 2..9 again from the state after window 1, each
    # timed on the host clock to its synchronize (the latency a caller sees)
    state, lat = d.stream_state_1, []
    for w in range(1, N_WINDOWS):
        t0 = time.perf_counter()
        _, (state,) = stream_windows(d, w, w + 1, state)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    med = sorted(lat)[len(lat) // 2]
    print(f"phase 5: streaming window ({LW} samples = {LW / FS} s, {BLOCKS_PER_DISPATCH} refresh "
          f"blocks) latency {med} ms (median of {lat}); per refresh block "
          f"{med / BLOCKS_PER_DISPATCH} ms; {LW / FS / (med / 1e3)} stream-seconds per s "
          f"({K * LW / FS / (med / 1e3)} node-audio-seconds per s)", flush=True)

    win = stft_ops.hann_periodic(512, device=d.dev)
    rows = d.x.reshape(-1, d.L)

    entries = []
    fl, nbytes = kernel_cost(lambda a: stft_ops.stft_kernel(a, with_mag=True), d.x)
    b_ms, b_by = bound(fl, nbytes)
    entries.append({
        "name": "stft", "route": "cuda", "source": "disco_tpu_torch/csrc/stft.cu",
        "replaces": "disco_tpu/ops/stft_ops.py:183", **_launches(d, "stft"),
        "max_abs_err": d.err["stft"],
        "ms": time_ms(lambda: stft_ops.stft_kernel(d.x, with_mag=True), reps=20),
        "device_ms": device_ms(lambda: stft_ops.stft_kernel(d.x, with_mag=True),
                               "stft_rfft_kernel"),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.stft(rows, 512, 256, window=win, center=True,
                                                 pad_mode="reflect", return_complex=True), reps=20),
    })
    # the bf16 lane's tensor-core DFT; its library call is one cuBLAS GEMM,
    # torch.matmul of the bf16 windowed frames and the bf16 [cos | sin]
    # table, whose output is bf16
    fl, nbytes = kernel_cost(lambda a: stft_ops.stft_bf16_kernel(a, with_mag=True), d.x)
    b_ms, b_by = bound(fl, nbytes, bf16=True)
    frames = torch.nn.functional.pad(rows, (256, 256), mode="reflect").unfold(-1, 512, 256)
    frames16, table16 = bf16_gemm_operands(frames * win, d.dev)
    entries.append({
        "name": "stft_bf16", "route": "cuda", "source": "disco_tpu_torch/csrc/stft_bf16.cu",
        "replaces": "disco_tpu/ops/stft_ops.py:183", **_launches(d, "stft_bf16"),
        "max_abs_err": d.err["stft_bf16"],
        "ms": time_ms(lambda: stft_ops.stft_bf16_kernel(d.x, with_mag=True), reps=20),
        "device_ms": device_ms(lambda: stft_ops.stft_bf16_kernel(d.x, with_mag=True),
                               "stft_bf16_kernel"),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(d.x, with_mag=True, precision="bf16"),
                            reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.matmul(frames16, table16), reps=20),
        "library_call": "torch.matmul(bf16 (96, 626, 512), bf16 (512, 514)) -> bf16 (cuBLAS)",
    })
    del frames, frames16, table16
    # both STFT kernels at the 16-clip batch's rows (the clip stack BATCH
    # times): events and device time, the bound of those rows, and for the
    # bf16 lane its plain version and the cuBLAS bf16 GEMM on the same rows
    xb = d.x[None].expand(BATCH, *d.x.shape).contiguous()
    rows_b = xb.reshape(-1, d.L)
    fl, nbytes = kernel_cost(lambda a: stft_ops.stft_kernel(a, with_mag=True), xb)
    entries[0]["batch_launches"] = [{
        "shape": f"batch {tuple(xb.shape)}",
        "ms": time_ms(lambda: stft_ops.stft_kernel(xb, with_mag=True), reps=10),
        "device_ms": device_ms(lambda: stft_ops.stft_kernel(xb, with_mag=True),
                               "stft_rfft_kernel", reps=5),
        "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        "library_ms": time_ms(lambda: torch.stft(rows_b, 512, 256, window=win, center=True,
                                                 pad_mode="reflect", return_complex=True), reps=5),
    }]
    # the f32 STFT kernel at phase 3g's scene-batch stack: its device time
    xs = d.scene_stft_x
    fl, nbytes = kernel_cost(lambda a: stft_ops.stft_kernel(a, with_mag=True), xs)
    entries[0]["batch_launches"].append({
        "shape": f"scene batch {tuple(xs.shape)}",
        "ms": time_ms(lambda: stft_ops.stft_kernel(xs, with_mag=True), reps=20),
        "device_ms": device_ms(lambda: stft_ops.stft_kernel(xs, with_mag=True),
                               "stft_rfft_kernel", reps=20),
        "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes})
    del d.scene_stft_x
    fl, nbytes = kernel_cost(lambda a: stft_ops.stft_bf16_kernel(a, with_mag=True), xb)
    frames16, table16 = bf16_gemm_operands(
        torch.nn.functional.pad(rows_b, (256, 256), mode="reflect").unfold(-1, 512, 256) * win,
        d.dev)
    entries[1]["batch_launches"] = [{
        "shape": f"batch {tuple(xb.shape)}",
        "ms": time_ms(lambda: stft_ops.stft_bf16_kernel(xb, with_mag=True), reps=10),
        "device_ms": device_ms(lambda: stft_ops.stft_bf16_kernel(xb, with_mag=True),
                               "stft_bf16_kernel", reps=5),
        "plain_ms": time_ms(lambda: stft_ops.stft_matmul(xb, with_mag=True, precision="bf16"),
                            reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.matmul(frames16, table16), reps=10),
        "library_call": f"torch.matmul(bf16 {tuple(frames16.shape)}, bf16 (512, 514)) -> bf16 "
                        "(cuBLAS)",
        "bound_ms": bound(fl, nbytes, bf16=True)[0], "flops": fl, "bytes": nbytes,
    }]
    for e in entries[:2]:
        for row in e["batch_launches"]:
            print(f"phase 5: {e['name']}: " + json.dumps(row), flush=True)
    del xb, rows_b, frames16, table16

    def cov_times(label, yy, mm, plain_reps, precision):
        fl, nbytes = kernel_cost(lambda a, b: cov_ops.masked_cov_kernel(a, b, precision), yy, mm)
        lib = (library_cov(yy, mm) if precision == "f32" else
               lambda: cov_ops.masked_covariances_folded(yy, mm, precision="bf16"))
        return {
            "shape": f"{label} {tuple(yy.shape)}",
            "ms": time_ms(lambda: cov_ops.masked_cov_kernel(yy, mm, precision), reps=50),
            "device_ms": device_ms(lambda: cov_ops.masked_cov_kernel(yy, mm, precision),
                                   "masked_cov_kernel"),
            "plain_ms": time_ms(lambda: cov_ops.masked_covariances_plain(yy, mm, precision),
                                reps=plain_reps),
            "library_ms": time_ms(lib, reps=plain_reps),
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    def mwf_times(label, Rss, Rnn, mu, plain_reps, precision):
        if isinstance(mu, torch.Tensor):
            fl, nbytes = kernel_cost(lambda a, b, m: mwf_ops.fused_mwf_kernel(
                a, b, mu=m, precision=precision), Rss, Rnn, mu)
        else:
            fl, nbytes = kernel_cost(lambda a, b: mwf_ops.fused_mwf_kernel(
                a, b, mu=mu, precision=precision), Rss, Rnn)
        return {
            "shape": f"{label} {tuple(Rss.shape)}",
            "ms": time_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu, precision=precision),
                          reps=20),
            "device_ms": device_ms(lambda: mwf_ops.fused_mwf_kernel(Rss, Rnn, mu=mu,
                                                                    precision=precision),
                                   "fused_mwf"),
            "plain_ms": time_ms(lambda: mwf_ops.fused_mwf_plain(Rss, Rnn, mu=mu,
                                                                precision=precision),
                                reps=plain_reps, warmup=1),
            "library_ms": None, "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    # covariances and fused solve, each lane: the step-1 (C=4) and step-2
    # (D=11) launches of one clip; beside them, those of the 16-clip batch
    for precision, pencils, batch in (("f32", d.pencils, d.batch),
                                      ("bf16", d.pencils_bf16, d.batch_bf16)):
        per = [cov_times(label, yy, d.m, 20, precision)
               for label, yy in (("step1", d.Y), ("step2", d.in_y))]
        entries.append(_summed(d, _lane("masked_cov", precision), "disco_tpu_torch/csrc/cov.cu",
                               "disco_tpu/ops/cov_ops.py:233", per))
        entries[-1]["batch_launches"] = [cov_times(f"batch {label}", yy, mm, 5, precision)
                                         for label, (yy, mm)
                                         in zip(("step1", "step2"), batch["masked_cov"])]
        per = [mwf_times(label, *pencils[label], 1.0, 2, precision)
               for label in ("step1", "step2")]
        entries.append(_summed(d, _lane("fused_mwf", precision), "disco_tpu_torch/csrc/mwf.cu",
                               "disco_tpu/ops/mwf_ops.py:434", per))
        entries[-1]["batch_launches"] = [mwf_times(f"batch {label}", Rss, Rnn, mu, 1, precision)
                                         for label, (Rss, Rnn, mu)
                                         in zip(("step1", "step2"), batch["fused_mwf"])]
    for e in entries[2:]:
        for row in e["per_launch"] + e["batch_launches"]:
            print(f"phase 5: {e['name']}: " + json.dumps(row), flush=True)

    def eigh_times(label, A, reps, plain_reps):
        fl, nbytes = kernel_cost(eigh_ops.eigh_jacobi_kernel, A)
        lib_ms, lib_chunk = library_eigh_ms(A)
        return {
            "shape": f"{label} {tuple(A.shape)}",
            "ms": time_ms(lambda: eigh_ops.eigh_jacobi_kernel(A), reps=reps),
            "device_ms": device_ms(lambda: eigh_ops.eigh_jacobi_kernel(A), "eigh_"),
            "plain_ms": time_ms(lambda: eigh_ops.eigh_jacobi_unsorted(A), reps=plain_reps,
                                warmup=1),
            "library_ms": lib_ms, "library_matrices_per_call": lib_chunk,
            "bound_ms": bound(fl, nbytes)[0], "flops": fl, "bytes": nbytes,
        }

    # eigensolver: step 1 (C=4) and step 2 (D=11) launches of one full-clip
    # stream; beside them, those of one refresh block of a streaming window
    per = [eigh_times(label, d.whitened[label], 10, 1) for label in ("step1", "step2")]
    entries.append(_summed(d, "eigh_jacobi", "disco_tpu_torch/csrc/eigh.cu",
                           "disco_tpu/ops/eigh_ops.py:341", per))
    entries[-1]["window_launches"] = [eigh_times(f"window {label}", A, 50, 3)
                                      for label, A in d.window_eigh.items()]
    for w in entries[-1]["window_launches"]:
        print("phase 5: eigh_jacobi at the streaming window's batch: " + json.dumps(w),
              flush=True)
    for e in entries:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            require(math.isfinite(e[key]), (e["name"], key))
    return entries


def crnn_cost(n_streams: int, n_ch: int, T: int, win: int = 21, win_out: int = 15) -> float:
    """Operations of one canonical CRNN over ``n_streams`` streams of ``T``
    frames by the stream route: the three 3x3 convs over the padded
    streams (T + win - 1 frames), and per window the GRU's 15 steps
    (input and hidden products, 3 gates of 256) and the 257-wide FF on
    each of its 15 frames."""
    flops, t, f, c_in = 0.0, T + win - 1, 257, n_ch
    for c_out in (32, 64, 64):
        t -= 2
        flops += 2 * n_streams * c_out * t * f * c_in * 9
        f, c_in = f // 4, c_out
    steps = n_streams * T * win_out
    return flops + steps * (2 * 3 * 256 * (256 + 256) + 2 * 256 * 257)


def phase5_crnn_mask_stage(d: SimpleNamespace) -> None:
    """CUDA-event times (median of 5) of the CRNN-masked path on the 16
    distinct clips, by part: step-1 masks, step-1 z, step-2 masks, and
    ``tango(solver='fused')`` with those masks."""
    from disco_tpu_torch.enhance.driver import _z_for_mask_device
    from disco_tpu_torch.enhance.inference import crnn_masks_batched
    from disco_tpu_torch.enhance.tango import tango, tango_step1

    Yb, Sb, Nb = d.crnn_batch
    B, _, _, F, T = Yb.shape
    refs = Yb[:, :, 0].reshape(B * K, F, T)
    Mz = crnn_masks_batched(refs, d.crnn[0]).reshape(B, K, F, T)
    z = tango_step1(Yb, Sb, Nb, Mz)
    zs = _z_for_mask_device(z["z_y"], z["zn"], K, "zs_hat").reshape(B * K, K - 1, F, T)
    Mw = crnn_masks_batched(refs, d.crnn[1], zs=zs).reshape(B, K, F, T)
    del z
    parts = {"step-1 masks": (lambda: crnn_masks_batched(refs, d.crnn[0]), crnn_cost(B * K, 1, T)),
             "step-1 z": (lambda: tango_step1(Yb, Sb, Nb, Mz), None),
             "step-2 masks": (lambda: crnn_masks_batched(refs, d.crnn[1], zs=zs),
                              crnn_cost(B * K, K, T)),
             "tango": (lambda: tango(Yb, Sb, Nb, Mz, Mw, solver="fused"), None)}
    total = 0.0
    for label, (fn, flops) in parts.items():
        fn()  # warm-up
        runs = sorted(time_ms(fn, reps=1, warmup=0) for _ in range(5))
        total += runs[2]
        rate = "" if flops is None else (f"; {flops / 1e12:.3f} TFLOP by the CRNN's shapes = "
                                         f"{flops / (runs[2] / 1e3) / 1e12:.2f} TFLOP/s")
        print(f"phase 5: CRNN-masked path, {BATCH} clips, {label} {runs[2]} ms (median of "
              f"{runs}){rate}", flush=True)
    print(f"phase 5: CRNN-masked path, {BATCH} clips, the four parts {total} ms = "
          f"{BATCH * K * DUR_S / (total / 1e3)} enhanced audio-s per s (the STFT and ISTFT "
          f"not included)", flush=True)


def library_cov(yy, mm):
    """One ``torch.einsum`` call per covariance computing the kernel's pair
    (the shared mask's weights made before, as the kernel's wrapper is
    handed the mask)."""
    import torch

    T = yy.shape[-1]
    if mm.ndim == yy.ndim:
        return lambda: [torch.einsum("...cft,...dft->...fcd", a, a.conj()) / T
                        for a in (mm * yy, (1 - mm) * yy)]
    w_st = torch.stack([mm * mm, (1 - mm) ** 2]).to(torch.complex64) / T
    return lambda: torch.einsum("w...ft,...cft,...dft->w...fcd", w_st, yy, yy.conj())


def device_ms(fn, kernel: str, reps: int = 10) -> float | None:
    """Device time of one call of ``fn`` in the kernels whose name holds
    ``kernel`` (``torch.profiler``), mean of ``reps`` calls each after an L2
    flush, as ``time_ms``; None when the profiler saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(25 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            us += t
    return us / 1e3 / reps if us > 0 else None


def library_eigh_ms(A) -> tuple[float, int]:
    """CUDA-event time of ``torch.linalg.eigh`` (cuSOLVER) over the same
    batch, and the matrices per call.  cuSOLVER's batched eigensolver may
    refuse a batch this large; the batch is then halved until it takes it,
    and the time is that of the calls over the whole batch.  Non-finite
    matrices, if any, are replaced by the identity: it takes no NaN."""
    import torch

    D = A.shape[-1]
    flat = A.reshape(-1, D, D)
    finite = torch.isfinite(flat).flatten(-2).all(-1)[:, None, None]
    flat = torch.where(finite, flat, torch.eye(D, dtype=A.dtype, device=A.device))
    chunk = flat.shape[0]
    while True:
        try:
            torch.linalg.eigh(flat[:chunk])
            torch.cuda.synchronize()
            break
        except torch.linalg.LinAlgError as err:
            require(chunk > 1, ("torch.linalg.eigh", str(err)[:200]))
            chunk = (chunk + 1) // 2
    parts = flat.split(chunk)
    return time_ms(lambda: [torch.linalg.eigh(x) for x in parts], reps=3, warmup=1), chunk


def profiled(label: str, fn) -> None:
    """Device time by kernel name (``torch.profiler``) of one call of
    ``fn``, and the device's busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append({"kernel": ev.key[:90], "calls": ev.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    if not rows:
        print(f"phase 6: {label}: the profiler recorded no device time: breakdown not measured",
              flush=True)
        return
    print(f"phase 6: {label} under the profiler: wall {wall_ms} ms, device busy {busy} ms "
          f"({busy / wall_ms} of the wall time)", flush=True)
    for r in rows[:14]:
        print(f"phase 6: {label}: " + json.dumps(r), flush=True)


def phase6_breakdown(d: SimpleNamespace) -> None:
    """Where the time of one 16-clip offline call, of the 16-clip CRNN mask
    stage, of one streaming window and of three train steps goes."""
    from disco_tpu_torch.enhance.driver import _batched_masks
    from disco_tpu_torch.enhance.fused import tango_clip_fused

    yb, sb, nb = batch_clips(d)
    profiled(f"one {BATCH}-clip offline call",
             lambda: tango_clip_fused(yb, sb, nb, solver="fused"))
    profiled(f"one {BATCH}-clip offline call, bf16 lane",
             lambda: tango_clip_fused(yb, sb, nb, solver="fused", precision="bf16"))
    del yb, sb, nb
    profiled(f"the {BATCH}-clip CRNN mask stage (_batched_masks)",
             lambda: _batched_masks(*d.crnn_batch, d.crnn, "irm1", 1.0, K, "zs_hat"))
    profiled("one streaming window (window 2)", lambda: stream_windows(d, 1, 2, d.stream_state_1))
    import torch

    from disco_tpu_torch.nn.training import make_step_fns

    model, state = canonical_train_state(4)
    train_step, _ = make_step_fns(model, "all")
    xb, yb = (torch.as_tensor(a, device=d.dev) for a in d.train["batch"])
    profiled(f"three train steps of the canonical CRNN, n_ch 4, batch {TRAIN_BATCH}",
             lambda: [train_step(state, xb, yb) for _ in range(3)])


def _launches(d: SimpleNamespace, name: str) -> dict:
    """A kernel's launches over the main paths' runs, and by path."""
    by_path = {path: counts[name] for path, counts in d.launches.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def _summed(d: SimpleNamespace, name, source, replaces, per) -> dict:
    """One kernel's entry over the launches of one clip (``per``)."""
    lib = [p["library_ms"] for p in per]
    flops, nbytes = sum(p["flops"] for p in per), sum(p["bytes"] for p in per)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        **_launches(d, name), "max_abs_err": d.err[name],
        "ms": sum(p["ms"] for p in per), "plain_ms": sum(p["plain_ms"] for p in per),
        "bound_ms": sum(p["bound_ms"] for p in per), "bound_by": bound(flops, nbytes)[1],
        "library_ms": None if None in lib else sum(lib), "per_launch": per,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed("1", phase1_build)
    d = timed("2", phase2_kernels)
    timed("2 sizes", phase2_sizes, d)
    d.launches = {}
    for name, phase in (("3", phase3_offline_path), ("3d", phase3d_crnn_masked_clip),
                        ("3e", phase3e_corpus), ("3f", phase3f_training),
                        ("3g", phase3g_simulation), ("3h", phase3h_serving),
                        ("3i", phase3i_recorded), ("3j", phase3j_gates),
                        ("3k", phase3k_command_line), ("3l", phase3l_milestones),
                        ("3m", phase3m_multi_gpu), ("3n", phase3n_programs),
                        ("3o", phase3o_gates), ("3p", phase3p_download_and_cache),
                        ("4", phase4_streaming_path)):
        timed(name, phase, d)
    entries = timed("5", phase5_times, d)
    timed("6", phase6_breakdown, d)
    print(f"phase seconds {json.dumps(seconds)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
