#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. device and build: needs a CUDA device; prints the card's name and
   power limit as ``nvidia-smi`` reports them, and builds the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, into
   ``build/repro_torch/``);
2. kernels: every kernel of the registry, at the main path's shapes
   (J = 8 coils on the 768 x 768 grid), held against its plain PyTorch
   version within the JAX spec's tolerance (a bf16 sample, flash
   attention's, within the spec's bf16 tolerance, and so over 8 more
   draws of it, with each draw's errors), then timed with CUDA events
   beside the plain version, the one-call PyTorch yardstick where there
   is one, and its bound (bytes or flops over the H100's peak rates),
   and its device time alone from ``torch.profiler`` (``device_ms``, and
   the yardstick's ``library_device_ms``: a small kernel behind a Python
   wrapper can leave the card waiting on the host, which the events then
   measure), split by CUDA kernel where a wrapper launches several, and
   the times of the parts that its spec names (``KernelSpec.parts``:
   ``grid_adjoint``'s fill and gather each alone, ``torch.zeros`` of the
   grid beside its fill, and ``degrid``'s launch of one sample, the
   floor of a launch); the seven frame kernels' batched forms at the
   service's width (4 rows of the main path's shapes) and ``masked_sum``'s
   at phase 10b's (2 rows) against their plain forms, timed beside B
   times the unbatched call, with their bound (and ``masked_sum``'s
   ``einsum`` yardstick); flash attention at every JAX feature
   sample through the route of its dtype and again in bf16 through the
   tensor cores, with a bitwise repeat at the LM sample, and with v's own
   head dim: the float32 ``DV_CASES`` (both routes) and the two MLA
   prefills of phase 11 (``MLA_CASES``: deepseek-v2-lite's 16 heads of D
   192 / Dv 128 and minicpm3's 40 of 96 / 64, 2048 tokens, causal, bf16)
   against ``chunked_attention``, each with a bitwise repeat, timed beside
   its bound and ``scaled_dot_product_attention`` on the same boolean
   mask; and row 12c, llama3.2-3b's dense GQA prefill (``GQA_CASE``: 24
   query heads on 8 kv heads, D = Dv = 128, 2048 tokens, causal, bf16)
   with a bitwise repeat, timed beside ``scaled_dot_product_attention``
   with ``is_causal=True`` and no mask tensor, as PyTorch dispatches it
   and with its flash backend forced;
3. main path: ``FrameStream(Reconstructor(newton=7, cg_iters=30))`` over 4
   frames of the paper's full width (n = 384, grid 768, J = 8, 11
   golden-angle spokes), with the launch counters set to 0 just before and
   read just after, and required to equal the counts that the CG
   iterations run imply; the images must be finite; then the host time
   of one ``plan_fft2`` cache hit, and of a frame's lookups;
4. kernel path against plain path at newton 3 / cg 10 on the card (relative
   L2 of the image within 1e-4), the kernel path against itself (bitwise),
   and the repo's quality criterion on a small input (NLINV's NRMSE below
   0.12 and below 0.6 x gridding's, as ``tests/test_nlinv.py`` asks);
5. radial gridding: frames 0-3 at full width (grid 768, J = 8, 11
   golden-angle spokes of 1536 samples) through ``radial_ops`` (a plan
   miss per frame, built on the host) -> ``RadialOps.forward`` of the
   phantom's coil images -> ``gridding_recon_radial``, with the launch
   counters set to 0 just before and required to show one ``degrid`` per
   forward and one ``grid_adjoint`` per recon; a second pass over the
   same frames must be 4 plan hits and 0 builds.  Then the kernel path
   against the plain path on frame 0 (relative L2 of the image within
   1e-4), ``grid_adjoint`` against itself (bitwise), the adjoint dot test
   on the card, the radial NRMSE beside the Cartesian gridding NRMSE of
   the same frames, and the repo's radial quality criterion on a small
   input (NRMSE below 0.35, as ``tests/test_gridding.py`` asks).

6. LM serving: recurrentgemma-2b at its published widths and depth (26
   layers, d_model 2560, 10 heads on one kv head of dim 256, d_ff 7680,
   vocab 256000, RG-LRU width 2560, window 2048, bf16) with random weights
   from a seeded generator on the card, behind
   ``repro_torch.serve.Engine(batch=2, max_len=4096)``: 4 requests with
   prompts of 3072, 2049, 512 and 1 tokens (numpy's ``default_rng(0)``)
   and max_new 16, 12, 8 and 4.  The launch counters are set to 0 just
   before the first submit and must read 8 ``flash_attention`` and 18
   ``rg_lru`` launches per prefill (32 and 72) and none in any decode
   step; every request must return its max_new tokens.  Prefill ms per
   request and decode ms per token come from CUDA events (after one
   warm-up prefill outside the count).  Then the same four requests
   through an ``Engine`` inside ``registry.plain()``, both paths' greedy
   tokens printed with the first position where they differ (and a note
   where every request repeats one token, which the random init can
   give, so that equal tokens are not read as agreement); and the
   same weights in float32 compute, whose four prefills through the
   kernels and through the plain versions must agree within
   ``LM_PATH_TOL_F32`` (relative L2 of the last-token logits), while in
   bf16 the kernel path must be no further from the float32 logits than
   ``LM_BF16_RATIO`` times the plain path.  The kernels phase also holds
   both LM kernels against their plain versions at the JAX specs' feature
   samples, and ``rg_lru`` against itself at the served shape (bitwise),
   and prints the registers, spills and tile bytes of the one-pass scan's
   four instances (a spill fails the run).
7. xlstm-350m served: the same phase for xlstm-350m at its published
   widths and depth (24 layers: 21 mLSTM and 3 sLSTM blocks, d_model
   1024, 4 heads of dim 512 over the mLSTM's inner width 2048, vocab
   50304, bf16), random weights from a generator seeded 0, behind
   ``Engine(batch=2, max_len=4096)`` with the same four prompts and
   max_new: 21 ``mlstm`` launches per prefill (84), none in decode, the
   same float32 and bf16 checks, and the share of a 3072-token prefill
   that its sLSTM loops take (CUDA events around the layers).  The kernels phase
   holds ``mlstm`` against ``mlstm_chunkwise`` at the served shape from a
   zero and a nonzero state and at every ``FEATURE_CASES`` entry (zero and
   nonzero state, a ragged S) in float32 and in bf16, within 2e-3, each
   through the route of its dtype, and requires a bitwise repeat.
8. the multi-rank core: four rank processes (``run_ranks``: spawned, one
   ``FileStore``, gloo, all on the one card) run
   ``FrameStream(Reconstructor(comm=4 ranks, channel_sum="crop"))`` over
   phase 3's 4 full-width frames (J = 8, 2 coils a rank, newton 7, cg 30),
   with the counters set to 0 just before and read just after on every
   rank: one ``masked_sum`` per channel-sum call (newton + the CG
   iterations, a frame) and the other frame kernels as
   ``expected_launches`` gives them for the rank's coils.  ``rho``, the CG
   log and the images must be bitwise equal on every rank; the 4-rank
   image within ``PATH_TOL`` of the 1-rank image at newton 3 / cg 10, and
   at full depth each frame's NRMSE within ``DEPTH_NRMSE_TOL`` of phase
   3's.  Then the segmented BLAS on full-width CG-state containers
   (``rho`` CLONE 768 x 768, ``chat`` NATURAL 8 x 768 x 768 from a numpy
   seed): ``xpby_dot``, ``cg_update``, ``axpy_dot`` and
   ``dot_allreduce`` held against the plain computation on the gathered
   arrays (the spec tolerance), one ``xpby_dot`` launch per leaf.  Last, a
   1-rank NCCL group runs frame 0 of the same program.  Times of this
   phase are times of a host-staged transport (gloo) on one shared card:
   they say nothing of four cards.  The stream's collectives are recorded
   (``core.comm.record``), and frame 0 runs once more on the 4 ranks
   under ``channel_sum="full"``, recorded too: every rank must record the
   same collectives, and the image-sized ones' wire bytes a rank in
   frame 0 (``launch.roofline``'s ring model) under ``full`` over
   ``crop`` must lie within ``WIRE_RATIO``; the bytes and the ratio are
   printed.  The kernels' blocks: rank 0 swept them on the card and
   broadcast its winners (``registry.tune_group``), so every rank must
   hold the same blocks, rank 0's swept and no other rank's.
8b. the core's other schedules: four rank processes sharing the card
   (gloo) stream phase 3's 4 full-width frames twice, with
   ``Reconstructor(overlap="p2p")`` on the 4 ranks (the ring) and with
   ``hierarchical=True`` on a ``(2, 2)`` ``("pod", "data")`` group, each
   with the counters set to 0 just before and read just after: the
   counts ``expected_launches`` gives (one ``masked_sum`` per channel
   sum under either schedule), ``rho``, the CG log and the movie bitwise
   equal on every rank, each frame's NRMSE within ``DEPTH_NRMSE_TOL`` of
   phase 3's, the newton 3 / cg 10 frame within ``PATH_TOL`` of 1 rank,
   the movie against phase 8's default schedule (the ring's must be
   bitwise equal to it: both sum one stack of the ranks' windows in rank
   order) and ms/frame beside phase 8's.  Then every new verb once on the
   4 ranks at sizes above both schedule thresholds (64 KiB), each
   schedule forced, against numpy (broadcast, reduce, ``gemm_ksplit``,
   the ring and hierarchical all-reduces, ``reduce_scatter``, every
   direct ``copy`` route, ``alltoall``, ``gemm_batched``,
   ``fft2_batched``, the OVERLAP2D halo exchange, ``invoke``,
   ``invoke_all``, ``survivor``), and phase 5's frame 0 through the
   radial plan with 2 of the 8 coils a rank (one ``degrid`` and one
   ``grid_adjoint`` launch on each rank) against phase 5's samples and
   image within ``PATH_TOL``.  It prints which verbs went through the
   host (gloo takes CUDA tensors in its all-reduce, all-gather and
   broadcast only).  These times are of a host-staged transport on one
   card, not of four cards.
9. the task-graph stream and the batched NLINV service, at full width.
   (a) ``FramePipeline(Reconstructor(newton=7, cg_iters=30))`` at
   inflight 2 and 3 over phase 3's 4 frames, between two ``FrameStream``
   runs of them: launch counts from the CG logs, the movie within
   ``STREAM_TOL`` of phase 3's (and whether it is bitwise equal), steady
   ms/frame of each.  (b) ``StreamScheduler(NlinvStreamWorkload(rec),
   ServeConfig(buckets=(1, 2, 4)))`` serving 3 clients (datasets of seeds
   0, 1, 2), 4 frames each, client 0 skipping tick 2, so the ticks run at
   widths 4 (3 clients and a padded row), 4, 2 and 4: the launch counters
   set to 0 before the first tick must equal the counts that the batched
   CG logs imply (one launch a kernel call for all rows, the loop running
   until every row stops); each client's frames within ``STREAM_TOL`` of
   its own ``FrameStream`` run (and whether bitwise equal; if not, the
   centered FFT of a batch against one call a row); a second run with
   client 1's frame 1 NaN must return it ``Rejected``, quarantine the
   client once and leave the other clients' frames bitwise as in the
   clean run.  It prints tick ms by width, per-client and aggregate
   frames/s, and the batched and sequential frames/s and their ratio.
   (c) The unfused batched frame, ``Reconstructor(fused=False)
   .fn_batched(4)``, on frame 0 of 4 full-width clients (seeds 0-3,
   newton 7, cg 30, one rank) after a warm-up tick: the ``coil_mult``
   launches of the tick, counted from 0 just before it, in the unfused
   operators' ratios (``coil_scale_mult`` one a Newton step, and per
   operator application one ``coil_lincomb``, one ``coil_forward`` and
   four ``plane_mult``, with G's and the right-hand side's); each row
   within ``STREAM_TOL`` of that client's unfused single frame (and
   whether bitwise); the images finite; tick ms beside the fused batched
   frame's on the same inputs and phase 9b's width-4 ticks.  (d)
   ``examples/torch_quickstart.py --ranks 1`` on the card, in a process
   of its own: exit 0 and its checks printed true.  (e) The registry's
   block autotuner (``phase_tune``): every candidate block of every
   spec's space at the spec's main-path sample, held against the plain
   version within the spec's tolerance and bitwise against the spec's
   default block (the fixed-order kernels ``coil_adjoint``,
   ``cg_update``, ``xpby_dot``, ``masked_sum`` and ``grid_adjoint`` must
   be; the others are reported), each timed (events and device ms,
   back to back) beside its bound, with the autotuner's own pick and its
   table (each candidate's device time from a cold L2, best of
   ``TUNE_ITERS``), the pick against the default in both; then
   the NLINV frame (``FRAMES`` frames of client 0) and the width-4
   tick (frame 0 of 4 clients), once with sweeps and once under
   ``REPRO_KERNEL_BLOCKS=default``: ms a frame and a tick, the first
   frame's and the tick plan's set-up ms with their sweeps, the tune
   cache's builds over the steady frames and ticks (0), the rows bitwise
   their single frames, and the two runs' images bitwise equal.  (That
   the ranks of a group hold rank 0's choices, phase 8 shows.)
10. the service under faults (``repro_torch.ft``), at full width and
   depth.  (a) One rank, 4 clients (seeds 0-3, so every row of a width-4
   tick is a client), buckets (1, 2, 4), 4 frames: a clean run (launch
   counts from its batched CG logs, counted from 0 before its first tick),
   then one run per fault of the reference's ``SERVE_CHAOS``
   (``tests/test_fault_injection.py``): a transient solve under
   ``RestartPolicy(max_restarts=2)`` (fired once, retried once, every
   frame bitwise the clean run's), one client's tick items corrupted at
   tick 1 (that frame ``Rejected``, the client quarantined once and
   streaming on, every other frame bitwise the clean run's), a transient
   step (requeued, ``step_faults == 1``, full parity) and two runs of a
   seeded straggle (equal, non-empty ``fired`` logs).  It prints the
   clean run's tick ms at width 4, its frames/s and the retried ticks'
   ms.  (b) Four rank processes sharing the card (gloo, as phase 8), 2
   clients (seeds 0, 1), buckets (1, 2): an uninterrupted batched service
   (launch counts on every rank, one ``masked_sum`` per channel sum for
   both rows; the same bits on every rank), each client's images against
   its own 4-rank ``FrameStream`` within ``STREAM_TOL`` (and whether
   bitwise); then a ``device_loss`` at the third solve, the survivor
   group of ranks 0-1, ``NlinvStreamWorkload.remesh`` on every rank (the
   lost ranks take part in the carries' gather, then retire and end),
   the frame resubmitted: frames before the loss bitwise the
   uninterrupted run's, after it within ``REMESH_TOL``, every frame
   delivered, ``remeshes == 1``; ms per tick before and after.  The
   kernels phase holds the batched ``masked_sum`` at 10b's shapes, (4, 2,
   384, 384), against its plain form, with its bound and its ``einsum``
   yardstick.
11. the eight configs served: qwen3-0.6b, llama3.2-3b, gemma2-27b,
   minicpm3-4b, deepseek-v2-lite-16b, granite-moe-3b-a800m,
   llama-3.2-vision-11b and whisper-tiny, one at a time, each at its
   published widths and full depth in bf16 with random weights from a
   generator seeded 0 (freed, and the allocator's cache emptied, before
   the next), behind ``Engine(batch=2, max_len=4096)``: prompts of 2048
   and 1 tokens (whisper-tiny 440 and 1, within its 448-token decoder
   context; numpy's ``default_rng(0)``), max_new 8 and 4, the
   frontend embeddings of the cross-attention archs from
   ``synthetic_frontend``.  The launch counters are set to 0 just before
   the first submit: one ``flash_attention`` launch per ``attn``,
   ``local`` or ``mla`` layer per prefill (``CONFIG_FLASH``: 28, 28, 46,
   62, 27, 32, 32 and 4; 518 over the phase), none in decode.  Each arch
   prints its parameters, GB on the card, peak memory
   (``torch.cuda.max_memory_allocated``), random-init seconds, prefill ms
   per request, decode ms per token and both paths' greedy tokens; the
   float32 and bf16 agreement of phase 6 run at the full width and the
   reduced depth ``CONFIG_F32_DEPTH`` (every layer kind still there;
   gemma2-27b alone is 109 GB in float32).  The cross-attention gates of
   llama-3.2-vision and whisper-tiny are opened to ``CROSS_GATE`` after
   each init (tanh(0) = 0 would leave the encoder out of every check).
   gemma2-27b must fit.  The phase's seconds are printed.

12. training on one card (``TRAIN_*``): (a) each LM kernel's gradients,
   through its autograd function (the kernel's forward, the plain
   version's backward recomputed), against the plain path's at the shapes
   its prefill runs (the spec's sample; the mLSTM from a nonzero state,
   so that every input takes one), float32 and bf16, within
   ``TRAIN_GRAD_TOL`` relative L2, the counter one launch a forward and
   none on the plain path; the plain backward's CUDA-event ms a call,
   and flash attention's at the train step's shape; (b)
   ``repro_torch.launch.train.main`` on qwen3-0.6b at full width and
   depth in float32, 8 steps of 2 x 2048 tokens, a checkpoint every 4
   into a temporary directory (removed after): losses finite, 28
   ``flash_attention`` launches a step (counted from 0 before the run),
   steady ms a step, tokens/s and peak memory; then one float32 step with
   the kernels against the same step inside ``registry.plain()`` (loss
   and global grad norm within ``TRAIN_PATH_TOL``; both with remat, since
   the plain path's saved attention scores of 28 layers would not fit),
   and the kernel path
   on that batch again: at least ``TRAIN_REPEAT_LOWER`` of its steps
   lower the loss; (c) at ``--layers 2`` (full width and vocab), a crash
   after the step-2 checkpoint through ``run_with_restarts``, resumed
   from it, against the uninterrupted run (final loss and parameters
   within ``TRAIN_RESUME_TOL``, and whether bitwise, under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``).

13. tensor-parallel serving (``TP_*``): four rank processes sharing the
   card over gloo (as phase 8) on ``("data", "model")`` meshes;
   llama3.2-3b at its published widths and full depth on (1, 4) and
   (2, 2), granite-moe-3b-a800m (40 experts, 10 a rank; vocab 49155,
   which does not divide) and minicpm3-4b (MLA) at full width and the
   depth ``TP_DEPTH`` on (1, 4), in float32 compute.  Each rank makes its
   shards leaf by leaf from a generator seeded 0 (``init_shards``: a leaf
   whole on the card, its slice kept, the rest freed); the one-rank
   reference builds the whole model once in the parent from the same
   seed.  Batch ``TP_BATCH`` of ``TP_PROMPT``-token prompts (numpy's
   ``default_rng(0)``), ``max_len`` ``TP_MAX_LEN``, then ``TP_DECODE``
   greedy decode steps.  Each run checks the last-token logits of every
   step against the one-rank ``make_serve_steps`` within
   ``LM_PATH_TOL_F32`` (relative L2) and every greedy token equal (a
   first difference passes only at a near tie of the reference's
   logits), one ``flash_attention`` launch a layer a prefill on each rank
   and none a decode step, each rank's parameter bytes equal to its
   slices by the specs (the stacked norms replicated over data counted),
   and prints ``torch.cuda.max_memory_allocated`` per rank and prefill
   ms and decode ms a token (CUDA events) beside the one-rank run's.  The
   ranks share one card over host-staged gloo, so the times measure that
   staging, not four cards.

14. sharded training (``SH_*``): the same four rank processes on
   ``("data", "model")`` meshes, each making its train state leaf by leaf
   from a generator seeded 0 (``make_train_state(mesh=)``): qwen3-0.6b at
   its published widths cut to 8 of 28 layers, float32, 3 steps of a
   global batch of 4 x 512 tokens on (1, 4) and (2, 2); recurrentgemma-2b
   cut to 3 of 26 layers (rglru, rglru, local) and xlstm-350m cut to 8 of
   24 (7 mlstm, 1 slstm) on (1, 4), each serving a prefill of 2 x 256
   tokens and 4 greedy decode steps (held as phase 13 holds its archs),
   then 2 train steps on the prompts.  The parent runs each one rank
   first on the whole model from the same seed and saves its final
   parameters and AdamW ``m`` to a temporary file.  Each step's loss and
   gnorm within ``SH_STEP_TOL`` of one rank's; after the steps every shard
   of ``m`` and of the parameters against one rank's slices by the rule of
   ``tests/test_torch_train.py`` (the parameters where AdamW's update was
   well conditioned, ``SH_COND_FLOOR``) and every parameter element
   against AdamW's update of the shard's own moments; launches a step and
   a prefill on each rank equal to one rank's (8 ``flash_attention`` a
   qwen3-0.6b step); params + m + v bytes a rank 3 x the specs'; peak
   memory, ms a step and the collectives a step by verb (the forward's,
   the backward's ``.bwd``, the step's own ``.step``) beside one rank,
   times of gloo's host staging on one shared card, not of four cards.
15. the dry run against the card (``repro_torch.launch.dryrun``, one
   rank's step traced on the meta device): (a) ``dryrun.main`` for
   qwen3-0.6b x ``train_4k`` and x ``decode_32k`` on the single production
   mesh (32 x 8 H100s, dry), each cell's dominant roofline term and its
   three modelled times; (b) phase 12b's step (qwen3-0.6b whole, float32,
   2 x 2048, without remat and with it, ``torch.utils.checkpoint``'s
   recomputation) as a dry cell on a 1 x 1 mesh against the same step
   on the card, under the same counters, in each mode: the counted flops
   equal (the matmul family's from ``FlopCounterMode`` and the kernels' from
   ``registry.count()``), the dry peak within ``DRY_PEAK_TOL`` of
   ``torch.cuda.max_memory_allocated`` (less what the process held before
   that is not the step's), the measured step ms at least the roofline's
   bound, their ratio printed, and the card's memory as
   ``core.runtime.HW["hbm_bytes"]`` holds it; (c) phase 14's qwen3-0.6b
   sharded step (8 layers, 4 ranks sharing the card over gloo, (1, 4))
   without and with sequence parallelism: rank 0's collective record
   equal to the dry cell's entry for entry in each mode, the loss and
   gnorm with it within ``DRY_SP_TOL`` of those without, and each rank's
   peak memory in both modes.  The phase's seconds are printed and held
   to ``DRY_PHASE_S``.

Each kernel's ``launches`` in the ``kernels`` line is its count from the
phase that drives its path: the frame (phase 3) and the unfused
batched tick (phase 9c, ``coil_mult``) for the NLINV kernels,
the 4-rank frames (phase 8's and phase 8b's two streams and phase 10b's
uninterrupted service, rank 0, each counted from 0) for ``masked_sum``
and the segmented
BLAS (phase 8) for ``xpby_dot``, the radial pass (phase 5) for
``degrid`` and ``grid_adjoint``, the served requests (phase 6) for
``flash_attention`` and ``rg_lru`` and (phase 7) for ``mlstm``, and phase
11's, phase 12b's and phase 13's (rank 0) for ``flash_attention`` again
(its row's ``mla`` entry holds the MLA shapes' numbers, ``causal_gqa``
row 12c's), and phase 14's (rank 0, each step and prefill counted from
0) for all three.  The served bf16 prefills must take the tensor-core
routes of ``flash_attention`` and ``mlstm`` and the float32 ones their
CUDA-core routes, and every served bf16 prefill (phases 6 and 11) the
flash kernel's TMA loader.  A kernel whose operands are
bf16 (flash attention, the mLSTM) is bounded by the bf16 tensor-core
rate; its row also carries ``f32_core_bound_ms``, the same flops over the
float32 CUDA-core rate (the float32 routes of both compute on the CUDA
cores).

Each phase's seconds are printed as it ends (``phase <name>: <s> s``) and
together, with the total, on a ``phase seconds:`` line before the kernels
line.  The line before the last is the ``kernels`` JSON object; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, NCOILS, SPOKES, FRAMES = 384, 8, 11, 4
NEWTON, CG_ITERS, DAMPING = 7, 30, 0.9
SHALLOW_NEWTON, SHALLOW_CG = 3, 10
PATH_TOL = 1e-4          # kernel path vs plain path, relative L2 of image
# back-to-back calls timed per kernel: the first call waits on the host
# from an idle card, a share that 100 calls make small
TIMING_REPS = 100
PLAN_LOOKUPS = 1000      # plan_fft2 cache hits timed on the host
LM_ARCH = "recurrentgemma-2b"
LM_PROMPTS = (3072, 2049, 512, 1)
LM_MAX_NEW = (16, 12, 8, 4)
LM_BATCH, LM_MAX_LEN = 2, 4096
# kernel path vs plain path, last-token prefill logits (relative L2): in
# float32 compute; in bf16 (the served dtype) each path's distance from
# the float32 plain logits, the kernel path's at most this multiple of
# the plain path's (bf16 rounding alone puts either path about 2e-2 from
# float32 at this depth, so a fixed bf16 bound would test the rounding)
LM_PATH_TOL_F32 = 1e-4
LM_BF16_RATIO = 1.5
# the float32 feature samples of flash attention, cast to bf16 for the
# tensor-core route: the JAX spec's tolerance of its bf16 sample
BF16_FEATURE_TOL = 2e-2
# row 12c: llama3.2-3b's prefill (configs/llama3_2_3b.py), one prompt of
# 2048 tokens, bf16, causal: (arch, B, query heads, kv heads, S, head dim)
GQA_CASE = ("llama3.2-3b", 1, 24, 8, 2048, 128)
# more draws of a kernel's sample where the sample is held to its own
# dtype's tolerance (flash attention's bf16 LM sample)
SAMPLE_DRAWS = tuple(range(100, 108))
# phase 9: the service's clients (each its own dataset seed) and widths
SERVE_SEEDS = (0, 1, 2)
SERVE_BUCKETS = (1, 2, 4)
SERVE_WIDTH = 4           # the width that 3 clients bucket to
SERVE_SKIP = ((0, 2),)    # client 0 skips tick 2: a width-2 tick
SERVE_POISON = (1, 1)     # (client, frame) whose acquisition is NaN
PIPE_INFLIGHT = (2, 3)
STREAM_TOL = 1e-5         # pipelined / batched against FrameStream
QUICKSTART_TIMEOUT_S = 300  # phase 9d: the example's process
# phase 8's frame 0 under each channel sum: the image-sized collectives
# (the reference's byte test's 4096-byte floor) and the limits of their
# full / crop wire-byte ratio (tests/test_nlinv_perf_collectives.py)
CHANNEL_SUMS = ("crop", "full")
WIRE_IMAGE_BYTES = 4096
WIRE_RATIO = (3.0, 6.0)
# phase 10: the service under faults.  10a: 4 clients on one rank, so that
# every row of a width-4 tick is a client; 10b: 2 clients on 4 ranks, a
# device loss at the third solve, the ranks 2 and 3 lost
CHAOS_SEEDS = SERVE_SEEDS + (3,)
CHAOS_FAULT_SEED = 1234   # the reference's SERVE_CHAOS seed
STRAGGLE_SEED = 7
REMESH_CLIENTS = 2
REMESH_BUCKETS = (1, 2)
REMESH_LOST = (2, 3)
REMESH_TOL = 1e-5         # after the remesh against the uninterrupted run
REMESH_TIMEOUT_S = 400    # phase 10b: the ranks' deadline, collectives too
# the kernels phase's batched rows: the frame kernels at SERVE_WIDTH, the
# channel sum's masked_sum at phase 10b's width, with its einsum
# yardstick at that shape
BATCHED_WIDTH = {"masked_sum": REMESH_CLIENTS}
BATCHED_YARDSTICK = ("masked_sum",)
XLSTM_ARCH = "xlstm-350m"
XLSTM_PROMPTS = (3072, 2049, 512, 1)
XLSTM_MAX_NEW = (16, 12, 8, 4)
DIST_RANKS = 4            # phase 8: ranks sharing the one card (gloo)
DIST_TIMEOUT_S = 400      # phase 8: the ranks' deadline, collectives too
SCHED_TIMEOUT_S = 600     # phase 8b: the same
VERB_SEED = 13            # phase 8b: the verbs' numpy inputs
# phase 8, full depth: the 4-rank frames' NRMSE against the 1-rank frames'
# (the depth-drift rule of the frame's earlier slices)
DEPTH_NRMSE_TOL = 1e-3
BLAS_SEED = 7
# phase 11: the eight configs, served one at a time
CONFIG_ARCHS = ("qwen3-0.6b", "llama3.2-3b", "gemma2-27b", "minicpm3-4b",
                "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
                "llama-3.2-vision-11b", "whisper-tiny")
CONFIG_PROMPTS = (2048, 1)
CONFIG_MAX_NEW = (8, 4)
# an arch whose decoder context is shorter than CONFIG_PROMPTS[0] serves a
# prompt that fits with its max_new: whisper's 448 tokens
CONFIG_PROMPTS_OF = {"whisper-tiny": (440, 1)}
# flash attention launches per prefill: the attn, local and mla layers
# (llama-3.2-vision's 8 cross layers run the plain chunked form)
CONFIG_FLASH = {"qwen3-0.6b": 28, "llama3.2-3b": 28, "gemma2-27b": 46,
                "minicpm3-4b": 62, "deepseek-v2-lite-16b": 27,
                "granite-moe-3b-a800m": 32, "llama-3.2-vision-11b": 32,
                "whisper-tiny": 4}
# the float32 agreement's depth: every layer kind of the arch (a cross
# layer at 5, the MoE after deepseek's dense layer at 3; whisper keeps 2
# encoder layers)
CONFIG_F32_DEPTH = {"llama-3.2-vision-11b": 5, "deepseek-v2-lite-16b": 3}
CONFIG_F32_ENCODER = 2
# the cross-attention gates of the archs with an encoder (vlm, whisper):
# the init's 0 gives tanh(0) = 0, which would leave the encoder and the
# cross cache out of every token and logit checked, so they are opened
# to this value (as the CPU tests open them) on both paths
CROSS_GATE = 0.5
# the port's kernel for each layer kind that prefills through one
KIND_KERNEL = {"attn": "flash_attention", "local": "flash_attention",
               "mla": "flash_attention", "rglru": "rg_lru", "mlstm": "mlstm"}
ATTN = ("attn", "local", "mla")
# phase 12: training.  (a) each LM kernel's gradients against the plain
# path's (the same operations, so bitwise; held to this relative L2), the
# plain backward timed over TRAIN_BWD_REPS calls; (b) the launcher on
# qwen3-0.6b at full width and depth in float32, then one step against
# the plain path (loss and global grad norm) and the loss falling on one
# repeated batch; (c) a crash resumed from a checkpoint at a cut depth
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
TRAIN_GRAD_TOL = 1e-6
TRAIN_BWD_REPS = 3
TRAIN_PATH_TOL = 1e-4
TRAIN_REPEAT_STEPS, TRAIN_REPEAT_LOWER, TRAIN_REPEAT_LR = 7, 5, 1e-4
TRAIN_RESUME_DEPTH, TRAIN_RESUME_STEPS = 2, 4
TRAIN_RESUME_EVERY, TRAIN_RESUME_CRASH = 2, 2
TRAIN_RESUME_TOL = 1e-6
# phase 13: tensor-parallel serving.  Four rank processes share the card
# over gloo (as phase 8), on the (data, model) meshes of TP_MESHES; each
# run serves TP_BATCH prompts of TP_PROMPT tokens (numpy's default_rng(0))
# in float32 compute, then TP_DECODE greedy decode steps, against the
# one-rank steps on the same weights (generator seeded 0, built whole in
# the parent); TP_DEPTH cuts a run's depth (None: the published depth)
TP_RANKS = 4
TP_AXES = ("data", "model")
TP_BATCH, TP_PROMPT, TP_MAX_LEN, TP_DECODE = 4, 1024, 2048, 16
TP_RUNS = (("llama3.2-3b", (1, 4)), ("llama3.2-3b", (2, 2)),
           ("granite-moe-3b-a800m", (1, 4)), ("minicpm3-4b", (1, 4)))
TP_DEPTH = {"granite-moe-3b-a800m": 8, "minicpm3-4b": 8}
TP_TIMEOUT_S = 900        # the ranks' deadline, collectives too
# phase 14: sharded training and the recurrent archs' sharded steps.  Four
# rank processes share the card over gloo (as phase 13); each run of
# SH_RUNS makes its shards from a generator seeded 0 (make_train_state(
# mesh=)) and is held against one rank's run on the same weights, built
# whole in the parent.  Widths are the published ones, depth cut to
# SH_LAYERS, float32 compute.  qwen3-0.6b trains SH_STEPS steps on a
# global batch of SH_BATCH x SH_SEQ tokens; the recurrent archs serve a
# prefill of SH_REC_BATCH x SH_REC_PROMPT tokens and SH_REC_DECODE greedy
# decode steps, then train SH_STEPS steps on the prompts.  The schedule is
# the tests' (lr 1e-3 from the first step).
SH_RUNS = (("qwen3-0.6b", (1, 4)), ("qwen3-0.6b", (2, 2)),
           ("recurrentgemma-2b", (1, 4)), ("xlstm-350m", (1, 4)))
SH_LAYERS = {"qwen3-0.6b": 8, "recurrentgemma-2b": 3, "xlstm-350m": 8}
SH_STEPS = {"qwen3-0.6b": 3, "recurrentgemma-2b": 2, "xlstm-350m": 2}
SH_BATCH, SH_SEQ = 4, 512
SH_REC_BATCH, SH_REC_PROMPT, SH_REC_MAX_LEN, SH_REC_DECODE = 2, 256, 512, 4
SH_TRAIN_KW = {"base_lr": 1e-3, "warmup": 0, "total": 10}
SH_STEP_TOL = 1e-4        # each step's loss and gnorm against one rank
# the parameters and AdamW's m after the steps against one rank's slices:
# the rule of tests/test_torch_train.py (the difference within UPDATE_TOL
# of the movement, each element within ELEMENT_TOL), the parameters where
# AdamW's update was well conditioned at every step (|m^| >=
# SH_COND_FLOOR), and every parameter element against AdamW's update of
# the shard's own moments within SH_ADAM_TOL
# (tests/test_torch_train_sharded.py)
SH_UPDATE_TOL, SH_ELEMENT_TOL = 1e-3, 5e-5
SH_COND_FLOOR, SH_ADAM_TOL = 1e-7, 1e-6
SH_TIMEOUT_S = 900        # the ranks' deadline, collectives too
SH_KERNELS = ("flash_attention", "rg_lru", "mlstm")

# phase 15: the dry run against the card.  (a) the production cells of
# DRY_ARCH traced by dryrun.main; (b) phase 12b's step as a dry cell on a
# 1 x 1 mesh against the step on the card; (c) phase 14's (1, 4) step
# without and with sequence parallelism against its dry cells.
DRY_ARCH = "qwen3-0.6b"
DRY_CELLS = ("train_4k", "decode_32k")
DRY_PEAK_TOL = 0.15       # (b) the dry peak against max_memory_allocated
DRY_SP_TOL = 1e-5         # (c) loss and gnorm with sequence parallelism
DRY_SP_MESH = (1, 4)
DRY_PHASE_S = 150.0


def ptxas_resources(log: str, names) -> dict:
    """Each named kernel's registers, spilled bytes and whether ptxas
    serialised its wgmma instructions (its "Potential Performance Loss"
    notes, C7510–C7520), from the build's ``-Xptxas -v`` log (whose
    mangled names hold the plain ones)."""
    import re
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        name = m and next((n for n in names if n in m.group(1)), None)
        if not name:
            continue
        rec = out.setdefault(name, {"wgmma_serialized": any(
            "instructions are serialized" in x and m.group(1) in x
            for x in lines)})
        for nxt in lines[i + 1:i + 5]:
            r = re.search(r"Used (\d+) registers", nxt)
            if r:
                rec["registers"] = int(r.group(1))
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", nxt)
            if s:
                rec["spill_bytes"] = int(s.group(1)) + int(s.group(2))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, args, reps=TIMING_REPS) -> float:
    """Mean time of ``fn(*args)`` on the card, from CUDA events around
    ``reps`` back-to-back calls after one warm-up call."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, args, reps=TIMING_REPS) -> tuple[float | None, dict]:
    """Mean device time of ``fn(*args)``: the CUDA kernels'
    ``torch.profiler`` time over ``reps`` calls after one warm-up call,
    and the same by kernel name (a wrapper may launch several).  Where
    the host cannot keep the card busy (small launches behind a Python
    wrapper), ``time_ms`` measures the host and this the card.  ``None``
    when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.key)
            by_name[name] = (by_name.get(name, 0.0) +
                             e.self_device_time_total / 1e3 / reps)
    total = sum(by_name.values())
    return (total if total else None), by_name


def _kernel_name(key: str) -> str:
    """The port's kernel key without its return type, namespace and
    arguments: "void (anonymous namespace)::k<float>(float const*)" is
    "k<float>".  Names that share a stem share a sum; the total holds."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0]


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, tuple) else (x,)


def _agree(got, want, tol) -> tuple[bool, float, float]:
    """allclose in the JAX registry harness's form (rtol = 10 tol,
    atol = tol) over every output, with the largest absolute error and
    the largest error relative to its output's largest value."""
    import torch
    pairs = list(zip(_outputs(got), _outputs(want)))
    err = max(float((g - w).abs().max()) for g, w in pairs)
    rel = max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
              for g, w in pairs)
    ok = all(torch.allclose(g, w, rtol=10 * tol, atol=tol)
             for g, w in pairs)
    return ok, err, rel


def _time_parts(spec, args, card) -> dict:
    """Events and device ms of each of ``spec.parts``: parts of a kernel's
    work, timed alone, and their yardsticks."""
    out = {}
    for name, call in spec.parts(*args).items():
        dev, split = device_ms(call, ())
        out[name] = {"ms": time_ms(call, ()), "device_ms": dev,
                     "device_ms_by_kernel": split}
        print(f"kernel {spec.name} part {name}: {out[name]['ms']:.4f} ms "
              f"(device {'n/a' if dev is None else f'{dev:.5f}'}; "
              f"{ {k: round(v, 5) for k, v in split.items()} }) [{card}]",
              flush=True)
    return out


def phase_kernels(device, card) -> list[dict]:
    import torch
    from repro_torch.kernels import registry
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # the batched samples draw from their own generator, so that every
    # kernel's main-path sample is the draw it has always been
    batch_gen = torch.Generator(device=device)
    batch_gen.manual_seed(19)
    rows = []
    for spec in registry.specs():
        args = spec.sample(device, gen)
        tol = spec.sample_tol or spec.tol
        ok, err, rel = _agree(spec.kernel(*args), spec.plain(*args), tol)
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"{spec.name}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        lib_ms = lib_dev_ms = None
        if spec.library is not None:
            lib_ok, lib_err, _ = _agree(spec.library(*args),
                                        spec.plain(*args), tol)
            if not lib_ok:
                raise AssertionError(f"{spec.name}: library yardstick "
                                     f"computes another function "
                                     f"({lib_err})")
            lib_ms = time_ms(spec.library, args)
            lib_dev_ms = device_ms(spec.library, args)[0]
        ms = time_ms(spec.kernel, args)
        dev_ms, dev_split = device_ms(spec.kernel, args)
        plain_ms = time_ms(spec.plain, args)
        bound, bound_by = spec.bound_ms(*args)
        rows.append({
            "name": spec.name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": 0,
            "max_abs_err": err, "max_rel_err": rel, "tol": tol,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms,
        })
        if len(dev_split) > 1:
            rows[-1]["device_ms_by_kernel"] = dev_split
        if spec.peak_flops != registry.H100_F32_FLOPS:
            rows[-1]["f32_core_bound_ms"] = (spec.flops(*args) /
                                             registry.H100_F32_FLOPS * 1e3)
        print(f"kernel {spec.name}: max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tol {tol}) "
              f"kernel {ms:.4f} ms (device "
              f"{'n/a' if dev_ms is None else f'{dev_ms:.4f}'}), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (device "
              f"{'n/a' if lib_dev_ms is None else f'{lib_dev_ms:.4f}'}), "
              f"bound "
              f"{bound:.4f} ms ({bound_by}, "
              f"{spec.nbytes(*args) / 1e6:.1f} MB) [{card}]", flush=True)
        if len(dev_split) > 1:
            print(f"kernel {spec.name} device ms by CUDA kernel: "
                  f"{ {k: round(v, 4) for k, v in dev_split.items()} }",
                  flush=True)
        if spec.parts is not None:
            rows[-1]["parts"] = _time_parts(spec, args, card)
        del args
        if spec.batched:
            rows[-1]["batched"] = _time_batched(spec, device, batch_gen,
                                                card, ms, dev_ms)
        if spec.sample_tol is not None:
            rows[-1]["draws"] = _draws(spec, device, card)
    return rows


def _draws(spec, device, card) -> list[dict]:
    """A kernel whose sample is held to ``sample_tol`` (a bf16 sample)
    over ``SAMPLE_DRAWS`` more draws of it, each within that tolerance:
    the readings behind the limit.  Each draw's errors, the kernel's and
    the library yardstick's against the plain version, and how many
    outputs lie outside the spec's float32 limit ``tol``."""
    import torch
    out = []
    for seed in SAMPLE_DRAWS:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        args = spec.sample(device, gen)
        want = spec.plain(*args)
        row = {"seed": seed,
               "outputs": sum(w.numel() for w in _outputs(want))}
        for who, fn in (("kernel", spec.kernel), ("library", spec.library)):
            if fn is None:
                continue
            got = fn(*args)
            ok, err, _ = _agree(got, want, spec.sample_tol)
            if who == "kernel" and not ok:
                raise AssertionError(f"{spec.name} draw {seed}: kernel "
                                     f"disagrees with its plain version "
                                     f"(max abs err {err})")
            far = sum(int((~torch.isclose(g, w, rtol=10 * spec.tol,
                                          atol=spec.tol)).sum())
                      for g, w in zip(_outputs(got), _outputs(want)))
            row[who] = {"max_abs_err": err, "outside_tol": far}
        out.append(row)
        del args, want
    print(f"kernel {spec.name} over {len(out)} draws of its sample (tol "
          f"{spec.sample_tol}; outside_tol counts the outputs beyond the "
          f"float32 tol {spec.tol}): {json.dumps(out)} [{card}]", flush=True)
    return out


def _time_batched(spec, device, gen, card, ms, dev_ms) -> dict:
    """A kernel's batched form at the width of the path that runs it (B =
    ``SERVE_WIDTH`` rows of the main path's shapes for the frame kernels,
    the planes one a row or shared as the batched frame passes them; the
    4-rank service's ``BATCHED_WIDTH`` for ``masked_sum``) against its
    plain form within the spec's tolerance, timed by events and on the
    device beside B times the unbatched call and, for the kernels in
    ``BATCHED_YARDSTICK``, the library call at the same shapes, and its
    bound (each input read once: B rows' bytes, a shared plane once)."""
    import torch
    width = BATCHED_WIDTH.get(spec.name, SERVE_WIDTH)
    args = spec.sample(device, gen, width=width)
    want = spec.plain(*args)
    ok, err, rel = _agree(spec.kernel(*args), want, spec.tol)
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{spec.name} at width {width}: kernel "
                             f"disagrees with its plain form ({err})")
    b_ms = time_ms(spec.kernel, args)
    b_dev = device_ms(spec.kernel, args)[0]
    bound, bound_by = spec.bound_ms(*args)
    out = {"width": width, "shape": [list(a.shape) for a in args],
           "max_abs_err": err, "max_rel_err": rel,
           "ms": b_ms, "device_ms": b_dev,
           "plain_ms": time_ms(spec.plain, args),
           "unbatched_x_width_ms": width * ms,
           "unbatched_x_width_device_ms":
               None if dev_ms is None else width * dev_ms,
           "bound_ms": bound, "bound_by": bound_by,
           "mb": spec.nbytes(*args) / 1e6,
           "library_ms": None, "library_device_ms": None}
    if spec.name in BATCHED_YARDSTICK:
        lib_ok, lib_err, _ = _agree(spec.library(*args), want, spec.tol)
        if not lib_ok:
            raise AssertionError(f"{spec.name} at width {width}: library "
                                 f"yardstick computes another function "
                                 f"({lib_err})")
        out["library_ms"] = time_ms(spec.library, args)
        out["library_device_ms"] = device_ms(spec.library, args)[0]
    lib_ms, lib_dev = out["library_ms"], out["library_device_ms"]
    print(f"kernel {spec.name} at width {width} {out['shape']}: max_abs_err "
          f"{err:.3e} (tol {spec.tol}); {b_ms:.4f} ms (device "
          f"{'n/a' if b_dev is None else f'{b_dev:.4f}'}) against "
          f"{width} x the unbatched call {width * ms:.4f} ms "
          f"(device {'n/a' if dev_ms is None else f'{width * dev_ms:.4f}'}"
          f"); plain {out['plain_ms']:.4f} ms; library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (device "
          f"{'n/a' if lib_dev is None else f'{lib_dev:.4f}'}); bound "
          f"{bound:.4f} ms ({bound_by}, {out['mb']:.1f} MB) [{card}]",
          flush=True)
    del args
    return out


def phase_lm_features(device, card) -> tuple[list[dict], dict]:
    """The LM kernels against their plain versions at the JAX specs'
    feature samples, each within its sample's tolerance (the mLSTM within
    its spec's, with a bitwise repeat, and at the served shape), flash
    attention with v's own head dim (``phase_mla``) and at row 12c
    (``phase_gqa``); returns the MLA shapes' rows and row 12c's."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import (FEATURE_CASES, ROUTES,
                                                     chunked_attention,
                                                     flash_attention)
    from repro_torch.kernels.rg_lru import FEATURE_CASES as LRU_CASES
    from repro_torch.kernels.rg_lru import rg_lru_scan, rg_lru_scan_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(500)
    spec = registry.get("flash_attention")
    for B, Hq, Hkv, S, T, D, dtype, kw, tol in FEATURE_CASES:
        x = [torch.randn(sh, device=device, generator=gen)
             for sh in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]
        # the sample in its own dtype, and every sample's bf16 form on the
        # tensor cores, held to the JAX spec's bf16 tolerance
        forms = [(dtype, tol)] + ([(torch.bfloat16, BF16_FEATURE_TOL)]
                                  if dtype != torch.bfloat16 else [])
        for dt, tl in forms:
            q, k, v = (t.to(dt) for t in x)
            route = ROUTES[dt]
            before = spec.entry_launches.get(route, 0)
            ok, err, _ = _agree(flash_attention(q, k, v, **kw).float(),
                                chunked_attention(q, k, v, **kw).float(), tl)
            print(f"flash_attention feature sample {kw} {dt} ({route}): "
                  f"max_abs_err {err:.3e} (tol {tl})", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention disagrees at {kw} "
                                     f"in {dt}")
            if spec.entry_launches.get(route, 0) != before + 1:
                raise AssertionError(f"{dt} did not take {route}")
    q, k, v, kw, _ = spec.sample(device, gen)
    first, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v,
                                                                   **kw)
    if not torch.equal(first, again):
        raise AssertionError("flash_attention_bf16 is not bitwise "
                             "repeatable at the LM sample")
    print("flash_attention_bf16 at the LM sample: repeat bitwise identical",
          flush=True)
    mla_rows = phase_mla(device, card, gen)
    gqa_row = phase_gqa(device, card, gen)
    for B, S, W, dtype, tol in LRU_CASES:
        la = (-0.1 * torch.randn((B, S, W), device=device,
                                 generator=gen).abs()).to(dtype)
        b = torch.randn((B, S, W), device=device, generator=gen).to(dtype)
        h0 = torch.randn((B, W), device=device, generator=gen).to(dtype)
        got = tuple(x.float() for x in rg_lru_scan(la, b, h0))
        want = tuple(x.float() for x in rg_lru_scan_plain(la, b, h0))
        ok, err, _ = _agree(got, want, tol)
        print(f"rg_lru feature sample {(B, S, W)} {dtype}: max_abs_err "
              f"{err:.3e} (tol {tol})", flush=True)
        if not ok:
            raise AssertionError(f"rg_lru disagrees at {(B, S, W)}")
    la, b, h0 = registry.get("rg_lru").sample(device, gen)
    first, again = rg_lru_scan(la, b, h0), rg_lru_scan(la, b, h0)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("rg_lru is not bitwise repeatable at the "
                             "served shape")
    print(f"rg_lru at the served shape {tuple(b.shape)}: repeat bitwise "
          f"identical", flush=True)
    del la, b, h0, first, again
    phase_rg_lru_resources()
    phase_mlstm_features(device, gen)
    torch.cuda.synchronize()
    return mla_rows, gqa_row


def _flash_check(q, k, v, kw, tol, label):
    """Flash attention on q, k and v against ``chunked_attention`` within
    ``tol``, with a bitwise repeat, through the route of q's dtype (two
    launches of its entry); returns the largest absolute and relative
    errors."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import (ROUTES,
                                                     chunked_attention,
                                                     flash_attention)
    spec = registry.get("flash_attention")
    route = ROUTES[q.dtype]
    before = spec.entry_launches.get(route, 0)
    got = flash_attention(q, k, v, **kw)
    ok, err, rel = _agree(got.float(),
                          chunked_attention(q, k, v, **kw).float(), tol)
    again = flash_attention(q, k, v, **kw)
    print(f"flash_attention {label} {q.dtype} ({route}) q "
          f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}: "
          f"max_abs_err {err:.3e} (tol {tol}); repeat bitwise "
          f"{torch.equal(got, again)}", flush=True)
    if not ok or got.shape[-1] != v.shape[-1]:
        raise AssertionError(f"flash_attention disagrees at {label}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention is not bitwise "
                             f"repeatable at {label} in {q.dtype}")
    if spec.entry_launches.get(route, 0) != before + 2:
        raise AssertionError(f"{q.dtype} did not take {route}")
    return err, rel


def phase_gqa(device, card, gen) -> dict:
    """Row 12c: flash attention at ``GQA_CASE``, llama3.2-3b's dense GQA
    prefill, against ``chunked_attention`` within the spec's bf16 sample
    tolerance with a bitwise repeat, on the TMA loader; timed (events and
    device) beside its bound, the plain version and
    ``scaled_dot_product_attention(q, k, v, is_causal=True,
    enable_gqa=True)`` with no mask tensor: as PyTorch dispatches it (its
    device time by CUDA kernel names the backend) and with the flash
    backend forced (``sdpa_kernel``).  Both yardsticks must agree with the
    plain version."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as flash_ops
    spec = registry.get("flash_attention")
    name, B, H, Hkv, S, D = GQA_CASE
    cfg = get_config(name)
    if (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) != (H, Hkv, D):
        raise AssertionError(f"{name}: GQA_CASE is not its attention")
    q, k, v = (torch.randn(sh, device=device, generator=gen).to(
        torch.bfloat16) for sh in ((B, H, S, D), (B, Hkv, S, D),
                                   (B, Hkv, S, D)))
    kw = {"causal": True}
    args = (q, k, v, kw, None)
    flash_ops.reset_loaders()
    err, rel = _flash_check(q, k, v, kw, spec.sample_tol, f"12c {name}")
    if flash_ops.loader_launches != {"tma": 2, "threads": 0}:
        raise AssertionError(f"12c took the loaders "
                             f"{flash_ops.loader_launches}")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    def sdpa_flash():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return sdpa()
    want = spec.plain(*args).float()
    for label, fn in (("dispatched", sdpa), ("flash backend", sdpa_flash)):
        ok, lib_err, _ = _agree(fn().float(), want, spec.sample_tol)
        if not ok:
            raise AssertionError(f"SDPA ({label}) computes another function "
                                 f"at 12c ({lib_err})")
    bound, bound_by = spec.bound_ms(*args)
    lib_dev, lib_split = device_ms(sdpa, ())
    row = {"arch": name, "shape": {"q": list(q.shape), "k": list(k.shape),
                                   "v": list(v.shape)},
           "max_abs_err": err, "max_rel_err": rel, "tol": spec.sample_tol,
           "ms": time_ms(spec.kernel, args),
           "device_ms": device_ms(spec.kernel, args)[0],
           "plain_ms": time_ms(spec.plain, args),
           "library_ms": time_ms(sdpa, ()), "library_device_ms": lib_dev,
           "library_kernels": sorted(lib_split),
           "library_flash_ms": time_ms(sdpa_flash, ()),
           "library_flash_device_ms": device_ms(sdpa_flash, ())[0],
           "bound_ms": bound, "bound_by": bound_by,
           "flops": spec.flops(*args), "mb": spec.nbytes(*args) / 1e6}
    print(f"kernel flash_attention 12c {name} {row['shape']}: kernel "
          f"{row['ms']:.4f} ms (device {row['device_ms']}), plain "
          f"{row['plain_ms']:.4f} ms, SDPA is_causal as dispatched "
          f"{row['library_ms']:.4f} ms (device {lib_dev}; "
          f"{row['library_kernels']}), SDPA flash backend "
          f"{row['library_flash_ms']:.4f} ms (device "
          f"{row['library_flash_device_ms']}), bound {bound:.4f} ms "
          f"({bound_by}, {row['flops']:.3e} flops, {row['mb']:.1f} MB) "
          f"[{card}]", flush=True)
    del q, k, v, args, want
    return row


def phase_mla(device, card, gen) -> list[dict]:
    """Flash attention with v's head dim apart from k's: the float32
    ``DV_CASES`` within their tolerance on the CUDA-core route and in bf16
    within ``BF16_FEATURE_TOL`` on the tensor cores, then the two MLA
    prefills (``MLA_CASES``, bf16, causal) within the spec's bf16 sample
    tolerance, each route with a bitwise repeat; each MLA shape timed
    (events and device) beside its bound and PyTorch's
    ``scaled_dot_product_attention`` on the same causal mask."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import DV_CASES, MLA_CASES
    spec = registry.get("flash_attention")
    for B, Hq, Hkv, S, T, D, Dv, dtype, kw, tol in DV_CASES:
        x = [torch.randn(sh, device=device, generator=gen)
             for sh in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv))]
        for dt, tl in ((dtype, tol), (torch.bfloat16, BF16_FEATURE_TOL)):
            _flash_check(*(t.to(dt) for t in x), kw, tl, f"Dv case {kw}")
    rows = []
    kw = {"causal": True}
    for name, B, H, S, D, Dv in MLA_CASES:
        q, k, v = (torch.randn(sh, device=device, generator=gen).to(
            torch.bfloat16) for sh in ((B, H, S, D), (B, H, S, D),
                                       (B, H, S, Dv)))
        pos = torch.arange(S, device=device)
        mask = pos[None, :] <= pos[:, None]
        args = (q, k, v, kw, mask)
        err, rel = _flash_check(q, k, v, kw, spec.sample_tol,
                                f"MLA {name}")
        lib_ok, lib_err, _ = _agree(spec.library(*args).float(),
                                    spec.plain(*args).float(),
                                    spec.sample_tol)
        if not lib_ok:
            raise AssertionError(f"the SDPA yardstick computes another "
                                 f"function at {name} ({lib_err})")
        bound, bound_by = spec.bound_ms(*args)
        row = {"arch": name, "shape": {"q": list(q.shape),
                                       "v": list(v.shape)},
               "max_abs_err": err, "max_rel_err": rel,
               "tol": spec.sample_tol, "ms": time_ms(spec.kernel, args),
               "device_ms": device_ms(spec.kernel, args)[0],
               "plain_ms": time_ms(spec.plain, args),
               "library_ms": time_ms(spec.library, args),
               "library_device_ms": device_ms(spec.library, args)[0],
               "bound_ms": bound, "bound_by": bound_by,
               "flops": spec.flops(*args), "mb": spec.nbytes(*args) / 1e6}
        rows.append(row)
        print(f"kernel flash_attention MLA {name} {row['shape']}: kernel "
              f"{row['ms']:.4f} ms (device {row['device_ms']}), plain "
              f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms "
              f"(device {row['library_device_ms']}), bound {bound:.4f} ms "
              f"({bound_by}, {row['flops']:.3e} flops, {row['mb']:.1f} MB) "
              f"[{card}]", flush=True)
        del q, k, v, args, mask
    return rows


def phase_rg_lru_resources() -> None:
    """The one-pass scan's four instances (float32 and bf16, each on TMA
    and on its threads' loader): registers and spills from the build's
    log, and a block's dynamic shared memory (its tile); a spill fails
    the run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rg_lru.ops import tile_bytes
    names = {"rg_lru_kernelIfLb1E": "float32 tma",
             "rg_lru_kernelIfLb0E": "float32 threads",
             "rg_lru_kernelI13__nv_bfloat16Lb1E": "bf16 tma",
             "rg_lru_kernelI13__nv_bfloat16Lb0E": "bf16 threads"}
    res = ptxas_resources(_build.library_path().with_suffix(".log")
                          .read_text(), tuple(names))
    res = {names[k]: dict(v, smem_bytes=tile_bytes()) for k, v in
           res.items()}
    print(f"rg_lru_kernel instances: {res}", flush=True)
    if len(res) != len(names) or any(r.get("spill_bytes", 0) or
                                     "registers" not in r
                                     for r in res.values()):
        raise AssertionError(f"rg_lru_kernel: an instance is missing from "
                             f"the build log or spills: {res}")


def phase_mlstm_features(device, gen) -> None:
    """``mlstm`` against ``mlstm_chunkwise`` at the served shape from a
    zero and from a nonzero state, and at every feature case (zero and
    nonzero state, a ragged S) in float32 and in bf16, within its
    tolerance, each through the route of its dtype, with a bitwise
    repeat."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.mlstm import (FEATURE_CASES, gated_inputs,
                                           mlstm_chunkwise, mlstm_scan)
    from repro_torch.kernels.mlstm.ops import (ROUTES, scratch_bytes,
                                               wgmma_smem_bytes)
    spec = registry.get("mlstm")
    tol = spec.tol
    served = (1, registry.XLSTM_HEADS, registry.XLSTM_SEQ,
              registry.XLSTM_HEAD_DIM, registry.XLSTM_HEAD_DIM)
    cases = [(spec.sample(device, gen), 128, "served shape"),
             (gated_inputs(*served, nonzero_state=True, dtype=torch.bfloat16,
                           device=device, generator=gen), 128,
              "served shape nonzero state")]
    for B, H, S, dk, dv, chunk, nonzero in FEATURE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = gated_inputs(B, H, S, dk, dv, nonzero_state=nonzero,
                                dtype=dtype, device=device, generator=gen)
            cases.append((args, chunk, f"feature sample {(B, H, S, dk, dv)}"
                          f" chunk {chunk}"
                          f"{' nonzero state' if nonzero else ''} {dtype}"))
    print(f"mlstm scratch at the served shape {served}: "
          f"{scratch_bytes(*served)} bytes", flush=True)
    # the bf16 route's two wgmma kernels: registers, spills and wgmma
    # serialisation from the build's log, dynamic shared memory from the
    # library
    from repro_torch.kernels import _build
    walk_smem, out_smem = wgmma_smem_bytes(registry.XLSTM_HEAD_DIM)
    res = ptxas_resources(_build.library_path().with_suffix(".log")
                          .read_text(), ("mlstm_state_walk_wgmma_kernel",
                                         "mlstm_chunk_out_wgmma_kernel"))
    res["mlstm_state_walk_wgmma_kernel"]["smem_bytes"] = walk_smem
    res["mlstm_chunk_out_wgmma_kernel"]["smem_bytes"] = out_smem
    print(f"mlstm_bf16 kernels at dk {registry.XLSTM_HEAD_DIM}: {res}",
          flush=True)
    for args, chunk, label in cases:
        route = ROUTES[args[0].dtype]
        before = spec.entry_launches.get(route, 0)
        h, state = mlstm_scan(*args, chunk=chunk)
        if spec.entry_launches.get(route, 0) != before + 1:
            raise AssertionError(f"mlstm at the {label} did not take "
                                 f"{route}")
        h2, state2 = mlstm_scan(*args, chunk=chunk)
        want_h, want_state = mlstm_chunkwise(*args, chunk=chunk)
        got = tuple(x.float() for x in (h, *state))
        ok, err, _ = _agree(got, tuple(x.float() for x in (want_h,
                                                            *want_state)),
                            tol)
        bitwise = all(torch.equal(a, b) for a, b in zip((h, *state),
                                                        (h2, *state2)))
        print(f"mlstm {label} ({route}): max_abs_err {err:.3e} (tol "
              f"{tol}); repeat bitwise identical: {bitwise}", flush=True)
        if not ok:
            raise AssertionError(f"mlstm disagrees at the {label}")
        if not bitwise:
            raise AssertionError(f"mlstm is not bitwise repeatable at the "
                                 f"{label}")


def expected_launches(cg_log, frames, newton,
                      collective=False) -> dict[str, int]:
    """Launches of each kernel implied by the CG iterations that ran, on
    one rank (the same on every rank of a group).

    Per CG iteration: DG_fused (1 coil_lincomb, 1 plane_mult), DGH_fused
    (2 plane_mult, 1 coil_adjoint, 1 coil_forward, and, with a
    ``collective`` channel sum, 1 masked_sum), 2 cg_update and 2 xpby (one
    per leaf).  Per Newton step outside CG: G_fused (1 coil_scale_mult, 1
    plane_mult) and the rhs DGH_fused (2 plane_mult, 1 coil_adjoint, 1
    coil_forward, 1 masked_sum with ``collective``).  Per frame: y masked
    once.  A group without a process group sums no channels across
    ranks, so it launches no masked_sum.

    A batched frame (a serving tick: ``frames`` counts ticks) launches
    each kernel once for all its rows, and its CG loop runs until every
    row has stopped: a solve logged as a tuple of row counts runs
    max(counts) iterations of launches."""
    steps = len(cg_log)
    if steps != frames * newton:
        raise AssertionError(f"{steps} CG solves logged, expected "
                             f"{frames * newton}")
    it = sum(max(c) if isinstance(c, tuple) else c for c in cg_log)
    want = {"coil_forward": it + steps, "coil_lincomb": it,
            "coil_scale_mult": steps,
            "plane_mult": 3 * it + 3 * steps + frames,
            "coil_adjoint": it + steps, "cg_update": 2 * it, "xpby": 2 * it}
    if collective:
        want["masked_sum"] = it + steps
    return want


def nrmse(img, truth, fov) -> float:
    import numpy as np
    m = np.asarray(fov) > 0
    a = np.abs(np.asarray(img))[m]
    b = np.abs(np.asarray(truth))[m]
    a = a / max(a.max(), 1e-9)
    b = b / max(b.max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def fft_plan_lookup_us(device, grid) -> float:
    """Host time of one ``plan_fft2`` lookup of the frame's FFT geometry
    that hits the cache: the mean over ``PLAN_LOOKUPS`` lookups timed
    with ``time.perf_counter``.  It launches nothing."""
    import torch
    from repro_torch.lib.fft import plan_fft2
    shape = (NCOILS, grid, grid)
    plan_fft2(shape, torch.complex64, device=device, centered=True)
    t0 = time.perf_counter()
    for _ in range(PLAN_LOOKUPS):
        plan_fft2(shape, torch.complex64, device=device, centered=True)
    return (time.perf_counter() - t0) * 1e6 / PLAN_LOOKUPS


def phase_main_path(device, card, data) -> tuple[dict[str, int], dict]:
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.gridding import gridding_recon
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    g = data["grid"]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    stream = FrameStream(rec, damping=DAMPING)
    registry.reset_launches()
    movie, report = stream.run(data["y"], data["masks"], data["fov"])
    torch.cuda.synchronize()
    counts = registry.launches()
    if tuple(movie.shape) != (FRAMES, g, g):
        raise AssertionError(f"movie shape {tuple(movie.shape)}")
    if not bool(torch.isfinite(movie).all()):
        raise AssertionError("main path produced non-finite images")
    want = expected_launches(rec.cg_log, FRAMES, NEWTON)
    frame_counts = {k: counts[k] for k in want}
    if frame_counts != want:
        raise AssertionError(f"launch counts {frame_counts} != expected "
                             f"{want}")
    missing = [k for k, v in frame_counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    stray = {k: v for k, v in counts.items() if k not in want and v}
    if stray:
        raise AssertionError(f"the frame launched other kernels: {stray}")
    s = report.summary()
    pc = s.get("plan_cache")
    if (pc is None or pc["steady_builds"] != 0
            or len(pc["frame_builds"]) != FRAMES):
        raise AssertionError(f"plan cache report: {pc}")
    e_nlinv = [nrmse(movie[f].cpu().numpy(), data["rho"][f], data["fov"])
               for f in range(FRAMES)]
    fov_d = rec.put_const(data["fov"])
    e_grid = [nrmse(gridding_recon(rec.put_frame(data["y"][f]),
                                   rec.put_const(data["masks"][f]),
                                   fov_d).cpu().numpy(),
                    data["rho"][f], data["fov"]) for f in range(FRAMES)]
    print(f"main path: n={N} grid={g} J={NCOILS} spokes={SPOKES} "
          f"frames={FRAMES} newton={NEWTON} cg={CG_ITERS}: cg iterations "
          f"{rec.cg_log}", flush=True)
    print(f"main path latency: first frame {s['first_frame_ms']:.3f} ms, "
          f"steady {s['mean_ms']:.3f} ms/frame (p50 {s['p50_ms']:.3f}, "
          f"p95 {s['p95_ms']:.3f}), {s['fps']:.3f} fps, frame_ms "
          f"{s['frame_ms']}; NRMSE nlinv {[round(e, 4) for e in e_nlinv]} "
          f"gridding {[round(e, 4) for e in e_grid]} [{card}]", flush=True)
    print(f"main path launches: {json.dumps(frame_counts)}", flush=True)
    print(f"main path plan cache: {json.dumps(pc)}", flush=True)
    lookup_us = fft_plan_lookup_us(device, g)
    per_frame = pc["hits"] / FRAMES
    print(f"fft2 plan lookup: {lookup_us:.3f} us of host time (mean of "
          f"{PLAN_LOOKUPS} cache hits); the frames made {per_frame:.2f} "
          f"lookups each, {lookup_us * per_frame / 1e3:.4f} ms of host time "
          f"a frame [{card}]", flush=True)
    return frame_counts, {"nrmse": e_nlinv, "frame_ms": s["frame_ms"],
                          "frame0": movie[0].clone(), "movie": movie}


def _solve(device, data, frame, *, newton, cg_iters, impl="auto",
           comm=None, **schedule):
    import torch
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    rec = Reconstructor(comm, device=device, newton=newton,
                        cg_iters=cg_iters, impl=impl, **schedule)
    J, g = data["y"].shape[1], data["grid"]
    u0 = rec.init_carry(J, g)
    x_ref = {k: v.clone() for k, v in u0.items()}
    u, img = rec(rec.put_frame(data["y"][frame]),
                 rec.put_const(data["masks"][frame]),
                 rec.put_const(data["fov"]), rec.put_const(sobolev_weight(g)),
                 u0, x_ref)
    torch.cuda.synchronize()
    return u, img


def phase_parity(device, card, data) -> None:
    import torch
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.gridding import gridding_recon
    kw = dict(newton=SHALLOW_NEWTON, cg_iters=SHALLOW_CG)
    u_k, img_k = _solve(device, data, 0, **kw)
    _, img_p = _solve(device, data, 0, impl="plain", **kw)
    u_k2, img_k2 = _solve(device, data, 0, **kw)
    rel = float(torch.linalg.vector_norm(img_k - img_p) /
                torch.linalg.vector_norm(img_p))
    bitwise = torch.equal(img_k, img_k2) and all(
        torch.equal(u_k[k], u_k2[k]) for k in u_k)
    print(f"kernel vs plain path (newton {SHALLOW_NEWTON}, cg {SHALLOW_CG}, "
          f"grid {data['grid']}): image relative L2 {rel:.3e} "
          f"(limit {PATH_TOL}); repeat bitwise identical: {bitwise} "
          f"[{card}]", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"kernel path drifts from plain path: {rel}")
    if not bitwise:
        raise AssertionError("kernel path is not bitwise repeatable")

    small = phantom.make_dataset(n=32, ncoils=4, nspokes=9, frames=1, seed=1)
    _, img = _solve(device, small, 0, newton=8, cg_iters=30)
    e_nlinv = nrmse(img.cpu().numpy(), small["rho"][0], small["fov"])
    grid_img = gridding_recon(
        torch.as_tensor(small["y"][0], device=device),
        torch.as_tensor(small["masks"][0], dtype=torch.float32,
                        device=device),
        torch.as_tensor(small["fov"], device=device))
    e_grid = nrmse(grid_img.cpu().numpy(), small["rho"][0], small["fov"])
    print(f"small-input quality (n=32, J=4, 9 spokes, newton 8): NRMSE "
          f"nlinv {e_nlinv:.4f}, gridding {e_grid:.4f}", flush=True)
    if not (e_nlinv < 0.12 and e_nlinv < 0.6 * e_grid):
        raise AssertionError(f"NLINV quality check failed: {e_nlinv} vs "
                             f"gridding {e_grid}")


def _rel_l2(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def phase_radial(device, card, data) -> tuple[dict[str, int], dict]:
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.gridding import degrid, grid_adjoint
    from repro_torch.lib.plan import default_cache
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.gridding import (gridding_recon,
                                            gridding_recon_radial,
                                            radial_ops)
    g = data["grid"]
    cache = default_cache()
    coils = torch.as_tensor(data["coils"], device=device)
    fov = torch.as_tensor(data["fov"], device=device)
    rho = [torch.as_tensor(data["rho"][f], device=device)
           for f in range(FRAMES)]
    torch.cuda.synchronize()

    build_ms, recon_ms, images, samples, plan_misses = [], [], [], [], []
    registry.reset_launches()
    first = cache.snapshot()
    for f in range(FRAMES):
        t0 = time.perf_counter()
        misses0 = cache.misses
        ops = radial_ops(g, SPOKES, frame=f, device=device)
        build_ms.append((time.perf_counter() - t0) * 1e3)
        plan_misses.append(cache.misses - misses0)
        y = ops.forward(rho[f][None] * coils)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = gridding_recon_radial(y, g, SPOKES, fov, frame=f,
                                    device=device)
        end.record()
        end.synchronize()
        recon_ms.append(start.elapsed_time(end))
        images.append(img)
        samples.append(y)
    counts = registry.launches()
    d_first = cache.delta(first)
    second = cache.snapshot()
    lookup_ms = []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        radial_ops(g, SPOKES, frame=f, device=device)
        lookup_ms.append((time.perf_counter() - t0) * 1e3)
    d_second = cache.delta(second)

    want = {k: 0 for k in counts}
    want.update(degrid=FRAMES, grid_adjoint=FRAMES)
    if counts != want:
        raise AssertionError(f"radial launch counts {counts} != {want}")
    if plan_misses != [1] * FRAMES:
        raise AssertionError(f"first radial pass: plan misses per frame "
                             f"{plan_misses}, expected one each")
    if d_second["hits"] != FRAMES or d_second["builds"] != 0 \
            or d_second["misses"] != 0:
        raise AssertionError(f"second radial pass: {d_second}, expected "
                             f"{FRAMES} hits and 0 builds")
    for img in images:
        if tuple(img.shape) != (g, g) or not bool(torch.isfinite(img).all()):
            raise AssertionError("radial recon produced a bad image")
    plan = radial_ops(g, SPOKES, frame=0, device=device).plan
    print(f"radial path: grid={g} J={NCOILS} spokes={SPOKES} samples "
          f"{plan.nsamp} (padded {plan.nsamp_padded}) frames={FRAMES}: plan "
          f"build ms {[round(t, 3) for t in build_ms]} (host), recon ms "
          f"{[round(t, 4) for t in recon_ms]} (CUDA events), second-pass "
          f"lookup ms {[round(t, 4) for t in lookup_ms]}; plan device bytes "
          f"{plan.device_bytes()} [{card}]", flush=True)
    print(f"radial plan cache: radial_ops misses per frame {plan_misses}; "
          f"first pass {json.dumps(d_first)}; second "
          f"pass {json.dumps(d_second)}", flush=True)
    print(f"radial launches: {json.dumps(counts)}", flush=True)

    # kernel path against plain path, frame 0
    ops_p = radial_ops(g, SPOKES, frame=0, device=device, impl="plain")
    y_p = ops_p.forward(rho[0][None] * coils)
    img_p = gridding_recon_radial(y_p, g, SPOKES, fov, frame=0,
                                  device=device, impl="plain")
    rel = _rel_l2(images[0], img_p)
    rel_y = _rel_l2(samples[0], y_p)
    # grid_adjoint repeats bit for bit
    k1 = grid_adjoint(samples[0], plan.interp)
    k2 = grid_adjoint(samples[0], plan.interp)
    bitwise = torch.equal(k1, k2)
    # adjoint dot test on the card
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    gg = torch.randn((NCOILS, g, g), dtype=torch.complex64, device=device,
                     generator=gen)
    yy = torch.randn((NCOILS, plan.nsamp_padded), dtype=torch.complex64,
                     device=device, generator=gen)
    lhs = complex(torch.vdot(degrid(gg, plan.interp).reshape(-1),
                             yy.reshape(-1)))
    rhs = complex(torch.vdot(gg.reshape(-1),
                             grid_adjoint(yy, plan.interp).reshape(-1)))
    dot_rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    torch.cuda.synchronize()
    print(f"radial kernel vs plain path (frame 0): image relative L2 "
          f"{rel:.3e}, samples relative L2 {rel_y:.3e} (limit {PATH_TOL}); "
          f"grid_adjoint repeat bitwise identical: {bitwise}; adjoint dot "
          f"test relative error {dot_rel:.3e} (limit 1e-3) [{card}]",
          flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"radial kernel path drifts from plain: {rel}")
    if not bitwise:
        raise AssertionError("grid_adjoint is not bitwise repeatable")
    if not dot_rel <= 1e-3:
        raise AssertionError(f"adjoint dot test failed: {lhs} vs {rhs}")

    e_rad = [nrmse(images[f].cpu().numpy(), data["rho"][f], data["fov"])
             for f in range(FRAMES)]
    e_cart = [nrmse(gridding_recon(
        torch.as_tensor(data["y"][f], device=device),
        torch.as_tensor(data["masks"][f], dtype=torch.float32,
                        device=device), fov).cpu().numpy(),
        data["rho"][f], data["fov"]) for f in range(FRAMES)]
    print(f"full-width NRMSE in the FOV: radial gridding "
          f"{[round(e, 4) for e in e_rad]}, Cartesian gridding "
          f"{[round(e, 4) for e in e_cart]}", flush=True)

    small = phantom.make_dataset(n=32, ncoils=4, nspokes=13, frames=1,
                                 seed=5)
    ops_s = radial_ops(small["grid"], 13, device=device)
    y_s = ops_s.forward(torch.as_tensor(small["rho"][0][None] *
                                        small["coils"], device=device))
    img_s = ops_s.recon(y_s, torch.as_tensor(small["fov"], device=device))
    e_small = nrmse(img_s.cpu().numpy(), small["rho"][0], small["fov"])
    print(f"small-input radial quality (n=32, J=4, 13 spokes, seed 5): "
          f"NRMSE {e_small:.4f} (limit 0.35)", flush=True)
    if not (e_small < 0.35 and np.isfinite(img_s.cpu().numpy()).all()):
        raise AssertionError(f"radial quality check failed: {e_small}")
    frame0 = {"coil_imgs": (rho[0][None] * coils).cpu().numpy(),
              "samples": samples[0].cpu().numpy(),
              "image": images[0].cpu().numpy()}
    return {k: counts[k] for k in ("degrid", "grid_adjoint")}, frame0


def _timed(fn, times: list, launches: list, logits: list | None = None):
    """``fn`` with each call's CUDA-event time appended to ``times``, the
    launch counters' movement during the call to ``launches``, and a copy
    of its logits to ``logits``."""
    import torch
    from repro_torch.kernels import registry

    def call(*args, **kwargs):
        before = registry.launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        after = registry.launches()
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
        if logits is not None:
            logits.append(out[0][0].float().clone())
        return out
    return call


def _paths(plain: bool):
    """The kernel path, or every kernel's plain version (``plain``)."""
    import contextlib
    from repro_torch.kernels import registry
    return registry.plain() if plain else contextlib.nullcontext()


def _serve(cfg, params, prompts, max_new, device, plain: bool):
    """The requests through one Engine; returns (outputs in rid order,
    prefill ms, prefill launches, decode ms, decode launches, prefill
    logits, wall seconds)."""
    import torch
    from repro_torch.serve import Engine
    eng = Engine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN,
                 device=device)
    wl = eng.workload
    pf_ms, pf_launch, dec_ms, dec_launch, logits = [], [], [], [], []
    wl._prefill = _timed(wl._prefill, pf_ms, pf_launch, logits)
    wl._decode = _timed(wl._decode, dec_ms, dec_launch)
    t0 = time.perf_counter()
    with _paths(plain):
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new=m)
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [r.out for r in sorted(done, key=lambda r: r.rid)]
    return outs, pf_ms, pf_launch, dec_ms, dec_launch, logits, wall


def _prefill_logits(cfg, params, prompts, device, plain: bool) -> list:
    """Last-token logits of one prefill of each prompt (with the frontend
    embeddings that ``Engine`` hands a cross-attention arch)."""
    import torch
    from repro_torch.models import frontends
    from repro_torch.serve import make_serve_steps
    prefill, _, init_cache = make_serve_steps(
        cfg, max_len=LM_MAX_LEN, batch=1, device=device)
    enc = frontends.synthetic_frontend(cfg, 1, device=device)
    out = []
    with _paths(plain):
        for p in prompts:
            tok = torch.tensor([p], dtype=torch.int64, device=device)
            logits, _ = prefill(params, tok, init_cache(), enc=enc)
            out.append(logits[0].float().clone())
    return out


def _free_card() -> None:
    """Collect what the last model left (an Engine's cycles hold its
    caches) and return the allocator's cache to the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _slstm_share(cfg, params, prompt, device) -> tuple[list, float]:
    """One kernel-path prefill of ``prompt`` with CUDA events around it and
    around each sLSTM layer (forward hooks): (ms of each sLSTM layer, ms
    of the prefill).  The sLSTM loop keeps the card idle between its
    small launches, so its events measure the host's loop."""
    import torch
    from repro_torch.serve import make_serve_steps
    layers = [m for m in params.layers if m.kind == "slstm"]
    if not layers:
        return [], 0.0
    marks = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    hooks = [h for m in layers for h in (m.register_forward_pre_hook(mark),
                                         m.register_forward_hook(mark))]
    prefill, _, init_cache = make_serve_steps(
        cfg, max_len=LM_MAX_LEN, batch=1, device=device)
    tok = torch.tensor([prompt], dtype=torch.int64, device=device)
    cache = init_cache()
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prefill(params, tok, cache)
        end.record()
        end.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return ([a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])],
            start.elapsed_time(end))


def _open_gates(cfg, params) -> None:
    """Set every cross-attention ``gate`` (an ``attn`` or ``xattn`` block's
    scalar, not a gated MLP's ``gate`` weight) of ``params`` to
    ``CROSS_GATE``; raises if an arch with an encoder has none."""
    import torch
    gates = [p for name, p in params.named_parameters()
             if name.split(".")[-2:] in (["attn", "gate"], ["xattn", "gate"])]
    if cfg.encoder_seq and not gates:
        raise AssertionError(f"{cfg.name}: no cross-attention gate")
    with torch.no_grad():
        for g in gates:
            g.fill_(CROSS_GATE)


def phase_lm(device, card, arch, prompts_len, max_new,
             f32_depth=None) -> dict[str, int]:
    """Serve ``arch`` at its published widths and depth through Engine;
    the LM phase (6) for recurrentgemma-2b, the xLSTM phase (7) and each
    arch of phase 11.  The float32 agreement runs on the served weights,
    or, with ``f32_depth``, on a model of the same widths and that depth
    (and at most ``CONFIG_F32_ENCODER`` encoder layers) seeded alike."""
    import collections
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ROUTES as ATTN_ROUTES
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm.ops import ROUTES as MLSTM_ROUTES
    from repro_torch.models import transformer
    # the kernels with a route per dtype: bf16 prefills take the tensor
    # cores, float32 ones the CUDA cores
    routed = {"flash_attention": ATTN_ROUTES, "mlstm": MLSTM_ROUTES}
    cfg = get_config(arch)
    kinds = [k for k, _ in transformer.unrolled_sigs(cfg)]
    per_prefill = dict(collections.Counter(KIND_KERNEL[k] for k in kinds
                                           if k in KIND_KERNEL))
    tag = {LM_ARCH: "lm", XLSTM_ARCH: "xlstm"}.get(arch, arch)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _open_gates(cfg, params)
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    heads = (f"{cfg.n_heads} heads on {cfg.n_kv_heads} kv of dim {cfg.hd}"
             if any(k in ATTN for k in kinds) else
             f"{cfg.rnn_heads} mLSTM heads of dim "
             f"{int(cfg.d_model * cfg.proj_factor) // cfg.rnn_heads}")
    if "mla" in kinds:
        heads = (f"{cfg.n_heads} MLA heads (qk {cfg.qk_nope_dim} + "
                 f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}, kv_lora "
                 f"{cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank})")
    extra = ""
    if cfg.n_experts:
        extra += (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
                  f"{cfg.moe_d_ff} (+{cfg.n_shared_experts} shared; the "
                  f"first {cfg.first_dense} dense)")
    if cfg.encoder_seq:
        extra += (f", {cfg.cross_kind} cross-attention on "
                  f"{cfg.encoder_seq} frontend tokens, "
                  f"{cfg.encoder_layers} encoder layers")
    print(f"{tag}: {arch} {cfg.n_layers} layers "
          f"({dict(collections.Counter(kinds))}), d_model {cfg.d_model}, "
          f"{heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"window {cfg.window}{extra}, {cfg.compute_dtype}: {n_params} "
          f"parameters, {n_bytes / 1e9:.3f} GB on the card ("
          f"{held / 1e9:.3f} GB held before), random init "
          f"{init_s:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in prompts_len]
    # warm-up (cuBLAS, the allocator, module loading), outside the count
    t0 = time.perf_counter()
    _prefill_logits(cfg, params, prompts[:1], device, plain=False)
    torch.cuda.synchronize()
    print(f"{tag} warm-up prefill ({prompts_len[0]} tokens): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms of host time",
          flush=True)

    registry.reset_launches()
    flash_ops.reset_loaders()
    outs, pf_ms, pf_launch, dec_ms, dec_launch, logits, wall = _serve(
        cfg, params, prompts, max_new, device, plain=False)
    counts = registry.launches()
    # every bf16 prefill's flash attention on the TMA loader
    loaders = dict(flash_ops.loader_launches)
    if loaders != {"tma": counts["flash_attention"], "threads": 0}:
        raise AssertionError(f"{tag}: flash attention's loaders {loaders} "
                             f"for {counts['flash_attention']} launches")
    if counts["flash_attention"]:
        print(f"{tag} flash attention loaders: {loaders}", flush=True)
    want = {k: 0 for k in counts}
    want.update({k: v * len(prompts) for k, v in per_prefill.items()})
    if counts != want:
        raise AssertionError(f"{tag} launch counts {counts} != {want}")
    if any(d != per_prefill for d in pf_launch):
        raise AssertionError(f"launches per prefill {pf_launch}")
    if any(dec_launch):
        raise AssertionError(f"decode steps launched kernels: {dec_launch}")
    for name, routes in routed.items():
        taken = dict(registry.get(name).entry_launches)
        if name in per_prefill and \
                taken != {routes[torch.bfloat16]: counts[name]}:
            raise AssertionError(f"bf16 prefills took the routes {taken}")
    if [len(o) for o in outs] != list(max_new):
        raise AssertionError(f"output lengths {[len(o) for o in outs]} != "
                             f"{list(max_new)}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(device).total_memory
    print(f"{tag} peak memory (torch.cuda.max_memory_allocated, init and "
          f"the kernel path's serving): {peak / 1e9:.3f} GB of the card's "
          f"{total / 1e9:.3f} GB [{card}]", flush=True)
    if peak >= total:
        raise AssertionError(f"{tag} does not fit on the card")
    for lg in logits:
        if lg.shape != (cfg.vocab,) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("prefill logits are not finite")
    n_tok = len(dec_ms)
    print(f"{tag} serve (kernel path): {len(prompts)} requests, prompts "
          f"{list(prompts_len)}, max_new {list(max_new)}, batch "
          f"{LM_BATCH} slots, max_len {LM_MAX_LEN}; wall {wall:.3f} s "
          f"[{card}]", flush=True)
    print(f"{tag} prefill ms per request (CUDA events): "
          f"{[round(t, 3) for t in pf_ms]} for prompts {list(prompts_len)}; "
          f"decode ms per token: mean {sum(dec_ms) / n_tok:.3f}, p50 "
          f"{sorted(dec_ms)[n_tok // 2]:.3f}, min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f} over {n_tok} steps [{card}]", flush=True)
    print(f"{tag} launches: {json.dumps(counts)}; per prefill "
          f"{json.dumps(pf_launch[0])}; decode steps launched none",
          flush=True)
    slstm_ms, total_ms = _slstm_share(cfg, params, prompts[0], device)
    if slstm_ms:
        print(f"{tag} sLSTM loop in a prefill of {prompts_len[0]} tokens "
              f"(CUDA events): layers {[round(t, 3) for t in slstm_ms]} ms, "
              f"{sum(slstm_ms):.3f} of {total_ms:.3f} ms, share "
              f"{sum(slstm_ms) / total_ms:.4f} [{card}]", flush=True)

    outs_p, pf_ms_p, pf_launch_p, dec_ms_p, _, logits_p, _ = _serve(
        cfg, params, prompts, max_new, device, plain=True)
    if any(pf_launch_p):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{pf_launch_p}")
    print(f"{tag} plain path prefill ms: {[round(t, 3) for t in pf_ms_p]}; "
          f"decode ms per token mean {sum(dec_ms_p) / len(dec_ms_p):.3f} "
          f"[{card}]", flush=True)
    for i, (a, b) in enumerate(zip(outs, outs_p)):
        diff = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        print(f"{tag} request {i} (prompt {prompts_len[i]}): kernel tokens "
              f"{a}, plain tokens {b}, first difference at "
              f"{'none' if diff is None else diff}", flush=True)
    if all(len(set(o)) == 1 for o in outs + outs_p):
        # under this random init greedy decoding can repeat one token for
        # every request: then equal tokens test nothing, and only the
        # float32 and bf16 logits checks below hold the two paths
        print(f"{tag} greedy tokens: every request repeats one token on "
              f"both paths, so their agreement tests nothing here; the "
              f"logits checks below hold the paths", flush=True)

    if f32_depth is not None:
        # the agreement at the full width and a depth that fits in float32:
        # a model of that depth seeded alike, its bf16 logits through
        # both paths
        del params
        _free_card()
        cfg = dataclasses.replace(
            cfg, n_layers=f32_depth,
            encoder_layers=min(cfg.encoder_layers, CONFIG_F32_ENCODER))
        kinds_r = [k for k, _ in transformer.unrolled_sigs(cfg)]
        if set(kinds_r) != set(kinds) or \
                {cfg.ffn_kind(i) for i in range(cfg.n_layers)} != \
                {get_config(arch).ffn_kind(i)
                 for i in range(get_config(arch).n_layers)}:
            raise AssertionError(f"{tag}: depth {f32_depth} drops a layer "
                                 f"kind")
        want = {k: sum(KIND_KERNEL.get(kd) == k for kd in kinds_r)
                * len(prompts) for k in want}
        gen.manual_seed(0)
        params = transformer.init_params(cfg, gen, device=device)
        _open_gates(cfg, params)
        logits = _prefill_logits(cfg, params, prompts, device, plain=False)
        logits_p = _prefill_logits(cfg, params, prompts, device, plain=True)
        print(f"{tag} float32 agreement at depth {cfg.n_layers} "
              f"({dict(collections.Counter(kinds_r))}, "
              f"{cfg.encoder_layers} encoder layers), full width", flush=True)

    # the same weights (the bf16 values) computing in float32: the
    # reference both bf16 paths are measured against, and the comparison
    # that sees the kernels rather than bf16's rounding
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = transformer.Transformer(cfg32, device="meta").to_empty(
        device=device)
    with torch.no_grad():
        for p32, p16 in zip(params32.parameters(), params.parameters()):
            p32.copy_(p16)
    del params
    _free_card()
    before = registry.launches()
    logits32 = _prefill_logits(cfg32, params32, prompts, device, plain=False)
    moved = {k: v - before[k] for k, v in registry.launches().items()
             if v != before[k]}
    if moved != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"float32 prefills launched {moved}")
    for name, routes in routed.items():
        taken = registry.get(name).entry_launches
        if name in per_prefill and \
                taken.get(routes[torch.float32], 0) != want[name]:
            raise AssertionError(f"float32 prefills took the routes {taken}")
    logits32_p = _prefill_logits(cfg32, params32, prompts, device, plain=True)
    rel32 = [_rel_l2(a, b) for a, b in zip(logits32, logits32_p)]
    rel16 = [_rel_l2(a, b) for a, b in zip(logits, logits_p)]
    err_k = [_rel_l2(a, b) for a, b in zip(logits, logits32_p)]
    err_p = [_rel_l2(a, b) for a, b in zip(logits_p, logits32_p)]
    print(f"{tag} float32 kernel vs plain path: last-token logits relative "
          f"L2 {[f'{r:.3e}' for r in rel32]} (limit {LM_PATH_TOL_F32})",
          flush=True)
    print(f"{tag} bf16 kernel vs plain path: {[f'{r:.3e}' for r in rel16]}; "
          f"each bf16 path against the float32 plain path: kernel "
          f"{[f'{r:.3e}' for r in err_k]}, plain "
          f"{[f'{r:.3e}' for r in err_p]} (limit: kernel <= "
          f"{LM_BF16_RATIO} x plain)", flush=True)
    if not all(r <= LM_PATH_TOL_F32 for r in rel32):
        raise AssertionError(f"{tag} kernel path drifts from plain in "
                             f"float32: {rel32}")
    if not all(k <= LM_BF16_RATIO * p for k, p in zip(err_k, err_p)):
        raise AssertionError(f"{tag} bf16 kernel path is further from "
                             f"float32 than the plain path: {err_k} vs "
                             f"{err_p}")
    del params32
    _free_card()
    return {k: counts[k] for k in per_prefill}


def phase_configs(device, card) -> dict[str, int]:
    """Phase 11: the eight configs of ``CONFIG_ARCHS`` served one at a time
    through ``phase_lm``, at full width and depth in bf16, the float32
    agreement at ``CONFIG_F32_DEPTH``; flash attention's launches over the
    phase."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    flash = 0
    for arch in CONFIG_ARCHS:
        kinds = [k for k, _ in transformer.unrolled_sigs(get_config(arch))]
        n = sum(KIND_KERNEL.get(k) == "flash_attention" for k in kinds)
        if n != CONFIG_FLASH[arch]:
            raise AssertionError(f"{arch}: {n} flash attention layers, not "
                                 f"{CONFIG_FLASH[arch]}")
        t1 = time.perf_counter()
        counts = phase_lm(device, card, arch,
                          CONFIG_PROMPTS_OF.get(arch, CONFIG_PROMPTS),
                          CONFIG_MAX_NEW,
                          f32_depth=CONFIG_F32_DEPTH.get(arch, 2))
        if counts != {"flash_attention": n * len(CONFIG_PROMPTS)}:
            raise AssertionError(f"{arch} launches {counts}")
        flash += counts["flash_attention"]
        print(f"{arch}: {time.perf_counter() - t1:.1f} s; card memory "
              f"held after it {torch.cuda.memory_allocated() / 1e9:.3f} GB",
              flush=True)
    want = len(CONFIG_PROMPTS) * sum(CONFIG_FLASH.values())
    if flash != want:
        raise AssertionError(f"phase 11: {flash} flash attention launches, "
                             f"not {want}")
    print(f"phase 11: {len(CONFIG_ARCHS)} configs served in "
          f"{time.perf_counter() - t0:.1f} s; flash_attention launches "
          f"{flash} [{card}]", flush=True)
    return {"flash_attention": flash}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _blas_inputs(comm):
    """Full-width CG-state containers from one numpy seed, the same on
    every rank: x, y, z, w = {rho CLONE (768, 768), chat NATURAL (8, 768,
    768)}, and the scalars."""
    import numpy as np
    from repro_torch.core import Policy
    rng = np.random.default_rng(BLAS_SEED)
    g = 2 * N

    def c(*shape):
        return (rng.standard_normal(shape, np.float32) +
                1j * rng.standard_normal(shape, np.float32)).astype(
                    np.complex64)

    trees = {}
    for name in "xyzw":
        trees[name] = {"rho": comm.container(c(g, g), policy=Policy.CLONE),
                       "chat": comm.container(c(NCOILS, g, g))}
    return trees, 0.37, 0.61


def _blas_check(comm) -> dict:
    """The segmented BLAS on full-width containers against the plain
    computation on the gathered arrays; launches of ``xpby_dot`` (one a
    leaf) counted from 0."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.lib import blas
    trees, a, b = _blas_inputs(comm)
    full = {n: {k: v.gather() for k, v in t.items()}
            for n, t in trees.items()}
    x, y, z, w = (trees[n] for n in "xyzw")
    X, Y, Z, W = (full[n] for n in "xyzw")
    beta = torch.tensor(b, device=comm.device)
    registry.reset_launches()
    wv, d = blas.xpby_dot(x, y, beta)
    x2, r2, rs = blas.cg_update(a, x, y, z, w)
    wa, da = blas.axpy_dot(a, x, y, z)
    dar = blas.dot_allreduce(x["chat"], y["chat"])
    torch.cuda.synchronize()
    counts = registry.launches()

    def vd(u, v):
        return torch.vdot(u.reshape(-1), v.reshape(-1))

    keys = ("chat", "rho")
    want = {
        "xpby_dot": ({k: X[k] + b * Y[k] for k in keys},
                     sum(torch.real(vd(X[k] + b * Y[k], X[k] + b * Y[k]))
                         for k in keys)),
        "cg_update": ({k: Z[k] + a * X[k] for k in keys},
                      {k: W[k] - a * Y[k] for k in keys},
                      sum(torch.real(vd(W[k] - a * Y[k], W[k] - a * Y[k]))
                          for k in keys)),
        "axpy_dot": ({k: a * X[k] + Y[k] for k in keys},
                     sum(vd(Z[k], a * X[k] + Y[k]) for k in keys)),
        "dot_allreduce": (vd(X["chat"], Y["chat"]),)}
    got = {"xpby_dot": (wv, d), "cg_update": (x2, r2, rs),
           "axpy_dot": (wa, da), "dot_allreduce": (dar,)}
    tol = registry.get("xpby_dot").tol
    errs = {}
    for op, outs in got.items():
        pairs = []
        for g_, w_ in zip(outs, want[op]):
            if isinstance(g_, dict):
                pairs += [(g_[k].gather(), w_[k]) for k in keys]
            else:
                pairs.append((g_.reshape(1), torch.as_tensor(
                    w_, device=comm.device).reshape(1)))
        ok, err, rel = _agree(tuple(p[0] for p in pairs),
                              tuple(p[1] for p in pairs), tol)
        errs[op] = (ok, err, rel)
    return {"errs": errs, "launches": counts}


def dist_rank(env, data, shallow_only=False) -> dict:
    """One rank of phase 8: the 4-frame stream at full depth with its
    launch counts, the shallow frame, the segmented BLAS and a
    ``masked_sum`` repeat.  ``shallow_only`` runs frame 0 at full depth
    and nothing else (the 1-rank NCCL run).  Arrays come back as numpy
    (a tensor would reach the parent through a file descriptor that ends
    with the rank)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    comm = env.world
    out = {"rank": comm.rank, "size": comm.size, "backend": comm.backend,
           "transport": comm.group.p2p_transport, "device": str(comm.device)}
    if shallow_only:
        u, img = _solve(comm.device, data, 0, newton=NEWTON,
                        cg_iters=CG_ITERS, comm=comm)
        out.update(img=img.cpu().numpy(), rho=_digest(u["rho"]))
        return out
    rec = Reconstructor(comm, newton=NEWTON, cg_iters=CG_ITERS,
                        channel_sum="crop")
    stream = FrameStream(rec, damping=DAMPING)
    from repro_torch.core.comm import record
    registry.reset_launches()
    with record() as log:
        movie, report = stream.run(data["y"], data["masks"], data["fov"])
    torch.cuda.synchronize()
    out["counts"] = registry.launches()
    out["cg_log"] = list(rec.cg_log)
    # frame 0's collectives: a channel sum and a residual-norm all-reduce
    # a Newton step and a CG iteration, and the readout's all-reduce
    calls = 2 * (NEWTON + sum(rec.cg_log[:NEWTON])) + 1
    out["wire"] = {"crop": list(log[:calls])}
    out["frame_ms"] = report.summary()["frame_ms"]
    out["devices"] = report.summary()["devices"]
    out["rho"] = _digest(stream.last_carry["u"]["rho"])
    out["movie"] = _digest(movie)
    out["movie_np"] = movie.cpu().numpy() if comm.rank == 0 else None
    out["finite"] = bool(torch.isfinite(movie).all())
    out["shape"] = tuple(movie.shape)
    out["nrmse"] = [nrmse(movie[f].cpu().numpy(), data["rho"][f],
                          data["fov"]) for f in range(FRAMES)]
    u, img = _solve(comm.device, data, 0, newton=SHALLOW_NEWTON,
                    cg_iters=SHALLOW_CG, comm=comm)
    out["shallow"] = img.cpu().numpy() if comm.rank == 0 else None
    out["shallow_rho"] = _digest(u["rho"])
    out["shallow_img"] = _digest(img)
    out["blas"] = _blas_check(comm)
    # frame 0 again under the full channel sum, its collectives recorded
    with record() as log:
        _solve(comm.device, data, 0, newton=NEWTON, cg_iters=CG_ITERS,
               comm=comm, channel_sum="full")
    out["wire"]["full"] = list(log)
    spec = registry.get("masked_sum")
    gen = torch.Generator(device=comm.device).manual_seed(11)
    p, m = spec.sample(comm.device, gen)
    first, again = spec.kernel(p, m), spec.kernel(p, m)
    torch.cuda.synchronize()
    out["masked_sum_repeat"] = bool(torch.equal(first, again))
    out["masked_sum_bits"] = _digest(first)
    out["choices"] = registry.choices()
    return out


def phase_multirank(device, card, data,
                    one_rank) -> tuple[dict[str, int], dict]:
    """Phase 8: the multi-rank core on the card (see the module's
    docstring)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import Environment, run_ranks
    from repro_torch.kernels import registry
    frames = {k: data[k] for k in ("y", "masks", "fov", "rho", "grid")}
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_RANKS, backend="gloo",
                      shared_card=True, args=(frames,),
                      timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"multi-rank: {DIST_RANKS} ranks, backend {r0['backend']} "
          f"(p2p {r0['transport']}), every rank on {r0['device']}; "
          f"{wall:.2f} s for the ranks' whole run, start-up included "
          f"[{card}]", flush=True)
    for key in ("cg_log", "rho", "movie", "shallow_rho", "shallow_img",
                "masked_sum_bits", "counts"):
        if any(r[key] != r0[key] for r in ranks[1:]):
            raise AssertionError(f"ranks disagree on {key}: "
                                 f"{[r[key] for r in ranks]}")
    if r0["shape"] != (FRAMES, data["grid"], data["grid"]) or \
            not all(r["finite"] for r in ranks) or r0["devices"] != DIST_RANKS:
        raise AssertionError(f"4-rank movie: shape {r0['shape']}, finite "
                             f"{[r['finite'] for r in ranks]}, devices "
                             f"{r0['devices']}")
    want = expected_launches(r0["cg_log"], FRAMES, NEWTON, collective=True)
    frame_counts = {k: r0["counts"][k] for k in want}
    stray = {k: v for k, v in r0["counts"].items() if k not in want and v}
    if frame_counts != want or stray:
        raise AssertionError(f"4-rank launch counts {r0['counts']} != "
                             f"expected {want}")
    print(f"multi-rank frame: cg iterations {r0['cg_log']} (the same on "
          f"every rank); rho, CG log and movie bitwise equal on all "
          f"{DIST_RANKS} ranks", flush=True)
    print(f"multi-rank launches (each rank): {json.dumps(frame_counts)}",
          flush=True)
    def steady(ms):
        return sum(ms[1:]) / max(len(ms) - 1, 1)

    print(f"multi-rank frame_ms per rank: "
          f"{[r['frame_ms'] for r in ranks]}; steady mean "
          f"{steady(r0['frame_ms']):.3f} ms/frame on 4 ranks against "
          f"{steady(one_rank['frame_ms']):.3f} on 1 rank (phase 3, "
          f"{one_rank['frame_ms']}) [{card}; gloo, host-staged, one shared "
          f"card]", flush=True)
    drift = [abs(a - b) for a, b in zip(r0["nrmse"], one_rank["nrmse"])]
    print(f"multi-rank full depth: NRMSE {[round(e, 5) for e in r0['nrmse']]}"
          f" against 1 rank's {[round(e, 5) for e in one_rank['nrmse']]} "
          f"(difference at most {max(drift):.2e}, limit "
          f"{DEPTH_NRMSE_TOL})", flush=True)
    if max(drift) > DEPTH_NRMSE_TOL:
        raise AssertionError(f"4-rank frames drift from 1 rank: {drift}")
    _, img1 = _solve(device, data, 0, newton=SHALLOW_NEWTON,
                     cg_iters=SHALLOW_CG)
    rel = _rel_l2(torch.from_numpy(r0["shallow"]).to(device), img1)
    print(f"multi-rank vs 1 rank (newton {SHALLOW_NEWTON}, cg {SHALLOW_CG}):"
          f" image relative L2 {rel:.3e} (limit {PATH_TOL})", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"4-rank frame drifts from 1 rank: {rel}")
    if not all(r["masked_sum_repeat"] for r in ranks):
        raise AssertionError("masked_sum is not bitwise repeatable")
    print("masked_sum: bitwise repeatable, the same bits on every rank",
          flush=True)
    blocks = [{k: c["block"] for k, c in r["choices"].items()}
              for r in ranks]
    sources = [sorted({c["source"] for c in r["choices"].values()})
               for r in ranks]
    print(f"multi-rank blocks: rank 0's choices "
          f"{json.dumps(r0['choices'])}; sources by rank {sources}",
          flush=True)
    if any(b != blocks[0] for b in blocks) or "swept" not in sources[0] \
            or any("swept" in s for s in sources[1:]):
        raise AssertionError(f"the ranks hold other blocks than rank 0's "
                             f"sweep: {[r['choices'] for r in ranks]}")
    blas_counts = r0["blas"]["launches"]
    for r in ranks:
        for op, (ok, err, rel_err) in r["blas"]["errs"].items():
            if not ok:
                raise AssertionError(f"rank {r['rank']}: blas.{op} "
                                     f"disagrees with the gathered plain "
                                     f"computation ({err})")
        if r["blas"]["launches"]["xpby_dot"] != 2 or \
                r["blas"]["launches"]["cg_update"] != 2:
            raise AssertionError(f"rank {r['rank']}: blas launches "
                                 f"{r['blas']['launches']}, expected one "
                                 f"xpby_dot and one cg_update a leaf")
    errs = {op: f"{e[1]:.3e}" for op, e in r0["blas"]["errs"].items()}
    print(f"segmented blas (rho CLONE {2 * N}x{2 * N}, chat NATURAL "
          f"{NCOILS}x{2 * N}x{2 * N}, {DIST_RANKS} ranks) against the "
          f"gathered plain computation: max abs err {errs} (tol "
          f"{registry.get('xpby_dot').tol}, relative 10x); launches on each "
          f"rank {json.dumps({k: v for k, v in blas_counts.items() if v})}",
          flush=True)

    _print_wire(ranks, card)

    with tempfile.TemporaryDirectory() as tmp:
        env = Environment(0, 1, store=dist.FileStore(f"{tmp}/store", 1),
                          backend="nccl", timeout=DIST_TIMEOUT_S)
        try:
            t0 = time.perf_counter()
            nccl = dist_rank(env, frames, shallow_only=True)
            nccl_ms = (time.perf_counter() - t0) * 1e3
        finally:
            env.close()
    img_nccl = torch.from_numpy(nccl["img"]).to(device)
    rel = _rel_l2(img_nccl, one_rank["frame0"])
    print(f"1-rank NCCL group: backend {nccl['backend']}, frame 0 at newton "
          f"{NEWTON} / cg {CG_ITERS} in {nccl_ms:.3f} ms (first call on the "
          f"group), image relative L2 {rel:.3e} from phase 3's frame 0 "
          f"(bitwise equal: {torch.equal(img_nccl, one_rank['frame0'])})"
          f" [{card}]", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"1-rank NCCL frame drifts: {rel}")
    return ({"masked_sum": frame_counts["masked_sum"],
             "xpby_dot": blas_counts["xpby_dot"]},
            {"movie": r0["movie_np"], "movie_bits": r0["movie"],
             "frame_ms": r0["frame_ms"], "shallow": r0["shallow"]})


def _print_wire(ranks, card) -> None:
    """Phase 8's frame 0 under each channel sum (the stream's crop frame
    0, its ``full`` run after it): the wire bytes a rank of its
    collectives (``core.comm.record``, priced by ``launch.roofline``'s
    ring model), the image-sized ones (at least ``WIRE_IMAGE_BYTES``) and
    their ratio, which must lie in ``WIRE_RATIO``, as the CPU test at the
    reference's sizes asks.  The crop frame's record must end on the
    readout's all-reduce."""
    from repro_torch.launch import roofline
    wire = {}
    for mode in CHANNEL_SUMS:
        logs = [r["wire"][mode] for r in ranks]
        if any(log != logs[0] for log in logs[1:]):
            raise AssertionError(f"ranks record other collectives ({mode})")
        if logs[0][-1]["kind"] != "all_reduce" or \
                logs[0][-1]["bytes"] < WIRE_IMAGE_BYTES:
            raise AssertionError(f"frame 0's record ({mode}) does not end "
                                 f"on the readout: {logs[0][-1]}")
        colls = roofline.collectives(logs[0])
        big = [c for c in colls if c["bytes"] >= WIRE_IMAGE_BYTES]
        wire[mode] = sum(c["wire_bytes"] for c in big)
        by_kind = {k: (v["count"], round(v["wire"] / 1e6, 3)) for k, v in
                   roofline.collective_summary(big)["by_kind"].items()}
        print(f"multi-rank wire bytes, frame 0, channel_sum={mode}: "
              f"{wire[mode] / 1e6:.3f} MB a rank in the image-sized "
              f"collectives (calls, MB by kind {by_kind}), "
              f"{roofline.collective_summary(colls)['wire_bytes'] / 1e6:.3f}"
              f" MB with the CG scalars; {len(colls)} collectives",
              flush=True)
    ratio = wire["full"] / max(wire["crop"], 1.0)
    print(f"multi-rank wire bytes full / crop: {ratio:.4f} (limits "
          f"{WIRE_RATIO}); at NVLink's {roofline.HW['nvlink_bw'] / 1e9:.0f}"
          f" GB/s a direction: full {wire['full'] / roofline.HW['nvlink_bw'] * 1e3:.3f}"
          f" ms, crop {wire['crop'] / roofline.HW['nvlink_bw'] * 1e3:.3f} ms"
          f" a frame (ring model, not measured) [{card}]", flush=True)
    if not WIRE_RATIO[0] < ratio < WIRE_RATIO[1]:
        raise AssertionError(f"full / crop wire bytes {ratio}")


# -- phase 8b: the channel sum's other schedules and the rest of the core ----

def _verbs_check(env, comm, mesh) -> list:
    """Every new verb of the core once on the ranks, at sizes above both
    schedule thresholds, each schedule forced, against numpy: rows of
    (verb, schedule taken, error, tolerance, ok)."""
    import numpy as np
    import torch
    from repro_torch.core import (PassThrough, Policy, SegmentedArray,
                                  hierarchical_psum, ring_allreduce)
    from repro_torch.core import comm as C
    from repro_torch.lib import blas
    from repro_torch.lib import fft as F
    rng = np.random.default_rng(VERB_SEED)
    n, r = comm.size, comm.rank
    rows = []

    def c(*shape):
        return (rng.standard_normal(shape, np.float32) +
                1j * rng.standard_normal(shape, np.float32)).astype(
                    np.complex64)

    def f(*shape):
        return rng.standard_normal(shape, np.float32)

    def check(verb, sched, got, want, tol=0.0):
        if isinstance(got, SegmentedArray):
            got = got.gather()
        got = got.detach().cpu().numpy() if hasattr(got, "detach") \
            else np.asarray(got)
        want = np.asarray(want)
        err = float(np.abs(got - want).max() /
                    max(float(np.abs(want).max()), 1e-30)) \
            if got.shape == want.shape else float("inf")
        rows.append((verb, sched, err, tol, err <= tol))

    x = c(256, 256)                                  # 512 KiB
    try:
        for sched in ("device_put", "scatter_allgather"):
            C.BCAST_SCHEDULE = sched
            taken = C.bcast_schedule(comm.group, x.nbytes)
            check("bcast", taken, comm.bcast(x if r == 0 else 0 * x), x)
    finally:
        C.BCAST_SCHEDULE = None
    xr = f(4 * n, 256, 256)                          # merged 256 KiB
    seg = comm.container(xr)
    a, b = f(512, 512), f(512, 512)
    want_ab = a.astype(np.float64) @ b
    try:
        for sched in ("psum", "rs_ag"):
            C.REDUCE_SCHEDULE = sched
            check("reduce", C.plan_reduce(seg).meta["schedule"],
                  comm.reduce(seg), xr.sum(0), 1e-5)
            sa, sb = comm.container(a, dim=1), comm.container(b)
            check("gemm_ksplit", blas.gemm_ksplit_schedule(sa, sb),
                  blas.gemm_ksplit(sa, sb).data, want_ab, 1e-4)
    finally:
        C.REDUCE_SCHEDULE = None
    check("allreduce", "p2p", seg.allreduce(p2p=True).data, xr.sum(0), 1e-5)
    mseg = mesh.container(xr)
    check("allreduce", "hierarchical", mseg.allreduce(hierarchical=True)
          .data, xr.sum(0), 1e-5)
    local = torch.from_numpy(xr[r]).to(comm.device)
    check("hierarchical_psum", "staged", hierarchical_psum(
        local, mesh.group), xr[:n].sum(0), 1e-5)
    bits = set()
    for chunks in (1, 2, 3):
        red = ring_allreduce(local, chunks=chunks, comm=comm)
        bits.add(_digest(red))
        check("ring_allreduce", f"chunks {chunks}", red, xr[:n].sum(0),
              1e-5)
    rows.append(("ring_allreduce", "same bits for chunks 1-3",
                 0.0 if len(bits) == 1 else 1.0, 0.0, len(bits) == 1))
    for op in ("sum", "max", "min"):
        check("reduce_scatter", C.plan_reduce_scatter(seg, op)
              .meta["schedule"], comm.reduce_scatter(seg, op),
              getattr(xr, op)(0), 1e-5 if op == "sum" else 0.0)
    xs = f(1024, 64)                                 # 256 KiB
    nat = comm.container(xs)
    blk = comm.container(xs, policy=Policy.BLOCK, block=16)
    for src, kw in ((nat, {"policy": Policy.CLONE}), (nat, {"dim": 1}),
                    (nat, {"policy": Policy.BLOCK, "block": 16}),
                    (blk, {"policy": Policy.NATURAL}),
                    (comm.container(xs, policy=Policy.CLONE),
                     {"policy": Policy.NATURAL})):
        check("copy", C.copy_route(src, **kw), comm.copy(src, **kw), xs)
    check("alltoall", "all_to_all", comm.alltoall(nat, 1), xs)
    ga, gb = f(4 * n, 64, 64), f(4 * n, 64, 64)
    check("gemm_batched", "local", blas.gemm_batched(
        comm.container(ga), comm.container(gb)), np.matmul(
            ga.astype(np.float64), gb), 1e-4)
    xf = c(8, 256, 256)
    want_f = np.fft.fft2(xf, axes=(-2, -1), norm="ortho")
    for dim in (0, 1, 2):
        s = comm.container(xf, dim=dim)
        plan = F.plan_fft2_batched(s)
        check("fft2_batched", plan.meta["schedule"], plan(s), want_f, 1e-5)
    xv = c(4, 256, 6)
    s = comm.container(xv, dim=1)
    plan = F.plan_fft2_batched(s)
    check("fft2_batched", plan.meta["schedule"], plan(s),
          np.fft.fft2(xv, axes=(-2, -1), norm="ortho"), 1e-5)
    xo = f(1024, 64)
    so = comm.container(xo, policy=Policy.OVERLAP2D, halo=2)
    xp = np.pad(xo, ((2, 2), (0, 0)))
    check("halo_exchange", "two open shifts", so.halo_exchange(
        lambda e: e[:-4] + e[1:-3] + e[2:-2] + e[3:-1] + e[4:]),
        sum(xp[k:k + 1024] for k in range(5)), 1e-5)
    check("invoke_all", "PassThrough", comm.invoke_all(
        lambda xl, full: xl * full.sum(), nat, PassThrough(nat)),
        xs * xs.sum(dtype=np.float64), 1e-5)
    one = np.zeros_like(xs)
    per = 1024 // n
    one[per:2 * per] = xs[per:2 * per]
    check("invoke", "rank 1", comm.invoke(lambda xl: xl, nat, rank=1), one)
    surv = env.survivor(comm, lost=(n - 1,))
    got = n - 1 if surv is None else float(surv.allreduce(
        torch.tensor(1.0, device=comm.device)))
    check("survivor", f"lost rank {n - 1}", np.float32(got),
          np.float32(n - 1))
    return rows


def _radial_rank(comm, frame0, fov) -> dict:
    """Phase 5's frame 0 through the radial plan on coil-segmented
    containers: the forward (a local ``fft2_batched``, then ``degrid``)
    and ``adjoint_recon`` (``grid_adjoint``, then one all-reduce), with
    the rank's launches counted from 0."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.lib.fft import fft2_batched
    from repro_torch.nlinv.gridding import radial_ops
    plan = radial_ops(2 * N, SPOKES, frame=0, device=comm.device).plan
    coil_imgs = comm.container(frame0["coil_imgs"])
    samples = comm.container(frame0["samples"])
    fov_d = torch.as_tensor(fov, device=comm.device)
    torch.cuda.synchronize()
    registry.reset_launches()
    fwd = plan.degrid(fft2_batched(coil_imgs, centered=True))
    img = plan.adjoint_recon(samples, fov_d)
    torch.cuda.synchronize()
    counts = {k: v for k, v in registry.launches().items() if v}
    kind = type(fwd).__name__
    fwd = fwd.gather()
    return {"counts": counts, "types": kind,
            "samples": fwd.cpu().numpy() if comm.rank == 0 else None,
            "image": img.cpu().numpy() if comm.rank == 0 else None,
            "image_bits": _digest(img)}


def sched_rank(env, data, frame0) -> dict:
    """One rank of phase 8b: the 4-frame stream with the ring on the
    4 ranks and with the hierarchical sum on the (2, 2) group, each with
    its launch counts and shallow frame; every new verb once; the
    coil-segmented radial frame."""
    import torch
    from repro_torch.core import comm as C
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    comm = env.world
    mesh = env.group((2, 2), ("pod", "data"))
    C.STAGED.clear()
    out = {"rank": comm.rank, "mesh": mesh.group.coords}
    for name, c, kw in (("p2p", comm, {"overlap": "p2p"}),
                        ("hier22", mesh, {"hierarchical": True})):
        rec = Reconstructor(c, newton=NEWTON, cg_iters=CG_ITERS,
                            channel_sum="crop", **kw)
        stream = FrameStream(rec, damping=DAMPING)
        registry.reset_launches()
        movie, report = stream.run(data["y"], data["masks"], data["fov"])
        torch.cuda.synchronize()
        res = {"counts": registry.launches(), "cg_log": list(rec.cg_log),
               "frame_ms": report.summary()["frame_ms"],
               "rho": _digest(stream.last_carry["u"]["rho"]),
               "movie": _digest(movie),
               "movie_np": movie.cpu().numpy() if comm.rank == 0 else None,
               "finite": bool(torch.isfinite(movie).all()),
               "shape": tuple(movie.shape),
               "nrmse": [nrmse(movie[f].cpu().numpy(), data["rho"][f],
                               data["fov"]) for f in range(FRAMES)]}
        u, img = _solve(c.device, data, 0, newton=SHALLOW_NEWTON,
                        cg_iters=SHALLOW_CG, comm=c, **kw)
        res["shallow"] = img.cpu().numpy() if comm.rank == 0 else None
        res["shallow_rho"] = _digest(u["rho"])
        res["shallow_img"] = _digest(img)
        out[name] = res
    out["staged_frames"] = dict(C.STAGED)
    out["verbs"] = _verbs_check(env, comm, mesh)
    out["radial"] = _radial_rank(comm, frame0, data["fov"])
    out["staged"] = dict(C.STAGED)
    return out


def phase_schedules(device, card, data, one_rank, dist, frame0) -> int:
    """Phase 8b (see the module's docstring).  Returns the ``masked_sum``
    launches of rank 0's two streams."""
    import numpy as np
    import torch
    from repro_torch.core import run_ranks
    frames = {k: data[k] for k in ("y", "masks", "fov", "rho", "grid")}
    t0 = time.perf_counter()
    ranks = run_ranks(sched_rank, DIST_RANKS, backend="gloo",
                      shared_card=True, args=(frames, frame0),
                      timeout=SCHED_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"phase 8b: {DIST_RANKS} ranks sharing the card over gloo, "
          f"{wall:.2f} s for the ranks' whole run, start-up included; the "
          f"(2, 2) ('pod', 'data') group's coordinates "
          f"{[r['mesh'] for r in ranks]} [{card}]", flush=True)
    _, img1 = _solve(device, data, 0, newton=SHALLOW_NEWTON,
                     cg_iters=SHALLOW_CG)
    default_movie = torch.from_numpy(dist["movie"]).to(device)

    def steady(ms):
        return sum(ms[1:]) / max(len(ms) - 1, 1)

    masked = 0
    for name, label in (("p2p", "overlap='p2p', 4 ranks on one axis"),
                        ("hier22", "hierarchical=True, the (2, 2) group")):
        res = [r[name] for r in ranks]
        s0 = res[0]
        for key in ("cg_log", "rho", "movie", "shallow_rho", "shallow_img",
                    "counts"):
            if any(s[key] != s0[key] for s in res[1:]):
                raise AssertionError(f"{name}: ranks disagree on {key}: "
                                     f"{[s[key] for s in res]}")
        if s0["shape"] != (FRAMES, data["grid"], data["grid"]) or \
                not all(s["finite"] for s in res):
            raise AssertionError(f"{name}: movie shape {s0['shape']}, "
                                 f"finite {[s['finite'] for s in res]}")
        want = expected_launches(s0["cg_log"], FRAMES, NEWTON,
                                 collective=True)
        got = {k: s0["counts"][k] for k in want}
        stray = {k: v for k, v in s0["counts"].items()
                 if k not in want and v}
        if got != want or stray:
            raise AssertionError(f"{name}: launch counts {s0['counts']} != "
                                 f"expected {want}")
        masked += got["masked_sum"]
        drift = [abs(a - b) for a, b in zip(s0["nrmse"], one_rank["nrmse"])]
        if max(drift) > DEPTH_NRMSE_TOL:
            raise AssertionError(f"{name}: frames drift from 1 rank: "
                                 f"{drift}")
        rel1 = _rel_l2(torch.from_numpy(s0["shallow"]).to(device), img1)
        if not rel1 <= PATH_TOL:
            raise AssertionError(f"{name}: shallow frame drifts from 1 "
                                 f"rank: {rel1}")
        movie = torch.from_numpy(s0["movie_np"]).to(device)
        bitwise = s0["movie"] == dist["movie_bits"]
        rel8 = _rel_l2(movie, default_movie)
        if name == "p2p" and not bitwise:
            raise AssertionError(f"the ring's movie is not phase 8's bit for "
                                 f"bit (relative L2 {rel8:.3e})")
        print(f"phase 8b {name} ({label}): cg iterations {s0['cg_log']}; "
              f"rho, CG log and movie bitwise equal on all {DIST_RANKS} "
              f"ranks; launches (each rank) {json.dumps(got)}", flush=True)
        print(f"phase 8b {name}: full-depth NRMSE "
              f"{[round(e, 5) for e in s0['nrmse']]} (at most {max(drift):.2e}"
              f" from 1 rank's, limit {DEPTH_NRMSE_TOL}); shallow frame "
              f"relative L2 {rel1:.3e} from 1 rank (limit {PATH_TOL}); movie "
              f"against phase 8's default schedule: bitwise {bitwise}, "
              f"relative L2 {rel8:.3e}", flush=True)
        print(f"phase 8b {name}: frame_ms per rank "
              f"{[s['frame_ms'] for s in res]}; steady mean "
              f"{steady(s0['frame_ms']):.3f} ms/frame against "
              f"{steady(dist['frame_ms']):.3f} for phase 8's default schedule "
              f"({dist['frame_ms']}) and {steady(one_rank['frame_ms']):.3f} "
              f"on 1 rank [{card}; gloo, host-staged, one shared card]",
              flush=True)
    print(f"phase 8b staged through the host (gloo on the card), calls on "
          f"rank 0: the two streams {json.dumps(r0['staged_frames'])}; the "
          f"whole phase {json.dumps(r0['staged'])}", flush=True)
    for r in ranks:
        bad = [row for row in r["verbs"] if not row[4]]
        if bad:
            raise AssertionError(f"rank {r['rank']}: verbs disagree with "
                                 f"numpy: {bad}")
    print("phase 8b verbs (rank 0; every rank within its tolerance): " +
          "; ".join(f"{v} [{s}] {e:.2e} (tol {t})"
                    for v, s, e, t, _ in r0["verbs"]), flush=True)
    rad = r0["radial"]
    if any(r["radial"]["counts"] != {"degrid": 1, "grid_adjoint": 1}
           for r in ranks) or rad["types"] != "SegmentedArray" or \
            any(r["radial"]["image_bits"] != rad["image_bits"]
                for r in ranks):
        raise AssertionError(f"coil-segmented radial frame: launches "
                             f"{[r['radial']['counts'] for r in ranks]}, "
                             f"type {rad['types']}")
    rel_y = float(np.linalg.norm(rad["samples"] - frame0["samples"]) /
                  np.linalg.norm(frame0["samples"]))
    rel_i = float(np.linalg.norm(rad["image"] - frame0["image"]) /
                  np.linalg.norm(frame0["image"]))
    print(f"phase 8b radial, 2 of {NCOILS} coils a rank: forward samples "
          f"relative L2 {rel_y:.3e} (bitwise "
          f"{np.array_equal(rad['samples'], frame0['samples'])}), "
          f"adjoint_recon image relative L2 {rel_i:.3e} (bitwise "
          f"{np.array_equal(rad['image'], frame0['image'])}) from phase 5's "
          f"frame 0 (limit {PATH_TOL}); launches on each rank "
          f"{json.dumps(rad['counts'])}", flush=True)
    if not (rel_y <= PATH_TOL and rel_i <= PATH_TOL):
        raise AssertionError(f"coil-segmented radial frame drifts: "
                             f"{rel_y}, {rel_i}")
    return masked


def _rel_max(a, b) -> float:
    """max |a - b| over max |b|: the stream tests' relative error."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _check_frame_launches(counts, cg_log, frames, label) -> dict:
    want = expected_launches(cg_log, frames, NEWTON)
    got = {k: counts[k] for k in want}
    stray = {k: v for k, v in counts.items() if k not in want and v}
    if got != want or stray:
        raise AssertionError(f"{label}: launch counts {counts} != expected "
                             f"{want}")
    return got


def phase_pipeline(device, card, data, one_rank) -> None:
    """Phase 9a: ``FramePipeline`` over phase 3's 4 frames at inflight 2
    and 3, between two ``FrameStream`` runs of the same frames (in turns,
    so that the times compare on one card): launch counts from the CG
    logs, the movie against phase 3's within ``STREAM_TOL``."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FramePipeline, FrameStream
    args = (data["y"], data["masks"], data["fov"])
    ref = one_rank["movie"]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    runs = [None, *PIPE_INFLIGHT, None]
    for inflight in runs:
        label = ("FrameStream" if inflight is None
                 else f"FramePipeline(inflight={inflight})")
        eng = (FrameStream(rec, damping=DAMPING) if inflight is None
               else FramePipeline(rec, damping=DAMPING, inflight=inflight))
        rec.cg_log.clear()
        registry.reset_launches()
        movie, report = eng.run(*args)
        torch.cuda.synchronize()
        got = _check_frame_launches(registry.launches(), rec.cg_log,
                                    FRAMES, label)
        s = report.summary()
        if s.get("dropped") or s["plan_cache"]["steady_builds"] != 0:
            raise AssertionError(f"{label}: report {s}")
        rel = _rel_max(movie, ref)
        # the run's ms a frame, the figure the two engines share: with
        # frames in flight, completion-to-completion times follow the
        # window's retire order, not the frames' work
        print(f"pipelined stream: {label}: run "
              f"{sum(report.frame_ms) / FRAMES:.3f} ms/frame (all frames' "
              f"wall over {FRAMES}); steady {s['mean_ms']:.3f} "
              f"ms/frame (p50 {s['p50_ms']:.3f}), {s['fps']:.3f} fps, "
              f"frame_ms {s['frame_ms']}; movie against phase 3's: max "
              f"relative error {rel:.3e} (limit {STREAM_TOL}), bitwise "
              f"equal: {torch.equal(movie, ref)}; cg iterations "
              f"{rec.cg_log}; launches {json.dumps(got)} [{card}]",
              flush=True)
        if not rel <= STREAM_TOL:
            raise AssertionError(f"{label} drifts from FrameStream: {rel}")
        del movie


def _serve_nlinv(device, datas, poison=None):
    """The service: 3 full-width clients through ``StreamScheduler(
    NlinvStreamWorkload(rec), buckets (1, 2, 4))``, client 0 skipping tick
    2, with the launch counters set to 0 before the first tick (the
    submits upload and launch no kernel) and read after the last."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    wl = NlinvStreamWorkload(rec, damping=DAMPING)
    sched = StreamScheduler(wl, ServeConfig(buckets=SERVE_BUCKETS))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                     fov=d["fov"]) for k, d in enumerate(datas)]
    builds0 = rec.plan_cache.builds
    registry.reset_launches()
    for f in range(FRAMES):
        for k, d in enumerate(datas):
            if (k, f) in SERVE_SKIP:
                continue
            y = d["y"][f]
            if (k, f) == poison:
                y = np.full_like(y, np.nan)
            if not sched.submit(ss[k], (y, d["masks"][f])):
                raise AssertionError(f"client {k} frame {f} shed")
        if sched.tick() == 0:
            raise AssertionError(f"tick {f} served nothing")
    torch.cuda.synchronize()
    return {"rec": rec, "wl": wl, "sched": sched, "sessions": ss,
            "counts": registry.launches(),
            "builds": rec.plan_cache.builds - builds0}


def phase_service(device, card, datas) -> list:
    """Phase 9b: the batched NLINV service against the same clients run
    one after another through ``FrameStream``, a clean run and a run
    with one client's frame poisoned (quarantine); returns the clean
    run's ms of its width-4 ticks."""
    import torch
    from repro_torch.nlinv.operators import fft2c
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    from repro_torch.serve import Rejected
    K = len(datas)
    served = [[f for f in range(FRAMES) if (k, f) not in SERVE_SKIP]
              for k in range(K)]
    # the poisoned run first: it also builds the widths' plans and warms
    # the card for the clean run's times
    bad = _serve_nlinv(device, datas, poison=SERVE_POISON)
    clean = _serve_nlinv(device, datas)
    rec, sched, ss = clean["rec"], clean["sched"], clean["sessions"]
    widths = [len(rec.cg_log[t * NEWTON]) for t in range(FRAMES)]
    if widths != [SERVE_WIDTH, SERVE_WIDTH, 2, SERVE_WIDTH]:
        raise AssertionError(f"tick widths {widths}")
    got = _check_frame_launches(clean["counts"], rec.cg_log, FRAMES,
                                "service")
    print(f"service: {K} clients (seeds {list(SERVE_SEEDS)}, grid "
          f"{datas[0]['grid']}, J={NCOILS}, newton {NEWTON}, cg {CG_ITERS}),"
          f" buckets {SERVE_BUCKETS}, client 0 skips tick 2: tick widths "
          f"{widths}; plans built {bad['builds']} (first run), "
          f"{clean['builds']} (second); cg iterations by tick and row "
          f"{rec.cg_log}; launches {json.dumps(got)}", flush=True)

    # the same clients one after another through FrameStream
    seq, seq_wall, seq_frames = [], 0.0, 0
    for k, d in enumerate(datas):
        srec = Reconstructor(device=device, newton=NEWTON,
                             cg_iters=CG_ITERS)
        f = served[k]
        imgs, rep = FrameStream(srec, damping=DAMPING).run(
            d["y"][f], d["masks"][f], d["fov"])
        torch.cuda.synchronize()
        seq.append(imgs)
        seq_wall += sum(rep.frame_ms[1:])
        seq_frames += len(rep.frame_ms) - 1
    errs, bitwise = [], []
    for k in range(K):
        res = ss[k].results
        if len(res) != len(served[k]) or \
                any(isinstance(r, Rejected) for r in res):
            raise AssertionError(f"client {k}: results {res}")
        errs += [_rel_max(r, seq[k][i]) for i, r in enumerate(res)]
        bitwise.append(all(torch.equal(r, seq[k][i])
                           for i, r in enumerate(res)))
    max_rel = max(errs)
    print(f"service against each client's own FrameStream: max relative "
          f"error {max_rel:.3e} (limit {STREAM_TOL}); bitwise equal by "
          f"client: {bitwise}", flush=True)
    if not max_rel <= STREAM_TOL:
        raise AssertionError(f"batched frames drift from FrameStream: "
                             f"{max_rel}")
    if not all(bitwise):
        # the kernels' rows are the unbatched kernels' bits (the card
        # tests), the norms a row each: test the centered FFT of a (B, J)
        # batch against one call a row
        g = datas[0]["grid"]
        z = torch.randn((SERVE_WIDTH, NCOILS, g, g), dtype=torch.complex64,
                        device=device,
                        generator=torch.Generator(device).manual_seed(9))
        whole = fft2c(z)
        rows = torch.stack([fft2c(z[b]) for b in range(SERVE_WIDTH)])
        print(f"service bitwise check: the centered FFT of a "
              f"({SERVE_WIDTH}, {NCOILS}) batch against one call a row: "
              f"bitwise equal {torch.equal(whole, rows)}, max abs "
              f"difference {float((whole - rows).abs().max()):.3e}",
              flush=True)
        del z, whole, rows

    # quarantine: the poisoned frame refused, the client streaming on,
    # every other client's frames bitwise the clean run's
    bs = bad["sessions"]
    c, f = SERVE_POISON
    i = served[c].index(f)
    others = all(torch.equal(a, b) for k in range(K) if k != c
                 for a, b in zip(bs[k].results, ss[k].results))
    before = all(torch.equal(bs[c].results[j], ss[c].results[j])
                 for j in range(i))
    after = bs[c].results[i + 1:]
    ok = (isinstance(bs[c].results[i], Rejected)
          and bad["wl"].quarantined == 1 and others and before
          and all(not isinstance(r, Rejected) and bool(torch.isfinite(r)
                                                        .all())
                  for r in after))
    print(f"service quarantine: client {c} frame {f} NaN: "
          f"{type(bs[c].results[i]).__name__}, quarantined "
          f"{bad['wl'].quarantined}, the client's later frames finite "
          f"{[bool(torch.isfinite(r).all()) for r in after]}; the other "
          f"clients bitwise equal to the clean run: {others}", flush=True)
    if not ok:
        raise AssertionError("the service's quarantine failed")

    ticks = sched.tick_ms
    by_width: dict[int, list] = {}
    for w, t in zip(widths, ticks):
        by_width.setdefault(w, []).append(round(t, 3))
    frames_per_tick = [sum(1 for k in range(K) if (k, f) not in SERVE_SKIP)
                       for f in range(FRAMES)]
    wall = sum(ticks)
    steady_fps = sum(frames_per_tick[1:]) / sum(ticks[1:]) * 1e3
    seq_fps = seq_frames / seq_wall * 1e3
    rep = sched.report()
    per_client = {k: round(len(ss[k].results) / wall * 1e3, 3)
                  for k in range(K)}
    print(f"service times: tick ms by width {by_width}; per-client frames/s"
          f" {per_client} and aggregate "
          f"{sum(frames_per_tick) / wall * 1e3:.3f} over the run's "
          f"{wall:.3f} ms of ticks; per-client latency "
          f"{ {c: (v['mean_ms'], v['fps']) for c, v in rep['clients'].items()} }"
          f" (mean ms, fps) [{card}]", flush=True)
    print("service vs sequential: " + json.dumps({
        "batched_fps": round(steady_fps, 3),
        "sequential_fps": round(seq_fps, 3),
        "batched_speedup": round(steady_fps / seq_fps, 4),
        "max_rel_err": max_rel}) + f" (steady: ticks and frames after the "
        f"first; sequential: {seq_frames} steady frames in "
        f"{seq_wall:.3f} ms) [{card}]", flush=True)
    return by_width[SERVE_WIDTH]


# -- phase 9c: the unfused batched frame ---------------------------------------

def _tick(fn, args) -> tuple:
    """``fn(*args)`` with the carry cloned, its ms to a synchronize."""
    import torch
    y, m, fov, w, u0 = args
    x0 = {k: v.clone() for k, v in u0.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(y, m, fov, w, x0, {k: v.clone() for k, v in u0.items()})
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_unfused_batched(device, card, datas, fused_ticks) -> dict:
    """Phase 9c: ``Reconstructor(fused=False).fn_batched(SERVE_WIDTH)`` on
    frame 0 of ``SERVE_WIDTH`` full-width clients, one rank: each row
    within ``STREAM_TOL`` of the unfused single frame of that client, the
    images finite, the ``coil_mult`` launches of a tick (counted from 0
    just before it) in the unfused operators' ratios; tick ms against the
    fused batched frame on the same inputs and phase 9's width-4 ticks.
    Returns the tick's launches."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import stack_carries
    t_phase = time.perf_counter()
    datas = datas[:SERVE_WIDTH]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS,
                        fused=False)
    g = datas[0]["grid"]
    args = (torch.stack([rec.put_frame(d["y"][0]) for d in datas]),
            torch.stack([rec.put_const(d["masks"][0]) for d in datas]),
            rec.put_const(datas[0]["fov"]), rec.put_const(sobolev_weight(g)),
            stack_carries([rec.init_carry(NCOILS, g) for _ in datas]))
    fn = rec.fn_batched(SERVE_WIDTH)
    _, warm_ms = _tick(fn, args)                        # plans, cuFFT
    registry.reset_launches()
    (u, img), tick_ms = _tick(fn, args)
    counts = {k: v for k, v in registry.launches().items() if v}
    applies = counts.get("coil_lincomb", 0)             # A(p) calls
    want = {"coil_scale_mult": NEWTON, "coil_lincomb": applies,
            "coil_forward": applies + NEWTON,
            "plane_mult": 4 * (applies + NEWTON)}
    if counts != want or not 2 * NEWTON <= applies <= \
            NEWTON * (1 + CG_ITERS):
        raise AssertionError(f"unfused tick launches {counts}, expected "
                             f"{want} with {applies} operator applications")
    fused = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    ffn = fused.fn_batched(SERVE_WIDTH)
    _tick(ffn, args)
    _, fused_ms = _tick(ffn, args)
    errs, bitwise = [], []
    y, m, fov, w, u0 = args
    for b in range(SERVE_WIDTH):
        row = {k: v[b].clone() for k, v in u0.items()}
        _, own = rec.fn(y[b], m[b], fov, w, row,
                        {k: v.clone() for k, v in row.items()})
        errs.append(_rel_max(img[b], own))
        bitwise.append(bool(torch.equal(img[b], own)))
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(img).all()) and all(
        bool(torch.isfinite(v).all()) for v in u.values())
    print(f"unfused batched frame: width {SERVE_WIDTH} (seeds "
          f"{list(CHAOS_SEEDS[:SERVE_WIDTH])}, grid {g}, J={NCOILS}, newton "
          f"{NEWTON}, cg {CG_ITERS}, one rank): rows against each client's "
          f"unfused single frame, max relative error "
          f"{[f'{e:.3e}' for e in errs]} (limit {STREAM_TOL}), bitwise "
          f"{bitwise}; images finite {finite}; launches a tick "
          f"{json.dumps(counts)} ({applies} operator applications)",
          flush=True)
    print(f"unfused batched frame: tick ms {tick_ms:.3f} (first "
          f"{warm_ms:.3f}) against the fused batched frame's {fused_ms:.3f}"
          f" on the same inputs and phase 9's width-4 ticks {fused_ticks};"
          f" phase {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if not max(errs) <= STREAM_TOL or not finite:
        raise AssertionError(f"unfused batched rows {errs}, finite "
                             f"{finite}")
    return counts


# -- phase 9e: the registry's block autotuner ---------------------------------

# the specs whose kernels sum in a fixed order: every block of their space
# must give their default block's bits
TUNE_BITWISE = ("coil_adjoint", "cg_update", "xpby_dot", "masked_sum",
                "grid_adjoint")
TUNE_STEADY = 2           # steady ticks of the width-4 frame
TUNE_ITERS = 3            # timed runs a candidate in the phase's own sweep


def _tune_specs(device, card) -> None:
    """Every candidate of every spec's block space at the spec's
    main-path sample: within tolerance of the plain version, bitwise
    against the default block where the spec's sums are fixed-order,
    timed beside the bound; the autotuner's pick on the same sample."""
    import torch
    from repro_torch.core.plan import PlanCache
    from repro_torch.kernels import registry
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    for spec in registry.specs():
        args = spec.sample(device, gen)
        tol = spec.sample_tol or spec.tol
        want = spec.plain(*args)
        # a space of one is compiled in: its wrapper takes no block
        many = len(spec.block_space) > 1

        def call(*a, b=spec.default_block):
            return spec.kernel(*a, **({"block": b} if many else {}))
        base = _outputs(call(*args))
        bound, bound_by = spec.bound_ms(*args)
        rows = {}
        for b in spec.block_space:
            got = call(*args, b=b)
            ok, err, _ = _agree(got, want, tol)
            same = all(torch.equal(g, d) for g, d in zip(_outputs(got),
                                                         base))
            del got

            def run(*a, b=b):
                return call(*a, b=b)
            ms = time_ms(run, args)
            dev = device_ms(run, args)[0]
            label = "x".join(map(str, b))
            rows[label] = {"ms": ms, "device_ms": dev, "bitwise": same}
            print(f"tune {spec.id} block {label}{' (default)' if b == spec.default_block else ''}: "
                  f"max_abs_err {err:.3e} (tol {tol}) bitwise with the "
                  f"default {same}; {ms:.4f} ms (device "
                  f"{'n/a' if dev is None else f'{dev:.5f}'}), bound "
                  f"{bound:.4f} ms ({bound_by}) [{card}]", flush=True)
            if not ok:
                raise AssertionError(f"{spec.id} block {b}: disagrees with "
                                     f"its plain version ({err})")
            if spec.name in TUNE_BITWISE and not same:
                raise AssertionError(f"{spec.id} block {b}: not bitwise "
                                     f"its default block's")
        cache = PlanCache()
        pick = registry.autotune(spec.id, sample=lambda: (args, {}),
                                 token=("chip_smoke", spec.name),
                                 cache=cache, iters=TUNE_ITERS)
        (plan,) = cache._plans.values()
        default = rows["x".join(map(str, spec.default_block))]
        won = rows["x".join(map(str, pick))]
        dev_ratio = (won["device_ms"] / default["device_ms"]
                     if won["device_ms"] and default["device_ms"] else None)
        fastest = min(rows, key=lambda k: rows[k]["device_ms"] or
                      float("inf"))
        table = plan.meta["table"]
        cold = (table["x".join(map(str, pick))] /
                table["x".join(map(str, spec.default_block))]
                if table else 1.0)
        print(f"tune {spec.id}: autotuner's pick {pick} "
              f"({plan.meta['source']}; cold-L2 device ms, best of "
              f"{TUNE_ITERS}: "
              f"{ {k: round(v, 5) for k, v in plan.meta['table'].items()} }"
              f", spread {plan.meta['spread']:.5f}, sweep "
              f"{plan.meta['ms']:.1f} ms); the pick against the "
              f"default: cold {cold:.4f}, device ms (back to back) "
              f"{'n/a' if dev_ratio is None else f'{dev_ratio:.4f}'}; "
              f"fastest by device ms {fastest} [{card}]", flush=True)
        if pick not in spec.block_space or (
                len(spec.block_space) > 1 and plan.meta["source"] != "swept"):
            raise AssertionError(f"{spec.id}: the autotuner's pick {pick} "
                                 f"({plan.meta['source']})")
        del args, want, base
    torch.cuda.synchronize()


def _tune_frames(device, datas, mode) -> dict:
    """The NLINV frame (``FRAMES`` frames of client 0) and the width-4
    tick (frame 0 of ``SERVE_WIDTH`` clients) from a cleared tune cache,
    with sweeps (``mode`` ``"swept"``) or under ``REPRO_KERNEL_BLOCKS=
    default``: set-up ms with the sweeps, steady ms, the tune cache over
    the steady region, the images."""
    import torch
    from repro_torch.core.plan import PlanCache
    from repro_torch.kernels import registry
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import stack_carries
    registry.reset_choices()
    registry.tune_cache().clear()
    data, g = datas[0], datas[0]["grid"]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    fov, w = rec.put_const(data["fov"]), rec.put_const(sobolev_weight(g))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = rec.init_carry(NCOILS, g)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    x_ref, frame_ms, movie = u, [], []
    snap = None
    for f in range(FRAMES):
        if f == 1:
            snap = registry.tune_cache().snapshot()
        t0 = time.perf_counter()
        u, img = rec(rec.put_frame(data["y"][f]),
                     rec.put_const(data["masks"][f]), fov, w, u, x_ref)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        x_ref = {k: DAMPING * v for k, v in u.items()}
        movie.append(img)
    frames_tune = registry.tune_cache().delta(snap)
    frame_choices = registry.choices()
    # the width-4 tick
    datas = datas[:SERVE_WIDTH]
    rec4 = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    rec4.plan_cache = PlanCache()
    args = (torch.stack([rec4.put_frame(d["y"][0]) for d in datas]),
            torch.stack([rec4.put_const(d["masks"][0]) for d in datas]),
            fov, w,
            stack_carries([rec4.init_carry(NCOILS, g) for _ in datas]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn = rec4.fn_batched(SERVE_WIDTH)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    (ub, imgb), first_tick = _tick(fn, args)
    snap, psnap = registry.tune_cache().snapshot(), \
        rec4.plan_cache.snapshot()
    ticks = [_tick(rec4.fn_batched(SERVE_WIDTH), args)[1]
             for _ in range(TUNE_STEADY)]
    ticks_tune = registry.tune_cache().delta(snap)
    ticks_plan = rec4.plan_cache.delta(psnap)
    y, m, _, _, u0 = args
    rows = []
    for b in range(SERVE_WIDTH):
        row = {k: v[b].clone() for k, v in u0.items()}
        _, own = rec4.fn(y[b], m[b], fov, w, row,
                         {k: v.clone() for k, v in row.items()})
        rows.append((_rel_max(imgb[b], own), bool(torch.equal(imgb[b],
                                                              own))))
    torch.cuda.synchronize()
    return {"mode": mode, "setup_ms": setup_ms, "frame_ms": frame_ms,
            "frames_tune": frames_tune, "choices": frame_choices,
            "tick_choices": registry.choices_token(
                ("cg_fused", "coil_mult", "masked_allreduce")),
            "plan_ms": plan_ms, "first_tick_ms": first_tick,
            "tick_ms": ticks, "ticks_tune": ticks_tune,
            "ticks_plan": ticks_plan, "rows": rows,
            "movie": torch.stack(movie), "ticks_img": imgb}


def phase_tune(device, card, datas) -> None:
    """Phase 9e (see the module's docstring)."""
    import os

    import numpy as np
    from repro_torch.kernels import registry
    t_phase = time.perf_counter()
    _tune_specs(device, card)
    runs = {}
    saved = os.environ.pop(registry.PIN_ENV, None)
    try:
        runs["swept"] = _tune_frames(device, datas, "swept")
        os.environ[registry.PIN_ENV] = "default"
        runs["default"] = _tune_frames(device, datas, "default")
    finally:
        os.environ.pop(registry.PIN_ENV, None)
        if saved is not None:
            os.environ[registry.PIN_ENV] = saved
    for r in runs.values():
        steady = r["frame_ms"][1:]
        print(f"tune frames {r['mode']}: init_carry with its sweeps "
              f"{r['setup_ms']:.3f} ms; frame ms {[round(t, 3) for t in r['frame_ms']]} "
              f"(steady mean {np.mean(steady):.3f}); tune cache over "
              f"frames 1-{FRAMES - 1}: {json.dumps(r['frames_tune'])}; "
              f"choices {json.dumps(r['choices'])} [{card}]", flush=True)
        print(f"tune tick {r['mode']}: width {SERVE_WIDTH} plan set-up with "
              f"its sweeps {r['plan_ms']:.3f} ms, first tick "
              f"{r['first_tick_ms']:.3f} ms, steady ticks "
              f"{[round(t, 3) for t in r['tick_ms']]} ms (mean "
              f"{np.mean(r['tick_ms']):.3f}); tune cache "
              f"{json.dumps(r['ticks_tune'])}, plan cache "
              f"{json.dumps(r['ticks_plan'])} over the steady ticks; rows "
              f"against their single frames (max rel, bitwise) "
              f"{[(f'{e:.3e}', bw) for e, bw in r['rows']]}; blocks "
              f"{r['tick_choices']} [{card}]", flush=True)
        if r["frames_tune"]["builds"] or r["ticks_tune"]["builds"] or \
                r["ticks_plan"]["builds"]:
            raise AssertionError(f"{r['mode']}: the steady region built "
                                 f"plans or tuned")
        if not all(bw for _, bw in r["rows"]):
            raise AssertionError(f"{r['mode']}: batched rows not bitwise "
                                 f"their single frames: {r['rows']}")
    import torch
    pinned = runs["default"]["choices"]
    if any(c["source"] != "pinned" or c["block"] != "x".join(
            map(str, registry.get(k).default_block))
           for k, c in pinned.items()):
        raise AssertionError(f"REPRO_KERNEL_BLOCKS=default: {pinned}")
    same = bool(torch.equal(runs["swept"]["movie"],
                            runs["default"]["movie"])) and \
        bool(torch.equal(runs["swept"]["ticks_img"],
                         runs["default"]["ticks_img"]))
    ratio = (np.mean(runs["swept"]["frame_ms"][1:]) /
             np.mean(runs["default"]["frame_ms"][1:]))
    print(f"tune: swept against default, steady frame ms ratio "
          f"{ratio:.4f}, tick ms ratio "
          f"{np.mean(runs['swept']['tick_ms']) / np.mean(runs['default']['tick_ms']):.4f}"
          f"; images bitwise equal {same} [{card}]", flush=True)
    if not same:
        raise AssertionError("swept and default blocks gave other images")
    print(f"phase 9e: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def phase_quickstart(card) -> None:
    """Phase 9d: ``examples/torch_quickstart.py`` on the card, one rank,
    in a process of its own: it must exit 0 and print its checks true."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              "torch_quickstart.py"),
                          "--ranks", "1"], capture_output=True, text=True,
                         timeout=QUICKSTART_TIMEOUT_S, env=env, cwd=ROOT)
    print(run.stdout, end="", flush=True)
    wants = ("reduce == sum: True", "allgather: True", "fft roundtrip: True",
             "quickstart OK")
    if run.returncode != 0 or not all(w in run.stdout for w in wants):
        raise AssertionError(f"torch_quickstart.py exited "
                             f"{run.returncode}: {run.stderr[-3000:]}")
    print(f"quickstart on the card: {time.perf_counter() - t0:.1f} s, "
          f"process start included [{card}]", flush=True)


# -- phase 10: the service under faults ---------------------------------------

def _chaos_service(device, datas, specs, *, seed=CHAOS_FAULT_SEED,
                   retry=None):
    """One run of phase 10a: every client's frames through ``StreamScheduler(
    NlinvStreamWorkload(rec), buckets (1, 2, 4))`` on one rank under
    ``FaultInjector(specs, seed)``, ticking until each frame is served,
    with the launch counters set to 0 before the first tick and read after
    the last."""
    import torch
    from repro_torch.ft import FaultInjector
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    wl = NlinvStreamWorkload(rec, damping=DAMPING, retry=retry)
    sched = StreamScheduler(wl, ServeConfig(buckets=SERVE_BUCKETS))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                     fov=d["fov"]) for k, d in enumerate(datas)]
    inj = FaultInjector(specs, seed=seed)
    registry.reset_launches()
    with inj:
        for f in range(FRAMES):
            for k, d in enumerate(datas):
                if not sched.submit(ss[k], (d["y"][f], d["masks"][f])):
                    raise AssertionError(f"client {k} frame {f} shed")
            while sched.tick() == 0 and any(
                    s.pending for s in sched.sessions.values()):
                pass
    torch.cuda.synchronize()
    return {"rec": rec, "wl": wl, "sched": sched, "sessions": ss,
            "inj": inj, "counts": registry.launches()}


def phase_chaos(device, card, datas) -> None:
    """Phase 10a: the 1-rank service at full width and depth with every
    row of a width-4 tick a client, clean and under each fault of the
    reference's ``SERVE_CHAOS`` (``tests/test_fault_injection.py``), with
    its checks."""
    import torch
    from repro_torch.ft import FaultSpec, RestartPolicy
    from repro_torch.serve import Rejected
    K = len(datas)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) and \
            len(a) == len(b)

    clean = _chaos_service(device, datas, [])
    ref = [s.results for s in clean["sessions"]]
    if any(len(r) != FRAMES or any(isinstance(x, Rejected) for x in r)
           for r in ref):
        raise AssertionError("the clean run did not deliver every frame")
    widths = {len(c) for c in clean["rec"].cg_log}
    if widths != {K}:
        raise AssertionError(f"clean run widths {widths}, expected {K}")
    got = _check_frame_launches(clean["counts"], clean["rec"].cg_log,
                                FRAMES, "chaos clean run")
    checks = {}
    retried = _chaos_service(
        device, datas, [FaultSpec(site="task", kind="transient",
                                  match="solve", at=(1,), max_fires=1)],
        retry=RestartPolicy(max_restarts=2, backoff_s=0))
    checks["retry fired"] = retried["inj"].fired == [
        ("task", "solve", 1, "transient")]
    checks["retry counted"] = retried["wl"].counters()["retried_tasks"] == 1
    checks["retry parity"] = all(same(s.results, ref[k]) for k, s in
                                 enumerate(retried["sessions"]))
    bad = _chaos_service(device, datas, [FaultSpec(
        site="step", kind="corrupt", at=(1,), pick=1, max_fires=1)])
    bs = bad["sessions"]
    checks["corrupt fired once"] = [f[3] for f in bad["inj"].fired] == [
        "corrupt"]
    checks["poisoned frame rejected"] = isinstance(bs[1].results[1],
                                                   Rejected)
    checks["quarantine counted"] = bs[1].poisoned == 1 and bad["sched"] \
        .report()["aggregate"]["ft"]["quarantined"] == 1
    checks["quarantined client streams on"] = all(
        not isinstance(r, Rejected) and bool(torch.isfinite(r).all())
        for r in bs[1].results[2:])
    checks["other clients bitwise"] = all(same(bs[k].results, ref[k])
                                          for k in range(K) if k != 1)
    checks["client's earlier frame bitwise"] = torch.equal(
        bs[1].results[0], ref[1][0])
    step = _chaos_service(device, datas, [FaultSpec(
        site="step", kind="transient", at=(1,), max_fires=1)])
    checks["step fault counted"] = step["sched"].step_faults == 1 == \
        step["sched"].report()["aggregate"]["ft"]["step_faults"]
    checks["step requeue parity"] = all(same(s.results, ref[k]) for k, s in
                                        enumerate(step["sessions"]))
    straggle = [FaultSpec(site="task", kind="straggle", match="solve",
                          prob=0.4, delay_ms=0.0)]
    a = _chaos_service(device, datas, straggle, seed=STRAGGLE_SEED)
    b = _chaos_service(device, datas, straggle, seed=STRAGGLE_SEED)
    checks["seeded replay identical"] = a["inj"].fired == b["inj"].fired \
        and len(a["inj"].fired) > 0
    ticks = clean["sched"].tick_ms
    rep = clean["sched"].report()["aggregate"]
    print(f"chaos (10a): {K} clients (seeds {list(CHAOS_SEEDS)}, grid "
          f"{datas[0]['grid']}, J={NCOILS}, newton {NEWTON}, cg "
          f"{CG_ITERS}), buckets {SERVE_BUCKETS}: every tick width {K} with "
          f"no padded row; cg iterations by tick and row "
          f"{clean['rec'].cg_log}; clean-run launches {json.dumps(got)}",
          flush=True)
    print(f"chaos (10a) fired: retry {retried['inj'].fired}, corrupt "
          f"{bad['inj'].fired}, step {step['inj'].fired}, straggle "
          f"{a['inj'].fired}; checks {json.dumps(checks)}", flush=True)
    print(f"chaos (10a) times: clean tick ms at width {K} "
          f"{[round(t, 3) for t in ticks]} (steady mean "
          f"{sum(ticks[1:]) / (len(ticks) - 1):.3f}), {rep['fps']} frames/s "
          f"aggregate over the run's ticks; the tick with the retried solve "
          f"{retried['sched'].tick_ms[1]:.3f} ms; the tick after the "
          f"requeued step {step['sched'].tick_ms[1]:.3f} ms [{card}]",
          flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 10a: {failed}")


def _remesh_run(env, datas, newton, cg_iters, own=False) -> dict:
    """One depth of phase 10b on this rank: the uninterrupted 4-rank
    batched service with its launch counts, each client's own 4-rank
    ``FrameStream`` (with ``own``), then the chaos run (a device loss at
    the third solve, the survivor group of ranks 0-1, the carries
    migrated, the frame resubmitted).  Images come back as numpy from
    rank 0, as digests from every rank."""
    import torch
    from repro_torch.ft import DeviceLossFault, FaultInjector, FaultSpec
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    comm = env.world
    keep = comm.rank == 0

    def make():
        rec = Reconstructor(comm, newton=newton, cg_iters=cg_iters,
                            channel_sum="crop")
        wl = NlinvStreamWorkload(rec, damping=DAMPING)
        sched = StreamScheduler(wl, ServeConfig(buckets=REMESH_BUCKETS))
        ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                         fov=d["fov"]) for k, d in enumerate(datas)]
        return rec, wl, sched, ss

    def feed(sched, ss, f):
        for k, d in enumerate(datas):
            if not sched.submit(ss[k], (d["y"][f], d["masks"][f])):
                raise AssertionError(f"client {k} frame {f} shed")

    def results(ss):
        return {"digest": [[_digest(r) for r in s.results] for s in ss],
                "np": [[r.cpu().numpy() for r in s.results] for s in ss]
                if keep else None}

    out = {"rank": comm.rank, "newton": newton, "cg_iters": cg_iters}
    rec, wl, sched, ss = make()
    registry.reset_launches()
    for f in range(FRAMES):
        feed(sched, ss, f)
        if sched.tick() != len(datas):
            raise AssertionError(f"tick {f} did not serve every client")
    torch.cuda.synchronize()
    out["counts"] = registry.launches()
    out["cg_log"] = list(rec.cg_log)
    out["tick_ms"] = list(sched.tick_ms)
    out["uninterrupted"] = results(ss)
    if own:
        movies = []
        for d in datas:
            srec = Reconstructor(comm, newton=newton, cg_iters=cg_iters,
                                 channel_sum="crop")
            movie, _ = FrameStream(srec, damping=DAMPING).run(
                d["y"], d["masks"], d["fov"])
            torch.cuda.synchronize()
            movies.append(movie.cpu().numpy() if keep else _digest(movie))
        out["own"] = movies

    rec, wl, sched, ss = make()
    inj = FaultInjector([FaultSpec(site="task", kind="device_loss",
                                   match="solve", at=(2,),
                                   device=REMESH_LOST[0])], seed=0)
    lost_at = size = None
    ms = {"before": [], "after": []}
    t0 = time.perf_counter()
    with inj:
        for f in range(FRAMES):
            feed(sched, ss, f)
            try:
                sched.tick()
                ms["before" if lost_at is None else "after"].append(
                    sched.tick_ms[-1])
            except DeviceLossFault as e:
                lost_at = f
                t1 = time.perf_counter()
                survivor = env.survivor(wl.rec.comm, lost=(e.device,) +
                                        REMESH_LOST[1:])
                wl.remesh(survivor, sessions=ss)
                out["remesh_ms"] = (time.perf_counter() - t1) * 1e3
                if survivor is None:
                    break
                size = survivor.size
                feed(sched, ss, f)
                sched.tick()
                ms["after"].append(sched.tick_ms[-1])
    torch.cuda.synchronize()
    out["chaos_s"] = time.perf_counter() - t0
    refused = None
    if wl.retired:
        try:
            wl.step([], 1)
        except RuntimeError as e:
            refused = str(e)
    out.update(lost_at=lost_at, survivor_size=size, retired=wl.retired,
               refused=refused, fired=list(inj.fired),
               remeshes=wl.remeshes,
               report_remeshes=sched.report()["aggregate"]["ft"]["remeshes"],
               chaos=results(ss), chaos_tick_ms=ms)
    return out


def remesh_rank(env, datas) -> dict:
    """One rank of phase 10b: the service at full depth, with each
    client's own stream, then at the shallow depth.  The ranks lost in
    the first chaos run retire that run's workload and take part in the
    second run's group as fresh ranks."""
    return {"full": _remesh_run(env, datas, NEWTON, CG_ITERS, own=True),
            "shallow": _remesh_run(env, datas, SHALLOW_NEWTON, SHALLOW_CG)}


def _check_remesh(ranks, datas, card) -> dict:
    """The chaos run of one depth of phase 10b against its uninterrupted
    run: the loss, the survivors, the counters, every frame delivered,
    the frames before the loss bitwise; returns the checks, the
    post-remesh relative errors and NRMSE drifts by client and frame."""
    import numpy as np
    r0 = ranks[0]
    K = len(datas)
    un, ch = r0["uninterrupted"]["np"], r0["chaos"]["np"]
    checks = {
        "loss at tick 2": all(r["lost_at"] == 2 for r in ranks),
        "fired": all(r["fired"] == [("task", "solve", 2, "device_loss")]
                     for r in ranks),
        "survivor size 2": [r["survivor_size"] for r in ranks] ==
        [2, 2, None, None],
        "remeshes 1": all(r["remeshes"] == 1 for r in ranks) and
        all(r["report_remeshes"] == 1 for r in ranks[:2]),
        "lost ranks retired": all(r["retired"] and "retired" in r["refused"]
                                  for r in ranks[2:]),
        "survivors agree": ranks[1]["chaos"]["digest"] ==
        r0["chaos"]["digest"],
        "all frames delivered": all(len(c) == FRAMES for c in ch),
        "pre-loss bitwise": all(np.array_equal(ch[k][f], un[k][f])
                                for k in range(K) for f in range(2)),
    }
    rel = [[float(np.abs(ch[k][f] - un[k][f]).max() /
                  np.abs(un[k][f]).max()) for f in range(2, FRAMES)]
           for k in range(K)]
    drift = [[abs(nrmse(ch[k][f], datas[k]["rho"][f], datas[k]["fov"]) -
                  nrmse(un[k][f], datas[k]["rho"][f], datas[k]["fov"]))
              for f in range(2, FRAMES)] for k in range(K)]
    cm = r0["chaos_tick_ms"]
    print(f"remesh (10b, newton {r0['newton']}, cg {r0['cg_iters']}) chaos: "
          f"fired {r0['fired']}; survivor sizes "
          f"{[r['survivor_size'] for r in ranks]}; remesh "
          f"{r0['remesh_ms']:.3f} ms on rank 0; frames 2-3 after the remesh "
          f"against the uninterrupted run, max relative error by client "
          f"{rel}, NRMSE drift by client {drift}; ms per tick on 4 ranks "
          f"before the loss {[round(t, 3) for t in cm['before']]}, on the 2 "
          f"survivors after {[round(t, 3) for t in cm['after']]}; the chaos "
          f"run {r0['chaos_s']:.2f} s on rank 0; checks "
          f"{json.dumps(checks)} [{card}]", flush=True)
    return {"checks": checks, "rel": max(max(r) for r in rel),
            "drift": max(max(d) for d in drift)}


def phase_remesh(device, card, datas) -> int:
    """Phase 10b: the batched service on 4 ranks sharing the card (gloo),
    an uninterrupted run against each client's own 4-rank stream, and a
    device loss remeshed onto ranks 0-1, at full depth and at the shallow
    depth (see the module's docstring).  Returns the ``masked_sum``
    launches of rank 0's uninterrupted full-depth run."""
    import numpy as np
    from repro_torch.core import run_ranks
    frames = [{k: d[k] for k in ("y", "masks", "fov", "grid")}
              for d in datas]
    t0 = time.perf_counter()
    ranks = run_ranks(remesh_rank, DIST_RANKS, backend="gloo",
                      shared_card=True, args=(frames,),
                      timeout=REMESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    full = [r["full"] for r in ranks]
    r0 = full[0]
    K = len(datas)
    print(f"remesh (10b): {DIST_RANKS} ranks sharing the card over gloo, "
          f"{K} clients (seeds {list(SERVE_SEEDS[:K])}), buckets "
          f"{REMESH_BUCKETS}, J={NCOILS} ({NCOILS // DIST_RANKS} coils a "
          f"rank); {wall:.2f} s for the ranks' whole run (both depths), "
          f"start-up included [{card}]", flush=True)
    for depth in ("full", "shallow"):
        rs = [r[depth] for r in ranks]
        for key in ("cg_log", "counts"):
            if any(r[key] != rs[0][key] for r in rs[1:]):
                raise AssertionError(f"ranks disagree on {key} ({depth})")
        if any(r["uninterrupted"]["digest"] != rs[0]["uninterrupted"]
               ["digest"] for r in rs[1:]):
            raise AssertionError(f"ranks disagree on the uninterrupted "
                                 f"images ({depth})")
    widths = {len(c) for c in r0["cg_log"]}
    want = expected_launches(r0["cg_log"], FRAMES, NEWTON, collective=True)
    got = {k: r0["counts"][k] for k in want}
    stray = {k: v for k, v in r0["counts"].items() if k not in want and v}
    if widths != {K} or got != want or stray:
        raise AssertionError(f"10b launches {r0['counts']} != {want} "
                             f"(widths {widths})")
    un = r0["uninterrupted"]["np"]
    errs, bitwise = [], []
    for k in range(K):
        own = r0["own"][k]
        errs += [float(np.abs(un[k][f] - own[f]).max() /
                       max(np.abs(own[f]).max(), 1e-30))
                 for f in range(FRAMES)]
        bitwise.append(all(np.array_equal(un[k][f], own[f])
                           for f in range(FRAMES)))
    print(f"remesh (10b) uninterrupted, newton {NEWTON}, cg {CG_ITERS}: cg "
          f"iterations by tick and row {r0['cg_log']}; launches (each rank) "
          f"{json.dumps(got)}; against each client's own {DIST_RANKS}-rank "
          f"FrameStream: max relative error {max(errs):.3e} (limit "
          f"{STREAM_TOL}), bitwise by client {bitwise}; tick ms "
          f"{[round(t, 3) for t in r0['tick_ms']]}", flush=True)
    if not max(errs) <= STREAM_TOL:
        raise AssertionError(f"10b rows drift from their own streams: "
                             f"{max(errs)}")
    # the reference's 1e-5 after the remesh holds at a depth like the
    # reference's own (newton 2, cg 6); at full depth the coil sums'
    # other association (4 coils a rank instead of 2) is amplified through
    # 2 frames of newton 7 and cg 30, and the frames are held to the full-
    # depth drift rule of the 4-rank frames (phase 8)
    deep = _check_remesh(full, datas, card)
    deep["checks"]["post-remesh NRMSE drift within DEPTH_NRMSE_TOL"] = \
        deep["drift"] <= DEPTH_NRMSE_TOL
    shallow = _check_remesh([r["shallow"] for r in ranks], datas, card)
    shallow["checks"]["post-remesh within REMESH_TOL"] = \
        shallow["rel"] <= REMESH_TOL
    print(f"remesh (10b) post-remesh: full depth max relative error "
          f"{deep['rel']:.3e}, NRMSE drift {deep['drift']:.3e} (limit "
          f"{DEPTH_NRMSE_TOL}); newton {SHALLOW_NEWTON}, cg {SHALLOW_CG}: "
          f"max relative error {shallow['rel']:.3e} (limit {REMESH_TOL})",
          flush=True)
    failed = [f"{label}: {k}" for label, res in (("full", deep),
                                                 ("shallow", shallow))
              for k, ok in res["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"phase 10b: {failed}")
    return r0["counts"]["masked_sum"]


# -- phase 12: training on one card -----------------------------------------

def _grad_inputs(name, dtype, device, gen):
    """The kernel's inputs at the shapes its prefill runs (its spec's
    sample), in ``dtype``, and which of them take a gradient: every input
    of flash attention and the RG-LRU scan; the mLSTM's from a nonzero
    state, so that the state takes one too."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.mlstm import gated_inputs
    if name == "mlstm":
        q, k, v, li, lf, st = gated_inputs(
            1, registry.XLSTM_HEADS, registry.XLSTM_SEQ,
            registry.XLSTM_HEAD_DIM, registry.XLSTM_HEAD_DIM,
            nonzero_state=True, dtype=dtype, device=device, generator=gen)
        return (q, k, v, li, lf, *st), (True,) * 8
    args = registry.get(name).sample(device, gen)
    tensors = tuple(a.to(dtype) for a in args
                    if isinstance(a, torch.Tensor) and a.dtype.is_floating_point)
    if name == "flash_attention":
        tensors = tensors[:3]
    return tensors, (True,) * len(tensors)


def _grad_call(name):
    """The wrapper, as a function of flat tensors to a tuple of outputs."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm import mlstm_scan
    from repro_torch.kernels.rg_lru import rg_lru_scan
    from repro_torch.kernels import registry
    if name == "flash_attention":
        return lambda q, k, v: (flash_attention(
            q, k, v, causal=True, window=registry.LM_WINDOW),)
    if name == "rg_lru":
        return rg_lru_scan
    return lambda q, k, v, li, lf, C, n, m: (
        lambda h, st: (h, *st))(*mlstm_scan(q, k, v, li, lf, (C, n, m)))


def _grads(fn, inputs, needs, weights, plain):
    """Gradients of sum(out * w) over the outputs, through the kernel path
    or (``plain``) the plain path; with the launches of its forward and
    the CUDA-event ms of its backward."""
    import torch
    from repro_torch.kernels import registry
    xs = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    before = registry.launches()
    with _paths(plain):
        outs = fn(*xs)
    launched = {k: v - before[k] for k, v in registry.launches().items()
                if v != before[k]}
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    gs = torch.autograd.grad(loss, [x for x, n in zip(xs, needs) if n])
    end.record()
    end.synchronize()
    return gs, launched, start.elapsed_time(end), all(
        o.grad_fn is not None for o in outs)


def phase_train_grads(device, card) -> dict:
    """Phase 12a: each LM kernel's gradients against the plain path's at
    its prefill shapes, float32 and bf16, every input that takes one; the
    kernel's counter must rise once per forward (and not at all on the
    plain path).  Returns each kernel's plain backward ms per call."""
    import torch
    gen = torch.Generator(device=device)
    bwd_ms = {}
    for name in ("flash_attention", "rg_lru", "mlstm"):
        for dtype in (torch.float32, torch.bfloat16):
            gen.manual_seed(12)
            inputs, needs = _grad_inputs(name, dtype, device, gen)
            fn = _grad_call(name)
            with torch.no_grad():
                outs = fn(*inputs)
            weights = [torch.randn(o.shape, device=device, generator=gen)
                       for o in outs]
            gk, launched, ms_k, has_fn = _grads(fn, inputs, needs, weights,
                                                plain=False)
            gp, plain_launched, ms_p, _ = _grads(fn, inputs, needs, weights,
                                                 plain=True)
            if launched != {name: 1} or plain_launched or not has_fn:
                raise AssertionError(f"{name} {dtype}: kernel path launched "
                                     f"{launched}, plain path "
                                     f"{plain_launched}, grad_fn {has_fn}")
            errs = [float((a.float() - b.float()).norm() /
                          b.float().norm().clamp(min=1e-30))
                    for a, b in zip(gk, gp)]
            if max(errs) > TRAIN_GRAD_TOL:
                raise AssertionError(f"{name} {dtype}: gradients {errs} "
                                     f"from the plain path's")
            times = [_grads(fn, inputs, needs, weights, plain=False)[2]
                     for _ in range(TRAIN_BWD_REPS)]
            key = f"{name} {str(dtype).split('.')[-1]}"
            bwd_ms[key] = sum(times) / len(times)
            print(f"phase 12a {key} at {[tuple(t.shape) for t in inputs]}: "
                  f"gradient relative L2 from the plain path {errs} "
                  f"(limit {TRAIN_GRAD_TOL}), bitwise "
                  f"{all(torch.equal(a, b) for a, b in zip(gk, gp))}; one "
                  f"{name} launch a forward; plain backward "
                  f"{bwd_ms[key]:.3f} ms a call (mean of {TRAIN_BWD_REPS}) "
                  f"[{card}]", flush=True)
    return bwd_ms


def _flash_train_bwd_ms(device, cfg) -> float:
    """Flash attention's plain backward at the train step's own shape
    (qwen3-0.6b: B 2, 16 heads on 8 kv of dim 128, 2048 tokens, causal,
    float32), CUDA-event ms a call."""
    import torch
    gen = torch.Generator(device=device).manual_seed(13)
    B, S, D = TRAIN_BATCH, TRAIN_SEQ, cfg.hd
    q, k, v = (torch.randn((B, h, S, D), device=device, generator=gen)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    fn = _grad_call("flash_attention")
    weights = [torch.randn((B, cfg.n_heads, S, D), device=device,
                           generator=gen)]
    from repro_torch.kernels.flash_attention import flash_attention

    def call(q, k, v):
        return (flash_attention(q, k, v, causal=True),)
    del fn
    times = [_grads(call, (q, k, v), (True,) * 3, weights, plain=False)[2]
             for _ in range(TRAIN_BWD_REPS + 1)][1:]
    return sum(times) / len(times)


def phase_train(device, card) -> dict[str, int]:
    """Phase 12 (see the module's docstring).  Returns the launches of the
    full-width run."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.launch.train import main as train_main
    from repro_torch.train import make_train_state, make_train_step
    t_phase = time.perf_counter()
    bwd_ms = phase_train_grads(device, card)
    # the launcher's default dtype; the served configs are bf16
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), compute_dtype="float32")
    bwd_ms["flash_attention float32 train shape"] = _flash_train_bwd_ms(
        device, cfg)
    print(f"phase 12a flash_attention plain backward at the train step's "
          f"shape: {bwd_ms['flash_attention float32 train shape']:.3f} ms a "
          f"call [{card}]", flush=True)

    # (b) the launcher at full width and depth
    _free_card()
    tmp = tempfile.mkdtemp(prefix="train-ckpt-")
    per_step = []

    def count(step, metrics):
        per_step.append(registry.launches())

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", tmp,
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1"]
    try:
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        t0 = time.perf_counter()
        out = train_main(argv, step_hook=count)
        wall = time.perf_counter() - t0
        counts = registry.launches()
        from repro_torch.ckpt import list_steps
        ckpts = list_steps(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in out["state"]["params"].parameters())
    del out["state"]
    _free_card()
    losses = [out["losses"][s] for s in range(TRAIN_STEPS)]
    secs = [out["step_s"][s] for s in range(TRAIN_STEPS)]
    flash = [b["flash_attention"] - a["flash_attention"] for a, b in
             zip([{"flash_attention": 0}] + per_step[:-1], per_step)]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / steady
    print(f"phase 12b {TRAIN_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, float32, batch {TRAIN_BATCH} "
          f"x {TRAIN_SEQ}: {n_params} parameters; losses {losses}; step s "
          f"{secs}; steady (median of steps 1-{TRAIN_STEPS - 1}) "
          f"{steady * 1e3:.1f} ms a step, {tok_s:.0f} tokens/s; peak "
          f"memory {peak / 1e9:.3f} GB; flash_attention launches a step "
          f"{flash}; checkpoints {ckpts}; {wall:.1f} s in the launcher "
          f"[{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if flash != [cfg.n_layers] * TRAIN_STEPS or any(
            v for k, v in counts.items() if k != "flash_attention"):
        raise AssertionError(f"launches a step {flash}, in all {counts}")
    if ckpts[-1] != TRAIN_STEPS:
        raise AssertionError(f"checkpoints {ckpts}")
    share = cfg.n_layers * bwd_ms["flash_attention float32 train shape"] / \
        (steady * 1e3)
    print(f"phase 12b flash_attention's plain backward: {share:.3f} of a "
          f"steady step ({cfg.n_layers} x "
          f"{bwd_ms['flash_attention float32 train shape']:.3f} ms) "
          f"[{card}]", flush=True)

    # one float32 step with the kernels against the same step on the plain
    # path, then the kernel path on the same batch: the loss must fall.
    # With remat (the same numbers): the plain path's chunked attention
    # keeps every key block's scores for its backward, about 2.7 GB a
    # layer here, which 28 layers at once would not fit on the card
    tok, lab = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, seed=0).batch_at(0)
    tok, lab = (torch.from_numpy(a).to(device) for a in (tok, lab))
    step = make_train_step(cfg, base_lr=TRAIN_REPEAT_LR, warmup=0,
                           total=TRAIN_REPEAT_STEPS, remat=True)
    mets = []
    for plain in (False, True):
        gen = torch.Generator(device=device).manual_seed(0)
        state = make_train_state(cfg, gen, device=device)
        with _paths(plain):
            state, met = step(state, tok, lab)
        mets.append({k: float(v) for k, v in met.items()})
        if plain:
            del state
        else:
            kernel_state = state
    rel = {k: abs(mets[0][k] - mets[1][k]) / abs(mets[1][k])
           for k in ("loss", "gnorm")}
    print(f"phase 12b one float32 step, kernel path {mets[0]} against plain "
          f"path {mets[1]}: relative {rel} (limit {TRAIN_PATH_TOL}) "
          f"[{card}]", flush=True)
    if max(rel.values()) > TRAIN_PATH_TOL:
        raise AssertionError(f"kernel step against plain step: {rel}")
    repeat = [mets[0]["loss"]]
    for _ in range(TRAIN_REPEAT_STEPS - 1):
        kernel_state, met = step(kernel_state, tok, lab)
        repeat.append(float(met["loss"]))
    lower = sum(b < a for a, b in zip(repeat, repeat[1:]))
    print(f"phase 12b one repeated batch, lr {TRAIN_REPEAT_LR}: losses "
          f"{repeat}; {lower} of {len(repeat) - 1} steps lowered it",
          flush=True)
    if lower < TRAIN_REPEAT_LOWER:
        raise AssertionError(f"repeated batch: {lower} steps lowered the "
                             f"loss {repeat}")
    del kernel_state
    _free_card()

    # (c) a crash in the middle, resumed from the checkpoint, against the
    # uninterrupted run, at depth TRAIN_RESUME_DEPTH
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_RESUME_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--layers", str(TRAIN_RESUME_DEPTH), "--ckpt-every",
            str(TRAIN_RESUME_EVERY), "--log-every", "1"]
    crashed = []

    def crash(step, metrics):
        if step == TRAIN_RESUME_CRASH and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = []
    try:
        for hook in (None, crash):
            tmp = tempfile.mkdtemp(prefix="train-resume-")
            try:
                runs.append(train_main(argv + ["--ckpt-dir", tmp],
                                       step_hook=hook))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    clean, resumed = runs
    a = dict(resumed["state"]["params"].named_parameters())
    worst, bitwise = 0.0, True
    with torch.no_grad():
        for name, p in clean["state"]["params"].named_parameters():
            worst = max(worst, float((a[name] - p).norm() /
                                     p.norm().clamp(min=1e-30)))
            bitwise &= torch.equal(a[name], p)
    final = TRAIN_RESUME_STEPS - 1
    loss_rel = abs(resumed["losses"][final] - clean["losses"][final]) / \
        abs(clean["losses"][final])
    print(f"phase 12c {TRAIN_ARCH} at depth {TRAIN_RESUME_DEPTH} (full width "
          f"and vocab): crash at step {crashed}, resumed from "
          f"{resumed['resumed']}; final loss {resumed['losses'][final]} "
          f"against uninterrupted {clean['losses'][final]} (relative "
          f"{loss_rel:.3e}); parameters' worst relative L2 {worst:.3e} "
          f"(limit {TRAIN_RESUME_TOL}), bitwise {bitwise}, under "
          f"torch.use_deterministic_algorithms(True, warn_only=True) "
          f"[{card}]", flush=True)
    if crashed != [TRAIN_RESUME_CRASH] or \
            resumed["resumed"] != [TRAIN_RESUME_CRASH // TRAIN_RESUME_EVERY
                                   * TRAIN_RESUME_EVERY]:
        raise AssertionError(f"crash {crashed}, resumed {resumed['resumed']}")
    if max(worst, loss_rel) > TRAIN_RESUME_TOL or not np.isfinite(worst):
        raise AssertionError(f"resumed run {worst}, {loss_rel} from the "
                             f"uninterrupted one")
    del runs, clean, resumed, a
    _free_card()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return {"flash_attention": counts["flash_attention"]}


# -- phase 13: tensor-parallel serving on four ranks sharing the card ------

def _tp_config(arch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if TP_DEPTH.get(arch):
        cfg = dataclasses.replace(cfg, n_layers=TP_DEPTH[arch])
    return cfg


def _tp_serve(cfg, params, tokens, steps, decode_steps=TP_DECODE) -> dict:
    """One prefill of ``tokens`` and ``decode_steps`` greedy decode steps
    through ``steps`` (a ``make_serve_steps`` triple); the launch counts of
    the prefill and of the decode steps, each step's CUDA-event ms, the
    collectives of the prefill and of a decode step (calls and bytes put
    in, by verb), the last-token logits of every step (numpy) and the
    greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import sharding
    prefill, decode, init_cache = steps
    cache = init_cache()
    registry.reset_launches()
    sharding.CALLS.clear()
    logits, toks, ms = [], [], []

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        return out

    lg, cache = timed(prefill, params, tokens, cache)
    pf_counts = registry.launches()
    pf_calls = dict(sharding.CALLS)
    sharding.CALLS.clear()
    for i in range(decode_steps + 1):
        logits.append(lg.cpu().numpy())
        nxt = lg.argmax(-1)
        toks.append(nxt.cpu().numpy())
        if i == decode_steps:
            break
        lg, cache = timed(decode, params, nxt[:, None], cache,
                          tokens.shape[1] + i)
    after = registry.launches()
    return {"prefill_counts": {k: v for k, v in pf_counts.items() if v},
            "decode_counts": {k: after[k] - pf_counts[k] for k in after
                              if after[k] != pf_counts[k]},
            "prefill_calls": pf_calls,
            "decode_calls": {k: v / decode_steps
                             for k, v in sharding.CALLS.items()},
            "prefill_ms": ms[0], "decode_ms": ms[1:], "logits": logits,
            "tokens": np.stack(toks, axis=1)}


def _tp_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (TP_BATCH, TP_PROMPT))


def tp_rank(env) -> list:
    """One rank of phase 13: every run of ``TP_RUNS`` on its mesh, this
    rank's shards made leaf by leaf from the seed (``init_shards``);
    results as numpy (rank 0 alone returns logits)."""
    import torch
    from repro_torch.launch.mesh import expert_pad_for
    from repro_torch.models import sharding, transformer
    from repro_torch.serve import make_serve_steps
    meshes = {shape: env.group(shape, TP_AXES)
              for shape in dict.fromkeys(s for _, s in TP_RUNS)}
    out = []
    for arch, shape in TP_RUNS:
        comm = meshes[shape]
        cfg = _tp_config(arch)
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=comm.device)
        gen.manual_seed(0)
        pad = expert_pad_for(cfg, comm)
        whole = transformer.Transformer(cfg, device="meta", expert_pad=pad)
        mesh_shape = comm.group.mesh_shape
        t0 = time.perf_counter()
        params = sharding.init_shards(cfg, comm, gen, expert_pad=pad)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        steps = make_serve_steps(cfg, comm, max_len=TP_MAX_LEN,
                                 batch=TP_BATCH)
        tokens = torch.from_numpy(_tp_prompts(cfg)).to(comm.device)
        # warm-up (cuBLAS, the allocator, the groups' first collectives)
        prefill, _, init_cache = steps
        prefill(params, tokens[:, :64], init_cache())
        torch.cuda.synchronize()
        res = _tp_serve(cfg, params, tokens, steps)
        res.update(rank=comm.rank, arch=arch, shape=shape, init_s=init_s,
                   coords=comm.group.coords,
                   param_bytes=sharding.param_bytes(params),
                   spec_bytes=sharding.spec_bytes(cfg, whole, mesh_shape),
                   stacked_bytes=sharding.stacked_replicated_bytes(
                       cfg, whole, mesh_shape),
                   peak=torch.cuda.max_memory_allocated())
        if comm.rank != 0:
            res["logits"] = None
        out.append(res)
        del params, steps, prefill, init_cache
    return out


def _tp_reference(device, arch) -> dict:
    """The one-rank steps of ``arch`` on the whole model (seeded 0, as the
    ranks' shards), with the same warm-up, prompts and decode steps."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import make_serve_steps
    cfg = _tp_config(arch)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    steps = make_serve_steps(cfg, max_len=TP_MAX_LEN, batch=TP_BATCH,
                             device=device)
    tokens = torch.from_numpy(_tp_prompts(cfg)).to(device)
    prefill, _, init_cache = steps
    prefill(params, tokens[:, :64], init_cache())
    torch.cuda.synchronize()
    res = _tp_serve(cfg, params, tokens, steps)
    res["peak"] = torch.cuda.max_memory_allocated()
    res["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in params.parameters())
    del params, steps, prefill, init_cache
    _free_card()
    return res


def _calls_line(calls) -> str:
    verbs = [k for k in calls if not k.endswith("_bytes")]
    return ", ".join(f"{k} {calls[k]:g} ({calls[k + '_bytes'] / 1e6:.3f} MB)"
                     for k in sorted(verbs))


def _first_flip(ref, got, logits, tol):
    """None when the greedy tokens agree; else (step, row, near_tie): the
    first step that differs and whether the reference's logits there put
    the two tokens within ``tol`` (relative to the row's norm)."""
    import numpy as np
    diff = np.argwhere(ref != got)
    if not len(diff):
        return None
    row, step = (int(x) for x in diff[np.lexsort((diff[:, 0],
                                                  diff[:, 1]))][0])
    lg = logits[step][row]
    gap = abs(lg[ref[row, step]] - lg[got[row, step]])
    return step, row, bool(gap <= tol * np.linalg.norm(lg))


def phase_tp(device, card) -> int:
    """Phase 13: LM serving with the weights and KV caches split over a
    (data, model) mesh of four ranks sharing the card (see the module's
    docstring); returns rank 0's flash attention launches."""
    import numpy as np
    from repro_torch.core import run_ranks
    from repro_torch.models import transformer
    t_phase = time.perf_counter()
    refs = {}
    for arch in dict.fromkeys(a for a, _ in TP_RUNS):
        t0 = time.perf_counter()
        refs[arch] = _tp_reference(device, arch)
        r = refs[arch]
        print(f"phase 13 one rank {arch} ({_tp_config(arch).n_layers} "
              f"layers, float32): parameters {r['param_bytes'] / 1e9:.3f} "
              f"GB, peak memory {r['peak'] / 1e9:.3f} GB; prefill "
              f"({TP_BATCH} x {TP_PROMPT}) {r['prefill_ms']:.3f} ms, decode "
              f"ms per token mean {np.mean(r['decode_ms']):.3f}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP_RANKS, backend="gloo", shared_card=True,
                      timeout=TP_TIMEOUT_S)
    print(f"phase 13: {TP_RANKS} ranks sharing the card over gloo, "
          f"{time.perf_counter() - t0:.1f} s for the ranks' whole run, "
          f"start-up included; the collectives are staged through the host "
          f"on one shared card, so these times measure that staging, not "
          f"four cards [{card}]", flush=True)
    flash = 0
    for i, (arch, shape) in enumerate(TP_RUNS):
        cfg = _tp_config(arch)
        runs = [r[i] for r in ranks]
        r0, ref = runs[0], refs[arch]
        n_attn = sum(k in ATTN for k, _ in transformer.unrolled_sigs(cfg))
        tag = f"phase 13 {arch} on {dict(zip(TP_AXES, shape))}"
        for r in runs:
            if r["prefill_counts"] != {"flash_attention": n_attn} or \
                    r["decode_counts"]:
                raise AssertionError(
                    f"{tag} rank {r['rank']}: prefill launches "
                    f"{r['prefill_counts']}, decode {r['decode_counts']}; "
                    f"want {n_attn} flash_attention a prefill, none in "
                    f"decode")
            if r["param_bytes"] != r["spec_bytes"]:
                raise AssertionError(f"{tag} rank {r['rank']}: "
                                     f"{r['param_bytes']} parameter bytes, "
                                     f"the spec's {r['spec_bytes']}")
            if not np.array_equal(r["tokens"], r0["tokens"]):
                raise AssertionError(f"{tag}: ranks disagree on tokens")
        flash += r0["prefill_counts"]["flash_attention"]
        rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
               for a, b in zip(r0["logits"], ref["logits"])]
        flip = _first_flip(ref["tokens"], r0["tokens"], ref["logits"],
                           LM_PATH_TOL_F32)
        print(f"{tag}: last-token logits against one rank, relative L2 "
              f"prefill {rel[0]:.3e}, decode max {max(rel[1:]):.3e} (limit "
              f"{LM_PATH_TOL_F32}); greedy tokens ({TP_BATCH} x "
              f"{TP_DECODE + 1}) "
              f"{'equal' if flip is None else f'first differ at step {flip[0]} row {flip[1]} (near tie: {flip[2]})'}",
              flush=True)
        print(f"{tag}: parameter bytes a rank {[r['param_bytes'] for r in runs]}"
              f" (the spec's: the JAX layout's slices "
              f"{r0['spec_bytes'] - r0['stacked_bytes']} and "
              f"{r0['stacked_bytes']} of stacked norms replicated over "
              f"data) against {ref['param_bytes']} on one rank; peak memory a rank (max_memory_allocated) "
              f"{[round(r['peak'] / 1e9, 3) for r in runs]} GB against "
              f"{ref['peak'] / 1e9:.3f} on one rank; shards made in "
              f"{[round(r['init_s'], 2) for r in runs]} s [{card}]",
              flush=True)
        print(f"{tag}: prefill ms a rank {[round(r['prefill_ms'], 3) for r in runs]}"
              f" against {ref['prefill_ms']:.3f} on one rank; decode ms per "
              f"token a rank {[round(float(np.mean(r['decode_ms'])), 3) for r in runs]}"
              f" against {np.mean(ref['decode_ms']):.3f} [{card}; gloo, "
              f"host-staged, one shared card]", flush=True)
        print(f"{tag}: collectives (rank 0; calls, and MB this rank put "
              f"in): a prefill {_calls_line(r0['prefill_calls'])}; a decode "
              f"step {_calls_line(r0['decode_calls'])}", flush=True)
        if max(rel) > LM_PATH_TOL_F32 or (flip is not None and
                                          not flip[2]):
            raise AssertionError(f"{tag}: logits {rel}, tokens {flip}")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; "
          f"flash_attention launches (rank 0) {flash} [{card}]", flush=True)
    return flash


# -- phase 14: sharded training and the recurrent archs' sharded steps ------

def _sh_config(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), compute_dtype="float32",
                               n_layers=SH_LAYERS[arch])


def _sh_tokens(cfg, arch):
    """(tokens, labels) numpy from ``default_rng(0)``: the train batch (the
    recurrent archs' prompts)."""
    import numpy as np
    rows, seq = (SH_BATCH, SH_SEQ) if arch == "qwen3-0.6b" else \
        (SH_REC_BATCH, SH_REC_PROMPT)
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (rows, seq))
    return tok, np.roll(tok, -1, 1)


def _sh_now(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _sh_peak(device) -> float:
    import torch
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else float("nan")


def _sh_reset(device) -> None:
    import torch
    if device.type == "cuda":
        _free_card()
        torch.cuda.reset_peak_memory_stats(device)


def _sh_run(arch, state, step_fn, tokens, labels, device, well=None):
    """``SH_STEPS[arch]`` steps on one batch: each step's metrics, ms
    (host clock around a synchronised step), kernel launches and the
    collectives of ``models.sharding.CALLS``; the parameters before the
    last step; with ``well`` (name -> bool tensor) the elements whose
    AdamW update stayed well conditioned, updated in place."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import sharding
    tok = torch.from_numpy(tokens).to(device)
    lab = torch.from_numpy(labels).to(device)
    out = {"metrics": [], "ms": [], "launches": [], "calls": []}
    for i in range(SH_STEPS[arch]):
        if i == SH_STEPS[arch] - 1:
            out["before"] = {n: p.detach().clone() for n, p in
                             state["params"].named_parameters()}
        registry.reset_launches()
        sharding.CALLS.clear()
        t0 = _sh_now(device)
        state, met = step_fn(state, tok, lab)
        out["ms"].append((_sh_now(device) - t0) * 1e3)
        out["launches"].append({k: v for k, v in registry.launches().items()
                                if v})
        out["calls"].append(dict(sharding.CALLS))
        out["metrics"].append({k: float(v) for k, v in met.items()})
        if well is not None:
            bc1 = 1 - 0.9 ** (i + 1)
            for n, m in state["opt"]["m"].items():
                well[n] &= (m / bc1).abs() >= SH_COND_FLOOR
    return out


def _sh_reference(device, arch, path) -> dict:
    """One rank's run of ``arch`` (the serve steps of a recurrent arch, then
    the train steps) on the whole model, seeded 0 as the ranks' shards;
    the final parameters, AdamW's first moments and the parameters'
    well-conditioned elements are saved to ``path`` for the ranks to hold
    their shards against."""
    import torch
    from repro_torch.serve import make_serve_steps
    from repro_torch.train import make_train_state, make_train_step
    cfg = _sh_config(arch)
    _sh_reset(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = make_train_state(cfg, gen, device=device)
    tokens, labels = _sh_tokens(cfg, arch)
    res = {}
    if arch != "qwen3-0.6b":
        steps = make_serve_steps(cfg, max_len=SH_REC_MAX_LEN,
                                 batch=SH_REC_BATCH, device=device)
        tok = torch.from_numpy(tokens).to(device)
        steps[0](state["params"], tok[:, :64], steps[2]())      # warm-up
        res["serve"] = _tp_serve(cfg, state["params"], tok, steps,
                                 SH_REC_DECODE)
    well = {n: torch.ones(p.shape, dtype=torch.bool, device=device)
            for n, p in state["params"].named_parameters()}
    res.update(_sh_run(arch, state, make_train_step(
        cfg, remat=False, **SH_TRAIN_KW), tokens, labels, device, well))
    res["peak"] = _sh_peak(device)
    res["bytes"] = sum(t.numel() * t.element_size() for t in (
        list(state["params"].parameters()) +
        list(state["opt"]["m"].values()) + list(state["opt"]["v"].values())))
    del res["before"]
    torch.save({"params": {n: p.detach().cpu() for n, p in
                           state["params"].named_parameters()},
                "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
                "well": {n: t.cpu() for n, t in well.items()}}, path)
    del state, well
    _sh_reset(device)
    return res


def _sh_compare(cfg, state, init, before, lr, t, path, group) -> dict:
    """This rank's shards after ``t`` steps against the one-rank run saved
    at ``path``, leaf by leaf: the worst of each rule as a share of its
    bound (1 is the bound: the update rule on the well-conditioned
    parameter elements and on every element of ``m``, every parameter
    element against AdamW's update of the shard's own moments), the
    elements left out as ill conditioned, and the worst well-conditioned
    parameter element."""
    import torch
    from repro_torch.models.sharding import local_slices
    from repro_torch.train.trainer import decay_mask
    ref = torch.load(path, mmap=True, weights_only=True)
    decay = decay_mask(cfg, state["params"])
    dev = group.device
    out = {"update": 0.0, "element": 0.0, "m": 0.0, "adamw": 0.0, "ill": 0,
           "elements": 0}

    def rule(have, want, old):
        moved = float(torch.linalg.vector_norm(want - old))
        diff = have - want
        return (float(torch.linalg.vector_norm(diff)) /
                max(SH_UPDATE_TOL * moved, 1e-30),
                float(diff.abs().max()) if diff.numel() else 0.0)

    bc1, bc2 = 1 - 0.9 ** t, 1 - 0.95 ** t
    with torch.no_grad():
        for name, p in state["params"].named_parameters():
            cut = local_slices(ref["params"][name].shape, p.pspec, group)
            want = ref["params"][name][cut].to(dev)
            well = ref["well"][name][cut].to(dev)
            m, v = state["opt"]["m"][name], state["opt"]["v"][name]
            r, e = rule(m, ref["m"][name][cut].to(dev), 0.0 * m)
            out["m"] = max(out["m"], r, e / SH_ELEMENT_TOL)
            r, e = rule(p[well], want[well], init[name][well])
            out["update"] = max(out["update"], r)
            out["element"] = max(out["element"], e)
            out["ill"] += int((~well).sum())
            out["elements"] += p.numel()
            b = before[name]
            delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
            if decay[name]:
                delta = delta + 0.1 * b
            own = b - lr * delta
            out["adamw"] = max(out["adamw"], float(
                ((p - own).abs() / (SH_ADAM_TOL * (own.abs() + lr))).max()))
    return out


def sh_rank(env, paths) -> list:
    """One rank of phase 14: every run of ``SH_RUNS`` on its mesh, this
    rank's shards made leaf by leaf from the seed (``make_train_state(
    mesh=)``); results as numpy and numbers (rank 0 alone returns
    logits)."""
    import torch
    from repro_torch.models import sharding, transformer
    from repro_torch.serve import make_serve_steps
    from repro_torch.train import make_train_state, make_train_step
    meshes = {shape: env.group(shape, TP_AXES)
              for shape in dict.fromkeys(s for _, s in SH_RUNS)}
    out = []
    for arch, shape in SH_RUNS:
        comm = meshes[shape]
        dev = comm.device
        cfg = _sh_config(arch)
        _sh_reset(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t0 = _sh_now(dev)
        state = make_train_state(cfg, gen, mesh=comm)
        res = {"rank": comm.rank, "coords": comm.group.coords,
               "init_s": _sh_now(dev) - t0}
        tokens, labels = _sh_tokens(cfg, arch)
        if arch != "qwen3-0.6b":
            steps = make_serve_steps(cfg, comm, max_len=SH_REC_MAX_LEN,
                                     batch=SH_REC_BATCH)
            tok = torch.from_numpy(tokens).to(dev)
            steps[0](state["params"], tok[:, :64], steps[2]())  # warm-up
            res["serve"] = _tp_serve(cfg, state["params"], tok, steps,
                                     SH_REC_DECODE)
            if comm.rank != 0:
                res["serve"]["logits"] = None
            del steps
        init = {n: p.detach().clone() for n, p in
                state["params"].named_parameters()}
        res.update(_sh_run(arch, state, make_train_step(
            cfg, mesh=comm, remat=False, **SH_TRAIN_KW), tokens, labels,
            dev))
        res["peak"] = _sh_peak(dev)
        whole = transformer.Transformer(cfg, device="meta")
        res["bytes"] = sharding.param_bytes(state["params"]) + sum(
            t.numel() * t.element_size() for k in ("m", "v")
            for t in state["opt"][k].values())
        res["spec_bytes"] = sharding.spec_bytes(cfg, whole,
                                                comm.group.mesh_shape)
        res["compare"] = _sh_compare(cfg, state, init, res.pop("before"),
                                     res["metrics"][-1]["lr"],
                                     SH_STEPS[arch], paths[arch], comm.group)
        out.append(res)
        del state, init
    return out


def phase_sharded(device, card) -> dict[str, int]:
    """Phase 14: the sharded train step and the recurrent archs' sharded
    steps on four ranks sharing the card (see the module's docstring);
    returns rank 0's launches of the LM kernels over the phase."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core import run_ranks
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="sharded-ref-"))
    try:
        refs, paths = {}, {}
        for arch in dict.fromkeys(a for a, _ in SH_RUNS):
            t0 = time.perf_counter()
            paths[arch] = str(tmp / f"{arch}.pt")
            refs[arch] = r = _sh_reference(device, arch, paths[arch])
            print(f"phase 14 one rank {arch} ({SH_LAYERS[arch]} layers, "
                  f"float32): params + m + v {r['bytes'] / 1e9:.3f} GB, peak "
                  f"memory {r['peak'] / 1e9:.3f} GB; train step ms "
                  f"{[round(x, 1) for x in r['ms']]}; "
                  f"{time.perf_counter() - t0:.1f} s with the reference "
                  f"saved [{card}]", flush=True)
        t0 = time.perf_counter()
        on_card = device.type == "cuda"
        ranks = run_ranks(sh_rank, TP_RANKS, backend="gloo",
                          shared_card=on_card,
                          device=None if on_card else "cpu", args=(paths,),
                          timeout=SH_TIMEOUT_S)
        print(f"phase 14: {TP_RANKS} ranks sharing the card over gloo, "
              f"{time.perf_counter() - t0:.1f} s for the ranks' whole run, "
              f"start-up included; the collectives are staged through the "
              f"host on one shared card, so these times measure that "
              f"staging, not four cards [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = dict.fromkeys(SH_KERNELS, 0)
    for i, (arch, shape) in enumerate(SH_RUNS):
        runs = [r[i] for r in ranks]
        r0, ref = runs[0], refs[arch]
        tag = f"phase 14 {arch} on {dict(zip(TP_AXES, shape))}"
        for r in runs:
            for step, (got, want) in enumerate(zip(r["metrics"],
                                                   ref["metrics"])):
                for k in ("loss", "gnorm", "nll", "aux"):
                    if abs(got[k] - want[k]) > SH_STEP_TOL * max(
                            abs(want[k]), 1e-30):
                        raise AssertionError(
                            f"{tag} rank {r['rank']} step {step}: {k} "
                            f"{got[k]} against one rank's {want[k]}")
                if got["lr"] != want["lr"]:
                    raise AssertionError(f"{tag}: lr {got['lr']}")
            if r["launches"] != ref["launches"]:
                raise AssertionError(f"{tag} rank {r['rank']}: launches a "
                                     f"step {r['launches']}, one rank's "
                                     f"{ref['launches']}")
            c = r["compare"]
            if max(c["update"], c["m"], c["adamw"]) > 1 or \
                    c["element"] > SH_ELEMENT_TOL:
                raise AssertionError(f"{tag} rank {r['rank']}: {c}")
            if r["bytes"] != 3 * r["spec_bytes"]:
                raise AssertionError(f"{tag} rank {r['rank']}: {r['bytes']}"
                                     f" bytes of params, m and v, 3 x the "
                                     f"spec's {r['spec_bytes']}")
            if "serve" in r:
                s, sref = r["serve"], ref["serve"]
                if s["prefill_counts"] != sref["prefill_counts"] or \
                        s["decode_counts"]:
                    raise AssertionError(
                        f"{tag} rank {r['rank']}: prefill launches "
                        f"{s['prefill_counts']} (one rank "
                        f"{sref['prefill_counts']}), decode "
                        f"{s['decode_counts']}")
                if not np.array_equal(s["tokens"], r0["serve"]["tokens"]):
                    raise AssertionError(f"{tag}: ranks disagree on tokens")
        if "serve" in r0:
            s, sref = r0["serve"], ref["serve"]
            rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                   for a, b in zip(s["logits"], sref["logits"])]
            flip = _first_flip(sref["tokens"], s["tokens"], sref["logits"],
                               LM_PATH_TOL_F32)
            print(f"{tag} served: last-token logits against one rank, "
                  f"relative L2 prefill {rel[0]:.3e}, decode max "
                  f"{max(rel[1:]):.3e} (limit {LM_PATH_TOL_F32}); greedy "
                  f"tokens ({SH_REC_BATCH} x {SH_REC_DECODE + 1}) "
                  f"{'equal' if flip is None else f'first differ at step {flip[0]} row {flip[1]} (near tie: {flip[2]})'};"
                  f" prefill launches a rank {s['prefill_counts']}, none in "
                  f"decode; prefill ms a rank "
                  f"{[round(r['serve']['prefill_ms'], 3) for r in runs]} "
                  f"against {sref['prefill_ms']:.3f} on one rank, decode ms "
                  f"per token {[round(float(np.mean(r['serve']['decode_ms'])), 3) for r in runs]}"
                  f" against {np.mean(sref['decode_ms']):.3f} [{card}; "
                  f"gloo, host-staged, one shared card]", flush=True)
            print(f"{tag} served: collectives (rank 0) a prefill "
                  f"{_calls_line(s['prefill_calls'])}; a decode step "
                  f"{_calls_line(s['decode_calls'])}", flush=True)
            if max(rel) > LM_PATH_TOL_F32 or (flip is not None and
                                              not flip[2]):
                raise AssertionError(f"{tag}: logits {rel}, tokens {flip}")
            for k, v in s["prefill_counts"].items():
                counts[k] = counts.get(k, 0) + v
        for step in r0["launches"]:
            for k, v in step.items():
                counts[k] = counts.get(k, 0) + v
        worst = {k: max(r["compare"][k] for r in runs)
                 for k in ("update", "element", "m", "adamw")}
        ill = sum(r["compare"]["ill"] for r in runs)
        n = sum(r["compare"]["elements"] for r in runs)
        print(f"{tag}: {SH_STEPS[arch]} train steps; loss "
              f"{[round(m['loss'], 6) for m in r0['metrics']]} against one "
              f"rank's {[round(m['loss'], 6) for m in ref['metrics']]}, "
              f"gnorm {[round(m['gnorm'], 6) for m in r0['metrics']]} "
              f"against {[round(m['gnorm'], 6) for m in ref['metrics']]} "
              f"(limit {SH_STEP_TOL} relative); after the steps, shards "
              f"against one rank's slices as a share of each bound (1 is "
              f"the bound): parameters' update {worst['update']:.3f}, m "
              f"{worst['m']:.3f}, AdamW of the shard's own moments "
              f"{worst['adamw']:.3f}, worst parameter element "
              f"{worst['element']:.3e} (limit {SH_ELEMENT_TOL}); {ill} of "
              f"{n} parameter elements ill conditioned (|m^| < "
              f"{SH_COND_FLOOR}) left out of the parameters' rule "
              f"[{card}]", flush=True)
        print(f"{tag}: launches a step a rank {r0['launches'][-1]} (one "
              f"rank {ref['launches'][-1]}); params + m + v bytes a rank "
              f"{[r['bytes'] for r in runs]} (3 x the spec's "
              f"{r0['spec_bytes']}) against {ref['bytes']} on one rank; "
              f"peak memory a rank (max_memory_allocated) "
              f"{[round(r['peak'] / 1e9, 3) for r in runs]} GB against "
              f"{ref['peak'] / 1e9:.3f} on one rank (autograd keeps the "
              f"gathered weights for the backward); shards made in "
              f"{[round(r['init_s'], 2) for r in runs]} s [{card}]",
              flush=True)
        print(f"{tag}: train step ms a rank "
              f"{[[round(x, 1) for x in r['ms']] for r in runs]} against "
              f"{[round(x, 1) for x in ref['ms']]} on one rank [{card}; "
              f"gloo, host-staged, one shared card]", flush=True)
        print(f"{tag}: collectives of the last step (rank 0; calls, and MB "
              f"this rank put in; the backward's are .bwd, the step's own "
              f"reductions .step) {_calls_line(r0['calls'][-1])}",
              flush=True)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; launches "
          f"(rank 0) {counts} [{card}]", flush=True)
    return counts


# -- phase 15: the dry run against the card ---------------------------------

def _dry_overrides(layers=None) -> dict:
    out = {"compute_dtype": "float32"}
    if layers is not None:
        out["n_layers"] = layers
    return out


def _dry_cost(shape, mesh_shape, *, act_sp, layers=None, remat=False):
    """The dry cell of ``DRY_ARCH`` at ``shape`` on a dry mesh of
    ``mesh_shape`` (float32), traced on the first and the last rank."""
    from repro_torch.core import Communicator, DeviceGroup
    from repro_torch.launch.costing import cell_cost
    return cell_cost(DRY_ARCH, shape, lambda r: Communicator(
        DeviceGroup.dry(mesh_shape, TP_AXES, r)), act_sp=act_sp,
        remat=remat, overrides=_dry_overrides(layers))


def dry_sp_rank(env, layers, seq, batch) -> list:
    """One rank of phase 15c: phase 14's qwen3-0.6b step (``layers``
    deep, ``batch`` x ``seq`` tokens) on (1, 4) from the seed, without and
    with sequence parallelism: the record, the metrics and the peak
    memory of each."""
    import numpy as np
    import torch
    from repro_torch.core import comm as C
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.costing import record_key
    comm = env.group(DRY_SP_MESH, TP_AXES)
    out = []
    for act_sp in (False, True):
        dev = comm.device
        _sh_reset(dev)
        cell, _ = build_cell(DRY_ARCH, (seq, batch, "train"), comm,
                             act_sp=act_sp, remat=False,
                             overrides=_dry_overrides(layers))
        tok = np.random.default_rng(0).integers(0, cell.cfg.vocab,
                                                (batch, seq))
        lab = np.roll(tok, -1, 1)
        state = cell.args[0]
        with C.record() as log:
            state, met = cell.step(state, torch.from_numpy(tok),
                                   torch.from_numpy(lab), None)
        out.append({"record": record_key(log), "act": cell.act_sharding,
                    "loss": float(met["loss"]), "gnorm": float(met["gnorm"]),
                    "peak": _sh_peak(dev)})
        del cell, state
    return out


def phase_dryrun(device, card) -> None:
    """Phase 15 (see the module's docstring)."""
    t_phase = time.perf_counter()
    dry_production(card)
    dry_one_card(device, card)
    dry_sharded(card)
    secs = time.perf_counter() - t_phase
    print(f"phase 15: {secs:.1f} s (limit {DRY_PHASE_S}) [{card}]",
          flush=True)
    if secs > DRY_PHASE_S:
        raise AssertionError(f"phase 15 took {secs:.1f} s")


def dry_production(card) -> None:
    """Phase 15a: the production cells of ``DRY_ARCH``, modelled."""
    import tempfile

    from repro_torch.core import HW
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        dryrun.main(["--arch", DRY_ARCH, "--shape", ",".join(DRY_CELLS),
                     "--mesh", "single", "--out", tmp])
        for shape in DRY_CELLS:
            rec = json.loads(Path(tmp, f"{DRY_ARCH}__{shape}__"
                                  f"{dryrun.MESH_NAMES[False]}.json")
                             .read_text())
            t = rec["roofline"]
            print(f"phase 15a {DRY_ARCH} x {shape} on {rec['mesh']}, "
                  f"modelled on {HW['name']} (core.runtime.HW): dominant "
                  f"{t['dominant']}; compute {t['t_compute_s'] * 1e3:.3f} "
                  f"ms, memory {t['t_memory_s'] * 1e3:.3f} ms, collective "
                  f"{t['t_collective_s'] * 1e3:.3f} ms; peak "
                  f"{rec['peak_bytes'] / 1e9:.3f} GB a rank, fits "
                  f"{rec['fits']}; traced in {rec['cell_s']} s on the host",
                  flush=True)



def dry_one_card(device, card) -> None:
    """Phase 15b: phase 12b's step, dry on a 1 x 1 mesh and on the card,
    without remat and with it (``torch.utils.checkpoint``'s recomputation,
    as every production train cell is traced)."""
    for remat in (False, True):
        _dry_one_card(device, card, remat)


def _dry_one_card(device, card, remat) -> None:
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import HW, Communicator, DeviceGroup
    from repro_torch.core import comm as C
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.costing import record_key, storages
    from repro_torch.launch.roofline import roofline_terms
    shape = (TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    dry = _dry_cost(shape, (1, 1), act_sp=True, remat=remat)
    dry_s = time.perf_counter() - t0
    terms = roofline_terms(dry, dry["colls"], dtype="float32")
    _free_card()
    comm = Communicator(DeviceGroup(0, 1, device, shape=(1, 1),
                                    axes=TP_AXES))
    cell, _ = build_cell(DRY_ARCH, shape, comm, remat=remat,
                         overrides=_dry_overrides())
    tok, lab = TokenPipeline(vocab=cell.cfg.vocab, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, seed=0).batch_at(0)
    tok, lab = (torch.from_numpy(a).to(device) for a in (tok, lab))
    state = cell.step(cell.args[0], tok, lab, None)[0]   # warm-up
    _free_card()
    held = torch.cuda.memory_allocated() - sum(storages(
        list(state["params"].parameters()) +
        [t for k in ("m", "v") for t in state["opt"][k].values()] +
        [state["opt"]["step"], tok, lab]).values())
    torch.cuda.reset_peak_memory_stats()
    with registry.count() as kern, C.record() as log, \
            FlopCounterMode(display=False) as fc:
        state, met = cell.step(state, tok, lab, None)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    real_flops = fc.get_total_flops() + registry.count_totals(kern)["flops"]
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = cell.step(state, tok, lab, None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = min(ms)
    total = torch.cuda.get_device_properties(0).total_memory
    bound_ms = terms["step_time_bound_s"] * 1e3
    rel_peak = (dry["peak_bytes"] - peak) / peak
    print(f"phase 15b {DRY_ARCH} whole ({cell.cfg.n_layers} layers, "
          f"float32, {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{'remat' if remat else 'no remat'}) on a 1 x 1 "
          f"mesh: dry flops {dry['flops']} (kernels {dry['kernel_flops']}) "
          f"against the card's {real_flops}; dry peak "
          f"{dry['peak_bytes'] / 1e9:.3f} GB against max_memory_allocated "
          f"{peak / 1e9:.3f} GB ({held / 1e9:.3f} GB held before the step "
          f"left out; relative {rel_peak:+.4f}, limit {DRY_PEAK_TOL}); "
          f"step {step_ms:.1f} ms measured (best of {ms}) against the "
          f"roofline's {terms['dominant']} bound {bound_ms:.1f} ms, ratio "
          f"{step_ms / bound_ms:.3f}; dry trace {dry_s:.1f} s on the host; "
          f"card memory {total} bytes (core.runtime.HW: {HW['hbm_bytes']}) "
          f"[{card}]", flush=True)
    if real_flops != dry["flops"] or \
            record_key(log) != record_key(dry["record"]):
        raise AssertionError(f"remat={remat}: dry flops {dry['flops']} "
                             f"and record {len(dry['record'])} against the "
                             f"card's {real_flops} and {len(log)}")
    if abs(rel_peak) > DRY_PEAK_TOL:
        raise AssertionError(f"remat={remat}: dry peak {dry['peak_bytes']} "
                             f"against the card's {peak}")
    if step_ms < bound_ms:
        raise AssertionError(f"step {step_ms} ms below its bound {bound_ms}")
    if torch.cuda.get_device_name(0) == HW["name"] and \
            total != HW["hbm_bytes"]:
        raise AssertionError(f"card memory {total} against HW "
                             f"{HW['hbm_bytes']}")
    del cell, state, met
    _free_card()


def dry_sharded(card) -> None:
    """Phase 15c: phase 14's sharded step without and with sequence
    parallelism against its dry cells."""
    from repro_torch.core import run_ranks
    from repro_torch.launch.costing import record_key
    layers, seq, batch = SH_LAYERS[DRY_ARCH], SH_SEQ, SH_BATCH
    t0 = time.perf_counter()
    ranks = run_ranks(dry_sp_rank, TP_RANKS, backend="gloo",
                      shared_card=True, args=(layers, seq, batch),
                      timeout=SH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    for i, act_sp in enumerate((False, True)):
        dry = _dry_cost((seq, batch, "train"), DRY_SP_MESH, act_sp=act_sp,
                        layers=layers)
        same = record_key(dry["record"]) == r0[i]["record"]
        print(f"phase 15c {DRY_ARCH} ({layers} layers, {batch} x {seq}) on "
              f"{dict(zip(TP_AXES, DRY_SP_MESH))}, act_sharding "
              f"{r0[i]['act']}: rank 0's record of {len(r0[i]['record'])} "
              f"collectives equal to the dry cell's {same}; loss "
              f"{r0[i]['loss']}, gnorm {r0[i]['gnorm']}; peak GB a rank "
              f"{[round(r[i]['peak'] / 1e9, 3) for r in ranks]} [{card}]",
              flush=True)
        if not same:
            raise AssertionError(f"act_sp={act_sp}: rank 0's record "
                                 f"{r0[i]['record']} against the dry cell's "
                                 f"{record_key(dry['record'])}")
    rel = {k: abs(r0[1][k] - r0[0][k]) / abs(r0[0][k])
           for k in ("loss", "gnorm")}
    print(f"phase 15c sequence parallelism against none: relative {rel} "
          f"(limit {DRY_SP_TOL}); ranks {ranks_s:.1f} s", flush=True)
    if max(rel.values()) > DRY_SP_TOL:
        raise AssertionError(f"sequence parallelism changed the step: {rel}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.nlinv import phantom

    device = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    # each phase's seconds, printed as it ends and all together before the
    # kernels line, so that a run shows where its time limit goes
    t_start = time.perf_counter()
    secs: dict[str, float] = {}
    t_last = [t_start]

    def mark(name):
        now = time.perf_counter()
        secs[name] = round(now - t_last[0], 1)
        t_last[0] = now
        print(f"phase {name}: {secs[name]} s", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s "
          f"(compiled this run: {_build.build_seconds is not None})",
          flush=True)
    print(lib.with_suffix(".log").read_text(), flush=True)
    mark("1 build")

    rows = phase_kernels(device, card)
    flash_row = next(r for r in rows if r["name"] == "flash_attention")
    flash_row["mla"], flash_row["causal_gqa"] = phase_lm_features(device,
                                                                  card)
    mark("2 kernels")

    t0 = time.perf_counter()
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=FRAMES, seed=0)
    print(f"dataset: {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    counts, one_rank = phase_main_path(device, card, data)
    mark("3 main path")
    phase_parity(device, card, data)
    mark("4 parity")
    radial_counts, radial0 = phase_radial(device, card, data)
    counts.update(radial_counts)
    mark("5 radial")
    counts.update(phase_lm(device, card, LM_ARCH, LM_PROMPTS, LM_MAX_NEW))
    mark("6 recurrentgemma-2b")
    counts.update(phase_lm(device, card, XLSTM_ARCH, XLSTM_PROMPTS,
                           XLSTM_MAX_NEW))
    mark("7 xlstm-350m")
    dist_counts, dist = phase_multirank(device, card, data, one_rank)
    counts.update(dist_counts)
    mark("8 multi-rank")
    counts["masked_sum"] += phase_schedules(device, card, data, one_rank,
                                            dist, radial0)
    mark("8b schedules")
    phase_pipeline(device, card, data, one_rank)
    mark("9a pipeline")
    t0 = time.perf_counter()
    datas = [data] + [phantom.make_dataset(n=N, ncoils=NCOILS,
                                           nspokes=SPOKES, frames=FRAMES,
                                           seed=s) for s in SERVE_SEEDS[1:]]
    print(f"service datasets: {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    fused_ticks = phase_service(device, card, datas)
    mark("9b service")
    t0 = time.perf_counter()
    chaos_datas = datas + [phantom.make_dataset(
        n=N, ncoils=NCOILS, nspokes=SPOKES, frames=FRAMES, seed=s)
        for s in CHAOS_SEEDS[len(datas):]]
    print(f"chaos datasets: {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    for name, n in phase_unfused_batched(device, card, chaos_datas,
                                         fused_ticks).items():
        counts[name] += n
    mark("9c unfused")
    phase_tune(device, card, chaos_datas)
    mark("9e tune")
    phase_quickstart(card)
    mark("9d quickstart")
    phase_chaos(device, card, chaos_datas)
    mark("10a chaos")
    counts["masked_sum"] += phase_remesh(device, card,
                                         datas[:REMESH_CLIENTS])
    mark("10b remesh")
    counts["flash_attention"] += phase_configs(device, card)[
        "flash_attention"]
    mark("11 configs")
    counts["flash_attention"] += phase_train(device, card)[
        "flash_attention"]
    mark("12 training")
    counts["flash_attention"] += phase_tp(device, card)
    mark("13 tensor-parallel")
    for name, n in phase_sharded(device, card).items():
        counts[name] += n
    mark("14 sharded")
    phase_dryrun(device, card)
    mark("15 dry run")
    for row in rows:
        row["launches"] = counts[row["name"]]

    print(f"phase seconds: {json.dumps(secs)}; total "
          f"{time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
