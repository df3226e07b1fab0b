#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``,
   the ``ptxas`` register / spill report of each kernel, and the count
   of tensor-core MMA instructions (``HMMA``/``HGMMA``, and the 1-bit
   ``BMMA``/``BGMMA``) in each kernel's SASS (``cuobjdump -sass``): a bf16
   flash attention instantiation without HMMA, or an ``xnor_gemm_kernel``
   instantiation without BMMA, fails the run;
2b. the card tests, ``pytest -m cuda tests/test_torch_cuda.py`` in a
   child process: each kernel against its plain version over more
   shapes than the phases below (flash attention at head dims
   32/64/112/128,
   GQA groups 1/2/7, ragged S, strided views with an offset, the
   alignment refusal; ``segment_cuda`` at B 1/8/16/33 on both paper
   nets and three spans); any failure fails the run;
3. kernel 1, ``xnor_gemm_cuda``: all 7 aspect configurations and the
   3 registered tile variants (``cuda_p16n64``, ``cuda_p32n64``,
   ``cuda_p64n32``) at every
   CIFAR-10 and Fashion-MNIST GEMM shape, B in {1, 8, 16, 33}, plus a
   ragged shape (P, N no tile multiples, Kw = 5), on random words and on
   all-zero and all-one words, each ``torch.equal`` to the plain
   ``xnor_gemm_ref`` on the same inputs;
4. kernel 2, ``segment_cuda``: the whole CIFAR-10 net, a tail span that
   starts at a step and a mid span that starts at a max-pool, B in
   {1, 8, 16, 33} (33 is no multiple of any tile), each ``torch.equal``
   to the plain ``_run_chain``;
4a. kernel 3, ``flash_attention_cuda``: the cases of
   ``tests/test_kernels_attention.py`` (causal and full), the qwen2-0.5B
   prefill shape, a ragged S and Sq = 1 against Sk = 2048, each held to
   the plain ``flash_attention_plain`` (f32 at 1e-4: only the order of
   the f32 sums differs; bf16 at 2e-2, the JAX bf16 test's tolerance:
   the tensor-core path rounds P to bf16 for P.V, an error of the size
   of the bf16 output's own rounding), bf16 at head dims 32, 64, 112,
   128 (f32 at 112 too), the deepseek-moe-16b and zamba2-7b prefill
   shapes, and phase 4e's: qwen2.5-14b (GQA group 5) and grok-1 (group
   6) at D 128, llava-next-mistral-7b's S 2,624 (576 frontend embeds
   ahead of 2,048 tokens) and musicgen-medium's 2,112 at MHA 24 / D 64,
   Sq 1 against Sk 2,048 at group 5, and f32 at groups 5 and 6;
4b. LM serving at full width: qwen2-0.5B (24 layers, d_model 896) with
   random weights from a seeded generator on the card.  An f32 check
   (B 2 x S 256: last-position logits through the kernel against the
   same forward with the plain attention, relative max error <= 1e-4),
   then the bf16 serve: ``greedy_decode`` of 32 tokens from 4 x
   2048-token prompts (NumPy seed 0), the teacher-forced decode logits
   against a full forward with the plain attention, and one traced
   prefill for the card's idle share;
4c. kernel 3 timing at the qwen2-0.5B, deepseek-moe-16b (D 128),
   zamba2-7b (D 112), qwen2.5-14b, llava-next-mistral-7b (S 2,624),
   musicgen-medium (S 2,112) and grok-1 prefill shapes, each beside its
   bound and
   ``torch.nn.functional.scaled_dot_product_attention`` as the yardstick
   (timed here only; the port never calls it);
4d. the MoE, SSM and hybrid families at full width (``family_phase``),
   one model at a time, each freed before the next: deepseek-moe-16b
   (28 layers, 64 routed experts top-6 + 2 shared), zamba2-7b (81
   Mamba2 layers, 13 shared-block applications at head dim 112) and
   mamba2-130m (24 layers, attention-free), bf16 with seeded random
   weights on the card, each through ``full_width_arch``: f32 checks at
   the deepest depth whose f32 weights (``cfg.n_params()``) and
   activations fit the card's free memory (deepseek at least 12 layers;
   the logits at every position and the residual stream after every
   attention block through the kernel against the plain attention, for
   mamba2-130m the card against CPU tensors; in an MoE every (token,
   layer) top-k set equal on both paths; then the teacher-forced decode
   path against the full forward, under the full forward's routing
   where a tie flipped a top-k set; <= 1e-4), ``greedy_decode`` of 32
   tokens from 4 x 2048-token prompts (``flash_attention_cuda`` must
   launch 28, 13 and 0 times), the teacher-forced bf16 check (an MoE
   under a capacity factor that must drop nothing, held at the positions
   whose routing agreed in every layer; the limit in ``FAMILY_ARCHS``'
   comment), and one traced prefill;
4e. the six attention configurations the card had not served at full
   width (``dense_family_phase``), the same way, cheapest first:
   olmo-1b (non-parametric LayerNorm, tied embeddings), minitron-8b
   (``relu2``, 256,000-row vocab), qwen2.5-14b (GQA group 5, 48 layers;
   its 59 GB of f32 weights checked before the bf16 ones are drawn),
   musicgen-medium (``gelu``, 64 frontend embeds) and
   llava-next-mistral-7b (576 frontend embeds), each with the stub's
   seeded embeds ahead of the prompt through ``greedy_decode``'s
   prefill, and grok-1 cut to 4 of its 64 layers at full width (the cut
   printed); flash launches a prefill 16, 32, 48, 48, 32 and 4; a
   summary line per model with the card's name and power limit;
5. main path at full width: random fp weights from NumPy seed 0 ->
   ``pack_params`` -> measured ``profile_bnn_model`` (through a fresh
   ``ProfileStore("dir://...").get_or_profile``, which saves it) -> DP
   mapping -> ``fuse_mapping`` with ``seg_cuda`` -> a ``ServingEngine``
   answering 32 single-example requests, every answer equal to the plain
   CPU ``forward_packed``;
6. the same traffic served under two forced mappings: all layers
   ``XYZ`` with ``seg_cuda`` over the whole net, and the mixed split
   (conv/fc on the card, elementwise layers on the host); then the same
   traffic once more under each of the three mappings with the profiler
   on, for the card's busy and idle time while serving;
7. kernel timings at the main-path shapes (device time per launch from
   the profiler's trace; CUDA events for the time per call and for the
   plain versions), beside the least time the card could take.  Kernel
   1 under all 7 aspect configurations and the 3 tile variants at every
   conv/fc layer at B 16 and B 1; the card's 1-bit tensor-core rate measured by
   ``xnor_mma_probe_kernel``, and each bound both ways: over that rate
   (the bound the JSON line carries) and over the popc pipe (the bound
   of the rows before the 1-bit product); ``torch._int_mm`` on the same
   dot products unpacked to +-1 int8 as a yardstick only (not the same
   function: 8x the input bytes);
7b. the Bi-Real unit's two kernels (``bireal_unit_phase``):
   ``bireal_patches_cuda`` and ``bireal_epilogue_cuda`` at each of the
   16 unit shapes of Bi-Real Net-18 at 224x224, B 32, each equal to its
   plain version, their device time per launch (the profiler) beside
   their byte bound and the plain versions' time per call (CUDA
   events), printed for stage 1 (56x56x64) and stage 4 (7x7x512) and
   summed over the 16 units;
8. the profile store: a second ``ProfileStore`` on the same root warm
   starts (``get_or_profile`` with a profiler that raises if called
   must return the stored table, equal to phase 5's), its time beside
   phase 5's profile; the DP mapping saved and loaded back;
9. adaptive serving: a ``ServingEngine`` under the DP mapping with
   ``SegmentTelemetry`` and a ``RemapController`` (persisting to the
   store; its detector needs 3 samples, so 5 quiet steps cover a whole
   detection window) serves bursts of 16 requests through ``ctl.step``.
   Calibrate: until no journal entry for 5 steps (at most 60); every
   ``SwapRecord``, and the settled state, is printed with each
   segment's observed p50 against its predicted time (the card's
   per-segment pipeline times).  Contend: through the
   engine's ``_build_pipeline`` seam every device segment first
   busy-waits 10x its calibrated time; a record naming a device segment
   must follow within 20 steps, with ``new_expected_s <=
   old_expected_s``.  Every answer equals the plain CPU
   ``forward_packed``, ``segment_cuda`` must have launched, and a fresh
   store warm-starts the last remapped mapping.  Then the step wall p50
   with telemetry on and off (telemetry's cost on the card);
10. the cache service over a write-back tiered store (memory front, dir
   back): a prewarm job finds the key warm (no profiling, no mapping),
   an explore job re-measures the rows phase 9's traffic never verified
   per layer, timing each layer's ``layer_fn`` with CUDA events on the
   card (``xnor_gemm_cuda`` must launch), and a flush job pushes the
   dirty keys to the back tier;
11. autotune: ``autotune_bnn_model`` measured on the card at batch
   sizes (1, 4, 16), ``prune_factor`` 3.0, on phase 5's weights: every
   GEMM row holds the fixed 8, every elementwise row is the fixed 8,
   every tile variant is timed at some layer; per GEMM layer at B 1 and
   16 the candidates, the pruned ones and the winner against ``XYZ``.
   The DP over the autotuned space must be predicted no slower than the
   DP over the fixed 8 on the same table; ``fuse_mapping`` with
   ``seg_cuda``; 32 requests served under the fused autotuned mapping,
   each equal to the plain CPU ``forward_packed``.  The paper's
   comparison: ``best_uniform(table, "XYZ")`` against the DP, predicted
   and served (p50 under all-``XYZ`` and under the DP, same requests).
   The analytic H100 model's kernel and boundary times over the measured
   rows at B 1 and 16, per layer and per kind.  A ``LatencyPredictor``
   fitted on the stored training rows at B 1 and 4, its error at B 16;
   a refit job through a ``CacheService`` on the phase 8 store must
   persist a predictor whose metadata names the stored row count;
12. co-serving (``fleet_phase``): full-width CIFAR-10 (phase 5's
   weights) and Fashion-MNIST (NumPy seed 1), each request drawn from a
   pool of 32 inputs per (model, level) whose plain CPU outputs are
   computed once.  ``[fleet]``: the profiles at (1, 4, 16) through the
   phase 8 store (CIFAR-10's must be a warm start), ``map_fleet`` at B
   16, gamma 1.0 (each tenant's mapping, shares, inflations and
   inflated us per example; joint makespan must be <= the all-GPU
   baseline), then 64 requests per tenant through a ``FleetRouter`` with
   a ``DeviceTimeLedger`` under the joint plan and under
   ``map_all_device``: the drain wall of each, the ledger's shares beside
   the predicted ones, and the observations ``InterferenceFit.add_ledger``
   harvests from the port's ledger.  ``[elastic]``: a CIFAR-10
   ``SubnetFamily`` at fractions (1.0, 0.5), ``plan_family`` (B 16,
   fused) through the store, an ``ElasticEngine`` switching levels 0 ->
   1 -> 0 with 32 requests each (each level's p50, predicted us per
   example and the bytes it shares with level 0 or copies), then the
   same engine behind a ``FleetRouter`` with a ``QualityController``
   (``degrade_after=2``), deadline 1.5x level 0's step, bursts of 64:
   the journal must hold a ``degrade``.  ``[cluster]``: the ``api``
   facade serving one model and two models on one host, then two
   models on two logical hosts (``consistent_hash``, the phase 8 store
   shared): 64 keyed requests per tenant, a ``scale_up`` that must
   warm-start from the store (``cache_hits >= 1``), a ``start_drain``
   of a host with queued requests that must migrate some, and
   ``cluster.stats()``.  Every answer, migrated or not, must equal the
   plain CPU ``forward_packed`` of the level that served it; both BNN
   kernels must launch during the phase.  The logical hosts share the
   one card and the one CPU.

13. training (``train_phase``): full-width CIFAR-10 trained on the card
   with the STE recipe on ``make_image_dataset(0, 4096, (32, 32), 3)``
   (``ShardedBatcher``, batch 64, AdamW lr 2e-3).  One ``train_step`` on
   the card against the same step on CPU tensors from the same
   ``fp_params_from_numpy`` params (loss and grad_norm within a relative
   1e-5, each trainable leaf's gradient within 1e-4 of its largest
   magnitude, latent weights, gamma and beta within 0.05 x lr where the
   clipped gradient is at least 1e-6 and within 2 x lr below that, the
   running mean within 1e-5 of its largest magnitude, the running var
   1e-4); then
   ``TrainLoop`` (checkpoints, async, an injected failure, a relaunch
   that resumes) under cuDNN deterministic, its final state held
   ``torch.equal`` to an uninterrupted run, the loss over the last 10
   steps below the first 10, steps/s, step wall p50, one traced train
   step's busy and idle time and a held-out accuracy; the fp eval
   logits of 32 held-out examples equal to ``forward_packed`` of
   ``pack_params(trained)``; ``api.plan_single(fuse=True)`` warm from
   the phase 8 store (a miss fails); 32 requests served through
   ``ServingEngine`` equal to the plain ``forward_packed`` (on CUDA
   tensors), their p50 beside phase 5's, and again under the same DP
   mapping unfused (its device GEMM layers one kernel 1 launch each);
   both BNN kernels must launch during the phase.

14. LM training (``lm_train_phase``): (a) every arch's smoke config
   widened to head dim 32 (the kernel refuses the smoke configs' 16),
   f32, TF32 off: one AdamW ``make_train_step`` on the card against the
   same step on CPU tensors from the same params and batch, with
   ``accum_steps`` 1 and again with 2 and ``grad_compression="bf16"``
   (loss, ce, aux and grad_norm within a relative 1e-5, every gradient
   leaf within 1e-4 of its largest magnitude, the updated params by
   phase 13's rule; kernel 3 must launch once per attention application
   of each micro-step and once more per layer its remat reruns), and the
   loss and gradient with ``remat`` on against off (losses equal, every
   leaf bit-equal, the MoE ones within 1e-4); (b) qwen2-0.5B at full
   width: an f32 loss and
   every gradient leaf at B 2 x S 256 through the kernel's forward and
   the chunk-recompute backward against plain autograd through the
   plain attention (relative 1e-4), then bf16 training through
   ``repro_torch.launch.train.main`` at B 4 x S 2,048 for 20 steps on
   the token stream (every loss finite, the last five below the first
   five, 2 x 24 x 20 flash launches: each layer's remat reruns its
   forward), its step p50, peak allocated memory, one traced step (busy,
   idle, largest activities) and the chunk-recompute backward's time
   per layer, then remat on against off from the same params and batch
   (``remat_ab``: loss equal, gradients bit-equal, step p50, tokens/s,
   peak allocated and launches a step of each: 48 and 24); (c)
   mamba2-130m at full
   width (chunk 128): an f32 step whose grad_norm is finite, the same
   step through the reference's exp-then-mask SSD, whose grad_norm must
   not be, and bf16 ``TrainLoop`` training at B 4 x S 2,048 with an
   injected failure and a resume held ``torch.equal`` to the
   uninterrupted run, its peak allocated memory and one traced step,
   then its remat on against off as qwen2's.
15. the sharding layer (``shard_phase``): (a) param, optimizer, batch
   and cache shardings of all ten full configs on abstract 16 x 16 and
   2 x 16 x 16 meshes under ``default_scheme`` and the hillclimb's
   variants, from ``meta`` specs (nothing allocated); (b) in a one-rank
   nccl process group, qwen2-0.5B's params distributed onto a 1 x 1
   ('data', 'model') DeviceMesh and ``remesh_state``'d onto 1 x 1 x 1
   ('pod', 'data', 'model'): every leaf's placements those of its
   ``NamedSharding`` and its ``to_local()`` ``torch.equal`` to the
   original; (c) under ``use_mesh`` and
   ``scheme_context(ShardScheme(attn_kv_parallel=True))``: f32 logits
   at 2 layers against the plain attention (1e-4), the bf16 prefill at
   B 4 x S 2,048 with kernel 3 launched once per (layer, KV part), 24 x
   16 = 384 times, confirmed by a trace, its logits against the normal
   prefill's (phase 4b's limit), kernel 3's ``return_lse`` against
   ``flash_attention_plain`` at one part's shape, and the
   context-parallel attention's device time per layer beside kernel 3's
   single launch; (d) HEP-Shard's ``search`` over ``attn_kv_parallel``
   and ``accum_steps``, each trial a bf16 AdamW train step at B 4 x S
   2,048 (one warm step, the median of two by CUDA events, peak memory,
   the batch's copy), the card's memory as ``hbm_bytes``, for the
   default remat step and again without remat; the f32 loss
   and gradient through the kernel per part and the chunk-recompute
   backward against plain autograd (1e-4).
16. the dry run (``dryrun_phase``): (a) qwen2-0.5B at full width, bf16,
   B 4 x S 2,048, as an AdamW train step and as a prefill, each traced
   by ``launch.dryrun.dry_run`` on a fake one-rank (1, 1) DeviceMesh
   with fake CUDA tensors (kernel 3 is its op's fake implementation;
   nothing may launch), then run for real under ``FlopCounterMode``
   after ``torch.cuda.reset_peak_memory_stats``: the per-device FLOPs of
   both must be equal, the predicted peak within 15 % of the measured
   one (``max_memory_allocated`` less what was allocated before the
   step's arguments), kernel 3 must launch once per layer of the
   forward and once more per layer the train step's remat reruns (48;
   the prefill 24), and the predicted ``max(compute, memory) +
   collective``
   (H100 datasheet rates) is printed beside the step's median of two by
   CUDA events; (b) ``launch.hillclimb.run_cell`` on the 16 x 16 fake
   mesh with fake CUDA tensors for the ``DRYRUN_CELLS``, one line per
   variant (derived numbers, datasheet-priced), and the phase's wall.
17. the sharded step on 8 ranks (``spmd_phase``): 8 processes from
   ``launch.mesh.spawn_world`` share the card through ``gloo`` (nccl
   refuses two ranks on one GPU), every collective through host memory:
   a correctness path, no multi-card or NVLink claim.  First a probe of
   the functional collectives DTensor issues, on CUDA tensors in 2-rank
   worlds: gloo's ``all_gather_into_tensor`` kills its processes
   (SIGSEGV) on the card's torch, so ``spawn_world`` has every gloo rank
   on CUDA run the all-gather as an ``all_to_all_single``
   (``launch.mesh.all_gather_through_all_to_all``), which the probe
   holds too (gloo's own is probed in a world spawned without it).
   Then qwen2-0.5B at full width under
   ``ShardScheme(tp=True, fsdp="zero1")`` on a (2, 4) and a (4, 2)
   ('data', 'model') mesh (14 heads over 4 do not divide, over 2 they
   do), weights from phase 4b's seeded generator on every rank: the f32
   forward at 2 layers, B 8 x S 256, against the one-rank forward
   (``LM_F32_REL``); the bf16 prefill at B 8 x S 512, its last logits
   against the one-rank prefill (``LM_BF16_REL``), kernel 3 once per
   layer on every rank (24, read from each rank's own counters), its
   wall beside the one-rank prefill's; on (2, 4) one bf16 AdamW step
   at ``accum_steps`` 1 and 4 (``SPMD_TRAIN_LAYERS``: the depth cut
   the card's memory forces, printed), loss and grad_norm against the
   one-rank step (``SPMD_TRAIN_REL``), each micro-batch's tokens
   ``Shard(0)`` over 'data' on every rank, and the accum-1 step again
   with ``attn_kv_parallel`` (the context-parallel attention's backward
   on sharded tensors, held to the same one-rank step); rank 0's
   ``StepRecorder
   over the (2, 4) prefill equal, collective by collective and in
   ``dot_flops``, to ``launch.dryrun.dry_run``'s on a fake (2, 4) CUDA
   group.
18. the examples (``examples_phase``): each ``examples/torch_*.py``
   imported by path and run in-process through ``main([...])`` at its
   own defaults, in a temporary working directory.  quickstart (train,
   pack, profile, greedy and DP mappings, the mapped model and 8 served
   answers exact) and serve_mapped (512 answers exact, p50 / p99): the
   measured profile must launch kernel 1, and whenever the DP mapping
   places a conv or fc layer on the card kernel 1 or 2 must launch
   while the mapped model runs and serves; serve_fleet (two tenants,
   every answer exact, ``rejected == shed``): kernel 1 must launch while
   serving whenever a tenant's plan places a conv or fc layer on
   ``XYZ``; train_lm at full width (qwen2-0.5B, B 8 x S 128) for 60
   steps, then again to 80 on the same checkpoint directory: finite
   losses, the last below the first, the second run resumed at 60 and
   ran 20 steps, kernel 3 twice per layer a step; hep_shard_demo
   (olmo-1b at 2 layers, train_4k) on a fake (2, 4) CUDA group, every
   trial printed, then its chosen scheme's bf16 AdamW step through
   ``launch.spmd.run_step`` on 8 gloo ranks that share the card (their
   all-gathers through ``spawn_world``'s routing) at B 8 x S 512 (the
   cut printed): loss and grad_norm within ``SPMD_TRAIN_REL`` of one
   rank's step, kernel 3 on every rank, rank 0's collectives and FLOPs
   equal to ``dry_run``'s at the cut shape on a fake (2, 4) CUDA group.
   Each example's wall and the phase's are printed.

Every traced window (the LM prefill, the three traced serving steps)
reads the launch counts before and after it; a trace that shows fewer
launches of a kernel than its wrapper counted is taken again, and three
such traces fail the run.

The launch counts are zeroed just before each main path and read just
after it: phase 4b's ``greedy_decode`` (``flash_attention_cuda`` must
launch once per layer of the prefill, 24 times), phase 4d's three
``greedy_decode`` runs (28, 13 and 0 launches), phase 4e's six (16, 32,
48, 48, 32 and 4), phases 5-6 up to
phase 6's untraced serving (both BNN kernels must have launched while
serving), phase 9's adaptive serving (``segment_cuda``), phase 10's
explore job (``xnor_gemm_cuda``), phase 11's autotune sweep and
serving (``xnor_gemm_cuda``), phase 12 (``xnor_gemm_cuda`` and
``segment_cuda``), phase 13 (``xnor_gemm_cuda`` and
``segment_cuda``), phase 14's qwen2 training
(``flash_attention_cuda``, twice per layer of each step: the forward
and its remat), phase 15's
context-parallel prefill (``flash_attention_cuda`` with the
log-sum-exp, once per layer and KV part), phase 16's real train step
and prefill (``flash_attention_cuda``, twice and once per layer) and
phase 17's 8-rank prefills (``flash_attention_cuda`` once per layer on
each rank, counted in each rank's process) and context-parallel train
step (with the log-sum-exp), and each example of phase 18 (run in this
process; the demo's real step counted in each rank's).  The last
lines are the device line, one JSON object with each kernel's numbers,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PROFILE_BATCHES = (1, 4, 16)
N_REQUESTS = 32
CHECK_BATCHES = (1, 8, 16, 33)
SEGMENT_BATCHES = (1, 8, 16, 33)
# CIFAR-10 full-width GEMM shapes: (layer, P windows, N outputs, Kw, k_true)
GEMM_SHAPES = (
    ("L1", 1024, 64, 9, 27), ("L3", 1024, 64, 18, 576),
    ("L6", 256, 256, 18, 576), ("L8", 256, 256, 72, 2304),
    ("L11", 64, 512, 72, 2304), ("L13", 64, 512, 144, 4608),
    ("L17", 1, 1024, 256, 8192), ("L19", 1, 10, 32, 1024),
)
FMNIST_GEMM_SHAPES = (
    ("F-L1", 784, 64, 9, 9), ("F-L4", 196, 64, 18, 576),
    ("F-L8", 1, 2048, 98, 3136), ("F-L10", 1, 10, 64, 2048),
)
RAGGED_SHAPE = ("ragged", 37, 21, 5, 150)   # P, N not tile multiples, Kw tail
ASPECT_SETS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
# kernel 1's registered tile variants: name -> (p_blk, n_blk), aspects XYZ
TILE_VARIANTS = {"cuda_p16n64": (16, 64), "cuda_p32n64": (32, 64),
                 "cuda_p64n32": (64, 32)}
# kernel 1's timing sweep: batches, launches per case
SWEEP_BATCHES = (16, 1)
SWEEP_ITERS = 20
# a trace drops launch records made right after it starts: the traced
# functions wait this long (seconds) inside the trace before they launch
PROFILER_SETTLE_S = 0.02
# ... and a traced serving window first launches this many tiny spin
# kernels (``torch.cuda._sleep``), which take the dropped records' place
# and are left out of every sum
TRACE_PRIMERS = 8
# (start, stop) layer spans of the CIFAR-10 net for the segment checks
SEGMENT_SPANS = {"whole": (0, 19), "tail from step": (14, 19),
                 "mid from mp": (8, 13)}
# qwen2-0.5B serving at full width (phase 4b): prompts, tokens generated
LM_ARCH = "qwen2_0_5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_CHECK_BATCH, LM_CHECK_LEN = 2, 256
# relative max error (max |a - b| over max |b|) allowed between the
# kernel path and the plain-attention path: f32 differs only in the
# attention's summation order; in bf16 the decode path (one token
# against the cache) and the full forward round activations at other
# places, over 24 layers
LM_F32_REL = 1e-4
LM_BF16_REL = 5e-2
# kernel 3 against its plain version: f32 differs only in summation
# order; bf16 outputs may differ by a bf16 rounding (the JAX bf16 test's)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (label, b, h, hkv, sq, sk, d, dtype, causal)
FLASH_CASES = tuple(
    (f"{b}x{h}/{hkv}x{s}x{d} {'causal' if c else 'full'}", b, h, hkv, s, s,
     d, "float32", c)
    for b, h, hkv, s, d in ((1, 1, 1, 128, 32), (2, 4, 2, 256, 64),
                            (1, 8, 1, 128, 128), (2, 6, 6, 64, 64))
    for c in (True, False)
) + (
    ("decode Sq 1 / Sk 512", 2, 4, 2, 1, 512, 64, "float32", True),
    ("bf16 1x2/1x128x64", 1, 2, 1, 128, 128, 64, "bfloat16", True),
    ("bf16 D32 full", 2, 4, 2, 256, 256, 32, "bfloat16", False),
    ("bf16 D128 MQA", 2, 8, 1, 256, 256, 128, "bfloat16", True),
    ("bf16 D128 ragged full", 1, 4, 4, 77, 130, 128, "bfloat16", False),
    ("logits x30", 1, 1, 1, 128, 128, 32, "float32", True),
    ("qwen2 prefill", 4, 14, 2, 2048, 2048, 64, "bfloat16", True),
    ("ragged S 2000", 4, 14, 2, 2000, 2000, 64, "bfloat16", True),
    ("Sq 1 / Sk 2048", 4, 14, 2, 1, 2048, 64, "bfloat16", True),
    ("Sq 1 / Sk 2048 f32", 4, 14, 2, 1, 2048, 64, "float32", True),
    ("bf16 D112 ragged full", 1, 4, 4, 77, 130, 112, "bfloat16", False),
    ("bf16 D112 GQA 7", 2, 14, 2, 200, 200, 112, "bfloat16", True),
    ("f32 D112 GQA 7", 2, 14, 2, 200, 200, 112, "float32", True),
    ("f32 D112 full", 1, 4, 4, 77, 130, 112, "float32", False),
    ("deepseek prefill", 4, 16, 16, 2048, 2048, 128, "bfloat16", True),
    ("zamba2 prefill", 4, 32, 32, 2048, 2048, 112, "bfloat16", True),
    # phase 4e's prefill shapes: GQA groups 5 and 6 at D 128, llava's 576
    # and musicgen's 64 frontend embeds ahead of the 2,048 tokens
    ("qwen2.5-14b prefill", 4, 40, 8, 2048, 2048, 128, "bfloat16", True),
    ("grok prefill", 4, 48, 8, 2048, 2048, 128, "bfloat16", True),
    ("llava prefill", 4, 32, 8, 2624, 2624, 128, "bfloat16", True),
    ("musicgen prefill", 4, 24, 24, 2112, 2112, 64, "bfloat16", True),
    ("Sq 1 / Sk 2048 group 5", 4, 40, 8, 1, 2048, 128, "bfloat16", True),
    ("f32 D128 GQA 5", 2, 10, 2, 200, 200, 128, "float32", True),
    ("f32 D128 GQA 6", 2, 12, 2, 200, 200, 128, "float32", True),
)
# kernel 3 is timed (phase 4c) at these models' prefill shapes: B
# LM_BATCH, S LM_PROMPT plus the model's frontend embeds, its heads and
# head dim (olmo-1b has deepseek's shape, minitron-8b llava's without
# the embeds)
FLASH_TIMED = ("qwen2_0_5b", "deepseek_moe_16b", "zamba2_7b", "qwen2_5_14b",
               "llava_next_mistral_7b", "musicgen_medium", "grok_1_314b")
# LMs at full width, one at a time, each freed before the next: the MoE,
# SSM and hybrid families (phase 4d), then the six attention
# configurations phase 4e adds (cheapest first).  FAMILY_FLASH: the
# flash launches a prefill must make (one per attention-block
# application).  DEPTH_CUT: the one cut, of depth only: grok-1's 64
# layers take 633 GB in bf16, its first 4 at full width 39.4 GB plus
# 3.2 GB of embeddings.  Each f32 check runs at the deepest depth whose
# f32 weights (``cfg.n_params()``) and the checks' activations
# (``f32_check_bytes``) fit in the card's free memory, worked out in the
# phase (deepseek-moe-16b's must reach F32_MIN_DEPTH): the logits at
# every position and the residual stream after every attention block
# through the kernel are held to the plain attention (mamba2-130m: the
# card to CPU tensors), and the teacher-forced decode path to the full
# forward, all within LM_F32_REL; in the MoE families every (token,
# layer) top-k set must agree between the kernel and the plain path.
# The decode path's routing may leave the full forward's at a tie (on
# an NVIDIA H100 80GB HBM3 at 700 W deepseek's 28 f32 layers flipped 57
# of 28,616 sets, the lowest at a gap of 7.9e-7 between the 6th and 7th
# probabilities, and moved the logits 4.1e-2): every flip in the lowest
# layer that has one must be a tie within LM_F32_REL, and the decode
# path is then held under the full forward's routing.  The
# teacher-forced check's batch, prompt and decode steps; the capacity
# factor under which an MoE's check must drop nothing (at least E /
# top_k, which lets an expert take every token of a group: deepseek's
# 16, grok-1's 4, whose (G, E, C, 32,768) buffers 16 would quadruple);
# and the share of (token, layer) top-k sets that must agree between
# the two bf16 paths (routing flips there are real: a bf16 rounding
# moves a gate across the top-k boundary).  The bf16 teacher-forced
# logits are held to LM_BF16_REL (phase 4b's), or, where the f32 check
# ran at full depth, to the bf16 full forward's own distance from the
# f32 one if that is larger: two bf16 computations of one function are
# held to bf16's own error, not below it (zamba2-7b's 81 + 13 blocks
# drift 0.12 from f32, its decode path 0.11; tools/lm_bf16_drift.py).
# MoE archs are held at the positions whose routing agreed in every
# layer.
FAMILY_ARCHS = ("deepseek_moe_16b", "zamba2_7b", "mamba2_130m")
DENSE_ARCHS = ("olmo_1b", "minitron_8b", "qwen2_5_14b", "musicgen_medium",
               "llava_next_mistral_7b", "grok_1_314b")
FAMILY_FLASH = {"deepseek_moe_16b": 28, "zamba2_7b": 13, "mamba2_130m": 0,
                "olmo_1b": 16, "minitron_8b": 32, "qwen2_5_14b": 48,
                "musicgen_medium": 48, "llava_next_mistral_7b": 32,
                "grok_1_314b": 4}
DEPTH_CUT = {"grok_1_314b": 4}
F32_MIN_DEPTH = {"deepseek_moe_16b": 12}
# what the f32 checks may need beyond the counted tensors: the caching
# allocator's rounding and fragmentation, cuBLAS workspaces, temporaries
F32_SLACK = 4 << 30
TF_BATCH, TF_PROMPT, TF_STEPS = 2, 512, 16
TF_CAPACITY = {"deepseek_moe_16b": 16.0, "grok_1_314b": 4.0}
ROUTE_AGREE_FLOOR = 0.5
# co-serving (phase 12): the batch the fleet is mapped and served at,
# requests per tenant under each fleet mapping, the width levels of the
# elastic family, and the quality bursts (requests, rounds; the deadline
# is this many times level 0's expected step)
FLEET_BATCH = 16
FLEET_REQUESTS = 64
ELASTIC_FRACTIONS = (1.0, 0.5)
QUALITY_BURST, QUALITY_ROUNDS, QUALITY_DEADLINE = 64, 4, 1.5

# training (phase 13): full-width CIFAR-10 on the synthetic images, the
# batch, AdamW's learning rate, TrainLoop's steps, checkpoint interval
# and injected failure; the card step is held to the CPU step at these
# tolerances (relative for loss, grad_norm, gradients and running
# stats; the AdamW-updated leaves absolute, in units of lr, where the
# clipped gradient is at least STEP_GRAD_FLOOR)
TRAIN_EXAMPLES, TRAIN_BATCH, TRAIN_LR = 4096, 64, 2e-3
TRAIN_STEPS, TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = 120, 40, 60
STEP_RTOL, STEP_W_ATOL, STEP_VAR_FACTOR = 1e-5, 0.05, 10
STEP_GRAD_RTOL, STEP_GRAD_FLOOR = 1e-4, 1e-6

# LM training (phase 14): every arch's smoke config widened to head dim
# 32 (the kernel's smallest) at B x S, AdamW lr; qwen2-0.5B at full
# width trained through launch.train at B x S for these steps; mamba2-130m
# at full width through TrainLoop for these steps, checkpoint interval
# and injected failure (the card step is held to the CPU step by phase
# 13's tolerances)
LM_TRAIN_HEAD_DIM = 32
LM_TRAIN_SMOKE_B, LM_TRAIN_SMOKE_S = 4, 64
LM_TRAIN_LR = 1e-3
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 2048, 20
SSD_TRAIN_STEPS, SSD_SAVE_EVERY, SSD_FAIL_AT = 3, 2, 3
# per-layer remat on against off (phase 14): the timed AdamW steps of
# each after a warm one, from the same params and batch.  The recompute
# runs the same kernels on the same inputs, so the loss and every
# gradient leaf are held bit-equal, except in the MoE families: there
# the backward of the combine's gather and of repeat_interleave adds
# rows with atomics in an order the launch decides, and each leaf is
# held to the card-vs-CPU limit STEP_GRAD_RTOL instead
REMAT_AB_STEPS = 3

# the sharding layer (phase 15): scheme variants planned for every
# config on the production meshes (the hillclimb's, src/repro/launch/
# hillclimb.py); the context-parallel attention's KV parts (the JAX
# package's default) and the f32 check's depth; HEP-Shard's knobs on one
# card, each trial one warm step and the median of SHARD_TIMED steps
SHARD_VARIANTS = {
    "default": {}, "attn_tp off": {"attn_tp": False},
    "attn_kv_parallel": {"attn_kv_parallel": True},
    "decode_replicate_batch": {"decode_replicate_batch": True},
    "out_proj_contracting_2d": {"out_proj_contracting_2d": True},
    "moe_e_over_data": {"moe_e_over_data": True},
}
KV_PARTS = 16
SHARD_F32_LAYERS = 2
SHARD_KNOBS = {"attn_kv_parallel": (False, True), "accum_steps": (1, 2, 4)}
SHARD_TIMED = 2
# the additive mask of the log-sum-exp yardstick (the reference's -1e30)
NEG_BIAS = -1e30
# kernel 3's log-sum-exp (f32 statistics): f32 inputs as the output,
# bf16 inputs at 1e-3 (the tensor-core path's approximate exp2)
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


# the dry run (phase 16): the 1 x 1 step's predicted peak against the
# measured one, the timed steps after a warm one, and the hillclimb
# cells run on the 16 x 16 fake mesh
DRYRUN_PEAK_REL = 0.15
DRYRUN_TIMED = 2
DRYRUN_CELLS = ("deepseek", "qwen-prefill")
# phase 17: the sharded step on 8 ranks that share the one card through
# gloo (nccl refuses two ranks on one GPU), every collective through host
# memory.  The collectives DTensor issues for these steps, probed first
# on CUDA tensors in a 2-rank world
SPMD_WORLD = 8
SPMD_MESHES = ((2, 4), (4, 2))
SPMD_SCHEME = {"tp": True, "fsdp": "zero1"}
SPMD_F32_LAYERS = 2
SPMD_F32_SHAPE = (8, 256)
SPMD_SHAPE = (8, 512)            # the bf16 prefill and train step
SPMD_TRAIN_MESH = (2, 4)
SPMD_TRAIN_ACCUM = (1, 4)
# the train step's depth (None: all 24 layers), cut and the cut printed:
# at 24 layers the accum-4 step's f32 gradient sums on 8 ranks outgrow
# the one card (an NVIDIA H100 80GB HBM3 at 700 W: 8.1-8.6 GiB a rank
# allocated when it ran out)
SPMD_TRAIN_LAYERS = 12
# loss and grad_norm of the bf16 step on 8 ranks against one rank:
# bf16 activations rounded at other places (sharded sums), as phase 4b's
# bf16 limit allows for logits
SPMD_TRAIN_REL = 1e-2
SPMD_TIMEOUT_S = 900.0
# gloo's own all-gather, probed in a world of its own (it crashes), and
# the all-gather spawn_world's gloo ranks on CUDA run
# (launch.mesh.all_gather_through_all_to_all)
SPMD_RAW_ALL_GATHER = "all_gather_into_tensor"
SPMD_ROUTED = "all_gather_into_tensor through all_to_all_single"
SPMD_PROBED = ("all_reduce", "reduce_scatter_tensor", "all_to_all_single",
               SPMD_ROUTED)

# phase 18: the five examples/torch_*.py entry points, run in-process at
# their own defaults (train_lm with --full, twice: 60 steps, then a
# resume to 80); the HEP-Shard demo's chosen scheme then takes one real
# bf16 AdamW step on SPMD_WORLD gloo ranks that share the card, its
# train_4k cell (256 x 4,096 tokens) cut to B x S = EXAMPLE_DEMO_CUT
EXAMPLES = ("quickstart", "serve_mapped", "serve_fleet", "train_lm",
            "hep_shard_demo")
EXAMPLE_TRAIN_ARGS = ("--full", "--arch", LM_ARCH, "--batch", "8", "--seq",
                      "128")
EXAMPLE_TRAIN_STEPS = (60, 80)
EXAMPLE_DEMO_CUT = (8, 512)
EXAMPLE_DEMO_TIMEOUT_S = 600.0

# adaptive serving (phase 9): requests per burst, calibration stops after
# this many steps without a new journal entry (at most CALIBRATE_MAX
# steps), the contended remap must follow within CONTEND_MAX steps, the
# busy-wait tax is this many times a device segment's calibrated time,
# and the telemetry cost is the p50 over this many steps each way
ADAPT_BURST = 16
CALIBRATE_QUIET, CALIBRATE_MAX = 5, 60
CONTEND_MAX = 20
TAX_FACTOR = 10.0
TELEMETRY_STEPS = 20
# Published H100 SXM dense bf16 tensor-core rate (data sheet)
BF16_FLOP_PER_S = 989e12
# Published H100 SXM rates: HBM3 bandwidth (data sheet) and POPC issue
# rate per SM per clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput).
HBM_BYTES_PER_S = 3.35e12
# phase 7b: the batch of a micro-batch in the cell bireal18-224.flood
BIREAL_BATCH = 32
POPC_PER_SM_PER_CLOCK = 16


def log(*args) -> None:
    print(*args, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean time per call of `fn` over `iters` back-to-back calls, from
    CUDA events, after one warm-up call: what a caller sees, host launch
    path included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernel: str, iters: int) -> tuple:
    """(device ms per launch of the CUDA kernel whose name contains
    `kernel`, source) over `iters` calls of `fn`, from the profiler's
    device trace; the CUDA-event time per call when the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += getattr(ev, "device_time_total", 0) or 0
            n += ev.count
    if n and us > 0:
        return us / 1e3 / n, "profiler"
    return time_ms(fn, iters), "events"


def device_trace(fn) -> tuple:
    """(wall ms, device-busy ms, {device activity: ms}, {device activity:
    count}) of one call of `fn` under the profiler: busy is the union of
    the intervals in which a kernel or a copy ran on the card.  The
    primer spin kernels launched before `fn` are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        for _ in range(TRACE_PRIMERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, n_by_name = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or "spin_kernel" in ev.name:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        name = ev.name.replace("(anonymous namespace)::", "")
        key = name.split("(")[0].split("<")[0].strip()[:40]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e3
        n_by_name[key] = n_by_name.get(key, 0) + 1
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall * 1e3, busy / 1e3, by_name, n_by_name


def kernel_sweep(cases, kernel: str, iters: int) -> tuple:
    """({label: device ms per launch}, launches traced) for `cases`
    [(label, fn)]: `iters` back-to-back calls of each case under a
    profiler trace of its own, the mean duration of the traced launches
    of the kernel whose name contains `kernel`.  The trace drops launch
    records (often the first ones of a trace); a trace that holds fewer
    than half of the launches is taken again, up to three times, and the
    fullest one is kept.  A case none of whose launches was traced fails
    the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res, n_traced = {}, 0
    for label, fn in cases:
        fn()
        torch.cuda.synchronize()
        best: list = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILER_SETTLE_S)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            spans = [ev.time_range.end - ev.time_range.start
                     for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA
                     and kernel in ev.name]
            if len(spans) > iters:
                raise AssertionError(f"kernel_sweep {label}: {len(spans)} "
                                     f"launches traced, {iters} made")
            best = max(best, spans, key=len)
            if 2 * len(best) >= iters:
                break
        if not best:
            raise AssertionError(f"kernel_sweep {label}: no launch of "
                                 f"{kernel} traced")
        n_traced += len(best)
        res[label] = sum(best) / 1e3 / len(best)
    return res, n_traced


def mma_b1_rate(mma_probe, dev, n_sm: int) -> tuple:
    """(bit-products per second, ms) of ``xnor_mma_probe_kernel``: 4
    blocks of 8 warps per SM, each warp 8 x `iters` independent
    m16n8k256 AND/popc products; the best of 3 timed launches."""
    import torch

    iters = 512
    out = torch.empty(4 * n_sm * 256, dtype=torch.int32, device=dev)
    mma_probe(out, 16)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mma_probe(out, iters)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    n_mma = out.numel() // 32 * 8 * iters
    return n_mma * 16 * 8 * 256 / (best / 1e3), best


def unpack_pm1(words):
    """(..., Kw) int32 words -> (..., 32 Kw) int8 of +-1, bit i of a word
    at position i."""
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return (2 * bits - 1).to(torch.int8).reshape(*words.shape[:-1], -1)


def int_mm_ms(a, w, iters: int) -> float:
    """Time per call of ``torch._int_mm`` on the +-1 int8 unpacking of
    the xnor product's operands (rows padded to a multiple of 8 above 16,
    neurons to a multiple of 8, as the call requires): the same dot
    products, not the same function (8x the input bytes).  A yardstick
    only; the port never calls it."""
    import torch

    x = unpack_pm1(a.reshape(-1, a.shape[-1]))
    y = unpack_pm1(w)
    m = max(24, -(-x.shape[0] // 8) * 8)
    n = -(-y.shape[0] // 8) * 8
    x = torch.nn.functional.pad(x, (0, 0, 0, m - x.shape[0])).contiguous()
    y = torch.nn.functional.pad(y, (0, 0, 0, n - y.shape[0])).contiguous()
    return time_ms(lambda: torch._int_mm(x, y.t()), iters)


# each wrapper's CUDA kernel, as the profiler names it
KERNEL_OF = {"xnor_gemm_cuda": "xnor_gemm_kernel",
             "segment_cuda": "segment_kernel",
             "flash_attention_cuda": "flash_attention_kernel"}


def traced(label: str, fn, counts, prepare=None, attempts: int = 3) -> tuple:
    """`device_trace` of `fn`, held against the launch counters read
    around it (`counts()` -> {wrapper: launches}): every launch a wrapper
    counted must be in the trace, or the trace lost device work and its
    busy and idle numbers are wrong.  The profiler drops a launch record
    now and then, so a trace that lost one is taken again (`prepare()`
    runs before each attempt, outside the trace); only a complete trace
    is returned, and `attempts` lossy ones fail the run."""
    for attempt in range(1, attempts + 1):
        if prepare is not None:
            prepare()
        before = counts()
        wall, busy, by_name, n_by_name = device_trace(fn)
        after = counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] > before[k]}
        seen = {kern: sum(n for key, n in n_by_name.items() if kern in key)
                for kern in KERNEL_OF.values()}
        log(f"[{label}] launch counters {launched}; kernels in the trace "
            f"{ {k: v for k, v in seen.items() if v} }")
        lost = {k: (n, seen[KERNEL_OF[k]]) for k, n in launched.items()
                if seen[KERNEL_OF[k]] < n}
        if not lost:
            return wall, busy, by_name
        log(f"[{label}] trace {attempt} lost launches (counted, traced): "
            f"{lost}")
    raise AssertionError(f"{label}: {attempts} traces lost launches")


def demangle(names: list) -> list:
    """C++ names as ``c++filt`` gives them (unchanged without it)."""
    if not names or shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60).stdout
    got = out.splitlines()
    return got if len(got) == len(names) else names


def short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ")


def ptxas_report(log_text: str) -> list:
    """[(kernel, "registers ..., spills ...")] from an ``nvcc -Xptxas=-v``
    log: each entry function's register count and spill line."""
    rows, fn, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            used = line.split(":", 1)[1].strip()
            rows.append((fn, f"{used}; {spill}"))
            fn = None
    names = demangle([r[0] for r in rows])
    return [(short(n), r[1]) for n, r in zip(names, rows)]


def sass_mma_counts(library: Path):
    """{kernel: tensor-core MMA instructions in its SASS (HMMA, HGMMA and
    the 1-bit BMMA, BGMMA)}, or None when the toolkit has no
    ``cuobjdump``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if tool is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "cuobjdump"
        tool = str(cand) if cand.exists() else None
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\b[HB]G?MMA\b", line):
            counts[fn] += 1
    names = demangle(list(counts))
    return {short(n): c for n, c in zip(names, counts.values())}


def busy_wait(seconds: float) -> None:
    """Burn the host thread for `seconds` (a co-tenant that does not
    yield, unlike a sleep)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0



def at_batch(table, batch: int):
    """`table`'s measured rows at one batch size, as a table of its own:
    the store entry a plan over ``(batch,)`` warm-starts from."""
    from repro_torch.core.profiler import ProfileTable

    def rows(d):
        return None if d is None else {batch: d[batch]}

    return ProfileTable(
        table.model_name, (batch,), table.layer_labels, rows(table.times),
        kernel_times=rows(table.kernel_times), h2d_times=rows(table.h2d_times),
        d2h_times=rows(table.d2h_times), provenance=table.provenance)


def mapping_line(config) -> str:
    return " ".join(f"{lab.split(':')[1]}={c}" for lab, c in
                    zip(config.layer_labels, config.layer_configs))


def fleet_phase(dev, model, packed, x_req, expected, store_root) -> tuple:
    """Phase 12: co-serve full-width CIFAR-10 (`model`, `packed`: phase
    5's) and Fashion-MNIST (NumPy seed 1) on the card: the joint mapping
    against all-GPU, an elastic CIFAR-10 family behind a quality
    controller, and the ``api`` facade at one and two logical hosts.
    Every answer is held to the plain CPU ``forward_packed`` of the
    level that served it.  Returns (launch counts, seconds)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.bnn.models import (
        build_model, forward_packed, pack_params, params_to,
        prepare_input_packed, random_fp_params,
    )
    from repro_torch.core import price_mapping, profile_bnn_model
    from repro_torch.device import HOST
    from repro_torch.elastic import (
        ElasticEngine, ElasticSpec, SubnetFamily, plan_family,
    )
    from repro_torch.estimator import InterferenceFit
    from repro_torch.fleet import (
        DeviceTimeLedger, FleetRouter, QualityController, map_all_device,
        map_fleet,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine
    from repro_torch.store import ProfileStore

    t_phase = time.perf_counter()
    reset_launch_counts()
    store = ProfileStore(f"dir://{store_root}", device=dev)

    def measured(m, p, *, batch_sizes):
        return profile_bnn_model(m, p, batch_sizes=batch_sizes, device=dev)

    def plain(m, p, x):
        """The plain CPU forward of the request pool `x`, and its s."""
        t0 = time.perf_counter()
        out = forward_packed(m.specs, [params_to(q, HOST) for q in p], x)
        return out.numpy(), time.perf_counter() - t0

    def check(label, reqs, want, index=None):
        """Request j answers pool entry ``index[j]`` (default j mod the
        pool): every answer must equal the plain forward's."""
        idx = np.arange(len(reqs)) if index is None else np.asarray(index)
        got = np.stack([r.wait(timeout=600) for r in reqs])
        if not np.array_equal(got, want[idx % len(want)]):
            raise AssertionError(f"{label}: served answers differ from the "
                                 f"plain CPU forward_packed")

    def trace_step(label, step, submit):
        """One traced `step` (`submit()` runs first, outside the trace):
        the step's wall, the card's busy time and its idle share."""
        wall, busy, by_name = traced(label, step, launch_counts,
                                     prepare=submit)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"[{label}] one step under the profiler: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}%"
            f"; by activity: " + ", ".join(f"{k} {v:.3f} ms" for k, v in top))

    fm = build_model("fashion_mnist")
    fm_packed = pack_params(fm.specs, random_fp_params(fm.specs, 1),
                            device=dev)
    fm_x = prepare_input_packed(torch.from_numpy(
        np.random.default_rng(1).random(
            (N_REQUESTS, *fm.input_hw, fm.in_channels), dtype=np.float32)))
    fm_expected, fm_plain_s = plain(fm, fm_packed, fm_x)
    models = {"cifar10": (model, packed), "fashion_mnist": (fm, fm_packed)}
    names = tuple(models)
    pools = {"cifar10": (x_req.numpy(), expected),
             "fashion_mnist": (fm_x.numpy(), fm_expected)}
    log(f"[fleet] plain CPU forward_packed of {N_REQUESTS} Fashion-MNIST "
        f"examples: {fm_plain_s:.2f} s (CIFAR-10 level 0 reuses phase 5's)")

    # -- joint mapping against all-GPU -----------------------------------
    tables, took = {}, {}
    for name, (m, p) in models.items():
        t0 = time.perf_counter()
        tables[name], loaded = store.get_or_profile(
            m, p, measured, batch_sizes=PROFILE_BATCHES)
        took[name] = time.perf_counter() - t0
        if loaded != (name == "cifar10"):
            raise AssertionError(f"{name}: loaded {loaded}; CIFAR-10 must "
                                 "warm-start, Fashion-MNIST be profiled")
    log(f"[fleet] profiles {PROFILE_BATCHES} through {store.backend.uri()}: "
        f"cifar10 warm start {took['cifar10'] * 1e3:.3f} ms, fashion_mnist "
        f"measured {took['fashion_mnist']:.2f} s")
    plan = map_fleet([tables[n] for n in names], names=names,
                     batch_sizes=(FLEET_BATCH,), gamma=1.0)
    for tp in plan.tenants:
        log(f"[fleet] joint {tp.name} B {tp.config.proper_batch_size}: "
            f"{mapping_line(tp.config)}; shares host {tp.host_share:.4f} "
            f"device {tp.device_share:.4f}; inflation host "
            f"{tp.host_inflation:.4f} device {tp.device_inflation:.4f}; "
            f"{tp.solo_expected_s * 1e6:.3f} us/example solo, "
            f"{tp.inflated_expected_s * 1e6:.3f} inflated")
    log(f"[fleet] joint makespan {plan.joint_makespan_s * 1e6:.3f} us against "
        f"all-GPU {plan.baseline_makespan_s * 1e6:.3f} us "
        f"({plan.vs_all_gpu:.4f}x), {plan.rounds} rounds, converged "
        f"{plan.converged}")
    if plan.joint_makespan_s > plan.baseline_makespan_s:
        raise AssertionError("the joint mapping is priced worse than all-GPU")
    joint = {tp.name: tp.config for tp in plan.tenants}
    all_gpu = {n: map_all_device(tables[n], batch_sizes=(FLEET_BATCH,))
               for n in names}
    for n in names:
        log(f"[fleet] all-GPU {n}: {mapping_line(all_gpu[n])}")

    def co_serve(label, configs):
        """FLEET_REQUESTS per tenant through one router + ledger, a
        burst of FLEET_BATCH per tenant a dispatch round, after one
        untimed round."""
        ledger = DeviceTimeLedger()
        router = FleetRouter(ledger=ledger)
        for n in names:
            m, p = models[n]
            router.add_tenant(n, ServingEngine(
                m, p, configs[n], allowed_batch_sizes=(FLEET_BATCH,),
                observer=ledger.observer(n), device=dev))
        warm = {n: [router.submit(n, pools[n][0][i])
                    for i in range(FLEET_BATCH)] for n in names}
        router.drain()
        for n in names:
            check(f"{label} {n} warm-up", warm[n], pools[n][1])
        ledger.reset()
        reqs = {n: [] for n in names}
        t0 = time.perf_counter()
        for lo in range(0, FLEET_REQUESTS, FLEET_BATCH):
            for n in names:
                reqs[n] += [router.submit(n, pools[n][0][i % N_REQUESTS])
                            for i in range(lo, lo + FLEET_BATCH)]
            router.step(force=True)
        router.drain()
        for n in names:
            for r in reqs[n]:
                r.wait(timeout=600)
        wall = time.perf_counter() - t0
        for n in names:
            check(f"{label} {n}", reqs[n], pools[n][1])
        solo = {n: price_mapping(tables[n], FLEET_BATCH,
                                 configs[n].layer_configs) for n in names}
        shares = ledger.shares()
        for n in names:
            u = ledger.usage(n)
            ph, pd = solo[n].placement_shares()
            lat = np.array([r.latency_s for r in reqs[n]]) * 1e3
            log(f"[fleet] {label} {n}: ledger host {shares[n][0]:.4f} device "
                f"{shares[n][1]:.4f} (predicted {ph:.4f} / {pd:.4f}); "
                f"{u.steps} steps, host {u.host_s * 1e3:.3f} ms, device "
                f"{u.device_s * 1e3:.3f} ms; latency p50 "
                f"{np.percentile(lat, 50):.3f} ms p99 "
                f"{np.percentile(lat, 99):.3f} ms")
        fit = InterferenceFit()
        n_obs = fit.add_ledger(ledger, {
            n: tuple(FLEET_BATCH * t for t in solo[n].stage_times())
            for n in names})
        obs = fit.observations()
        log(f"[fleet] {label}: InterferenceFit.add_ledger harvested {n_obs} "
            f"observations from the port's ledger: " + "; ".join(
                f"{o.tenant} {o.placement} share {o.share:.3f} inflation "
                f"{o.inflation:.3f}" for o in obs[:8])
            + (f" ...; fitted gamma {fit.fit().gamma:.4f}" if obs else ""))
        log(f"[fleet] {label}: {FLEET_REQUESTS} requests per tenant drained "
            f"in {wall * 1e3:.3f} ms, every answer equal to the plain CPU "
            f"forward_packed")
        traced_reqs = {n: [] for n in names}

        def submit_round():
            for n in names:
                traced_reqs[n] += [router.submit(n, pools[n][0][i])
                                   for i in range(FLEET_BATCH)]

        trace_step(f"trace fleet {label}", lambda: router.step(force=True),
                   submit_round)
        for n in names:
            check(f"traced {label} {n}", traced_reqs[n], pools[n][1],
                  np.arange(len(traced_reqs[n])) % FLEET_BATCH)
        return wall

    walls = {label: co_serve(label, configs) for label, configs in
             (("joint", joint), ("all-GPU", all_gpu))}
    log(f"[fleet] drain wall joint / all-GPU: {walls['joint'] * 1e3:.3f} / "
        f"{walls['all-GPU'] * 1e3:.3f} ms = "
        f"{walls['joint'] / walls['all-GPU']:.4f}x")

    # -- elastic: nested widths on the card -------------------------------
    t0 = time.perf_counter()
    fam = SubnetFamily.build(model, packed,
                             ElasticSpec(fractions=ELASTIC_FRACTIONS))
    store.save_profile(at_batch(tables["cifar10"], FLEET_BATCH))
    eplan = plan_family(fam, batch_sizes=(FLEET_BATCH,), store=store,
                        fuse=True, device=dev)
    log(f"[elastic] SubnetFamily {fam.names()} and plan_family "
        f"(B {FLEET_BATCH}, fuse, level 0 warm from the store, level 1 "
        f"measured): {time.perf_counter() - t0:.2f} s")
    narrow = fam.level(1)
    l1_expected, l1_plain_s = plain(narrow.model, narrow.packed, x_req)
    level_out = (expected, l1_expected)
    log(f"[elastic] plain CPU forward_packed of {N_REQUESTS} examples at "
        f"level 1: {l1_plain_s:.2f} s")
    engine = ElasticEngine(eplan, allowed_batch_sizes=(FLEET_BATCH,),
                           device=dev)
    engine.warm()
    x_np = pools["cifar10"][0]
    p50s: dict = {}
    for k in (0, 1, 0):
        if not engine.set_level(k):
            raise AssertionError(f"level {k} did not apply at a boundary")
        reqs = [engine.submit(x_np[i]) for i in range(N_REQUESTS)]
        engine.step(force=True)
        check(f"elastic level {k}", reqs, level_out[k])
        p50s.setdefault(k, []).append(float(np.percentile(
            [r.latency_s * 1e3 for r in reqs], 50)))
    for k, lvl in enumerate(fam):
        cfg = eplan.configs[k]
        mem = fam.storage(k)
        log(f"[elastic] level {k} {lvl.model.name} ({lvl.fraction}): "
            f"{mapping_line(cfg)}; fused {[f[:3] for f in cfg.fused_segments]}"
            f"; predicted {cfg.expected_time_per_example * 1e6:.3f} us/example"
            f"; served p50 over {N_REQUESTS} requests "
            + " / ".join(f"{v:.3f}" for v in p50s[k])
            + f" ms; packed bytes shared with level 0 {mem['shared_bytes']}, "
            f"copied {mem['copied_bytes']}")
    for k in (0, 1):
        engine.set_level(k)
        traced_reqs = []
        trace_step(f"trace elastic level {k}", lambda: engine.step(force=True),
                   lambda: traced_reqs.extend(engine.submit(x_np[i])
                                              for i in range(N_REQUESTS)))
        check(f"traced elastic level {k}", traced_reqs, level_out[k])
    engine.set_level(0)
    log(f"[elastic] level 1 / level 0 p50: "
        f"{p50s[1][0] / np.mean(p50s[0]):.4f}; every answer equal to its "
        f"level's plain forward")

    qc = QualityController(degrade_after=2)
    router = FleetRouter(ledger=DeviceTimeLedger(), quality=qc)
    step0 = eplan.configs[0].expected_time_per_example * FLEET_BATCH
    router.add_tenant("cifar10", engine, deadline_s=QUALITY_DEADLINE * step0)
    rounds = []
    for _ in range(QUALITY_ROUNDS):
        level = engine.level              # the level this round serves at
        sent = [(i, router.submit("cifar10", x_np[i % N_REQUESTS]))
                for i in range(QUALITY_BURST)]
        router.step(force=True)
        took_in = [(i, r) for i, r in sent if r is not None]
        check(f"quality round at level {level}", [r for _, r in took_in],
              level_out[level], [i for i, _ in took_in])
        rounds.append((level, len(took_in)))
    for rec in qc.journal:
        log(f"[elastic] quality {dataclasses.asdict(rec)}")
    log(f"[elastic] quality rounds (level, admitted of {QUALITY_BURST}): "
        f"{rounds}; deadline {QUALITY_DEADLINE} x level 0's step "
        f"{step0 * 1e3:.3f} ms; stats {router.stats()['cifar10']}")
    if not any(rec.action == "degrade" for rec in qc.journal):
        raise AssertionError("the quality controller never degraded")

    # -- the api facade at three topologies -------------------------------
    t0 = time.perf_counter()
    store.save_profile(at_batch(tables["fashion_mnist"], FLEET_BATCH))
    single = api.Deployment.plan((model, packed), batch_sizes=(FLEET_BATCH,),
                                 store=store, device=dev).serve()
    reqs = [single.submit(x_np[i]) for i in range(FLEET_BATCH)]
    single.drain()
    check("api single", reqs, expected)
    fleet = api.Deployment.plan(models, batch_sizes=(FLEET_BATCH,),
                                store=store, device=dev).serve()
    reqs = {n: [fleet.submit(pools[n][0][i], tenant=n)
                for i in range(FLEET_BATCH)] for n in names}
    fleet.drain()
    for n in names:
        check(f"api fleet {n}", reqs[n], pools[n][1])
    log(f"[cluster] Deployment hosts=1: single ({single.mode}) and two models "
        f"({fleet.mode}) served {FLEET_BATCH} requests each, equal to the "
        f"plain forward ({time.perf_counter() - t0:.2f} s)")
    dep = api.Deployment.plan(models, hosts=2, batch_sizes=(FLEET_BATCH,),
                              routing="consistent_hash",
                              store=f"dir://{store_root}", device=dev).serve()
    cluster = dep.cluster
    reqs = {n: [dep.submit(pools[n][0][i % N_REQUESTS], tenant=n,
                           key=f"{n}-{i}") for i in range(FLEET_REQUESTS)]
            for n in names}
    dep.drain()
    for n in names:
        check(f"cluster {n}", reqs[n], pools[n][1])
    log(f"[cluster] hosts=2, consistent_hash: placement "
        f"{json.dumps(cluster.plan.to_dict())}; {FLEET_REQUESTS} keyed "
        f"requests per tenant, equal to the plain forward")
    host, moved = cluster.scale_up()
    if cluster.cache_hits < 1:
        raise AssertionError(f"scale-up did not warm-start from the shared "
                             f"store: {cluster.stats().get('cache')}")
    log(f"[cluster] scale_up: host {host.host_id} replicates {moved}; "
        f"cache hits {cluster.cache_hits}, misses {cluster.cache_misses}")
    tenant = moved[0]
    x_t, want_t = pools[tenant]
    reqs = [dep.submit(x_t[i], tenant=tenant, key=f"drain-{i}")
            for i in range(N_REQUESTS)]
    victim = max(cluster._hosts_for(tenant), key=lambda h: h.pending())
    queued = victim.pending()
    cluster.start_drain(victim)
    migrated = queued - victim.pending()
    if migrated <= 0:
        raise AssertionError(f"draining host {victim.host_id} migrated no "
                             f"queued request ({queued} queued)")
    dep.drain()
    check(f"cluster drain {tenant}", reqs, want_t)
    victim.retire()
    log(f"[cluster] start_drain host {victim.host_id}: {migrated} of {queued} "
        f"queued requests migrated, every answer (moved or not) equal to the "
        f"plain forward; host retired")
    log(f"[cluster] stats {json.dumps(cluster.stats(), default=str)}")

    counts = launch_counts()
    log(f"[fleet] launches over phase 12: {counts}")
    for name in ("xnor_gemm_cuda", "segment_cuda"):
        if counts[name] == 0:
            raise AssertionError(f"phase 12 never launched {name}")
    seconds = time.perf_counter() - t_phase
    log(f"[fleet] phase 12: {seconds:.2f} s")
    return counts, seconds


def fp_packed_divergence(model, params, packed, x01) -> str:
    """Where the fp-sim eval forward first parts from the packed forward
    on `x01`: the layer, example, channel and the values on both sides
    (pre-activation, BN output, folded threshold and flip), or "" when
    no layer does."""
    import torch

    from repro_torch.bnn import layers as L
    from repro_torch.bnn.binarize import unpack_bits
    from repro_torch.bnn.models import params_to, prepare_input_packed

    x_fp = L.binarize_input(x01)
    x_pk = prepare_input_packed(x01)
    with torch.no_grad():
        for spec, p, q in zip(model.specs, params, packed):
            q = params_to(q, x_pk.device)
            pre = x_fp
            if spec.kind == "conv":
                x_fp, x_pk = (L.conv_fp(x_fp, p["w"]),
                              L.conv_packed(x_pk, q["w_words"], q["k_true"]))
            elif spec.kind == "mp":
                x_fp, x_pk = L.maxpool_fp(x_fp), L.maxpool_packed(x_pk)
            elif spec.kind == "step":
                x_fp = L.step_fp(x_fp, p, train=False)[0]
                x_pk = L.step_packed(x_pk, q["thresh"], q["flip"])
            elif spec.kind == "flat":
                x_fp = x_fp.reshape(x_fp.shape[0], -1)
                x_pk = L.flat_packed(x_pk, spec.in_shape[-1])
            elif spec.kind == "fc":
                x_fp, x_pk = (L.fc_fp(x_fp, p["w"]),
                              L.fc_packed(x_pk, q["w_words"], q["k_true"]))
            if spec.kind == "flat":
                continue            # packed words: compared at the next step
            got = (unpack_bits(x_pk, spec.units) if spec.kind == "step"
                   else x_pk.float())
            bad = (got != x_fp).nonzero()
            if len(bad):
                where = tuple(int(i) for i in bad[0])
                c = where[-1]
                msg = (f"L{spec.idx} {spec.notation}: {len(bad)} values "
                       f"differ, first at {where}: fp {float(x_fp[where])} "
                       f"packed {float(got[where])}")
                if spec.kind == "step":
                    y = ((pre[where] - p["mean"][c])
                         * torch.rsqrt(p["var"][c] + L.BN_EPS) * p["gamma"][c]
                         + p["beta"][c])
                    msg += (f"; pre-activation {float(pre[where])}, BN output "
                            f"{float(y)!r} (float32), threshold "
                            f"{int(q['thresh'][c])}, flip {bool(q['flip'][c])}"
                            f", gamma {float(p['gamma'][c])!r} beta "
                            f"{float(p['beta'][c])!r} mean "
                            f"{float(p['mean'][c])!r} var "
                            f"{float(p['var'][c])!r}")
                return msg
    return ""


def train_phase(dev, store_root, serve_p50_ms: float) -> tuple:
    """Phase 13: train full-width CIFAR-10 on the card with the STE
    recipe, then pack, plan and serve the trained net.  One step on the
    card against the same step on CPU tensors; ``TrainLoop`` with
    checkpoints, an injected failure and a resume held ``torch.equal``
    to the uninterrupted run; the fp eval logits equal to the packed
    scores; ``api.plan_single`` warm from the phase 8 store; 32 served
    answers bit-exact against the plain ``forward_packed`` (on CUDA
    tensors: integer arithmetic with the same answers as on the CPU).
    `serve_p50_ms` is phase 5's served p50, printed beside this one.
    Returns (launch counts, seconds)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.bnn import layers as L
    from repro_torch.bnn.models import (
        build_model, forward_packed, fp_params_from_numpy, pack_params,
        prepare_input_packed,
    )
    from repro_torch.bnn.train import (
        TrainState, cross_entropy, eval_step, init_train_state, train_step,
    )
    from repro_torch.data import ShardedBatcher, make_image_dataset
    from repro_torch.device import HOST
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import InjectedFailure, LoopConfig, TrainLoop
    from repro_torch.serving import ServingEngine
    from repro_torch.store import ProfileStore
    from repro_torch.tree import flatten, leaves, paths, unflatten

    t_phase = time.perf_counter()
    reset_launch_counts()
    model = build_model("cifar10")
    ds = make_image_dataset(SEED, TRAIN_EXAMPLES, model.input_hw,
                            model.in_channels)
    bt = ShardedBatcher(n=TRAIN_EXAMPLES, global_batch=TRAIN_BATCH, seed=SEED)
    log(f"[train] CIFAR-10 at full width ({len(model.specs)} layers), "
        f"make_image_dataset({SEED}, {TRAIN_EXAMPLES}, {model.input_hw}, "
        f"{model.in_channels}), ShardedBatcher(global_batch={TRAIN_BATCH}, "
        f"seed={SEED}), AdamW lr {TRAIN_LR}")

    # -- one step on the card against the same step on CPU tensors -------
    init, opt = init_train_state(model, torch.Generator().manual_seed(SEED),
                                 lr=TRAIN_LR, device=HOST)
    params_np = [{k: v.numpy() for k, v in p.items()} for p in init.params]

    def fresh(device):
        params = fp_params_from_numpy(params_np, device)
        trainable, _ = L.split_trainable(params)
        return TrainState(params, opt.init(trainable),
                          torch.zeros((), dtype=torch.int32, device=device))

    x, y = bt.batch((ds.x, ds.y), 0)

    def grads_of(device):
        """The loss gradient of every trainable leaf at the initial
        params on `device`, taken as ``train_step`` takes it."""
        trainable, bn = L.split_trainable(fresh(device).params)
        flat, tdef = flatten(trainable)
        live = [t.requires_grad_(True) for t in flat]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            logits, _ = model.apply_fp(
                L.merge_params(unflatten(tdef, live), bn),
                torch.as_tensor(x, device=device), train=True)
            loss = cross_entropy(logits, torch.as_tensor(y, device=device))
            got = torch.autograd.grad(loss, live)
        return {f".params/{n}": g.cpu() for n, g in zip(paths(trainable),
                                                         got)}

    t0 = time.perf_counter()
    cpu_state, cpu_m = train_step(model, opt, fresh(HOST), x, y)
    cpu_s = time.perf_counter() - t0
    dev_state, dev_m = train_step(model, opt, fresh(dev), x, y)
    torch.cuda.synchronize()
    cpu_g, dev_g = grads_of(HOST), grads_of(dev)
    # the clipped gradient AdamW's first step takes, from the CPU step
    clip = min(1.0, 1.0 / (float(cpu_m["grad_norm"]) + 1e-9))
    metrics, errs, fails = [], [], []
    for k in ("loss", "grad_norm"):
        a, b = float(dev_m[k]), float(cpu_m[k])
        rel = abs(a - b) / abs(b)
        metrics.append(f"{k} card {a!r} cpu {b!r} rel {rel:.3e}")
        if rel > STEP_RTOL:
            fails.append(k)
    for name, a, b in zip(paths(dev_state), leaves(dev_state),
                          leaves(cpu_state)):
        if not name.startswith(".params"):
            continue
        d = (a.cpu().double() - b.double()).abs()
        kind = name.rsplit("/", 1)[1]
        short_name = name.removeprefix(".params/")
        if kind in ("mean", "var"):
            tol = STEP_RTOL * float(b.abs().max()) * (
                STEP_VAR_FACTOR if kind == "var" else 1)
            errs.append(f"{short_name} {float(d.max()):.3e} (of max "
                        f"{float(b.abs().max()):.4g})")
            if float(d.max()) > tol:
                fails.append((name, float(d.max()), tol))
            continue
        g_err = float((dev_g[name] - cpu_g[name]).abs().max())
        g_tol = STEP_GRAD_RTOL * float(cpu_g[name].abs().max())
        firm = (clip * cpu_g[name]).abs() >= STEP_GRAD_FLOOR
        firm_err = float(d[firm].max()) if bool(firm.any()) else 0.0
        soft_err = float(d[~firm].max()) if bool((~firm).any()) else 0.0
        errs.append(f"{short_name} {float(d.max()):.3e} (grad {g_err:.3e} "
                    f"of max {g_tol / STEP_GRAD_RTOL:.3e}; at or above the "
                    f"floor {firm_err:.3e}; {int((~firm).sum())} below it, "
                    f"max {soft_err:.3e})")
        if g_err > g_tol:
            fails.append((name + " grad", g_err, g_tol))
        if firm_err > STEP_W_ATOL * TRAIN_LR:
            fails.append((name, firm_err, STEP_W_ATOL * TRAIN_LR))
        if soft_err > 2 * TRAIN_LR:
            fails.append((name + " below the floor", soft_err, 2 * TRAIN_LR))
    log(f"[train] one step, card against CPU tensors from the same "
        f"fp_params_from_numpy and batch (CPU step {cpu_s:.2f} s); "
        f"tolerances: loss and grad_norm relative {STEP_RTOL}; each "
        f"trainable leaf's gradient {STEP_GRAD_RTOL} of its largest "
        f"magnitude (a conv weight's gradient sums {TRAIN_BATCH * 1024} "
        f"positions in f32, in cuDNN's order and in the CPU's); "
        f"after the AdamW step (g / (|g| + 1e-8) x lr, within 1 % of "
        f"+-lr where the clipped |g| >= {STEP_GRAD_FLOOR:g}) every w, gamma "
        f"and beta within {STEP_W_ATOL} x lr where |g| >= "
        f"{STEP_GRAD_FLOOR:g}, within one step either way (2 x lr) below "
        f"it, where rounding decides the step; running mean {STEP_RTOL} "
        f"of its largest magnitude, running var "
        f"{STEP_VAR_FACTOR * STEP_RTOL:g} (a batch variance sums up to "
        f"{TRAIN_BATCH * 1024} squares); " + "; ".join(metrics)
        + "; max abs error per layer and leaf: " + "; ".join(errs))
    if fails:
        raise AssertionError(f"card step differs from the CPU step: {fails}")

    # -- TrainLoop: checkpoints, an injected failure, a resume ------------
    def step_fn(state, batch):
        return train_step(model, opt, state, *batch)

    def batch_fn(step):
        xb, yb = bt.batch((ds.x, ds.y), step)
        return torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)

    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def loop(name, inject=None):
        cfg = LoopConfig(total_steps=TRAIN_STEPS,
                         ckpt_dir=str(ckpt_root / name),
                         save_every=TRAIN_SAVE_EVERY, keep=2,
                         async_save=True, inject_failure_at=inject)
        return TrainLoop(step_fn, batch_fn, fresh(dev), cfg)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                     allow_tf32=False):
        ref = loop("ref")
        t0 = time.perf_counter()
        ref_out = ref.run()
        ref_s = time.perf_counter() - t0
        crash = loop("crash", inject=TRAIN_FAIL_AT)
        try:
            crash.run()
            raise AssertionError("the injected failure did not fire")
        except InjectedFailure as e:
            failed_at = str(e)
        crash.mgr.wait()        # the crashed run's async write lands first
        resumed = loop("crash")
        resumed_out = resumed.run()
        xt, yt = bt.batch((ds.x, ds.y), 10_001)
        acc = float(eval_step(model, ref.state.params, xt, yt))
        xs, ys = batch_fn(TRAIN_STEPS)
        wall, busy, by_name, n_by_name = device_trace(
            lambda: step_fn(ref.state, (xs, ys)))
    shutil.rmtree(ckpt_root, ignore_errors=True)
    diff = [(n, float((a.double() - b.double()).abs().max()))
            for n, a, b in zip(paths(ref.state), leaves(resumed.state),
                               leaves(ref.state)) if not torch.equal(a, b)]
    losses = [r["loss"] for r in ref_out["metrics"]]
    secs = np.array([r["sec"] for r in ref_out["metrics"]])
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[train] TrainLoop {TRAIN_STEPS} steps (checkpoint every "
        f"{TRAIN_SAVE_EVERY}, async, keep 2) under cudnn deterministic: "
        f"{ref_s:.2f} s, {TRAIN_STEPS / ref_s:.2f} steps/s, "
        f"{TRAIN_STEPS * TRAIN_BATCH / ref_s:.1f} examples/s; step wall "
        f"(sync included) p50 {np.percentile(secs, 50) * 1e3:.3f} ms, p90 "
        f"{np.percentile(secs, 90) * 1e3:.3f} ms; stragglers "
        f"{sum(r['straggler'] for r in ref_out['metrics'])}")
    log(f"[train] loss mean over steps 1-10 {first:.4f}, over steps "
        f"{TRAIN_STEPS - 9}-{TRAIN_STEPS} {last:.4f}; first {losses[0]:.4f}, "
        f"last {losses[-1]:.4f}; held-out accuracy (batch 10001, "
        f"{TRAIN_BATCH} examples) {acc:.4f}")
    log(f"[train] {failed_at}; the relaunch restored step "
        f"{resumed.start_step} and ran {len(resumed_out['metrics'])} steps; "
        f"final state of {len(leaves(ref.state))} leaves torch.equal to the "
        f"uninterrupted run: {not diff}"
        + (f"; differing leaves {diff[:5]}" if diff else ""))
    log(f"[train] one traced train step (B {TRAIN_BATCH}): wall {wall:.3f} "
        f"ms, device busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}%, "
        f"{sum(n_by_name.values())} device activities; by activity: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")
    if not last < first:
        raise AssertionError(f"the loss did not fall: {first} -> {last}")
    if resumed.start_step == 0 or diff:
        raise AssertionError("the resumed run does not equal the "
                             "uninterrupted one")
    if [r["loss"] for r in resumed_out["metrics"]] != losses[
            resumed.start_step:]:
        raise AssertionError("the resumed losses differ")

    # -- packed scores against the fp eval logits -------------------------
    trained = ref.state.params
    packed = pack_params(model.specs, trained, device=dev)
    x_eval = torch.from_numpy(xt[:N_REQUESTS]).to(dev)
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                     allow_tf32=False), torch.no_grad():
        logits, _ = model.apply_fp(trained, x_eval, train=False)
    x_words = prepare_input_packed(x_eval)
    scores = forward_packed(model.specs, packed, x_words)
    if not torch.equal(scores, logits.to(torch.int32)) or not torch.equal(
            logits, logits.round()):
        raise AssertionError("fp eval logits differ from the packed scores: "
                             + fp_packed_divergence(model, trained, packed,
                                                    x_eval))
    log(f"[train] fp eval logits on the card equal forward_packed scores of "
        f"pack_params(trained) on {N_REQUESTS} held-out examples (integers "
        f"in [{int(scores.min())}, {int(scores.max())}])")

    # -- plan through the store (warm) and serve the trained net ----------
    store = ProfileStore(f"dir://{store_root}", device=dev)
    before = dict(store.stats())
    t0 = time.perf_counter()
    plan = api.plan_single(model, packed, batch_sizes=PROFILE_BATCHES,
                           store=store, fuse=True, device=dev)
    plan_s = time.perf_counter() - t0
    after = store.stats()
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    log(f"[train] api.plan_single(fuse=True, policy dp) through "
        f"{store.backend.uri()}: {plan_s:.2f} s, store hits {hits}, misses "
        f"{misses}; {mapping_line(plan.config)}; fused spans "
        f"{[f[:3] for f in plan.config.fused_segments]}")
    if hits < 1 or misses:
        raise AssertionError("plan_single did not warm-start from the store")
    expected = forward_packed(model.specs, packed, x_words).cpu().numpy()

    def serve_trained(config):
        """Latencies (ms) of N_REQUESTS served under `config`, each answer
        held to the plain forward_packed."""
        engine = ServingEngine(model, packed, config,
                               allowed_batch_sizes=plan.table.batch_sizes,
                               device=dev)
        engine.step(force=True)
        reqs = [engine.submit(x_words[i].cpu().numpy())
                for i in range(N_REQUESTS)]
        engine.step(force=True)
        got = np.stack([r.wait(timeout=600) for r in reqs])
        if not np.array_equal(got, expected):
            raise AssertionError("served answers of the trained net differ "
                                 "from the plain forward_packed")
        return np.array([r.latency_s for r in reqs]) * 1e3

    lat = serve_trained(plan.config)
    # the same DP mapping unfused: its device GEMM layers go through
    # kernel 1, one launch a layer, whichever spans the fusion above took
    # (a measured table may fuse every device layer into seg_cuda spans)
    lat_unfused = serve_trained(api.map_model(plan.table, policy="dp"))
    counts = launch_counts()
    log(f"[train] served {N_REQUESTS} requests of the trained net: equal to "
        f"the plain forward_packed on CUDA tensors; latency p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms "
        f"(phase 5's random-weight net: p50 {serve_p50_ms:.3f} ms); the DP "
        f"mapping unfused: equal, p50 {np.percentile(lat_unfused, 50):.3f} "
        f"ms; launches over phase 13 {counts}")
    for name in ("xnor_gemm_cuda", "segment_cuda"):
        if counts[name] == 0:
            raise AssertionError(f"phase 13 never launched {name}")
    seconds = time.perf_counter() - t_phase
    log(f"[train] phase 13: {seconds:.2f} s")
    return counts, seconds


def flash_timing(dev, gen, shape) -> dict:
    """Kernel 3 at one prefill shape (B, H, Hkv, S, D), bf16, causal, on
    (B,S,H,D) tensors seen as (B,H,S,D), as the models hand it: device
    ms per launch from the trace, ms per call, the plain version's ms,
    ``scaled_dot_product_attention``'s ms (a yardstick), and the bound:
    2 * 2 * B * H * S * S * D / 2 FLOP over the bf16 rate, or q, k, v
    and o once over the memory rate, whichever is longer."""
    import torch
    from repro_torch.kernels import flash_attention_cuda
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_plain,
    )

    B, H, Hkv, S, D = shape

    def randn(*dims):
        return torch.randn(dims, generator=gen).to(dev, torch.bfloat16)

    q = randn(B, S, H, D).transpose(1, 2)
    k = randn(B, S, Hkv, D).transpose(1, 2)
    v = randn(B, S, Hkv, D).transpose(1, 2)
    ms, how = kernel_ms(lambda: flash_attention_cuda(q, k, v),
                        "flash_attention_kernel", 20)
    # per call through the custom op and launched directly, alternately
    # (op, direct, direct, op): what the op wrapper costs a launch
    off = q.shape[2] - k.shape[2]
    calls = {"op": [], "direct": []}
    for which in ("op", "direct", "direct", "op"):
        fn = ((lambda: flash_attention_cuda(q, k, v)) if which == "op"
              else (lambda: _launch(q, k, v, True, D ** -0.5, off, False)))
        calls[which].append(time_ms(fn, 20))
    call = sum(calls["op"]) / 2
    direct = sum(calls["direct"]) / 2
    plain = time_ms(lambda: flash_attention_plain(q, k, v), 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        lib = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                   enable_gqa=True), 20)
        lib_how = "enable_gqa"
    except TypeError:   # a PyTorch without enable_gqa: k/v expanded first
        ke = k.repeat_interleave(H // Hkv, dim=1)
        ve = v.repeat_interleave(H // Hkv, dim=1)
        lib = time_ms(lambda: sdpa(q, ke, ve, is_causal=True), 20)
        lib_how = "k/v expanded"
    flops = 2 * 2 * B * H * S * S * D * 0.5
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q,k,v,o
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "how": how, "call_ms": call, "direct_call_ms": direct,
            "plain_ms": plain,
            "library_ms": lib, "library_how": lib_how, "flops": flops,
            "bytes": n_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class Routing(list):
    """Recorded expert ids, one (tokens, k) tensor per ``moe_ffn`` call,
    and in ``gaps`` each token's gap between its k-th and (k+1)-th router
    probability over the k-th: how near a tie its top-k boundary was."""

    def __init__(self):
        super().__init__()
        self.gaps: list = []


@contextlib.contextmanager
def routing_recorded():
    """The expert ids of every ``moe_ffn`` call made in the block, in call
    order (one (tokens, k) tensor per MoE layer per forward), as a
    ``Routing``: the port's ``moe.route`` wrapped for the block's
    duration."""
    import torch
    from repro_torch.models import moe

    calls = Routing()
    route = moe.route

    def recording(logits, top_k):
        gates, ids = route(logits, top_k)
        calls.append(ids)
        top = torch.topk(torch.softmax(logits.float(), dim=-1), top_k + 1,
                         dim=-1).values
        calls.gaps.append((top[:, -2] - top[:, -1]) / top[:, -2])
        return gates, ids

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


@contextlib.contextmanager
def routing_replayed(calls: list, batch: int):
    """``moe.route`` made to pick, call by call, the experts a recorded
    forward picked (`calls`: one (batch * S, k) tensor per layer, as
    ``routing_recorded`` gives them) for the positions each call routes:
    a prefill takes the next S0 positions of each row, a decode step the
    next one.  The gates are the call's own probabilities at those
    experts, renormalised, as ``moe.route`` makes them."""
    import torch
    from repro_torch.models import moe

    rows = [c.reshape(batch, -1, c.shape[-1]) for c in calls]
    taken = [0] * len(rows)
    n_calls = [0]
    route = moe.route

    def replay(logits, top_k):
        layer = n_calls[0] % len(rows)
        n_calls[0] += 1
        n = logits.shape[0] // batch
        ids = rows[layer][:, taken[layer]:taken[layer] + n].reshape(-1, top_k)
        taken[layer] += n
        gates = torch.softmax(logits.float(), dim=-1).gather(-1, ids)
        return gates / gates.sum(dim=-1, keepdim=True), ids

    moe.route = replay
    try:
        yield
    finally:
        moe.route = route


def topk_sets(calls: list, batch: int):
    """(L, B, S, k) sorted expert ids from a run of forwards' recorded
    calls: layer l's calls are every L-th one, their tokens appended in
    call order (a prefill, then one token per decode step)."""
    import torch

    return [torch.cat([c.reshape(batch, -1, c.shape[-1]) for c in layer],
                      dim=1).sort(dim=-1).values
            for layer in calls]


def dropped_choices(calls: list, batch: int, cfg) -> int:
    """Choices past their expert's capacity over the recorded calls, each
    call's groups (batch rows) counted as ``moe_ffn`` dispatches them."""
    import torch
    from repro_torch.models.moe import capacity

    n = 0
    for ids in calls:
        per_group = ids.reshape(batch, -1)
        tg = per_group.shape[1] // cfg.moe.top_k
        counts = torch.zeros((batch, cfg.moe.n_experts), dtype=torch.int64,
                             device=ids.device)
        counts.scatter_add_(1, per_group, torch.ones_like(per_group))
        n += int((counts - capacity(cfg, tg)).clamp(min=0).sum())
    return n


@contextlib.contextmanager
def blocks_recorded():
    """The residual stream after every attention block run in the block,
    in call order (one (B, S, d) tensor per layer per forward): the
    port's ``transformer.attn_block_apply`` wrapped for the block's
    duration."""
    from repro_torch.models import transformer

    outs: list = []
    apply = transformer.attn_block_apply

    def recording(*args, **kwargs):
        out = apply(*args, **kwargs)
        outs.append(out[0].detach())
        return out

    transformer.attn_block_apply = recording
    try:
        yield outs
    finally:
        transformer.attn_block_apply = apply


def attention_blocks(cfg) -> int:
    """Attention-block applications of one forward."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every
    return cfg.n_layers


def tf_config(cfg, arch: str):
    """`cfg` under the teacher-forced checks' capacity factor (MoE)."""
    if not cfg.moe:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=TF_CAPACITY[arch]))


def f32_check_bytes(cfg, arch: str) -> int:
    """Bytes the f32 checks of ``full_width_arch`` hold at `cfg`'s depth:
    the f32 weights (``cfg.n_params()``); the logits at every position
    of the larger check (both paths of LM_CHECK_BATCH x LM_CHECK_LEN, or
    the teacher-forced full forward); the prefill's KV and the decode
    cache at the teacher-forced length; the residual streams both paths
    record; one layer's largest FFN transient (an MoE's g, u, silu(g) and
    g * u over the (G, E, C, fe) buffers at the teacher-forced capacity,
    and its (G, E, C, d) dispatch, expert outputs and gathered choices);
    and F32_SLACK."""
    from repro_torch.models.moe import capacity

    nf = cfg.n_frontend_embeds
    s_chk, s_tf = nf + LM_CHECK_LEN, nf + TF_PROMPT
    n_attn = attention_blocks(cfg)
    logits = 4 * cfg.vocab * max(2 * LM_CHECK_BATCH * s_chk,
                                 TF_BATCH * s_tf)
    kv = 2 * 2 * 4 * n_attn * TF_BATCH * s_tf * cfg.n_kv_heads * cfg.hd
    hidden = 2 * 4 * n_attn * LM_CHECK_BATCH * s_chk * cfg.d_model
    if cfg.moe:
        c = capacity(tf_config(cfg, arch), s_tf)
        fe = cfg.moe.d_expert or cfg.d_ff
        ffn = 4 * TF_BATCH * cfg.moe.n_experts * c * (
            4 * fe + 3 * cfg.d_model)
    else:
        ffn = 4 * 4 * TF_BATCH * s_tf * cfg.d_ff
    return 4 * cfg.n_params() + logits + kv + hidden + ffn + F32_SLACK


def f32_depth(cfg, arch: str, free: int) -> int:
    """The deepest depth <= ``cfg.n_layers`` whose f32 checks fit in
    `free` bytes, by ``f32_check_bytes``."""
    depth = cfg.n_layers
    while f32_check_bytes(dataclasses.replace(cfg, n_layers=depth),
                          arch) > free:
        depth -= 1
        if depth == 0:
            raise AssertionError(f"{arch}: not one layer's f32 checks fit "
                                 f"in {free / 2**30:.1f} GiB")
    return depth


def stub_embeds(cfg, batch: int, dev):
    """The vlm / audio frontend stub: (batch, n_frontend_embeds, d_model)
    standard normals from NumPy seed SEED in ``cfg.dtype`` (the shape
    ``configs.input_specs`` gives them); None for a tokens-only arch."""
    import numpy as np
    import torch

    nf = cfg.n_frontend_embeds
    if not nf:
        return None
    x = np.random.default_rng(SEED).standard_normal(
        (batch, nf, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x).to(dev, getattr(torch, cfg.dtype))


def full_width_arch(dev, arch: str) -> dict:
    """One LM of phases 4d / 4e at full width, freed before it returns:
    (1) the f32 checks at ``f32_depth``: every position's logits and the
    residual stream after every attention block through the kernel
    against the plain attention (mamba2-130m: the card against CPU
    tensors), routing equal on both paths (MoE), then the teacher-forced
    decode path against the full forward; (2) bf16 ``greedy_decode`` of
    LM_GEN tokens from LM_BATCH x LM_PROMPT prompts (after the frontend
    stub's embeds where the arch has them), its flash launches, prefill
    ms, decode ms a token, weight and peak GiB; (3) the bf16
    teacher-forced check; (4) one traced prefill.  Returns those
    numbers."""
    import gc

    import numpy as np
    import torch
    from repro_torch import configs as lm_configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import modules as lm_modules
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.tree import leaves

    plain_attn = lm_modules.chunked_attention_plain
    t_arch = time.perf_counter()
    tag = f"[{arch}]"
    cfg = lm_configs.get(arch)
    if arch in DEPTH_CUT:
        whole = cfg
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT[arch])
        log(f"{tag} depth cut to {cfg.n_layers} of {whole.n_layers} layers, "
            f"widths as published (d_model {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}): the whole model's "
            f"bf16 weights take {2 * whole.n_params() / 1e9:.1f} GB, "
            f"{cfg.n_layers} layers {2 * cfg.n_params() / 1e9:.1f} GB")
    cfg_tf = tf_config(cfg, arch)
    nf = cfg.n_frontend_embeds
    p0 = TF_PROMPT - TF_STEPS
    attn_free = FAMILY_FLASH[arch] == 0
    out = {"layers": cfg.n_layers}
    how = ("chunked prefill {} + {} recurrent decode steps vs the chunked "
           "full forward" if attn_free else
           "prefill {} through the kernel + {} decode steps vs a full "
           "forward with the plain attention").format(p0, TF_STEPS - 1)
    if nf:
        how += f", {nf} frontend embeds ahead"

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def generator():
        return torch.Generator(device=dev).manual_seed(SEED)

    def tokens(b, s):
        return torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (b, s))).to(dev)

    def by_layer(calls, n_layers):
        return [calls[i::n_layers] for i in range(n_layers)]

    def decode_path(c, params, seq, fe):
        """The logits at the last TF_STEPS positions of `seq`: a prefill
        of `fe` and the first p0 tokens through the kernel, then one
        decode step per position; with the recorded routing."""
        serve_step = lm_steps.make_serve_step(c)
        with routing_recorded() as rec:
            last, cache = lm_steps.make_prefill_step(c)(params, seq[:, :p0],
                                                        fe)
            cache = lm_steps.decode_cache(c, cache, nf + TF_PROMPT,
                                          device=dev)
            dec = [last]
            for t in range(TF_STEPS - 1):
                logits, cache = serve_step(params, cache,
                                           seq[:, p0 + t:p0 + t + 1])
                dec.append(logits)
            del cache
        return torch.stack(dec, dim=1), rec

    def teacher_forced(c, params, seq, fe):
        """``decode_path`` and, at the same positions, a full forward
        with the plain attention; with each path's recorded routing."""
        dec, rec_dec = decode_path(c, params, seq, fe)
        with routing_recorded() as rec_full:
            ref, _, _ = lm.forward(c, params, seq, frontend_embeds=fe,
                                   attention=plain_attn)
        ref = ref[:, nf + p0 - 1:].clone()
        return dec, ref, rec_dec, rec_full

    seq = tokens(TF_BATCH, TF_PROMPT - 1)

    # -- f32 at the deepest depth that fits: the kernel against the plain
    # attention (or the card against CPU tensors), then teacher-forced ----
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    depth = f32_depth(cfg, arch, free)
    need = f32_check_bytes(dataclasses.replace(cfg, n_layers=depth), arch)
    if depth < F32_MIN_DEPTH.get(arch, 1):
        raise AssertionError(f"{arch}: f32 checks fit {depth} layers, "
                             f"{F32_MIN_DEPTH[arch]} required")
    out["f32_depth"] = depth
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=depth)
    p32 = lm.init_params(cfg32, generator(), dev)
    toks = tokens(LM_CHECK_BATCH, LM_CHECK_LEN)
    fe32 = stub_embeds(cfg32, LM_CHECK_BATCH, dev)
    with routing_recorded() as rec, blocks_recorded() as hid:
        lk, _, aux_k = lm.forward(cfg32, p32, toks, frontend_embeds=fe32)
        n_k, n_h = len(rec), len(hid)
        if attn_free:
            lp, _, _ = lm.forward(
                cfg32, tree_to(p32, "cpu"), toks.cpu(),
                frontend_embeds=None if fe32 is None else fe32.cpu())
            other = "the same forward on CPU tensors"
        else:
            lp, _, _ = lm.forward(cfg32, p32, toks, frontend_embeds=fe32,
                                  attention=plain_attn)
            other = "the plain attention"
    lp = lp.to(dev)
    rel32 = rel_err(lk, lp)
    per_block = [rel_err(a, b.to(dev)) for a, b in zip(hid[:n_h], hid[n_h:])]
    del hid
    note = ""
    if per_block:
        worst = max(range(len(per_block)), key=per_block.__getitem__)
        note += (f"; the residual stream after each of {len(per_block)} "
                 f"attention blocks: worst {per_block[worst]:.3e} (block "
                 f"{worst})")
    if cfg.moe:
        a = torch.stack(topk_sets(by_layer(rec[:n_k], depth),
                                  LM_CHECK_BATCH))
        b = torch.stack(topk_sets(by_layer(rec[n_k:], depth),
                                  LM_CHECK_BATCH))
        agree = (a == b).all(-1)                        # (L, B, S)
        route_share = float(agree.float().mean())
        note += (f"; (token, layer) top-{cfg.moe.top_k} sets that agree "
                 f"between the paths: {route_share:.6f} of {agree.numel()} "
                 f"({int((~agree).sum())} differ); aux {float(aux_k):.6f}")
        if not bool(agree.all()):
            raise AssertionError(f"{arch} f32 routing differs between the "
                                 f"paths at {int((~agree).sum())} (token, "
                                 f"layer) sets")
    if not (torch.isfinite(lk).all() and rel32 <= LM_F32_REL
            and all(r <= LM_F32_REL for r in per_block)):
        raise AssertionError(f"{arch} f32: logits rel {rel32}, residual "
                             f"streams {per_block} against {other}")
    out["f32_rel"] = rel32
    log(f"{tag} f32 {depth} of {cfg.n_layers} layers (the deepest whose "
        f"checks fit: {need / 2**30:.1f} GiB of {free / 2**30:.1f} GiB "
        f"free), B={LM_CHECK_BATCH} S={LM_CHECK_LEN}"
        + (f" + {nf} frontend embeds" if nf else "")
        + f": logits at all {lk.shape[1]} positions against {other}, "
        f"relative max error {rel32:.3e} (limit {LM_F32_REL}){note}")
    del lk, lp, rec
    tf32 = dataclasses.replace(cfg_tf, dtype="float32", n_layers=depth)
    fe_tf = stub_embeds(tf32, TF_BATCH, dev)
    dec, ref, rec_dec, rec_full = teacher_forced(tf32, p32, seq, fe_tf)
    rel_tf32 = rel_err(dec, ref)
    held_rel, note = rel_tf32, ""
    if cfg.moe:
        # where the two f32 paths' routing differs, the decode path is
        # held again under the full forward's routing; every flip in the
        # lowest layer that has one (the others may follow from it) must
        # be a tie at f32's precision on the full path
        a = torch.stack(topk_sets(by_layer(rec_dec, depth), TF_BATCH))
        b = torch.stack(topk_sets(by_layer(rec_full, depth), TF_BATCH))
        flip = ~(a == b).all(-1)                        # (L, B, S)
        gaps = torch.stack([torch.cat(layer).reshape(TF_BATCH, -1) for
                            layer in by_layer(rec_full.gaps, depth)])
        n_flip = int(flip.sum())
        note = (f"; (token, layer) top-{cfg.moe.top_k} sets that differ "
                f"between the paths: {n_flip} of {flip.numel()}")
        if n_flip:
            low = int(flip.any(-1).any(-1).nonzero()[0])
            first = gaps[low][flip[low]]
            where = flip.nonzero().tolist()
            with routing_replayed(rec_full, TF_BATCH):
                dec_r, _ = decode_path(tf32, p32, seq, fe_tf)
            held_rel = rel_err(dec_r, ref)
            note += (f", with each path's own routing {rel_tf32:.3e}, at "
                     f"(layer, row, position) {where[:8]}"
                     f"{' ...' if len(where) > 8 else ''}; the lowest "
                     f"layer's gaps between the k-th and (k+1)-th "
                     f"probabilities {first.tolist()}; under the full "
                     f"forward's routing the decode path is "
                     f"{held_rel:.3e} from it")
            del dec_r
            if float(first.max()) > LM_F32_REL:
                raise AssertionError(f"{arch} f32 routing differs where no "
                                     f"tie explains it: gaps "
                                     f"{first.tolist()}")
    if not (torch.isfinite(dec).all() and held_rel <= LM_F32_REL):
        raise AssertionError(f"{arch} f32 teacher-forced logits: rel "
                             f"{held_rel}{note}")
    # the f32 full forward at full depth: the truth bf16 drifts from
    truth = ref if depth == cfg.n_layers else None
    log(f"{tag} teacher-forced f32 {depth} layers B={TF_BATCH} prompt "
        f"{TF_PROMPT} ({how}): relative max error {held_rel:.3e} "
        f"(limit {LM_F32_REL}){note}")
    del p32, dec, ref, rec_dec, rec_full
    gc.collect()
    torch.cuda.empty_cache()

    # -- bf16: greedy_decode at full width ----------------------------------
    t0 = time.perf_counter()
    params = lm.init_params(cfg, generator(), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out["weights_gib"] = sum(t.numel() * t.element_size()
                             for t in leaves(params)) / 2**30
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompt_t = torch.from_numpy(prompt).to(dev)
    fe = stub_embeds(cfg, LM_BATCH, dev)
    lm_steps.greedy_decode(cfg, params, prompt[:, :128], n_steps=2,
                           max_len=nf + 130, device=dev,
                           frontend_embeds=fe)                 # warm-up
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    toks_out = lm_steps.greedy_decode(
        cfg, params, prompt, n_steps=LM_GEN,
        max_len=nf + LM_PROMPT + LM_GEN, device=dev, stats=stats,
        frontend_embeds=fe)
    counts = launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["launches"] = counts["flash_attention_cuda"]
    if out["launches"] != FAMILY_FLASH[arch]:
        raise AssertionError(
            f"{arch}: flash_attention_cuda launched {out['launches']} "
            f"times in one prefill, {FAMILY_FLASH[arch]} expected")
    if toks_out.shape != (LM_BATCH, LM_GEN) or not bool(
            ((toks_out >= 0) & (toks_out < cfg.vocab)).all()):
        raise AssertionError(f"{arch} greedy tokens "
                             f"{tuple(toks_out.shape)}")
    out["prefill_ms"] = stats["prefill_s"] * 1e3
    out["decode_ms"] = stats["decode_s"] * 1e3 / stats["decode_steps"]
    tok_s = LM_BATCH * LM_GEN / (stats["prefill_s"] + stats["decode_s"])
    log(f"{tag} bf16 {cfg.n_params() / 1e9:.3f} B parameters drawn on "
        f"the card in {init_s:.2f} s, {out['weights_gib']:.2f} GiB of "
        f"weights; greedy_decode B={LM_BATCH} prompt {LM_PROMPT}"
        + (f" after {nf} frontend embeds" if nf else "")
        + f" gen {LM_GEN}: prefill {out['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms']:.3f} ms/token, {tok_s:.1f} tokens/s, peak "
        f"allocated {out['peak_gib']:.2f} GiB; launches {counts}; sample "
        f"{toks_out[0, :8].tolist()}")

    # -- bf16 teacher-forced -----------------------------------------------
    dec, ref, rec_dec, rec_full = teacher_forced(
        cfg_tf, params, seq, stub_embeds(cfg, TF_BATCH, dev))
    held = torch.ones(dec.shape[:2], dtype=torch.bool, device=dev)
    note = ""
    if cfg.moe:
        drops = dropped_choices(rec_dec + rec_full, TF_BATCH, cfg_tf)
        if drops:
            raise AssertionError(f"{arch}: {drops} choices dropped under "
                                 f"capacity_factor {TF_CAPACITY[arch]}")
        a = torch.stack(topk_sets(by_layer(rec_dec, cfg.n_layers),
                                  TF_BATCH))
        b = torch.stack(topk_sets(by_layer(rec_full, cfg.n_layers),
                                  TF_BATCH))
        agree = (a == b).all(-1)                        # (L, B, S)
        share = float(agree.float().mean())
        per_layer = agree.float().mean((1, 2)).tolist()
        held = agree[:, :, nf + p0 - 1:].all(0)         # (B, STEPS)
        note = (f"; 0 choices dropped under capacity_factor "
                f"{TF_CAPACITY[arch]}; routing: {share:.4f} of "
                f"{agree.numel()} (token, layer) top-{cfg.moe.top_k} sets "
                f"agree (floor {ROUTE_AGREE_FLOOR}), by layer "
                f"{[round(x, 3) for x in per_layer]}; {int(held.sum())} of "
                f"{held.numel()} compared positions agree in every layer")
        if share < ROUTE_AGREE_FLOOR or not bool(held.any()):
            raise AssertionError(f"{arch} routing agreement {share}, "
                                 f"{int(held.sum())} positions held")
    diff = (dec - ref).abs().amax(-1)                   # (B, STEPS)
    rel16 = float(diff[held].max() / ref[held].abs().max())
    rel_all = float(diff.max() / ref.abs().max())
    agree_tok = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    limit = LM_BF16_REL
    if truth is not None:   # bf16's own distance from the f32 truth
        drift = rel_err(ref, truth)
        # an MoE's drift counts the positions whose bf16 routing left
        # f32's, which its held positions leave out: it raises no limit
        if not cfg.moe:
            limit = max(LM_BF16_REL, drift)
        note += (f"; bf16 drift from the f32 full forward: full "
                 f"{drift:.3e}, decode path {rel_err(dec, truth):.3e}")
    if not (torch.isfinite(dec).all() and rel16 <= limit):
        raise AssertionError(f"{arch} bf16 teacher-forced logits: rel "
                             f"{rel16} (limit {limit})")
    out["bf16_rel"], out["bf16_limit"] = rel16, limit
    log(f"{tag} teacher-forced bf16 B={TF_BATCH} prompt {TF_PROMPT} "
        f"({how}): relative max error {rel16:.3e} at the "
        f"{int(held.sum())} held positions (limit {limit:.3e}), "
        f"{rel_all:.3e} over all {diff.numel()}; argmax agreement "
        f"{agree_tok:.4f}{note}")
    del dec, ref, seq, truth, rec_dec, rec_full

    # -- one traced prefill ------------------------------------------------
    prefill = lm_steps.make_prefill_step(cfg)
    prefill(params, prompt_t, fe)
    wall, busy, by_name = traced(f"{arch} trace",
                                 lambda: prefill(params, prompt_t, fe),
                                 launch_counts)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out["idle"] = 1 - busy / wall
    log(f"{tag} one traced prefill B={LM_BATCH} S={nf + LM_PROMPT}: wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms, idle "
        f"{100 * out['idle']:.1f}%; by activity: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
    del params, prompt_t, fe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} {time.perf_counter() - t_arch:.2f} s")
    return out


def family_phase(dev) -> dict:
    """Phase 4d: deepseek-moe-16b, zamba2-7b and mamba2-130m at full
    width, one at a time; returns {arch: ``full_width_arch``'s
    numbers}."""
    t_phase = time.perf_counter()
    res = {arch: full_width_arch(dev, arch) for arch in FAMILY_ARCHS}
    log(f"[families] phase 4d: {time.perf_counter() - t_phase:.2f} s")
    return res


def dense_family_phase(dev, device_line: str) -> dict:
    """Phase 4e: the six attention configurations the card had not served
    at full width (olmo-1b, minitron-8b, qwen2.5-14b, musicgen-medium,
    llava-next-mistral-7b, grok-1 at DEPTH_CUT's 4 layers), one at a
    time, cheapest first; returns {arch: ``full_width_arch``'s
    numbers}."""
    t_phase = time.perf_counter()
    res = {arch: full_width_arch(dev, arch) for arch in DENSE_ARCHS}
    for arch, r in res.items():
        log(f"[dense] {arch} ({r['layers']} layers, bf16) on {device_line}: "
            f"prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms']:.3f} "
            f"ms/token, weights {r['weights_gib']:.2f} GiB, peak "
            f"{r['peak_gib']:.2f} GiB, {r['launches']} flash launches a "
            f"prefill, idle {100 * r['idle']:.1f}%; f32 at {r['f32_depth']} "
            f"layers {r['f32_rel']:.3e}; bf16 teacher-forced "
            f"{r['bf16_rel']:.3e} (limit {r['bf16_limit']:.3e})")
    log(f"[dense] phase 4e: {time.perf_counter() - t_phase:.2f} s")
    return res


def lm_train_phase(dev, flash_ms: float) -> dict:
    """Phase 14: LM training on the card.  (a) every arch's smoke config
    (head dim 32) one AdamW step on the card against the same step on
    CPU tensors, f32, twice (``accum_steps`` 1, then 2 with bf16
    gradient compression); (b) qwen2-0.5B at full width: an f32 loss and
    gradient through the kernel-forward ``FlashAttentionFn`` against
    plain autograd through the plain attention, then bf16 training
    through ``repro_torch.launch.train.main`` (its flash launches counted
    around the run), a traced step, peak memory and the recompute
    backward's time; (c) mamba2-130m at full width: an f32 step whose
    grad_norm is finite and the same step through the reference's
    exp-then-mask SSD, which must not be; bf16 ``TrainLoop`` with an
    injected failure and a resume ``torch.equal`` to the uninterrupted
    run.  `flash_ms` is kernel 3's device ms per launch at qwen2's
    prefill shape (phase 4c).  Returns {"train_launches", "steps",
    "seconds"}."""
    import numpy as np
    import torch
    from repro_torch import configs as lm_configs
    from repro_torch.data import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    from repro_torch.launch import train as lm_train
    from repro_torch.models import mamba2 as lm_mamba2
    from repro_torch.models import modules as lm_modules
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.runtime import InjectedFailure, LoopConfig, TrainLoop
    from repro_torch.tree import flatten, leaves, paths, unflatten

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32

    def rel(a, b) -> float:
        a, b = float(a), float(b)
        return abs(a - b) / abs(b) if b else abs(a)

    def leaf_rel(a, b) -> float:
        scale = float(b.abs().max())
        diff = float((a.cpu().double() - b.cpu().double()).abs().max())
        return diff / scale if scale else diff

    def grads(cfg, params, batch, attention=None):
        """(loss, [gradient leaves]) of ``loss_fn`` at `params`."""
        flat, tdef = flatten(params)
        live = [t.detach().requires_grad_() for t in flat]
        loss, _ = lm_steps.loss_fn(cfg, unflatten(tdef, live),
                                   batch["tokens"], batch["labels"],
                                   batch.get("frontend_embeds"),
                                   attention=attention)
        got = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(live, got)]

    def n_attention(cfg) -> int:
        """Kernel 3's launches in one train forward and backward: each
        attention application once, and once more in its layer's
        recompute where ``cfg.remat`` checkpoints it (the hybrid's
        weight-shared block is never checkpointed)."""
        n = attention_blocks(cfg)
        return n if cfg.family == "hybrid" or not cfg.remat else 2 * n

    def remat_held(tag, cfg, params, batch) -> tuple:
        """The loss and gradient of `cfg` at `params` with remat on and
        off: the losses equal, each leaf bit-equal (MoE: within
        ``STEP_GRAD_RTOL``), kernel 3 launched ``n_attention`` times by
        each.  Returns (loss, bit-equal leaves, leaves, worst rel,
        {remat: launches})."""
        got, launched = {}, {}
        for remat in (True, False):
            c = dataclasses.replace(cfg, remat=remat)
            before = launch_counts()["flash_attention_cuda"]
            got[remat] = grads(c, params, batch)
            torch.cuda.synchronize()
            launched[remat] = launch_counts()["flash_attention_cuda"] - before
            if launched[remat] != n_attention(c):
                raise AssertionError(
                    f"{tag} remat={remat}: {launched[remat]} flash launches, "
                    f"{n_attention(c)} expected")
        (l_on, g_on), (l_off, g_off) = got[True], got[False]
        if not torch.equal(l_on, l_off):
            raise AssertionError(f"{tag}: loss with remat {float(l_on)!r}, "
                                 f"without {float(l_off)!r}")
        same = [torch.equal(a, c) for a, c in zip(g_on, g_off)]
        errs = [0.0 if eq else leaf_rel(a, c)
                for eq, a, c in zip(same, g_on, g_off)]
        limit = STEP_GRAD_RTOL if cfg.moe else 0.0
        if max(errs) > limit:
            worst_i = int(np.argmax(errs))
            raise AssertionError(
                f"{tag}: gradient {paths(params)[worst_i]} with remat vs "
                f"without rel {errs[worst_i]} (limit {limit})")
        return float(l_on), sum(same), len(same), max(errs), launched

    def remat_ab(tag, cfg, batch) -> dict:
        """`cfg` at full width from seeded params and one batch, remat on
        and off: ``remat_held``, then per setting one warm AdamW step and
        ``REMAT_AB_STEPS`` timed by CUDA events, the peak allocated over
        them (``reset_peak_memory_stats`` after the warm step) and kernel
        3's launches a step.  Returns {remat: numbers}."""
        import gc

        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        loss, n_same, n_all, r_err, _ = remat_held(tag, cfg, params, batch)
        n_tok = batch["tokens"].numel()
        out = {}
        for remat in (True, False):
            c = dataclasses.replace(cfg, remat=remat)
            opt = adamw(LM_TRAIN_LR)
            step = lm_steps.make_train_step(c, opt)
            gc.collect()
            torch.cuda.empty_cache()
            p, o, _ = step(params, opt.init(params), batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()["flash_attention_cuda"]
            times = []
            for _ in range(REMAT_AB_STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                p, o, m = step(p, o, batch)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            n = (launch_counts()["flash_attention_cuda"] - before) / (
                REMAT_AB_STEPS)
            if n != n_attention(c):
                raise AssertionError(f"{tag} remat={remat}: {n} flash "
                                     f"launches a step")
            out[remat] = {
                "p50_ms": float(np.percentile(times, 50)),
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "launches": n, "times": times}
            out[remat]["tok_s"] = n_tok / (out[remat]["p50_ms"] / 1e3)
            del p, o, m, step
        log(f"[lm train] {tag} bf16 B={LM_TRAIN_B} S={LM_TRAIN_S} remat on "
            f"vs off, same params and batch: loss {loss:.6f} equal, "
            f"{n_same} of {n_all} gradient leaves bit-equal (worst rel "
            f"{r_err:.2e}); " + "; ".join(
                f"remat {'on' if r else 'off'}: step p50 "
                f"{v['p50_ms']:.3f} ms of {[round(t, 3) for t in v['times']]}"
                f" (CUDA events, after a warm step), {v['tok_s']:.0f} "
                f"tokens/s, peak allocated {v['peak_bytes'] / 2**30:.2f} "
                f"GiB, kernel 3 launches a step {v['launches']:g}"
                for r, v in out.items())
            + f"; remat step / plain {out[True]['p50_ms'] / out[False]['p50_ms']:.3f}, "
            f"peak {out[True]['peak_bytes'] / out[False]['peak_bytes']:.3f}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # -- (a) every arch's smoke config: card step against CPU step --------
    worst = {"metric": 0.0, "grad": 0.0, "firm": 0.0, "soft": 0.0}
    for arch in lm_configs.ARCH_NAMES:
        cfg = lm_configs.get_smoke(arch)
        if cfg.family != "ssm":   # the kernel takes head dims from 32 up
            cfg = dataclasses.replace(cfg, head_dim=LM_TRAIN_HEAD_DIM)
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                               "cpu")
        rng = np.random.default_rng(SEED)
        b_np = {"tokens": rng.integers(0, cfg.vocab, (
            LM_TRAIN_SMOKE_B, LM_TRAIN_SMOKE_S), dtype=np.int32)}
        b_np["labels"] = b_np["tokens"]
        if cfg.n_frontend_embeds:
            b_np["frontend_embeds"] = rng.standard_normal(
                (LM_TRAIN_SMOKE_B, cfg.n_frontend_embeds, cfg.d_model)
            ).astype(np.float32)
        b_cpu = {k: torch.from_numpy(v) for k, v in b_np.items()}
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        p_dev = tree_to(p_cpu, dev)
        line = []
        for accum, comp in ((1, "none"), (2, "bf16")):
            opt = adamw(LM_TRAIN_LR)
            step = lm_steps.make_train_step(cfg, opt, accum_steps=accum,
                                            grad_compression=comp)
            new_c, _, m_c = step(p_cpu, opt.init(p_cpu), b_cpu)
            before = launch_counts()["flash_attention_cuda"]
            new_d, _, m_d = step(p_dev, opt.init(p_dev), b_dev)
            torch.cuda.synchronize()
            launched = launch_counts()["flash_attention_cuda"] - before
            if launched != n_attention(cfg) * accum:
                raise AssertionError(
                    f"{arch} accum {accum}: {launched} flash launches, "
                    f"{n_attention(cfg) * accum} attention applications")
            errs = {k: rel(m_d[k], m_c[k]) for k in m_c}
            worst["metric"] = max(worst["metric"], *errs.values())
            if max(errs.values()) > STEP_RTOL:
                raise AssertionError(f"{arch} accum {accum}: metrics card "
                                     f"vs CPU {errs}")
            # the gradient the step took, on the CPU: the micro-batch mean
            # (and its bf16 round trip) where it accumulates
            mb = LM_TRAIN_SMOKE_B // accum
            g_cpu = None
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in b_cpu.items()}
                _, g = grads(cfg, p_cpu, part)
                g_cpu = g if g_cpu is None else [
                    a + c for a, c in zip(g_cpu, g)]
            g_cpu = [g / accum for g in g_cpu]
            if comp == "bf16":
                g_cpu = [g.to(torch.bfloat16).float() for g in g_cpu]
            if accum == 1:
                _, g_dev = grads(cfg, p_dev, b_dev)
                for name, a, c in zip(paths(p_cpu), g_dev, g_cpu):
                    e = leaf_rel(a, c)
                    worst["grad"] = max(worst["grad"], e)
                    if e > STEP_GRAD_RTOL:
                        raise AssertionError(f"{arch} gradient {name}: "
                                             f"card vs CPU rel {e}")
            clip = min(1.0, 1.0 / (float(m_c["grad_norm"]) + 1e-9))
            for name, a, c, g in zip(paths(p_cpu), leaves(new_d),
                                     leaves(new_c), g_cpu):
                d = (a.cpu().double() - c.double()).abs()
                firm = (clip * g).abs() >= STEP_GRAD_FLOOR
                f_err = float(d[firm].max()) if bool(firm.any()) else 0.0
                s_err = float(d[~firm].max()) if bool((~firm).any()) else 0.0
                worst["firm"] = max(worst["firm"], f_err / LM_TRAIN_LR)
                worst["soft"] = max(worst["soft"], s_err / LM_TRAIN_LR)
                if (f_err > STEP_W_ATOL * LM_TRAIN_LR
                        or s_err > 2 * LM_TRAIN_LR):
                    raise AssertionError(f"{arch} accum {accum}: {name} "
                                         f"moved {f_err} / {s_err} apart")
            line.append(f"accum {accum} {comp}: loss {float(m_d['loss']):.5f}"
                        f" rel {errs['loss']:.2e}, grad_norm rel "
                        f"{errs['grad_norm']:.2e}, {launched} launches")
        _, n_same, n_all, r_err, r_n = remat_held(arch, cfg, p_dev, b_dev)
        line.append(f"remat on vs off: {n_same} of {n_all} gradient leaves "
                    f"bit-equal, worst rel {r_err:.2e}, launches {r_n[True]} "
                    f"/ {r_n[False]}")
        log(f"[lm train] {arch} smoke (head dim {cfg.hd}) B "
            f"{LM_TRAIN_SMOKE_B} S {LM_TRAIN_SMOKE_S}: " + "; ".join(line))
    log(f"[lm train] 10 archs, card step vs CPU step: worst metric rel "
        f"{worst['metric']:.3e} (limit {STEP_RTOL}), worst gradient leaf "
        f"rel {worst['grad']:.3e} (limit {STEP_GRAD_RTOL}), params after "
        f"AdamW {worst['firm']:.3e} x lr where the clipped |g| >= "
        f"{STEP_GRAD_FLOOR:g} (limit {STEP_W_ATOL}), {worst['soft']:.3e} x "
        f"lr below it (limit 2)")

    # -- (b) qwen2-0.5B at full width ---------------------------------------
    cfg = lm_configs.get(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_CHECK_BATCH, LM_CHECK_LEN))).to(dev)
    batch = {"tokens": toks, "labels": toks}

    def plain_autograd(*args, **kwargs):
        return lm_modules.chunked_attention_plain(
            *args, **{**kwargs, "remat_chunks": False})

    before = launch_counts()["flash_attention_cuda"]
    loss_k, g_k = grads(cfg32, p32, batch)
    if launch_counts()["flash_attention_cuda"] - before != n_attention(cfg32):
        raise AssertionError("the f32 check did not go through the kernel")
    loss_p, g_p = grads(cfg32, p32, batch, attention=plain_autograd)
    g_errs = [leaf_rel(a, c) for a, c in zip(g_k, g_p)]
    worst_i = int(np.argmax(g_errs))
    log(f"[lm train] {cfg.name} f32 B={LM_CHECK_BATCH} S={LM_CHECK_LEN}: "
        f"loss through the kernel + chunk-recompute backward "
        f"{float(loss_k):.6f}, plain autograd {float(loss_p):.6f} (rel "
        f"{rel(loss_k, loss_p):.3e}); worst of {len(g_errs)} gradient "
        f"leaves {g_errs[worst_i]:.3e} ({paths(p32)[worst_i]}); limit "
        f"{LM_F32_REL}")
    if rel(loss_k, loss_p) > LM_F32_REL or max(g_errs) > LM_F32_REL:
        raise AssertionError("qwen2 f32 gradient: kernel path vs plain")
    del p32, g_k, g_p
    torch.cuda.empty_cache()

    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_"))
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = lm_train.main([
        "--arch", LM_ARCH, "--full", "--device", "cuda",
        "--steps", str(LM_TRAIN_STEPS), "--batch", str(LM_TRAIN_B),
        "--seq", str(LM_TRAIN_S), "--save-every", str(10 * LM_TRAIN_STEPS),
        "--ckpt", str(ckpt_root / "qwen2")])
    train_s = time.perf_counter() - t0
    train_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(ckpt_root / "qwen2", ignore_errors=True)
    rows = res["out"]["metrics"]
    losses = [r["loss"] for r in rows]
    secs = np.array([r["sec"] for r in rows])
    n = train_counts["flash_attention_cuda"]
    tok_s = (LM_TRAIN_STEPS - 1) * LM_TRAIN_B * LM_TRAIN_S / secs[1:].sum()
    log(f"[lm train] {cfg.name} bf16 launch.train.main B={LM_TRAIN_B} "
        f"S={LM_TRAIN_S} {LM_TRAIN_STEPS} steps (AdamW, warmup-cosine lr "
        f"3e-3, make_token_stream): {train_s:.2f} s with one final "
        f"checkpoint; step wall (data and sync included) p50 "
        f"{np.percentile(secs, 50) * 1e3:.3f} ms, p90 "
        f"{np.percentile(secs, 90) * 1e3:.3f} ms, first step "
        f"{secs[0] * 1e3:.1f} ms; "
        f"{tok_s:.0f} tokens/s over steps 2-{LM_TRAIN_STEPS}; peak allocated "
        f"{peak / 2**30:.2f} GiB; flash launches {n} "
        f"({n / LM_TRAIN_STEPS:g} per step); loss "
        + " ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError("a qwen2 training loss is not finite")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the qwen2 loss did not fall: {losses}")
    if not cfg.remat or n != 2 * cfg.n_layers * LM_TRAIN_STEPS:
        raise AssertionError(f"flash_attention_cuda launched {n} times in "
                             f"{LM_TRAIN_STEPS} steps of {cfg.n_layers} "
                             f"layers, each run and rerun by its remat")
    loop = res["loop"]
    nxt = loop.batch_fn(LM_TRAIN_STEPS)
    wall, busy, by_name = traced(
        "lm train trace", lambda: loop.step_fn(loop.state, nxt),
        launch_counts)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    del res, loop
    torch.cuda.empty_cache()
    # the chunk-recompute backward of one attention layer at this shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v, g = (torch.randn((LM_TRAIN_B, LM_TRAIN_S, h, D), device=dev,
                              dtype=torch.bfloat16).transpose(1, 2)
                  .requires_grad_() for h in (H, Hkv, Hkv, H))
    out = FlashAttentionFn.apply(q, k, v, True, D ** -0.5, 0,
                                 cfg.attn_q_chunk, cfg.attn_kv_chunk, True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (q, k, v), g.detach(), retain_graph=True), 3)
    del q, k, v, g, out
    log(f"[lm train] one traced train step B={LM_TRAIN_B} S={LM_TRAIN_S}: "
        f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
        f"{100 * (1 - busy / wall):.1f}%; by activity: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
    log(f"[lm train] attention per layer at B={LM_TRAIN_B} S={LM_TRAIN_S} "
        f"H={H}/{Hkv} D={D} bf16: kernel forward {flash_ms:.4f} ms (phase "
        f"4c), chunk-recompute backward {bwd_ms:.3f} ms per call; x "
        f"{cfg.n_layers} layers: {bwd_ms * cfg.n_layers:.1f} ms, "
        f"{100 * bwd_ms * cfg.n_layers / busy:.1f}% of the traced step's "
        f"busy time")
    ab_tokens = make_token_stream(SEED, cfg.vocab)(0, LM_TRAIN_B,
                                                   LM_TRAIN_S).to(dev)
    ab = {cfg.name: remat_ab(cfg.name, cfg, {"tokens": ab_tokens,
                                             "labels": ab_tokens})}

    # -- (c) mamba2-130m at full width ---------------------------------------
    mcfg = lm_configs.get("mamba2_130m")
    m32 = dataclasses.replace(mcfg, dtype="float32")
    pm = lm.init_params(m32, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, mcfg.vocab, (LM_CHECK_BATCH, LM_CHECK_LEN))).to(dev)
    mbatch = {"tokens": toks, "labels": toks}
    opt = adamw(LM_TRAIN_LR)
    step = lm_steps.make_train_step(m32, opt)
    _, _, m_fixed = step(pm, opt.init(pm), mbatch)
    fixed = lm_mamba2._intra_decay
    # the reference's order (src/repro/models/mamba2.py:58-61)
    lm_mamba2._intra_decay = lambda diff, mask: torch.where(
        mask, torch.exp(diff), 0.0)
    try:
        _, _, m_ref = step(pm, opt.init(pm), mbatch)
    finally:
        lm_mamba2._intra_decay = fixed
    log(f"[lm train] mamba2-130m f32 B={LM_CHECK_BATCH} S={LM_CHECK_LEN} "
        f"chunk {mcfg.ssm.chunk}: grad_norm {float(m_fixed['grad_norm'])!r} "
        f"with exp after the mask, {float(m_ref['grad_norm'])!r} with the "
        f"reference's exp then mask (loss {float(m_fixed['loss']):.6f} / "
        f"{float(m_ref['loss']):.6f})")
    if not math.isfinite(float(m_fixed["grad_norm"])):
        raise AssertionError("mamba2 grad_norm is not finite")
    if math.isfinite(float(m_ref["grad_norm"])):
        raise AssertionError("the reference's SSD order gave a finite "
                             "grad_norm: the repair is not shown")
    if float(m_fixed["loss"]) != float(m_ref["loss"]):
        raise AssertionError("the two SSD orders differ in the forward")
    del pm
    torch.cuda.empty_cache()

    sample = make_token_stream(SEED, mcfg.vocab)
    mopt = adamw(linear_warmup_cosine(3e-3, 10, SSD_TRAIN_STEPS))
    mstep = lm_steps.make_train_step(mcfg, mopt)
    init = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED),
                          dev)

    def step_fn(state, batch):
        p, o = state
        p, o, m = mstep(p, o, batch)
        return (p, o), m

    def batch_fn(i):
        t = sample(i, LM_TRAIN_B, LM_TRAIN_S).to(dev)
        return {"tokens": t, "labels": t}

    def mloop(name, inject=None):
        return TrainLoop(step_fn, batch_fn, (init, mopt.init(init)),
                         LoopConfig(total_steps=SSD_TRAIN_STEPS,
                                    ckpt_dir=str(ckpt_root / name),
                                    save_every=SSD_SAVE_EVERY, keep=2,
                                    async_save=True,
                                    inject_failure_at=inject))

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = mloop("ref")
    ref_out = ref.run()
    ref_s = time.perf_counter() - t0
    mpeak = torch.cuda.max_memory_allocated(dev)
    mnext = batch_fn(SSD_TRAIN_STEPS)
    mwall, mbusy, mby_name = traced(
        "mamba2 train trace", lambda: step_fn(ref.state, mnext),
        launch_counts)
    mtop = sorted(mby_name.items(), key=lambda kv: -kv[1])[:6]
    crash = mloop("crash", inject=SSD_FAIL_AT)
    try:
        crash.run()
        raise AssertionError("the injected failure did not fire")
    except InjectedFailure as e:
        failed_at = str(e)
    crash.mgr.wait()            # the crashed run's async write lands first
    resumed = mloop("crash")
    resumed_out = resumed.run()
    shutil.rmtree(ckpt_root, ignore_errors=True)
    diff = [(name, float((a.double() - b.double()).abs().max()))
            for name, a, b in zip(paths(ref.state), leaves(resumed.state),
                                  leaves(ref.state)) if not torch.equal(a, b)]
    mlosses = [r["loss"] for r in ref_out["metrics"]]
    msecs = [r["sec"] * 1e3 for r in ref_out["metrics"]]
    log(f"[lm train] mamba2-130m bf16 TrainLoop B={LM_TRAIN_B} "
        f"S={LM_TRAIN_S} {SSD_TRAIN_STEPS} steps (checkpoint every "
        f"{SSD_SAVE_EVERY}, async): {ref_s:.2f} s; step walls "
        + " ".join(f"{x:.1f}" for x in msecs) + " ms; loss "
        + " ".join(f"{x:.4f}" for x in mlosses)
        + f"; {failed_at}; the relaunch restored step {resumed.start_step} "
        f"and ran {len(resumed_out['metrics'])} steps; final state of "
        f"{len(leaves(ref.state))} leaves torch.equal to the uninterrupted "
        f"run: {not diff}" + (f"; differing leaves {diff[:5]}" if diff
                              else ""))
    log(f"[lm train] mamba2-130m: peak allocated {mpeak / 2**30:.2f} GiB; "
        f"one traced train step B={LM_TRAIN_B} S={LM_TRAIN_S}: wall "
        f"{mwall:.3f} ms, device busy {mbusy:.3f} ms, idle "
        f"{100 * (1 - mbusy / mwall):.1f}%; by activity: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in mtop))
    if not all(np.isfinite(mlosses)):
        raise AssertionError("a mamba2 training loss is not finite")
    if resumed.start_step == 0 or diff or [
            r["loss"] for r in resumed_out["metrics"]] != mlosses[
                resumed.start_step:]:
        raise AssertionError("the resumed mamba2 run does not equal the "
                             "uninterrupted one")
    del init, ref, crash, resumed
    ab_tokens = sample(0, LM_TRAIN_B, LM_TRAIN_S).to(dev)
    ab[mcfg.name] = remat_ab(mcfg.name, mcfg, {"tokens": ab_tokens,
                                               "labels": ab_tokens})
    seconds = time.perf_counter() - t_phase
    log(f"[lm train] phase 14: {seconds:.2f} s")
    return {"train_launches": n, "steps": LM_TRAIN_STEPS,
            "seconds": seconds, "remat_ab": ab}


def shard_plans() -> dict:
    """Phase 15 (a): param, opt, batch and cache shardings of every full
    config on abstract 16 x 16 and 2 x 16 x 16 meshes under
    ``default_scheme`` and the hillclimb's variants, from ``meta``
    specs.  Returns {arch: {mesh: sharded param leaves under the
    default scheme}}."""
    import torch
    from repro_torch import configs as lm_configs
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import leaves

    meshes = {"16x16": abstract_mesh((16, 16)),
              "2x16x16": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
    out, n_plans = {}, 0
    alloc = torch.cuda.memory_allocated()
    for arch in lm_configs.ARCH_NAMES:
        cfg = lm_configs.get(arch)
        specs = lm.param_specs(cfg)
        n_leaves = len(leaves(specs))
        counts = {}
        for mname, mesh in meshes.items():
            for vname, knobs in SHARD_VARIANTS.items():
                scheme = dataclasses.replace(SH.default_scheme(cfg), **knobs)
                ps = leaves(SH.make_param_shardings(cfg, mesh, specs, scheme))
                os_ = leaves(SH.make_opt_shardings(cfg, mesh, specs, scheme))
                if len(ps) != n_leaves or len(os_) != 2 * n_leaves + 1:
                    raise AssertionError(f"{arch} {mname} {vname}: plan "
                                         f"leaves {len(ps)}, {len(os_)}")
                n_plans += 2
                for shape in lm_configs.SHAPES:
                    if not lm_configs.cell_supported(cfg, shape):
                        continue
                    inputs = lm_configs.input_specs(cfg, shape)
                    bs = leaves(SH.make_batch_shardings(cfg, mesh, inputs,
                                                        scheme))
                    if len(bs) != len(leaves(inputs)):
                        raise AssertionError(f"{arch} {shape}: batch plan")
                    n_plans += 1
                    if "cache" in inputs:
                        SH.make_cache_shardings(cfg, mesh, inputs["cache"],
                                                scheme, allow_hd=False)
                        n_plans += 1
                if vname == "default":
                    counts[mname] = tuple(
                        sum(any(e is not None for e in s.spec) for s in sh)
                        for sh in (ps, os_))
        out[arch] = counts
        log(f"[shard plan] {arch} ({cfg.n_params() / 1e9:.2f}B params, "
            f"{n_leaves} leaves): sharded param / optimizer-state leaves "
            f"under default_scheme: 16x16 {counts['16x16']}, 2x16x16 "
            f"{counts['2x16x16']}")
    if torch.cuda.memory_allocated() != alloc:
        raise AssertionError("planning allocated device memory")
    log(f"[shard plan] {n_plans} plans over {len(out)} configs x "
        f"{len(meshes)} meshes x {len(SHARD_VARIANTS)} schemes; nothing "
        f"allocated")
    return out


def lse_visible_pairs(sq: int, kp: int, off: int) -> int:
    """(query, key) pairs a causal launch of `sq` queries against a part
    of `kp` keys at offset `off` computes: key j of the part is visible
    to query i iff j <= i + off."""
    import numpy as np

    i = np.arange(sq)
    return int(np.clip(i + off + 1, 0, kp).sum())


def lse_visible_rows(sq: int, off: int) -> int:
    """Queries of a causal launch of `sq` queries at offset `off` that see
    at least one key of the part (key 0 is visible to query i iff
    i + off >= 0): only their q rows are the function's input; the other
    rows' output is 0 and their lse -inf whatever q holds."""
    return max(0, min(sq, sq + off))


def shard_phase(dev, flash_ms: float) -> dict:
    """Phase 15: the sharding layer on one card.  (a) plans for every
    config (``shard_plans``); (b) qwen2-0.5B at full width distributed
    onto a 1 x 1 DeviceMesh in a one-rank nccl group and remeshed onto
    1 x 1 x 1; (c) the context-parallel prefill under ``use_mesh`` and
    ``scheme_context(ShardScheme(attn_kv_parallel=True))``: f32 at 2
    layers against the plain attention, bf16 at 24 layers against the
    normal prefill, kernel 3 once per (layer, KV part), confirmed by a
    trace, kernel 3's log-sum-exp launch against its plain version and
    timed; (d) HEP-Shard's ``search`` over ``SHARD_KNOBS``, each trial a
    measured bf16 AdamW train step, and the f32 gradient of the
    kernel-per-part path against plain autograd.  `flash_ms` is kernel
    3's device ms per launch at qwen2's prefill shape (phase 4c)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as lm_configs
    from repro_torch.core.hep_shard import ShardTrial, device_hbm_bytes, search
    from repro_torch.kernels import (
        flash_attention_cuda, launch_counts, reset_launch_counts,
    )
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.launch.mesh import make_debug_mesh, single_process_group
    from repro_torch.models import modules as lm_modules
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.constrain import scheme_context, use_mesh
    from repro_torch.runtime import remesh_state
    from repro_torch.tree import flatten, leaves, paths, unflatten

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.cuda.set_device(dev)      # the nccl group's device
    plans = shard_plans()
    cfg = lm_configs.get(LM_ARCH)
    kv = SH.ShardScheme(attn_kv_parallel=True)
    res: dict = {"plans": plans}

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def leaf_rel(a, b) -> float:
        scale = float(b.abs().max())
        diff = float((a.double() - b.double()).abs().max())
        return diff / scale if scale else diff

    with single_process_group("nccl"):
        # -- (b) distribute, remesh --------------------------------------
        mesh2 = make_debug_mesh((1, 1), ("data", "model"))
        mesh3 = make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        t0 = time.perf_counter()
        scheme = SH.default_scheme(cfg)
        placed = SH.distribute(params, SH.make_param_shardings(
            cfg, mesh2, params, scheme))
        moved = remesh_state(cfg, placed, mesh3, scheme)
        torch.cuda.synchronize()
        remesh_s = time.perf_counter() - t0
        want = SH.make_param_shardings(cfg, mesh3, params, scheme)
        bad = [name for name, got, orig, sh in zip(
            paths(moved), leaves(moved), leaves(params), leaves(want))
            if not (isinstance(got, DTensor)
                    and tuple(got.placements) == sh.placements()
                    and torch.equal(got.to_local(), orig))]
        log(f"[shard] {cfg.name} bf16 ({len(leaves(params))} leaves, "
            f"{sum(t.numel() for t in leaves(params)) / 1e6:.1f} M params): "
            f"distributed onto {mesh2} under {scheme}, remeshed onto "
            f"{mesh3}: {remesh_s:.3f} s; placements equal "
            f"NamedSharding.placements() and to_local() torch.equal to the "
            f"original for {len(leaves(params)) - len(bad)} of "
            f"{len(leaves(params))} leaves")
        if bad:
            raise AssertionError(f"remesh_state: leaves differ: {bad[:5]}")
        del placed, moved

        # -- (c) context-parallel prefill --------------------------------
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=SHARD_F32_LAYERS)
        p32 = lm.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(SEED), dev)
        toks32 = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_CHECK_BATCH, LM_CHECK_LEN))).to(dev)
        before = flash_attention_cuda.lse_launches
        with use_mesh(mesh2), scheme_context(kv):
            lk, _, _ = lm.forward(cfg32, p32, toks32)
        n32 = flash_attention_cuda.lse_launches - before
        lp, _, _ = lm.forward(cfg32, p32, toks32,
                              attention=lm_modules.chunked_attention_plain)
        rel32 = rel(lk, lp)
        log(f"[shard] {cfg.name} f32 {SHARD_F32_LAYERS} layers B="
            f"{LM_CHECK_BATCH} S={LM_CHECK_LEN}: logits through kernel 3 per "
            f"KV part ({n32} launches) vs the plain attention, relative max "
            f"error {rel32:.3e} (limit {LM_F32_REL})")
        if n32 != SHARD_F32_LAYERS * KV_PARTS or not (
                torch.isfinite(lk).all() and rel32 <= LM_F32_REL):
            raise AssertionError(f"context-parallel f32 logits: rel {rel32}"
                                 f", {n32} launches")
        del lk, lp

        prompt_t = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
        prefill = lm_steps.make_prefill_step(cfg)
        with use_mesh(mesh2), scheme_context(kv):
            prefill(params, prompt_t)                   # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            last_kv, _ = prefill(params, prompt_t)
            torch.cuda.synchronize()
            kv_wall = time.perf_counter() - t0
            counts = launch_counts()
            n_lse = flash_attention_cuda.lse_launches
            wall, busy, by_name = traced(
                "shard kv prefill", lambda: prefill(params, prompt_t),
                launch_counts)
        want_n = cfg.n_layers * KV_PARTS
        log(f"[shard] {cfg.name} bf16 context-parallel prefill B={LM_BATCH}"
            f" S={LM_PROMPT}: {kv_wall * 1e3:.3f} ms; launches {counts}, "
            f"with the log-sum-exp {n_lse} ({cfg.n_layers} layers x "
            f"{KV_PARTS} KV parts = {want_n}); traced: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}%"
            "; by activity: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]))
        if counts["flash_attention_cuda"] != want_n or n_lse != want_n:
            raise AssertionError(f"kernel 3 launched {counts} / {n_lse} "
                                 f"times, {want_n} (layer, part) pairs")
        res["launches"] = n_lse
        with use_mesh(mesh2), scheme_context(kv):
            kv_logits, _, _ = lm.forward(cfg, params, prompt_t)
        ref_logits, _, _ = lm.forward(cfg, params, prompt_t)
        rel16 = rel(kv_logits, ref_logits)
        agree = float((kv_logits.argmax(-1) == ref_logits.argmax(-1))
                      .float().mean())
        last_rel = rel(last_kv, ref_logits[:, -1])
        del kv_logits, ref_logits
        log(f"[shard] teacher-forced bf16 logits at all {LM_PROMPT} "
            f"positions, context-parallel vs the normal prefill (one kernel 3"
            f" launch a layer): relative max error {rel16:.3e} (limit "
            f"{LM_BF16_REL}), argmax agreement {agree:.4f}; last position "
            f"through make_prefill_step {last_rel:.3e}")
        if not rel16 <= LM_BF16_REL or not last_rel <= LM_BF16_REL:
            raise AssertionError(f"context-parallel bf16 logits: {rel16}")
        del params
        torch.cuda.empty_cache()

        # kernel 3 with the log-sum-exp at one part's shape, vs plain
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        S, kp = LM_PROMPT, LM_PROMPT // KV_PARTS
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def qkv(b, dtype):
            return [torch.randn((b, S, h, D), generator=gen, device=dev)
                    .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv)]

        err_lse = 0.0
        part = 5
        for dt, b in (("bfloat16", LM_BATCH), ("float32", 1)):
            q, k, v = qkv(b, getattr(torch, dt))
            off = -part * kp
            kk, vv = (t[:, :, part * kp:(part + 1) * kp] for t in (k, v))
            o, lse = flash_attention_cuda(q, kk, vv, kv_offset=off,
                                          return_lse=True)
            torch.cuda.synchronize()
            po, plse = flash_attention_plain(q, kk, vv, kv_offset=off,
                                             return_lse=True)
            dead = torch.isinf(plse)
            e_o = float((o.float() - po.float()).abs().max())
            e_l = float((lse[~dead] - plse[~dead]).abs().max())
            ok = (torch.equal(torch.isinf(lse), dead)
                  and float(o[dead].float().abs().sum()) == 0
                  and bool(((o.float() - po.float()).abs()
                            <= FLASH_TOL[dt] * (1 + po.float().abs())).all())
                  and bool(((lse[~dead] - plse[~dead]).abs()
                            <= LSE_TOL[dt] * (1 + plse[~dead].abs())).all()))
            log(f"[shard] flash_attention_cuda return_lse {dt} B={b} H={H}/"
                f"{Hkv} Sq={S} part {part} (keys {part * kp}:"
                f"{(part + 1) * kp}, kv_offset {off}): {int(dead.sum())} rows"
                f" see no key (lse -inf, output 0); output max_abs_err "
                f"{e_o:.3e} (limit {FLASH_TOL[dt]}), lse {e_l:.3e} (limit "
                f"{LSE_TOL[dt]}) against flash_attention_plain")
            if not ok:
                raise AssertionError(f"kernel 3 lse {dt} differs")
            err_lse = max(err_lse, e_o, e_l)
        res["max_abs_err"] = err_lse

        # timing at qwen2's prefill shape: the context-parallel attention
        # (16 launches + the merge) beside kernel 3's single launch
        q, k, v = (t.transpose(1, 2) for t in qkv(LM_BATCH, torch.bfloat16))

        def kv_attn():
            return lm_modules.chunked_attention_kv_parallel(
                q, k, v, causal=True, q_chunk=cfg.attn_q_chunk)

        lse_ms, how = kernel_ms(kv_attn, "flash_attention_kernel", 10)
        # the per-layer time from CUDA events (the JSON's number); the
        # trace below is a breakdown of a window, not the main path (the
        # prefill's trace above is held to its launch count): the
        # profiler may drop a launch record of a short window, so the
        # fullest of 3 traces is kept, its busy time printed beside its
        # count and kept for the JSON only when the trace is whole
        call_ms = time_ms(kv_attn, 10)
        best = (-1, 0.0, {})
        for _ in range(3):
            _, busy_, by_, n_by = device_trace(kv_attn)
            n_seen = sum(n for key, n in n_by.items()
                         if "flash_attention_kernel" in key)
            best = max(best, (n_seen, busy_, by_), key=lambda r: r[0])
            if n_seen == KV_PARTS:
                break
        n_seen, a_busy, a_by = best
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        parts = [(p_, -p_ * kp) for p_ in range(KV_PARTS)]   # Sq = Sk

        def plain_parts():
            for p_, off in parts:
                flash_attention_plain(
                    qt, kt[:, :, p_ * kp:(p_ + 1) * kp],
                    vt[:, :, p_ * kp:(p_ + 1) * kp], kv_offset=off,
                    return_lse=True)

        plain_ms = time_ms(plain_parts, 1) / KV_PARTS
        pairs = sum(lse_visible_pairs(S, kp, off) for _, off in parts)
        flops = 2 * 2 * LM_BATCH * H * D * pairs
        # q read for the rows that see a key of the part; o and lse
        # written dense; the part's k and v read once
        q_rows = sum(lse_visible_rows(S, off) for _, off in parts)
        n_bytes = (2 * LM_BATCH * H * D * q_rows
                   + KV_PARTS * (2 * qt.numel() + 4 * LM_BATCH * H * S
                                 + 2 * 2 * LM_BATCH * Hkv * kp * D))
        t_ops = flops / BF16_FLOP_PER_S * 1e3 / KV_PARTS
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3 / KV_PARTS
        try:   # a yardstick: efficient attention with a bias returns lse
            eff = torch.ops.aten._scaled_dot_product_efficient_attention
            ke = kt.repeat_interleave(H // Hkv, dim=1)
            ve = vt.repeat_interleave(H // Hkv, dim=1)
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(kp, device=dev)[None, :]
            bias = [torch.where(cols <= rows + off, 0.0, NEG_BIAS).to(
                torch.bfloat16).expand(LM_BATCH, H, S, kp)
                for _, off in parts]

            def library():
                for (p_, _), bb in zip(parts, bias):
                    eff(qt, ke[:, :, p_ * kp:(p_ + 1) * kp],
                        ve[:, :, p_ * kp:(p_ + 1) * kp], bb, True)

            lib_ms = time_ms(library, 10) / KV_PARTS
            lib_how = ("_scaled_dot_product_efficient_attention with a "
                       "bias, log-sum-exp on, k/v expanded beforehand")
        except (RuntimeError, TypeError, AttributeError) as e:
            lib_ms, lib_how = None, f"none: {e!r}"[:200]
        res.update({"ms": lse_ms, "how": how, "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes", "library_ms": lib_ms,
                    "attention_ms": call_ms,
                    "attention_busy_ms": (a_busy if n_seen == KV_PARTS
                                          else None)})
        log(f"[shard] context-parallel attention per layer at B={LM_BATCH} "
            f"S={S} H={H}/{Hkv} D={D} bf16, {KV_PARTS} parts: device busy "
            f"{a_busy:.4f} ms ({n_seen} of {KV_PARTS} kernel 3 launches in "
            f"the trace; by activity: " + ", ".join(
                f"{k_} {v_:.4f} ms" for k_, v_ in sorted(
                    a_by.items(), key=lambda kv_: -kv_[1])[:4])
            + f"), per call {call_ms:.4f} ms (CUDA events); kernel 3 "
            f"return_lse "
            f"{lse_ms:.5f} ms per launch ({how}) x {KV_PARTS}; kernel 3 one "
            f"launch {flash_ms:.4f} ms (phase 4c); plain per part "
            f"{plain_ms:.3f} ms; bound per launch {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}: {flops / KV_PARTS / 1e9:.3f} GFLOP, "
            f"{n_bytes / KV_PARTS / 1e6:.2f} MB, q read for {q_rows} of "
            f"{KV_PARTS * S} part rows); library "
            f"{'—' if lib_ms is None else f'{lib_ms:.5f} ms'} ({lib_how})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

        # -- (d) HEP-Shard on the card -----------------------------------
        hbm = device_hbm_bytes(dev)
        host_toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_TRAIN_B, LM_TRAIN_S)))
        init = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)

        def evaluate(s, tcfg, tried) -> ShardTrial:
            opt = adamw(LM_TRAIN_LR)
            step = lm_steps.make_train_step(tcfg, opt,
                                            accum_steps=s.accum_steps)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            h0 = torch.cuda.Event(enable_timing=True)
            h1 = torch.cuda.Event(enable_timing=True)
            h0.record()
            t = host_toks.to(dev)
            h1.record()
            batch = {"tokens": t, "labels": t}
            p, o = init, opt.init(init)
            times = []
            with use_mesh(mesh2), scheme_context(s):
                for i in range(1 + SHARD_TIMED):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    p, o, m = step(p, o, batch)
                    e1.record()
                    e1.synchronize()
                    if i:
                        times.append(e0.elapsed_time(e1) / 1e3)
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"trial {s}: loss {float(m['loss'])}")
            tried.append(ShardTrial(
                scheme=s, compute_s=float(np.median(times)), memory_s=0.0,
                collective_s=0.0,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                h2d_s=h0.elapsed_time(h1) / 1e3, hbm_bytes=hbm))
            return tried[-1]

        # the default train step (each layer rematerialised), then the
        # same search without remat beside it
        res["trials"], chosen = {}, {}
        for remat in (True, False):
            tcfg = dataclasses.replace(cfg, remat=remat)
            how = "remat on" if remat else "remat off"
            tried: list = []
            t0 = time.perf_counter()
            launched0 = flash_attention_cuda.lse_launches
            best, history = search(
                lambda s_: evaluate(s_, tcfg, tried), SH.default_scheme(cfg),
                knobs=SHARD_KNOBS,
                log=lambda line: log(f"[hep-shard] {how}{line}"))
            search_s = time.perf_counter() - t0
            hist = [(t.scheme.attn_kv_parallel, t.scheme.accum_steps)
                    for t in history]
            for t in tried:
                log(f"[hep-shard] {how} trial attn_kv_parallel="
                    f"{t.scheme.attn_kv_parallel} accum_steps="
                    f"{t.scheme.accum_steps}: step median "
                    f"{t.compute_s * 1e3:.3f} ms of {SHARD_TIMED} (after a "
                    f"warm step), peak {t.peak_bytes / 2**30:.2f} GiB, batch "
                    f"h2d {t.h2d_s * 1e6:.1f} us, cost {t.cost:.6f} s")
            log(f"[hep-shard] {how} {cfg.name} bf16 AdamW B={LM_TRAIN_B} "
                f"S={LM_TRAIN_S}, knobs {SHARD_KNOBS}, hbm_bytes {hbm} (the "
                f"card's): {len(tried)} trials, history (attn_kv_parallel, "
                f"accum_steps) {hist}, {search_s:.1f} s; chosen "
                f"attn_kv_parallel={best.scheme.attn_kv_parallel} "
                f"accum_steps={best.scheme.accum_steps}, cost "
                f"{best.cost:.6f} s; kernel 3 log-sum-exp launches over the "
                f"search {flash_attention_cuda.lse_launches - launched0}")
            if best.cost != min(t.cost for t in tried) or not any(
                    t.scheme.attn_kv_parallel for t in tried):
                raise AssertionError("the search did not try both attentions "
                                     "or did not keep its best")
            chosen[remat] = (best.scheme.attn_kv_parallel,
                             best.scheme.accum_steps)
            res["trials"].update({
                f"{how} attn_kv_parallel={t.scheme.attn_kv_parallel} "
                f"accum_steps={t.scheme.accum_steps}": {
                    "step_s": t.compute_s, "peak_bytes": t.peak_bytes}
                for t in tried})
        log(f"[hep-shard] chosen (attn_kv_parallel, accum_steps): remat on "
            f"{chosen[True]}, remat off {chosen[False]}")
        del init
        torch.cuda.empty_cache()

        # the f32 gradient through the kernel per part against autograd
        def grads(attention=None, scheme=None):
            flat, tdef = flatten(p32)
            live = [t.detach().requires_grad_() for t in flat]
            ctx = (scheme_context(scheme) if scheme is not None
                   else contextlib.nullcontext())
            with use_mesh(mesh2), ctx:
                loss, _ = lm_steps.loss_fn(cfg32, unflatten(tdef, live),
                                           toks32, toks32,
                                           attention=attention)
            got = torch.autograd.grad(loss, live)
            return float(loss), got

        def plain_autograd(*args, **kwargs):
            return lm_modules.chunked_attention_plain(
                *args, **{**kwargs, "remat_chunks": False})

        before = flash_attention_cuda.lse_launches
        loss_k, g_k = grads(scheme=kv)
        # each layer's parts once in the forward and once in its remat
        if flash_attention_cuda.lse_launches - before != (
                SHARD_F32_LAYERS * KV_PARTS * (2 if cfg32.remat else 1)):
            raise AssertionError("the f32 gradient check missed the kernel")
        loss_p, g_p = grads(attention=plain_autograd)
        g_errs = [leaf_rel(a, c) for a, c in zip(g_k, g_p)]
        worst = int(np.argmax(g_errs))
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        log(f"[shard] {cfg.name} f32 {SHARD_F32_LAYERS} layers B="
            f"{LM_CHECK_BATCH} S={LM_CHECK_LEN}: loss through kernel 3 per KV "
            f"part + the chunk-recompute backward {loss_k:.6f}, plain "
            f"autograd {loss_p:.6f} (rel {loss_rel:.3e}); worst of "
            f"{len(g_errs)} gradient leaves {g_errs[worst]:.3e} "
            f"({paths(p32)[worst]}); limit {LM_F32_REL}")
        if loss_rel > LM_F32_REL or max(g_errs) > LM_F32_REL:
            raise AssertionError("context-parallel f32 gradient differs")
        del p32, g_k, g_p
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[shard] phase 15: {seconds:.2f} s")
    res["seconds"] = seconds
    return res


def dryrun_phase(dev) -> dict:
    """Phase 16: the XLA-free dry run.  (a) qwen2-0.5B's bf16 AdamW train
    step and prefill at B 4 x S 2,048, each dry-run on a fake (1, 1)
    mesh and then run for real: FLOPs equal, peak within
    ``DRYRUN_PEAK_REL``, kernel 3 once per layer; (b) the hillclimb's
    ``DRYRUN_CELLS`` on the 16 x 16 fake mesh.  Returns {"steps": {kind:
    numbers}, "launches": {kind: kernel 3 launches}, "seconds": wall}."""
    import gc
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs as lm_configs
    from repro_torch.kernels import (
        flash_attention_cuda, launch_counts, reset_launch_counts,
    )
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import fake_process_group, make_debug_mesh
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    cfg = lm_configs.get(LM_ARCH)
    gib = 2**30
    out = {"steps": {}, "launches": {}}
    for kind in ("train", "prefill"):
        cell = lm_configs.ShapeCell(f"chip {kind}", kind, LM_PROMPT,
                                    LM_BATCH)
        with fake_process_group(1):
            mesh = make_debug_mesh((1, 1), ("data", "model"),
                                   device_type="cuda")
            before = flash_attention_cuda.launches
            pred = dryrun.dry_run(cfg, cell, mesh, device=dev)
            if flash_attention_cuda.launches != before:
                raise AssertionError("the dry run launched kernel 3")
        flops_pred = pred["per_device"]["hlo_flops"]
        peak_pred = pred["memory"]["peak_bytes_per_device"]
        compute_s = flops_pred / dryrun.PEAK_BF16
        memory_s = pred["per_device"]["hlo_bytes"] / dryrun.HBM_BW
        coll_s = pred["collectives"]["per_device_bytes"] / dryrun.LINK_BW
        step_pred_ms = (max(compute_s, memory_s) + coll_s) * 1e3

        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = lm.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                               generator=gen, device=dev,
                               dtype=torch.int32)
        if kind == "train":
            opt = adamw(3e-4)
            state = opt.init(params)
            step = lm_steps.make_train_step(cfg, opt,
                                            grad_compression="bf16")
            batch = {"tokens": tokens, "labels": tokens}

            def run():
                return step(params, state, batch)
        else:
            prefill = lm_steps.make_prefill_step(cfg)

            def run():
                return prefill(params, tokens)

        run()                                      # warm
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            res = run()
            torch.cuda.synchronize()
        launched = launch_counts()["flash_attention_cuda"]
        peak = torch.cuda.max_memory_allocated(dev) - base
        del res
        times = []
        for _ in range(DRYRUN_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del res
        step_ms = statistics.median(times)
        flops_card = fc.get_total_flops()
        ratio = peak_pred / peak
        log(f"[dryrun] {cfg.name} bf16 {kind} B={LM_BATCH} S={LM_PROMPT} "
            f"on a fake 1 x 1 mesh (trace {pred['trace_s']} s) vs the "
            f"card: per-device FLOPs dry run {flops_pred} card "
            f"(FlopCounterMode) {flops_card}; peak predicted "
            f"{peak_pred / gib:.3f} GiB, measured {peak / gib:.3f} GiB "
            f"(max_memory_allocated less {base / gib:.3f} GiB held "
            f"before), ratio {ratio:.4f}; step predicted "
            f"{step_pred_ms:.2f} ms (compute {compute_s * 1e3:.2f}, "
            f"memory {memory_s * 1e3:.2f}, collective "
            f"{coll_s * 1e3:.2f} ms), measured {step_ms:.2f} ms (median "
            f"of {[round(t, 2) for t in times]}); kernel 3 launches "
            f"{launched}; HBM bytes predicted "
            f"{pred['per_device']['hlo_bytes'] / 1e9:.2f} GB")
        if flops_pred != flops_card:
            raise AssertionError(f"{kind}: dry-run FLOPs {flops_pred} != "
                                 f"FlopCounterMode's {flops_card}")
        if abs(ratio - 1.0) > DRYRUN_PEAK_REL:
            raise AssertionError(f"{kind}: predicted peak {peak_pred} vs "
                                 f"measured {peak}, ratio {ratio}")
        # the train step reruns each layer's forward in its backward
        want = cfg.n_layers * (2 if kind == "train" and cfg.remat else 1)
        if launched != want:
            raise AssertionError(f"{kind}: kernel 3 launched {launched} "
                                 f"times, {want} expected")
        out["steps"][kind] = {
            "flops": flops_pred, "peak_pred": peak_pred, "peak": peak,
            "step_pred_ms": step_pred_ms, "step_ms": step_ms}
        out["launches"][kind] = launched
        del params, tokens, run
        if kind == "train":
            del state, batch, step
        gc.collect()
        torch.cuda.empty_cache()

    outdir = Path(tempfile.mkdtemp(prefix="chip_smoke_hillclimb_"))
    try:
        for key in DRYRUN_CELLS:
            t0 = time.perf_counter()
            results = hillclimb.run_cell(key, outdir, device=dev)
            bad = [r for r in results if "error" in r]
            if bad:
                raise AssertionError(f"hillclimb {key}: {bad}")
            for r in results:
                log(f"[hillclimb] {key} {r['variant']}: "
                    f"{json.dumps({k: r[k] for k in ('compute_s', 'memory_s', 'collective_s', 'peak_gib', 'coll_by_kind_gib')})}")
            log(f"[hillclimb] {key}: {len(results)} variants on the 16 x 16 "
                f"fake mesh in {time.perf_counter() - t0:.1f} s "
                f"(datasheet-priced, derived)")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 16: {out['seconds']:.2f} s")
    return out


def gloo_probe_rank(rank: int, names: tuple) -> dict:
    """One rank of the gloo-on-CUDA probe: each functional collective of
    `names` (the form DTensor issues; ``SPMD_ROUTED`` is the all-gather
    through ``launch.mesh.all_gather_through_all_to_all``, which
    ``spawn_world`` installs in a gloo rank on CUDA, and
    ``SPMD_RAW_ALL_GATHER`` gloo's own, in a world spawned without it)
    on a CUDA tensor of 2 x world x 4 floats, held to what it must give.
    Returns {name: "ok" or the refusal's first line}: the refusals are
    what the probe is for, and a refusal is an argument check that each
    rank makes alike."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    dev = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size()
    group = dist.group.WORLD
    x = torch.arange(8.0 * n, device=dev).reshape(2 * n, 4) + rank
    every = [x - rank + r for r in range(n)]      # each rank's x
    out = {}
    for name in names:
        try:
            if name in (SPMD_RAW_ALL_GATHER, SPMD_ROUTED):
                got = funcol.all_gather_tensor(x, 0, group)
                want = torch.cat(every)
            elif name == "all_reduce":
                got = funcol.all_reduce(x, "sum", group)
                want = sum(every)
            elif name == "reduce_scatter_tensor":
                got = funcol.reduce_scatter_tensor(x, "sum", 0, group)
                want = sum(every).chunk(n)[rank]
            else:
                got = funcol.all_to_all_single(x, None, None, group)
                want = torch.cat([t.chunk(n)[rank] for t in every])
            got = funcol.wait_tensor(got)
            torch.cuda.synchronize(dev)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
            continue
        out[name] = ("ok" if got.is_cuda and torch.equal(got.cpu(),
                                                         want.cpu())
                     else f"wrong values on {got.device}")
    return out


def spmd_rank(rank: int, plan: dict) -> dict:
    """One rank of phase 17 (``spmd_phase``): for each mesh of `plan`,
    the f32 forward at ``f32_layers`` (rank 0 holds it to the one-rank
    forward), a warm bf16 prefill (on ``record_mesh`` rank 0's under a
    ``StepRecorder``), the timed prefill with this rank's kernel 3
    launches, and on ``train_mesh`` one train step per ``accum`` with the
    micro-batch placements ``loss_fn`` saw.  Rank 0 also runs the
    one-rank prefill and steps (plain tensors, no mesh) and returns the
    errors.  `plan` names the device type, the config and the sizes, so
    a CPU world can rehearse it at smoke size."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import (
        flash_attention_cuda, launch_counts, reset_launch_counts,
    )
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.trace_analysis import StepRecorder
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.parallel.constrain import on_mesh
    from repro_torch.parallel.sharding import ShardScheme

    cuda = plan["device_type"] == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    # what the steps need of gloo on CUDA tensors, probed in this world
    # (its all-gather through spawn_world's all_to_all_single)
    out = {"rank": rank, "meshes": {},
           "probe": gloo_probe_rank(rank, plan["probe"]) if cuda else {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = plan["cfg"]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier()

    def rel(a, b) -> float:
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def generator():
        return torch.Generator(device=dev).manual_seed(SEED)

    t_rank = time.perf_counter()

    def progress(what):
        if cuda:
            torch.cuda.empty_cache()   # the other ranks share the card
        if rank == 0:
            log(f"[spmd] rank 0: {what} at {time.perf_counter() - t_rank:.1f}"
                f" s" + (f", {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                         f" GiB peak allocated" if cuda else ""))

    def tokens(shape):
        return torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, shape, dtype=np.int32)).to(dev)

    for shape in plan["meshes"]:
        mesh = make_debug_mesh(shape, ("data", "model"), plan["device_type"])
        scheme = ShardScheme(**plan["scheme"])
        res = {}
        # -- (b) the f32 forward at f32_layers ----------------------------
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=plan["f32_layers"])
        p32 = lm.init_params(cfg32, generator(), dev)
        toks = tokens(plan["f32_shape"])
        logits, _ = spmd.forward(cfg32, mesh, scheme, p32, toks)
        if rank == 0:
            ref, _, _ = lm.forward(cfg32, p32, toks)
            res["f32_rel"] = rel(logits, ref)
            res["f32_finite"] = bool(torch.isfinite(logits).all())
            del ref
        del p32, logits
        progress(f"{shape} f32 forward")

        # -- (b) the bf16 prefill, (d) recorded, (e) timed ----------------
        params = lm.init_params(cfg, generator(), dev)
        batch = {"tokens": tokens(plan["shape"])}
        rec = (StepRecorder() if rank == 0
               and tuple(shape) == tuple(plan["record_mesh"]) else None)
        spmd.run_step(cfg, "prefill", mesh, scheme, params, batch,
                      recorder=rec)                          # warm
        if rec is not None:
            coll = rec.collectives
            res["recorded"] = {"bytes_by_kind": coll.bytes_by_kind,
                               "count_by_kind": coll.count_by_kind,
                               "dot_flops": rec.dot_flops}
        run, _ = spmd.sharded_step(cfg, "prefill", mesh, scheme, params,
                                   batch)
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with on_mesh(mesh, scheme):
            last, _ = run()
        sync()
        res["prefill_s"] = time.perf_counter() - t0
        res["launches"] = launch_counts()["flash_attention_cuda"]
        last = last.full_tensor()
        del run
        if rank == 0:
            prefill = lm_steps.make_prefill_step(cfg)
            prefill(params, batch["tokens"])                 # warm
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ref, _ = prefill(params, batch["tokens"])
            if cuda:
                torch.cuda.synchronize(dev)
            res["local_prefill_s"] = time.perf_counter() - t0
            res["prefill_rel"] = rel(last, ref)
            res["prefill_finite"] = bool(torch.isfinite(last).all())
            del ref
        del last
        progress(f"{shape} bf16 prefill")

        # -- (c) train steps ----------------------------------------------
        if tuple(shape) == tuple(plan["train_mesh"]):
            tcfg = (cfg if plan["train_layers"] is None else
                    dataclasses.replace(cfg, n_layers=plan["train_layers"]))
            if tcfg is not cfg:
                del params
                params = lm.init_params(tcfg, generator(), dev)
            tparams = params
            toks = batch["tokens"]
            tbatch = {"tokens": toks, "labels": toks}
            res["train"] = {}
            for accum in plan["accum"]:
                tscheme = ShardScheme(**plan["scheme"], accum_steps=accum)
                seen = []
                loss_fn = lm_steps.loss_fn

                def spy(cfg_, params_, tokens_, *args, **kwargs):
                    seen.append(repr(tuple(tokens_.placements)))
                    return loss_fn(cfg_, params_, tokens_, *args, **kwargs)

                run, _ = spmd.sharded_step(tcfg, "train", mesh, tscheme,
                                           tparams, tbatch)
                sync()
                t0 = time.perf_counter()
                lm_steps.loss_fn = spy
                try:
                    with on_mesh(mesh, tscheme):
                        _, _, metrics = run()
                finally:
                    lm_steps.loss_fn = loss_fn
                sync()
                step_s = time.perf_counter() - t0
                metrics = {k: float(v) for k, v in
                           spmd.full_tensors(metrics).items()}
                del run
                progress(f"{shape} train step, accum {accum}")
                got = {"step_s": step_s, "metrics": metrics,
                       "placements": seen}
                if rank == 0:
                    _, _, ref = spmd.local_step(tcfg, "train", tparams,
                                                tbatch, tscheme)
                    got["local_metrics"] = {k: float(v)
                                            for k, v in ref.items()}
                res["train"][accum] = got
                progress(f"{shape} one-rank train step, accum {accum}")
            if plan.get("kvpar"):
                # the context-parallel attention's backward on sharded
                # tensors; held to the one-rank step of accum 1
                kscheme = ShardScheme(**plan["scheme"], attn_kv_parallel=True)
                run, _ = spmd.sharded_step(tcfg, "train", mesh, kscheme,
                                           tparams, tbatch)
                sync()
                reset_launch_counts()
                t0 = time.perf_counter()
                with on_mesh(mesh, kscheme):
                    _, _, metrics = run()
                sync()
                res["kvpar"] = {
                    "step_s": time.perf_counter() - t0,
                    "lse_launches": flash_attention_cuda.lse_launches
                    if cuda else 0,
                    "metrics": {k: float(v) for k, v in
                                spmd.full_tensors(metrics).items()}}
                del run
                progress(f"{shape} context-parallel train step")
            del tparams
        del params, batch
        out["meshes"][tuple(shape)] = res
    return out


def spmd_phase(dev) -> dict:
    """Phase 17: the port's sharded LM steps on a real world of
    ``SPMD_WORLD`` processes that share the one card through gloo (every
    collective crosses host memory: a correctness path, no multi-card or
    NVLink claim).  The probe of the collectives gloo takes on CUDA
    tensors; qwen2-0.5B at full width on each of ``SPMD_MESHES`` under
    ``SPMD_SCHEME``: the f32 forward at ``SPMD_F32_LAYERS`` held to one
    rank at ``LM_F32_REL``, the bf16 prefill's last logits at
    ``LM_BF16_REL``, kernel 3 once per layer on every rank; on
    ``SPMD_TRAIN_MESH`` the bf16 AdamW step per ``SPMD_TRAIN_ACCUM``
    (loss and grad_norm within ``SPMD_TRAIN_REL``, each micro-batch
    ``Shard(0)`` over 'data'), and once more at accum 1 with
    ``attn_kv_parallel`` (kernel 3 with the log-sum-exp on every rank,
    held to the one-rank step of accum 1); rank 0's recorded prefill
    collectives and FLOPs equal to ``dry_run``'s on a fake (2, 4) CUDA
    group.  Returns {"launches": {mesh: per-rank kernel 3 launches},
    "kvpar_lse": {mesh: per-rank launches of the context-parallel
    step}, "seconds": wall, "probe": {collective: what gloo did with
    it}}."""
    import gc

    import torch
    from repro_torch import configs as lm_configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (
        fake_process_group, make_debug_mesh, spawn_world,
    )
    from repro_torch.parallel.sharding import ShardScheme

    t_phase = time.perf_counter()
    cfg = lm_configs.get(LM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[spmd] the parent process holds "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB of the card")
    # 8 caching allocators share the card: segments that grow in place
    # keep each one's unused reserve small (the ranks inherit it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    # gloo's own all-gather on CUDA tensors kills its processes
    # (SIGSEGV): it is probed in a world of its own; the collectives the
    # steps use are probed in the ranks' world (spmd_rank)
    try:
        got = spawn_world(2, gloo_probe_rank, (SPMD_RAW_ALL_GATHER,),
                          backend="gloo", device_type="cuda", timeout=120.0,
                          route_all_gather=False)
        raw = sorted({r[SPMD_RAW_ALL_GATHER] for r in got})
    except RuntimeError as e:
        raw = [f"crashed: {str(e).splitlines()[0][:160]}"]
    log(f"[spmd] gloo's {SPMD_RAW_ALL_GATHER} on CUDA tensors, 2 ranks: "
        f"{raw} ({time.perf_counter() - t_phase:.1f} s)")

    record_mesh = SPMD_MESHES[0]
    scheme = ShardScheme(**SPMD_SCHEME)
    cell = lm_configs.ShapeCell("spmd prefill", "prefill", SPMD_SHAPE[1],
                                SPMD_SHAPE[0])
    with fake_process_group(SPMD_WORLD):
        mesh = make_debug_mesh(record_mesh, ("data", "model"),
                               device_type="cuda")
        pred = dryrun.dry_run(cfg, cell, mesh, scheme, device=dev)
    plan = {"device_type": "cuda", "cfg": cfg, "meshes": SPMD_MESHES,
            "scheme": SPMD_SCHEME, "f32_layers": SPMD_F32_LAYERS,
            "f32_shape": SPMD_F32_SHAPE, "shape": SPMD_SHAPE,
            "record_mesh": record_mesh, "train_mesh": SPMD_TRAIN_MESH,
            "probe": SPMD_PROBED, "kvpar": True,
            "accum": SPMD_TRAIN_ACCUM, "train_layers": SPMD_TRAIN_LAYERS}
    t0 = time.perf_counter()
    ranks = spawn_world(SPMD_WORLD, spmd_rank, plan, backend="gloo",
                        device_type="cuda", timeout=SPMD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    probe = {k: sorted({r["probe"][k] for r in ranks}) for k in SPMD_PROBED}
    log(f"[spmd] gloo on CUDA tensors, {SPMD_WORLD} ranks (one card), the "
        f"functional collectives DTensor issues: {json.dumps(probe)}")
    launches, kvpar_lse = {}, {}
    failures = [f"gloo {k}: {v}" for k, v in probe.items() if v != ["ok"]]
    probe[SPMD_RAW_ALL_GATHER] = raw
    for shape in SPMD_MESHES:
        r0 = ranks[0]["meshes"][shape]
        per_rank = [r["meshes"][shape]["launches"] for r in ranks]
        launches[shape] = per_rank
        walls = [r["meshes"][shape]["prefill_s"] for r in ranks]
        log(f"[spmd] {cfg.name} {shape} mesh, {SPMD_WORLD} gloo ranks on one "
            f"card, {scheme}: f32 {SPMD_F32_LAYERS} layers B x S = "
            f"{SPMD_F32_SHAPE}: logits vs one rank, relative max error "
            f"{r0['f32_rel']:.3e} (limit {LM_F32_REL}); bf16 prefill "
            f"{SPMD_SHAPE}: last logits vs one rank {r0['prefill_rel']:.3e} "
            f"(limit {LM_BF16_REL}); kernel 3 launches per rank {per_rank}; "
            f"prefill wall {max(walls) * 1e3:.1f} ms (slowest rank; gloo "
            f"over host on one card: a correctness path) beside the "
            f"one-rank prefill's {r0['local_prefill_s'] * 1e3:.1f} ms")
        if not (r0["f32_finite"] and r0["f32_rel"] <= LM_F32_REL):
            failures.append(f"{shape} f32 rel {r0['f32_rel']}")
        if not (r0["prefill_finite"] and r0["prefill_rel"] <= LM_BF16_REL):
            failures.append(f"{shape} prefill rel {r0['prefill_rel']}")
        if any(n != cfg.n_layers for n in per_rank):
            failures.append(f"{shape} kernel 3 launches {per_rank}")
        for accum, got in r0.get("train", {}).items():
            depth = SPMD_TRAIN_LAYERS or cfg.n_layers
            m, ref = got["metrics"], got["local_metrics"]
            errs = {k: abs(m[k] - ref[k]) / abs(ref[k])
                    for k in ("loss", "grad_norm")}
            micro = sorted({p for r in ranks
                            for p in r["meshes"][shape]["train"][accum][
                                "placements"]})
            steps = [r["meshes"][shape]["train"][accum]["step_s"]
                     for r in ranks]
            log(f"[spmd] {cfg.name} bf16 AdamW train step {shape} B x S = "
                f"{SPMD_SHAPE}, {depth} of {cfg.n_layers} layers"
                f"{'' if depth == cfg.n_layers else ' (cut: 8 ranks on one card)'}"
                f", accum {accum}: loss {m['loss']:.6f} vs one rank "
                f"{ref['loss']:.6f}, grad_norm {m['grad_norm']:.6f} vs "
                f"{ref['grad_norm']:.6f}, relative {errs} (limit "
                f"{SPMD_TRAIN_REL}); micro-batch tokens on every rank "
                f"{micro}; step wall {max(steps):.2f} s (slowest rank)")
            if not all(math.isfinite(m[k]) and e <= SPMD_TRAIN_REL
                       for k, e in errs.items()):
                failures.append(f"train accum {accum}: {errs}")
            if micro != ["(Shard(dim=0), Replicate())"]:
                failures.append(f"train accum {accum}: micro-batch {micro}")
        if "kvpar" in r0:
            depth = SPMD_TRAIN_LAYERS or cfg.n_layers
            m, ref = r0["kvpar"]["metrics"], r0["train"][1]["local_metrics"]
            errs = {k: abs(m[k] - ref[k]) / abs(ref[k])
                    for k in ("loss", "grad_norm")}
            lse = [r["meshes"][shape]["kvpar"]["lse_launches"] for r in ranks]
            kvpar_lse[shape] = lse
            steps = [r["meshes"][shape]["kvpar"]["step_s"] for r in ranks]
            log(f"[spmd] {cfg.name} bf16 AdamW train step {shape} B x S = "
                f"{SPMD_SHAPE}, {depth} of {cfg.n_layers} layers, "
                f"attn_kv_parallel ({KV_PARTS} KV parts): loss "
                f"{m['loss']:.6f} vs one rank {ref['loss']:.6f}, grad_norm "
                f"{m['grad_norm']:.6f} vs {ref['grad_norm']:.6f}, relative "
                f"{errs} (limit {SPMD_TRAIN_REL}); kernel 3 with the "
                f"log-sum-exp per rank {lse}; step wall {max(steps):.2f} s "
                f"(slowest rank)")
            if not all(math.isfinite(m[k]) and e <= SPMD_TRAIN_REL
                       for k, e in errs.items()):
                failures.append(f"context-parallel train step: {errs}")
            if min(lse) == 0:
                failures.append(f"context-parallel train step: kernel 3 "
                                f"with the log-sum-exp per rank {lse}")
    rec = ranks[0]["meshes"][record_mesh]["recorded"]
    want = {"bytes_by_kind": pred["collectives"]["by_kind_bytes"],
            "count_by_kind": pred["collectives"]["by_kind_count"],
            "dot_flops": pred["per_device"]["hlo_flops"]}
    log(f"[spmd] {cfg.name} bf16 prefill {SPMD_SHAPE} on {record_mesh}: rank "
        f"0's StepRecorder {json.dumps(rec)}; dry_run on a fake "
        f"{record_mesh} CUDA group {json.dumps(want)}")
    if rec != want:
        failures.append("the recorded prefill differs from the dry run")
    seconds = time.perf_counter() - t_phase
    log(f"[spmd] phase 17: {seconds:.2f} s ({SPMD_WORLD}-rank world "
        f"{world_s:.1f} s)")
    if failures:
        raise AssertionError(f"phase 17: {failures}")
    return {"launches": launches, "kvpar_lse": kvpar_lse,
            "seconds": seconds, "probe": probe}


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (by path: ``examples/``
    is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_gemm_layers(config) -> list:
    """The conv and fc layers `config` places on the card: the layers
    that launch kernel 1 (or kernel 2, in a fused span)."""
    from repro_torch.core.parallel_config import is_host_config
    from repro_torch.core.plan import kind_of_label

    return [label for label, c in zip(config.layer_labels,
                                      config.layer_configs)
            if kind_of_label(label) in ("conv", "fc")
            and not is_host_config(c)]


def demo_rank(rank: int, plan: dict) -> dict:
    """One rank of phase 18's real step of the HEP-Shard demo's chosen
    scheme: ``launch.spmd.run_step`` of one bf16 AdamW train step of
    ``plan["cfg"]`` at ``plan["shape"]`` on a ``plan["mesh"]`` mesh,
    rank 0's under a ``StepRecorder``; this rank's kernel 3 launches
    and step wall; rank 0 also runs the one-rank step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.trace_analysis import StepRecorder
    from repro_torch.models import transformer as lm
    from repro_torch.parallel.sharding import ShardScheme

    cuda = plan["device_type"] == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = plan["cfg"]
    scheme = ShardScheme(**plan["scheme"])
    mesh = make_debug_mesh(plan["mesh"], ("data", "model"),
                           plan["device_type"])
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, plan["shape"], dtype=np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    rec = StepRecorder() if rank == 0 else None
    dist.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, _, metrics = spmd.run_step(cfg, "train", mesh, scheme, params, batch,
                                  recorder=rec)
    if cuda:
        torch.cuda.synchronize(dev)
    out = {"step_s": time.perf_counter() - t0,
           "launches": launch_counts()["flash_attention_cuda"],
           "metrics": {k: float(v) for k, v in metrics.items()}}
    if rank == 0:
        coll = rec.collectives
        out["recorded"] = {"bytes_by_kind": coll.bytes_by_kind,
                           "count_by_kind": coll.count_by_kind,
                           "dot_flops": rec.dot_flops}
        _, _, ref = spmd.local_step(cfg, "train", params, batch, scheme)
        out["local_metrics"] = {k: float(v) for k, v in ref.items()}
    return out


def bireal_unit_phase(dev) -> dict:
    """Phase 7b: the Bi-Real unit's patches and epilogue kernels at every
    unit shape of Bi-Real Net-18 at B BIREAL_BATCH against their plain
    versions, timed beside their byte bounds; returns the two kernels'
    rows for the JSON line."""
    import numpy as np
    import torch

    from repro_torch.bnn.layers import strided_side
    from repro_torch.bnn.models import (
        build_model, pack_real, packed_params_from_numpy, random_real_params,
    )
    from repro_torch.kernels import bireal_unit as U

    b = BIREAL_BATCH
    gen = torch.Generator(device=dev).manual_seed(0)
    units = [s for s in build_model("bireal18").specs if s.kind == "bireal"]
    per_shape, rows = {}, {"patches": [], "epilogue": []}
    for i, spec in enumerate(units):
        (h, w, cin), cout, stride = spec.in_shape, spec.units, spec.stride
        key = (h, w, cin, cout, stride)
        if key not in per_shape:
            fp = random_real_params(spec, np.random.default_rng(i))
            p = packed_params_from_numpy([pack_real(spec, fp)], dev)[0]
            ho, wo = strided_side(h, stride), strided_side(w, stride)
            x = torch.randn(b, h, w, cin, generator=gen, device=dev)
            k = p["k_true"]
            acc = torch.randint(-k, k + 1, (b, ho * wo, cout), generator=gen,
                                device=dev, dtype=torch.int32)
            res = torch.randn(b, ho, wo, cout, generator=gen, device=dev)
            ep = (acc, p["corr"], p["scale"], p["shift"], res)
            pat = U.bireal_patches_cuda(x, stride)
            if not torch.equal(pat, U.bireal_patches_plain(x, stride)):
                raise AssertionError(f"bireal_patches_cuda {key}: words "
                                     f"differ from the plain version's")
            if not torch.equal(U.bireal_epilogue_cuda(*ep),
                               U.bireal_epilogue_plain(*ep)):
                raise AssertionError(f"bireal_epilogue_cuda {key}: floats "
                                     f"differ from the plain version's")
            t = {}
            for name, fn, plain, kernel, n_bytes in (
                    ("patches", lambda: U.bireal_patches_cuda(x, stride),
                     lambda: U.bireal_patches_plain(x, stride),
                     "bireal_patches_kernel",
                     4 * (x.numel() + pat.numel())),
                    ("epilogue", lambda: U.bireal_epilogue_cuda(*ep),
                     lambda: U.bireal_epilogue_plain(*ep),
                     "bireal_epilogue_kernel",
                     4 * (3 * res.numel() + p["corr"].numel() + 2 * cout))):
                ms, how = kernel_ms(fn, kernel, 50)
                t[name] = (ms, how, time_ms(fn, 50), time_ms(plain, 20),
                           n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes)
            per_shape[key] = t
            for name, (ms, how, call, plain, bound, n_bytes) in t.items():
                log(f"[bireal unit] {name} B={b} {h}x{w}x{cin}->{cout}/"
                    f"{stride}: device {ms:.5f} ms ({how}), per call "
                    f"{call:.5f} ms, plain {plain:.4f} ms, bound {bound:.5f} "
                    f"ms ({n_bytes / 1e6:.2f} MB), {100 * bound / ms:.1f} % "
                    f"of it")
        for name in rows:
            rows[name].append(per_shape[key][name])
    out = {}
    for name, rs in rows.items():
        ms = sum(r[0] for r in rs)
        plain = sum(r[3] for r in rs)
        bound = sum(r[4] for r in rs)
        n_bytes = sum(r[5] for r in rs)
        log(f"[bireal unit] {name} B={b}, the {len(rs)} units: device "
            f"{ms:.5f} ms summed ({ms / b * 1e3:.3f} us an image), plain "
            f"{plain:.4f} ms, bound {bound:.5f} ms ({n_bytes / 1e6:.1f} MB, "
            f"{n_bytes / b / 1e6:.2f} MB an image), {100 * bound / ms:.1f} % "
            f"of it")
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound}
    both = sum(v["ms"] for v in out.values())
    log(f"[bireal unit] both kernels B={b}: {both:.5f} ms summed over the "
        f"units, plain chain {sum(v['plain_ms'] for v in out.values()):.4f} "
        f"ms, bound {sum(v['bound_ms'] for v in out.values()):.5f} ms")
    return out


def examples_phase(dev) -> dict:
    """Phase 18: each ``examples/torch_*.py`` of ``EXAMPLES``, imported
    by path and run in-process through its ``main([...])`` at its own
    defaults, in a temporary working directory (its ``results/`` and
    checkpoints land there).  quickstart and serve_mapped: their
    exactness asserts, kernel 1 launched by the measured profile, and
    kernel 1 or 2 launched while serving whenever the DP mapping places
    a conv or fc layer on the card; serve_fleet: both tenants bit-exact,
    ``rejected == shed``, kernel 1 launched while serving whenever a
    tenant's plan places a conv or fc layer on ``XYZ``; train_lm at full
    width (``EXAMPLE_TRAIN_ARGS``) for ``EXAMPLE_TRAIN_STEPS[0]`` steps,
    then resumed to ``[1]``: finite losses, the last below the first,
    kernel 3 twice per layer a step (forward and remat), the resume at
    the saved step; hep_shard_demo on a fake (2, 4) CUDA group, then its
    chosen scheme's real step on ``SPMD_WORLD`` gloo ranks at
    ``EXAMPLE_DEMO_CUT`` (:func:`demo_rank`): loss and grad_norm within
    ``SPMD_TRAIN_REL`` of one rank's step, rank 0's collectives and FLOPs
    equal to ``dry_run``'s at the cut shape, kernel 3 on every rank.
    Returns {"launches": {example: {kernel: launches}}, "walls":
    {example: s}, "seconds": the phase's wall}."""
    import gc

    import torch
    from repro_torch import configs as lm_configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (
        fake_process_group, make_debug_mesh, spawn_world,
    )
    from repro_torch.parallel.sharding import ShardScheme

    t_phase = time.perf_counter()
    failures = []
    launches, walls = {}, {}
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    os.chdir(work)

    def run(name, key, argv):
        mod = load_example(name)
        gc.collect()
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(list(argv))
        torch.cuda.synchronize(dev)
        walls[key] = time.perf_counter() - t0
        launches[key] = launch_counts()
        log(f"[examples] {key}: wall {walls[key]:.1f} s, launches "
            f"{json.dumps(launches[key])}")
        return res

    def check_device_launches(key, config, got):
        gemm = device_gemm_layers(config)
        n = got["xnor_gemm_cuda"] + got["segment_cuda"]
        log(f"[examples] {key}: conv / fc layers the DP mapping places on "
            f"the card {gemm}; kernel 1 + 2 launches while it ran {n}")
        if gemm and n == 0:
            failures.append(f"{key}: device layers {gemm}, no BNN kernel "
                            f"launched")

    try:
        # -- quickstart ----------------------------------------------------
        q = run("quickstart", "quickstart", [])
        served = {k: q["launches"]["mapped"][k] + q["launches"]["serve"][k]
                  for k in q["launches"]["serve"]}
        log(f"[examples] quickstart: eval acc {q['eval_acc']:.3f}; DP "
            f"{q['t_dp'] * 1e6:.1f} / greedy {q['t_greedy'] * 1e6:.1f} / "
            f"full-XYZ {q['t_xyz'] * 1e6:.1f} us/img (DP "
            f"{q['t_xyz'] / q['t_dp']:.3f}x "
            f"vs XYZ, {q['t_greedy'] / q['t_dp']:.3f}x vs greedy); schedule "
            f"{q['schedule']}, proper batch {q['ec'].proper_batch_size}; "
            f"mapped output and 8 answers exact; launches "
            f"{json.dumps(q['launches'])}")
        if q["launches"]["profile"]["xnor_gemm_cuda"] == 0:
            failures.append("quickstart: the profile launched no kernel 1")
        check_device_launches("quickstart", q["ec"], served)
        del q

        # -- serve_mapped --------------------------------------------------
        r = run("serve_mapped", "serve_mapped", [])
        log(f"[examples] serve_mapped: {len(r['scores'])} answers exact, "
            f"p50 {r['p50_us']:.1f} us, p99 {r['p99_us']:.1f} us; schedule "
            f"{r['schedule']}, proper batch {r['ec'].proper_batch_size}; "
            f"launches {json.dumps(r['launches'])}")
        if r["launches"]["plan"]["xnor_gemm_cuda"] == 0:
            failures.append("serve_mapped: the profile launched no kernel 1")
        check_device_launches("serve_mapped", r["ec"], r["launches"]["serve"])
        del r

        # -- serve_fleet ---------------------------------------------------
        f = run("serve_fleet", "serve_fleet", [])
        plan = f["plan"]
        log(f"[examples] serve_fleet: joint makespan "
            f"{plan.joint_makespan_s * 1e6:.1f} us vs all-GPU "
            f"{plan.baseline_makespan_s * 1e6:.1f} us (predicted, "
            f"{plan.vs_all_gpu:.3f}x); the example's wall, planning "
            f"included, {walls['serve_fleet']:.1f} s. The port's joint "
            f"co-run drained slower than all-GPU when both were served "
            f"(phase 12): printed, not asserted")
        xyz = []
        configs = {t.name: t.config for t in plan.tenants}
        for name in f["names"]:
            ledger = f["stats"]["ledger"][name]
            log(f"[examples] serve_fleet {name}: schedule "
                f"{f['schedules'][name]}, {len(f['answers'][name])} answers "
                f"exact, shed {f['shed'][name]} (= rejected), p50 "
                f"{f['p50_us'][name]:.1f} us, p99 {f['p99_us'][name]:.1f} us, "
                f"ledger host {ledger['host_s'] * 1e3:.2f} ms / device "
                f"{ledger['device_s'] * 1e3:.2f} ms")
            xyz += device_gemm_layers(configs[name])
        got = f["launches"]["serve"]["xnor_gemm_cuda"]
        log(f"[examples] serve_fleet: conv / fc layers on XYZ {xyz}; kernel "
            f"1 launches while serving {got}")
        if xyz and got == 0:
            failures.append("serve_fleet: XYZ layers, no kernel 1 launched")
        del f, plan

        # -- train_lm ------------------------------------------------------
        ckpt = os.path.join(work, "train_lm_ckpt")
        per_step = None
        for i, steps in enumerate(EXAMPLE_TRAIN_STEPS):
            key = f"train_lm run {i + 1}"
            t = run("train_lm", key, [*EXAMPLE_TRAIN_ARGS, "--steps",
                                      str(steps), "--ckpt", ckpt])
            cfg = t["cfg"]
            per_step = cfg.n_layers * (2 if cfg.remat else 1)
            ran = len(t["metrics"])
            losses = [m["loss"] for m in t["metrics"]]
            secs = sorted(m["sec"] for m in t["metrics"][1:])
            k3 = launches[key]["flash_attention_cuda"]
            log(f"[examples] {key}: {cfg.name} resumed at {t['resumed']}, "
                f"{ran} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                f"step p50 {secs[len(secs) // 2] * 1e3:.1f} ms (of "
                f"{len(secs)} after the first), kernel 3 launches {k3} "
                f"({per_step} a step expected)")
            want_start = 0 if i == 0 else EXAMPLE_TRAIN_STEPS[i - 1]
            if t["resumed"] != want_start or ran != steps - want_start:
                failures.append(f"{key}: resumed {t['resumed']}, ran {ran}")
            if not all(math.isfinite(x) for x in losses):
                failures.append(f"{key}: loss not finite")
            if i == 0 and not losses[-1] < losses[0]:
                failures.append(f"{key}: loss {losses[0]} -> {losses[-1]}")
            if k3 != per_step * ran:
                failures.append(f"{key}: kernel 3 launches {k3}, "
                                f"{per_step * ran} expected")
            del t
        shutil.rmtree(ckpt, ignore_errors=True)

        # -- hep_shard_demo ------------------------------------------------
        d = run("hep_shard_demo", "hep_shard_demo", [])

        def knobs(scheme):
            return {k: getattr(scheme, k) for k in ("tp", "fsdp",
                                                    "batch_over_model")}

        for trial in d["trials"].values():
            log(f"[examples] hep_shard_demo trial {knobs(trial.scheme)}: "
                f"compute {trial.compute_s * 1e3:.3f} ms, memory "
                f"{trial.memory_s * 1e3:.3f} ms, collective "
                f"{trial.collective_s * 1e3:.3f} ms, transfer "
                f"{trial.transfer_s * 1e3:.4f} ms, peak "
                f"{trial.peak_bytes / 2**30:.2f} GiB, cost {trial.cost:.6g}")
        best = d["best"]
        log(f"[examples] hep_shard_demo: {len(d['trials'])} schemes traced "
            f"({len(d['history'])} steps of the search) of {d['cfg'].name} "
            f"at {d['shape'].name} on a fake (2, 4) CUDA group; chosen "
            f"{knobs(best.scheme)}: compute {best.compute_s * 1e3:.3f}"
            f" ms, memory {best.memory_s * 1e3:.3f} ms, collective "
            f"{best.collective_s * 1e3:.3f} ms, transfer "
            f"{best.transfer_s * 1e3:.4f} ms, peak "
            f"{best.peak_bytes / 2**30:.2f} GiB")
        cfg = d["cfg"]
        scheme = dataclasses.asdict(best.scheme)
        del d
        b, s_ = EXAMPLE_DEMO_CUT
        cell = lm_configs.ShapeCell("demo cut", "train", s_, b)
        with fake_process_group(SPMD_WORLD):
            mesh = make_debug_mesh((2, 4), ("data", "model"),
                                   device_type="cuda")
            pred = dryrun.dry_run(cfg, cell, mesh, ShardScheme(**scheme),
                                  device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_world(SPMD_WORLD, demo_rank, {
            "device_type": "cuda", "cfg": cfg, "scheme": scheme,
            "mesh": (2, 4), "shape": EXAMPLE_DEMO_CUT},
            backend="gloo", device_type="cuda",
            timeout=EXAMPLE_DEMO_TIMEOUT_S)
        walls["hep_shard_demo real step"] = time.perf_counter() - t0
        r0 = ranks[0]
        m, ref = r0["metrics"], r0["local_metrics"]
        errs = {k: abs(m[k] - ref[k]) / abs(ref[k])
                for k in ("loss", "grad_norm")}
        full = lm_configs.SHAPES["train_4k"]
        per_rank = [r["launches"] for r in ranks]
        launches["hep_shard_demo real step, per rank"] = per_rank
        want = {"bytes_by_kind": pred["collectives"]["by_kind_bytes"],
                "count_by_kind": pred["collectives"]["by_kind_count"],
                "dot_flops": pred["per_device"]["hlo_flops"]}
        log(f"[examples] hep_shard_demo real step: {knobs(best.scheme)}, "
            f"{cfg.name} ({cfg.n_layers} layers) bf16 AdamW, B x S = "
            f"{EXAMPLE_DEMO_CUT} (cut from {full.batch} x {full.seq}: 8 "
            f"ranks share one "
            f"card), {SPMD_WORLD} gloo ranks: loss {m['loss']:.6f} vs one "
            f"rank {ref['loss']:.6f}, grad_norm {m['grad_norm']:.6f} vs "
            f"{ref['grad_norm']:.6f}, relative {errs} (limit "
            f"{SPMD_TRAIN_REL}); kernel 3 launches per rank {per_rank}; "
            f"step wall {max(r['step_s'] for r in ranks):.2f} s (slowest "
            f"rank, full tensors gathered); world "
            f"{walls['hep_shard_demo real step']:.1f} s")
        log(f"[examples] hep_shard_demo real step: rank 0's StepRecorder "
            f"{json.dumps(r0['recorded'])}; dry_run at the cut shape on a "
            f"fake (2, 4) CUDA group {json.dumps(want)}")
        if not all(math.isfinite(m[k]) and e <= SPMD_TRAIN_REL
                   for k, e in errs.items()):
            failures.append(f"hep_shard_demo real step: {errs}")
        if min(per_rank) == 0:
            failures.append(f"hep_shard_demo real step: kernel 3 per rank "
                            f"{per_rank}")
        if r0["recorded"] != want:
            failures.append("hep_shard_demo real step: the recorded step "
                            "differs from the dry run")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"[examples] phase 18: {seconds:.2f} s; walls "
        f"{json.dumps({k: round(v, 2) for k, v in walls.items()})}")
    if failures:
        raise AssertionError(f"phase 18: {failures}")
    return {"launches": launches, "walls": walls, "seconds": seconds}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bnn.layers import extract_patch_words
    from repro_torch.bnn.models import (
        build_model, forward_packed, pack_params, params_to,
        prepare_input_packed, random_fp_params,
    )
    from repro_torch.core import (
        autotune_bnn_model, best_uniform, build_plan, fuse_mapping,
        map_efficient_configuration, price_mapping, profile_bnn_model,
        profile_segment_variants,
    )
    from repro_torch.core.cost_model import layer_time_split_h100
    from repro_torch.core.parallel_config import CONFIGS
    from repro_torch.core.profiler import gemm_shape_of
    from repro_torch.estimator import (
        LatencyPredictor, group_key, training_rows_from_table,
    )
    from repro_torch.device import HOST
    from repro_torch import configs as lm_configs
    from repro_torch.kernels import (
        build, flash_attention_cuda, launch_counts, reset_launch_counts,
        segment_cuda, xnor_gemm_cuda,
    )
    from repro_torch.kernels.xnor_popcount import mma_probe
    from repro_torch.kernels.flash_attention import _launch as flash_launch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import modules as lm_modules
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer as lm
    from repro_torch.kernels.ref import xnor_gemm_ref
    from repro_torch.kernels.segment_fused import (
        _run_chain, segment_gemm_work, segment_weight_bytes,
    )
    from repro_torch.serving import ServingEngine, canonical_mixed_mapping
    from repro_torch.adapt import DriftDetector, RemapController, SegmentTelemetry
    from repro_torch.cachesvc import (
        CacheService, LocalDirBackend, MemoryBackend, TieredBackend,
        execution_counts,
    )
    from repro_torch.core.parallel_config import is_host_config
    from repro_torch.core.profiler import layer_fn
    from repro_torch.kernels import DEFAULT_REGISTRY
    from repro_torch.store import ProfileStore

    t_start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    # -- 1. device ------------------------------------------------------
    device_line = smi("name,power.limit")
    log(device_line)
    max_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    popc_per_s = n_sm * POPC_PER_SM_PER_CLOCK * max_clock_hz
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {n_sm} SMs, "
        f"max SM clock {max_clock_hz / 1e6:.0f} MHz, "
        f"popc peak {popc_per_s:.4g}/s")

    def bound_popc(n_bytes: float, word_ops: float) -> tuple:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = word_ops / popc_per_s * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # -- 2. build -------------------------------------------------------
    targets = build.build_all()
    log(f"[build] {build.build_seconds:.1f} s")
    for stem, out in build.build_log.items():
        for kernel, report in ptxas_report(out):
            log(f"[build] {stem}: {kernel}: {report}")
    mma = sass_mma_counts(targets["flash_attention"])
    if mma is None:
        log("[build] flash_attention SASS: tensor-core MMA count not "
            "checked (no cuobjdump)")
    else:
        for kernel, n in sorted(mma.items()):
            log(f"[build] flash_attention SASS: {kernel}: {n} HMMA/HGMMA")
        bf16 = {k: n for k, n in mma.items() if "bfloat16" in k}
        if not bf16 or min(bf16.values()) == 0:
            raise AssertionError(f"a bf16 flash attention instantiation "
                                 f"has no tensor-core MMA: {bf16}")
    bmma = sass_mma_counts(targets["xnor_gemm"])
    if bmma is None:
        log("[build] xnor_gemm SASS: 1-bit MMA count not checked (no "
            "cuobjdump)")
    else:
        for kernel, n in sorted(bmma.items()):
            log(f"[build] xnor_gemm SASS: {kernel}: {n} BMMA/BGMMA")
        gemm = {k: n for k, n in bmma.items() if "xnor_gemm_kernel" in k}
        if not gemm or min(gemm.values()) == 0:
            raise AssertionError(f"an xnor_gemm_kernel instantiation has no "
                                 f"1-bit tensor-core MMA: {gemm}")

    # -- 2b. the card tests ---------------------------------------------
    t0 = time.perf_counter()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    summary = (tests.stdout.strip().splitlines() or ["no output"])[-1]
    log(f"[card tests] tests/test_torch_cuda.py: {summary} "
        f"({time.perf_counter() - t0:.1f} s)")
    if tests.returncode != 0:
        log(tests.stdout[-4000:] + tests.stderr[-2000:])
        raise AssertionError("the card tests failed")

    gen = torch.Generator().manual_seed(SEED)

    def words(*shape, kind="random"):
        if kind == "zeros":
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        if kind == "ones":
            return torch.full(shape, -1, dtype=torch.int32, device=dev)
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    # -- 3. kernel 1 against its plain version ---------------------------
    for v, tiles in TILE_VARIANTS.items():
        reg = DEFAULT_REGISTRY.get(v)
        if (reg.p_blk, reg.n_blk, reg.aspects) != (*tiles, ("X", "Y", "Z")):
            raise AssertionError(f"registered {v}: {reg}")
    err1 = 0
    n_checks = 0
    shapes = GEMM_SHAPES + FMNIST_GEMM_SHAPES + (RAGGED_SHAPE,)
    cases = [(b, shape, "random") for b in CHECK_BATCHES for shape in shapes]
    cases += [(b, shape, kind) for kind in ("zeros", "ones")
              for b in (1, 33) for shape in (GEMM_SHAPES[0], GEMM_SHAPES[6],
                                             RAGGED_SHAPE)]
    for b, (name, p, n, kw, k_true), kind in cases:
        a, w = words(b, p, kw, kind=kind), words(n, kw, kind=kind)
        ref = xnor_gemm_ref(a, w, k_true)
        launches = [(asp, lambda asp=asp: xnor_gemm_cuda(a, w, k_true,
                                                         tuple(asp)))
                    for asp in ASPECT_SETS]
        launches += [(v, lambda v=v: DEFAULT_REGISTRY.get(v).builder(
            a, w, k_true)) for v in TILE_VARIANTS]
        for label, launch in launches:
            out = launch()
            torch.cuda.synchronize()
            err1 = max(err1, max_abs_err(out, ref))
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"xnor_gemm_cuda {label} B={b} {name} {kind} differs")
            n_checks += 1
    log(f"[kernel 1] xnor_gemm_cuda: {n_checks} checks torch.equal to "
        f"xnor_gemm_ref (7 aspects and the {len(TILE_VARIANTS)} tile "
        f"variants {tuple(TILE_VARIANTS)} x {len(shapes)} shapes x B in "
        f"{CHECK_BATCHES} on random words, and all-zero / all-one words "
        f"at 3 shapes x B in (1, 33)), max_abs_err {err1}")

    # -- 4. kernel 2 against its plain version ---------------------------
    model = build_model("cifar10")
    specs = model.specs
    fp = random_fp_params(specs, SEED)
    packed = pack_params(specs, fp, device=dev)

    def layer_inputs(x):
        xs = [x]
        for i in range(len(specs)):
            xs.append(_run_chain(specs[i:i + 1], packed[i:i + 1], xs[-1]))
        return xs

    def images(b):
        return torch.rand((b, *model.input_hw, model.in_channels),
                          generator=gen)

    err2 = 0
    for b in SEGMENT_BATCHES:
        xs = layer_inputs(prepare_input_packed(images(b)).to(dev))
        for label, (s, e) in SEGMENT_SPANS.items():
            fn = segment_cuda(specs[s:e], packed[s:e])
            out = fn(xs[s])
            torch.cuda.synchronize()
            ref = _run_chain(specs[s:e], packed[s:e], xs[s])
            err2 = max(err2, max_abs_err(out, ref))
            if not torch.equal(out, ref):
                raise AssertionError(f"segment_cuda {label} B={b} differs")
            log(f"[kernel 2] segment_cuda {label} [{s}:{e}] B={b}: "
                f"torch.equal to _run_chain, out {tuple(out.shape)}, "
                f"grid {fn.grid} blocks")

    # -- 4a. kernel 3 against its plain version -------------------------
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    err3 = 0.0
    for label, b, h, hkv, sq, sk, d, dt, causal in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = randn(b, h, sq, d, dtype=dtype,
                  scale=30.0 if label == "logits x30" else 1.0)
        k, v = randn(b, hkv, sk, d, dtype=dtype), randn(b, hkv, sk, d,
                                                        dtype=dtype)
        out = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=causal)
        if out.dtype != dtype or out.shape != q.shape:
            raise AssertionError(f"flash_attention_cuda {label}: "
                                 f"{out.dtype} {tuple(out.shape)}")
        # the custom op's body is the launch: the same bits as launching
        # directly
        direct, _ = flash_launch(q, k, v, causal, d ** -0.5, sk - sq, False)
        if not torch.equal(out, direct):
            raise AssertionError(f"flash_attention_cuda {label}: the op "
                                 f"differs from the direct launch")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = FLASH_TOL[dt]
        if not bool((diff <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"flash_attention_cuda {label} differs: "
                                 f"max_abs_err {err}")
        err3 = max(err3, err)
        log(f"[kernel 3] flash_attention_cuda {label} {dt}: within "
            f"{tol} of flash_attention_plain, max_abs_err {err:.3e}")

    # -- 4b. LM serving at full width: qwen2-0.5B -------------------------
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_configs.get(LM_ARCH)
    plain_attn = lm_modules.chunked_attention_plain

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def lm_generator():
        return torch.Generator(device=dev).manual_seed(SEED)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = lm.init_params(cfg32, lm_generator(), dev)
    toks32 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_CHECK_BATCH, LM_CHECK_LEN))).to(dev)
    lk, _, _ = lm.forward(cfg32, p32, toks32, last_only=True)
    lp, _, _ = lm.forward(cfg32, p32, toks32, last_only=True,
                          attention=plain_attn)
    rel32 = rel_err(lk, lp)
    if not (torch.isfinite(lk).all() and rel32 <= LM_F32_REL):
        raise AssertionError(f"qwen2 f32 logits: kernel vs plain rel "
                             f"{rel32}")
    log(f"[lm] {cfg.name} f32 B={LM_CHECK_BATCH} S={LM_CHECK_LEN}: "
        f"last-position logits through the kernel vs plain attention, "
        f"relative max error {rel32:.3e} (limit {LM_F32_REL})")
    del p32, lk, lp

    params = lm.init_params(cfg, lm_generator(), dev)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompt_t = torch.from_numpy(prompt).to(dev)
    max_len = LM_PROMPT + LM_GEN
    lm_steps.greedy_decode(cfg, params, prompt[:, :128], n_steps=2,
                           max_len=130, device=dev)          # warm-up
    stats: dict = {}
    reset_launch_counts()
    tokens = lm_steps.greedy_decode(cfg, params, prompt, n_steps=LM_GEN,
                                    max_len=max_len, device=dev,
                                    stats=stats)
    lm_counts = launch_counts()
    if lm_counts["flash_attention_cuda"] != cfg.n_layers:
        raise AssertionError(
            f"flash_attention_cuda launched "
            f"{lm_counts['flash_attention_cuda']} times in one prefill of "
            f"{cfg.n_layers} layers")
    if tokens.shape != (LM_BATCH, LM_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"greedy tokens {tuple(tokens.shape)}")
    decode_ms = stats["decode_s"] * 1e3 / stats["decode_steps"]
    tok_s = LM_BATCH * LM_GEN / (stats["prefill_s"] + stats["decode_s"])
    log(f"[lm] {cfg.name} bf16 greedy_decode B={LM_BATCH} prompt "
        f"{LM_PROMPT} gen {LM_GEN}: prefill {stats['prefill_s'] * 1e3:.3f} "
        f"ms, decode {decode_ms:.3f} ms/token, {tok_s:.1f} tokens/s; "
        f"launches {lm_counts}; sample {tokens[0, :8].tolist()}")

    # teacher-forced: the decode path's logits on the greedy tokens
    # against a full forward with the plain attention
    last, cache = lm_steps.make_prefill_step(cfg)(params, prompt_t)
    full = lm_steps.decode_cache(cfg, cache, max_len, device=dev)
    del cache
    serve_step = lm_steps.make_serve_step(cfg)
    dec = [last]
    for t in range(LM_GEN - 1):
        logits, full = serve_step(params, full, tokens[:, t:t + 1])
        dec.append(logits)
    dec = torch.stack(dec, dim=1)                      # (B, GEN, V)
    del full
    seq = torch.cat([prompt_t, tokens[:, :LM_GEN - 1]], dim=1)
    ref_logits, _, _ = lm.forward(cfg, params, seq, attention=plain_attn)
    ref_logits = ref_logits[:, LM_PROMPT - 1:]
    rel16 = rel_err(dec, ref_logits)
    agree = float((dec.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    del ref_logits, seq
    if not (torch.isfinite(dec).all() and rel16 <= LM_BF16_REL):
        raise AssertionError(f"qwen2 bf16 teacher-forced logits: rel "
                             f"{rel16}")
    log(f"[lm] teacher-forced bf16 logits at {LM_GEN} positions (prefill "
        f"through the kernel + decode steps) vs a full forward with the "
        f"plain attention: relative max error {rel16:.3e} (limit "
        f"{LM_BF16_REL}), argmax agreement {agree:.4f}")
    prefill = lm_steps.make_prefill_step(cfg)
    prefill(params, prompt_t)
    wall, busy, by_name = traced("lm trace", lambda: prefill(params, prompt_t),
                                 launch_counts)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    lm_idle = 1 - busy / wall
    log(f"[lm] one traced prefill B={LM_BATCH} S={LM_PROMPT}: wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms, idle "
        f"{100 * lm_idle:.1f}%; by activity: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in top))

    # -- 4c. kernel 3 timing at the prefill shapes ----------------------
    del params
    torch.cuda.empty_cache()
    flash_times = {}
    for arch in FLASH_TIMED:
        c = lm_configs.get(arch)
        shape = (LM_BATCH, c.n_heads, c.n_kv_heads,
                 c.n_frontend_embeds + LM_PROMPT, c.hd)
        r = flash_times[arch] = flash_timing(dev, gen, shape)
        log(f"[time] flash_attention_cuda {arch} B={shape[0]} "
            f"H={shape[1]}/{shape[2]} S={shape[3]} D={shape[4]} bf16 causal: "
            f"device {r['ms']:.4f} ms ({r['how']}), per call "
            f"{r['call_ms']:.4f} ms through the custom op, "
            f"{r['direct_call_ms']:.4f} ms launched directly, plain "
            f"{r['plain_ms']:.3f} ms, "
            f"scaled_dot_product_attention {r['library_ms']:.4f} ms "
            f"({r['library_how']}), bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}: {r['flops'] / 1e9:.2f} GFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB); "
            f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s")
    k3 = flash_times[LM_ARCH]
    torch.cuda.empty_cache()

    # -- 4d. the MoE, SSM and hybrid families at full width --------------
    family = family_phase(dev)

    # -- 4e. the six attention configurations at full width -------------
    dense = dense_family_phase(dev, device_line)

    # -- 5./6. the main path: profile -> map -> fuse -> serve ------------
    rng = np.random.default_rng(SEED)
    x01 = rng.random((N_REQUESTS, *model.input_hw, model.in_channels),
                     dtype=np.float32)
    x_req = prepare_input_packed(torch.from_numpy(x01))
    t0 = time.perf_counter()
    expected = forward_packed(
        specs, [params_to(p, HOST) for p in packed], x_req).numpy()
    log(f"[main] plain CPU forward_packed of {N_REQUESTS} examples: "
        f"{time.perf_counter() - t0:.2f} s")
    if expected.shape != (N_REQUESTS, model.n_classes):
        raise AssertionError(f"reference output shape {expected.shape}")

    p50s: dict = {}

    def serve(label, config, batch_sizes, trace=False):
        before = launch_counts()
        engine = ServingEngine(model, packed, config,
                               allowed_batch_sizes=batch_sizes, device=dev)
        engine.step(force=True)       # idle: a no-op
        bursts = []

        def submit():
            bursts.append([engine.submit(x_req[i].numpy())
                           for i in range(N_REQUESTS)])

        if trace:
            wall, busy, by_name = traced(label, lambda: engine.step(force=True),
                                         launch_counts, prepare=submit)
        else:
            submit()
            engine.step(force=True)
        for reqs in bursts:
            got = np.stack([r.wait(timeout=600) for r in reqs])
            if got.shape != expected.shape or not np.array_equal(got,
                                                                 expected):
                raise AssertionError(f"{label}: served answers differ")
        if trace:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"[{label}] one step of {N_REQUESTS} requests under the "
                f"profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                f"idle {100 * (1 - busy / wall):.1f}%; by activity: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
            return None
        lat = np.array([r.latency_s for r in reqs]) * 1e3
        p50s[label] = float(np.percentile(lat, 50))
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after}
        log(f"[{label}] {N_REQUESTS} requests in one burst, batch "
            f"{config.proper_batch_size}: equal to plain CPU forward_packed; "
            f"latency (n={N_REQUESTS}) p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms; launches {used}")
        return used

    reset_launch_counts()
    store_root = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
    store = ProfileStore(f"dir://{store_root}", device=dev)

    def measured_profile(m, p, *, batch_sizes):
        return profile_bnn_model(m, p, batch_sizes=batch_sizes, device=dev)

    t0 = time.perf_counter()
    table, loaded = store.get_or_profile(model, packed, measured_profile,
                                         batch_sizes=PROFILE_BATCHES)
    profile_s = time.perf_counter() - t0
    if loaded:
        raise AssertionError("a fresh profile store held a profile")
    profiled_json = table.to_json()
    log(f"[main] profile_bnn_model {PROFILE_BATCHES} through "
        f"ProfileStore.get_or_profile (saved): {profile_s:.1f} s")
    config = map_efficient_configuration(table, policy="dp")
    config = fuse_mapping(model, packed, table, config, device=dev)
    log(f"[main] DP mapping at batch {config.proper_batch_size}, "
        f"{config.expected_time_per_example * 1e6:.3f} us/example expected: "
        + " ".join(f"{lab.split(':')[1]}={c}" for lab, c in
                   zip(config.layer_labels, config.layer_configs)))
    log(f"[main] fused spans: {[f[:3] for f in config.fused_segments]}")
    serving = [serve("serve dp", config, table.batch_sizes)]

    batch = config.proper_batch_size
    whole = (0, len(specs))
    profile_segment_variants(model, packed, table, spans=(whole,),
                             batch_sizes=(batch,), device=dev)
    forced = price_mapping(table, batch, ("XYZ",) * len(specs))
    forced = dataclasses.replace(forced, fused_segments=(
        (*whole, "seg_cuda", table.segment_time(batch, *whole, "seg_cuda")),
    ))
    serving.append(serve("serve forced seg_cuda", forced, table.batch_sizes))
    mixed = price_mapping(table, batch, canonical_mixed_mapping(model))
    serving.append(serve("serve forced mixed", mixed, table.batch_sizes))
    main_counts = launch_counts()
    log(f"[main] launches over phases 5-6: {main_counts}")
    for name in ("xnor_gemm_cuda", "segment_cuda"):
        if sum(u[name] for u in serving) == 0:
            raise AssertionError(f"{name} never launched while serving")
    # where the serving time goes: the same traffic once more per mapping,
    # traced (after the counts are read, so these launches are not counted)
    for label, cfg in (("trace dp", config), ("trace forced seg_cuda", forced),
                       ("trace forced mixed", mixed)):
        serve(label, cfg, table.batch_sizes, trace=True)

    # -- 7. timings at the main-path shapes ------------------------------
    b1_rate, probe_ms = mma_b1_rate(mma_probe, dev, n_sm)
    log(f"[time] xnor_mma_probe_kernel: {b1_rate:.4g} bit-products/s "
        f"(m16n8k256 AND/popc on register fragments, {4 * n_sm} blocks of "
        f"8 warps, {probe_ms:.3f} ms), {b1_rate / n_sm / max_clock_hz:.0f} "
        f"bit-products per SM per clock at the max SM clock")

    def bound_b1(n_bytes: float, word_ops: float) -> tuple:
        """The least time: bytes over HBM, or the 1-bit product (32
        bit-products a word-op) over the measured tensor-core rate."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 32 * word_ops / b1_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def gemm_layers(b):
        """[(label, a, w, k_true)] of every conv/fc layer on the main
        path's inputs at batch `b` (conv as patches x weights)."""
        xs_b = layer_inputs(prepare_input_packed(images(b)).to(dev))
        out = []
        for i, spec in enumerate(specs):
            if spec.kind not in ("conv", "fc"):
                continue
            x = xs_b[i]
            a = (extract_patch_words(x).reshape(b, spec.in_shape[0]
                 * spec.in_shape[1], -1) if spec.kind == "conv"
                 else x[:, None, :])
            out.append((f"L{spec.idx}", a.contiguous(), packed[i]["w_words"],
                        packed[i]["k_true"]))
        return out

    sweep, per_layer = [], {}
    for b in SWEEP_BATCHES:
        per_layer[b] = gemm_layers(b)
        for name, a, w, k_true in per_layer[b]:
            for asp in ASPECT_SETS:
                sweep.append((f"{name} B{b} {asp}",
                              lambda a=a, w=w, k=k_true, asp=asp:
                              xnor_gemm_cuda(a, w, k, tuple(asp))))
            for v, (pb, nb) in TILE_VARIANTS.items():
                sweep.append((f"{name} B{b} {v}",
                              lambda a=a, w=w, k=k_true, pb=pb, nb=nb:
                              xnor_gemm_cuda(a, w, k, ("X", "Y", "Z"),
                                             p_blk=pb, n_blk=nb)))
    sweep_dev, n_traced = kernel_sweep(sweep, "xnor_gemm_kernel",
                                       SWEEP_ITERS)
    log(f"[time] xnor_gemm_cuda sweep: {len(sweep)} cases x {SWEEP_ITERS} "
        f"launches, {n_traced} traced")
    sweep_call = {label: time_ms(fn, SWEEP_ITERS) for label, fn in sweep}
    rows = []
    k1_b = SWEEP_BATCHES[0]
    for b in SWEEP_BATCHES:
        for name, a, w, k_true in per_layer[b]:
            n, kw = w.shape
            work = a.shape[0] * a.shape[1] * n * kw
            n_bytes = 4 * (a.numel() + w.numel() + a.shape[0] * a.shape[1] * n)
            b_ms, b_by = bound_b1(n_bytes, work)
            p_ms, p_by = bound_popc(n_bytes, work)
            log(f"[time] xnor_gemm_cuda {name} B={b} P={a.shape[1]} N={n} "
                f"Kw={kw}: device ms per launch / per call: " + " ".join(
                    f"{asp}={sweep_dev[f'{name} B{b} {asp}']:.5f}/"
                    f"{sweep_call[f'{name} B{b} {asp}']:.5f}"
                    for asp in ASPECT_SETS + tuple(TILE_VARIANTS))
                + f"; bound {b_ms:.4g} ms ({b_by}; 1-bit MMA rate), popc-pipe "
                f"bound {p_ms:.4g} ms ({p_by})")
            if b == k1_b:
                plain = time_ms(lambda: xnor_gemm_ref(a, w, k_true), 3)
                lib = int_mm_ms(a, w, SWEEP_ITERS)
                rows.append((sweep_dev[f"{name} B{b} XYZ"], plain, n_bytes,
                             work, lib))
                log(f"[time] xnor_gemm_cuda {name} B={b} XYZ: plain "
                    f"{plain:.3f} ms; yardstick torch._int_mm on the +-1 int8 "
                    f"unpacking (not the same function, 8x the input bytes) "
                    f"{lib:.5f} ms per call")
    for b in SWEEP_BATCHES:
        sums = {asp: sum(sweep_dev[f"{name} B{b} {asp}"]
                         for name, *_ in per_layer[b])
                for asp in ASPECT_SETS + tuple(TILE_VARIANTS)}
        log(f"[time] xnor_gemm_cuda B={b} device ms summed over the "
            f"{len(per_layer[b])} layers: " + " ".join(
                f"{k}={v:.5f}" for k, v in sums.items()))
    k1_ms, k1_plain = sum(r[0] for r in rows), sum(r[1] for r in rows)
    k1_bytes, k1_work = sum(r[2] for r in rows), sum(r[3] for r in rows)
    k1_bound, k1_by = bound_b1(k1_bytes, k1_work)
    k1_popc, _ = bound_popc(k1_bytes, k1_work)
    log(f"[time] xnor_gemm_cuda XYZ B={k1_b}, {len(rows)} layers: device "
        f"{k1_ms:.5f} ms summed, plain {k1_plain:.3f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_by}: {k1_bytes / 1e6:.2f} MB, "
        f"{32 * k1_work:.4g} bit-products), popc-pipe bound {k1_popc:.5f} ms; "
        f"yardstick torch._int_mm {sum(r[4] for r in rows):.5f} ms summed")

    xs = layer_inputs(prepare_input_packed(images(batch)).to(dev))
    seg = segment_cuda(specs, packed)
    k2_ms, how = kernel_ms(lambda: seg(xs[0]), "segment_kernel", 20)
    k2_call = time_ms(lambda: seg(xs[0]), 20)
    k2_plain = time_ms(lambda: _run_chain(specs, packed, xs[0]), 3)
    n_bytes = 4 * (xs[0].numel() + xs[-1].numel()) + segment_weight_bytes(
        packed)
    k2_work = segment_gemm_work(specs, packed, batch)
    k2_bound, k2_by = bound_b1(n_bytes, k2_work)
    k2_popc, _ = bound_popc(n_bytes, k2_work)
    log(f"[time] segment_cuda whole net B={batch}: device {k2_ms:.4f} ms "
        f"({how}), per call {k2_call:.4f} ms, plain {k2_plain:.3f} ms, "
        f"bound {k2_bound:.5f} ms ({k2_by}; 1-bit MMA rate), popc-pipe "
        f"bound {k2_popc:.5f} ms, grid {seg.grid} blocks")
    x1 = xs[0][:1].contiguous()
    b1_ms, how = kernel_ms(lambda: seg(x1), "segment_kernel", 20)
    b1_call = time_ms(lambda: seg(x1), 20)
    b1_bytes = 4 * (x1.numel() + model.n_classes) + segment_weight_bytes(
        packed)
    b1_bound, b1_by = bound_b1(b1_bytes, segment_gemm_work(specs, packed, 1))
    b1_popc, _ = bound_popc(b1_bytes, segment_gemm_work(specs, packed, 1))
    log(f"[time] segment_cuda whole net B=1: device {b1_ms:.4f} ms ({how}), "
        f"per call {b1_call:.4f} ms, bound {b1_bound:.5f} ms ({b1_by}; 1-bit "
        f"MMA rate), popc-pipe bound {b1_popc:.5f} ms, grid {seg.grid} "
        f"blocks")
    # the same layers one launch each (one op, no grid barrier): what
    # each layer costs inside the fused launch
    parts = []
    for s, e in ((0, 2), (2, 5), (5, 7), (7, 10), (10, 12), (12, 15),
                 (15, 18), (18, 19)):
        part = segment_cuda(specs[s:e], packed[s:e])
        parts.append((f"{s}:{e}", kernel_ms(lambda: part(xs[s]),
                                            "segment_kernel", 20)[0]))
    log(f"[time] segment_cuda B={batch} one layer per launch (device ms): "
        + " ".join(f"[{k}] {v:.4f}" for k, v in parts)
        + f"; sum {sum(v for _, v in parts):.4f}")
    # -- 7b. the Bi-Real unit's two kernels ------------------------------
    unit = bireal_unit_phase(dev)
    # -- 8. the profile store: warm start ---------------------------------
    t_phase = time.perf_counter()
    def no_profiling(*args, **kwargs):
        raise AssertionError("a warm start called the profiler")

    t0 = time.perf_counter()
    warm_table, loaded = ProfileStore(
        f"dir://{store_root}", device=dev).get_or_profile(
            model, packed, no_profiling, batch_sizes=PROFILE_BATCHES)
    warm_s = time.perf_counter() - t0
    if not loaded or json.loads(warm_table.to_json()) != json.loads(
            profiled_json):
        raise AssertionError("the warm start did not return the stored "
                             "profile")
    store.save_mapping(config)
    got = ProfileStore(f"dir://{store_root}", device=dev).load_mapping(
        model, policy="dp", batch=batch)
    if got is None or got.layer_configs != config.layer_configs or (
            got.fused_segments != config.fused_segments):
        raise AssertionError("the DP mapping did not round-trip the store")
    log(f"[store] warm start from {store.backend.uri()} (fingerprint "
        f"{store.fingerprint}): {warm_s * 1e3:.3f} ms, zero profiling, "
        f"table equal to phase 5's; phase 5's measured profile took "
        f"{profile_s:.3f} s; the DP mapping saved and loaded back "
        f"({len(store.entries())} entries)")

    log(f"[store] phase 8: {time.perf_counter() - t_phase:.2f} s")

    # -- 9. adaptive serving: telemetry -> drift -> remap -> hot swap -----
    t_phase = time.perf_counter()
    class ContendedEngine(ServingEngine):
        """A ServingEngine whose every pipeline (hot-swapped ones too)
        runs each device segment after a busy-wait of ``tax_s``."""

        tax_s = 0.0

        def _build_pipeline(self, config):
            pipe = super()._build_pipeline(config)

            def taxed(fn):
                def run(x):
                    busy_wait(self.tax_s)
                    return fn(x)
                return run

            pipe.segment_fns = [(seg, taxed(fn) if seg.on_device else fn)
                                for seg, fn in pipe.segment_fns]
            return pipe

    def serve_burst(engine, step, i):
        """One step of ADAPT_BURST requests; (wall s, config served)."""
        lo = (i * ADAPT_BURST) % N_REQUESTS
        reqs = [engine.submit(x_req[lo + j].numpy())
                for j in range(ADAPT_BURST)]
        served = engine.config
        t0 = time.perf_counter()
        step(force=True)
        wall = time.perf_counter() - t0
        got = np.stack([r.wait(timeout=600) for r in reqs])
        if not np.array_equal(got, expected[lo:lo + ADAPT_BURST]):
            raise AssertionError(f"adaptive step {i}: served answers differ")
        return wall, served

    def segment_times(label, served, snapshot, reports=()):
        """Each segment's observed p50 against its predicted time."""
        pred = served.segment_expected_times()
        floor = {r.segment_index: r for r in reports}
        for i, seg in enumerate(served.segments()):
            snap = snapshot.get(i)
            if snap is None:
                continue
            r = floor.get(i)
            log(f"[adapt]   {label}: segment {i} [{seg.start}:{seg.stop}] "
                f"({seg.placement}) observed p50 {snap['p50_s'] * 1e6:.3f} "
                f"us/example over {snap['count']} steps, predicted "
                f"{pred[i] * 1e6:.3f}, ratio {snap['p50_s'] / pred[i]:.3f}"
                + ("" if r is None else f"; drifted: recent floor "
                   f"{r.observed_s * 1e6:.3f}, ratio {r.ratio:.3f}"))

    def show(rec, served):
        segment_times(f"step {rec.at_step}", served, rec.telemetry,
                      rec.reports)
        log(f"[adapt]   -> changed {rec.changed}, expected "
            f"{rec.old_expected_s * 1e6:.3f} -> {rec.new_expected_s * 1e6:.3f}"
            f" us/example on the corrected table; new mapping "
            + " ".join(rec.new_configs))

    reset_launch_counts()
    tel = SegmentTelemetry()
    engine = ContendedEngine(model, packed, config,
                             allowed_batch_sizes=table.batch_sizes,
                             device=dev, telemetry=tel)
    ctl = RemapController(engine, table, store=store,
                          detector=DriftDetector(min_samples=3))
    counts: dict = {}
    n_steps = quiet = 0
    while quiet < CALIBRATE_QUIET and n_steps < CALIBRATE_MAX:
        before = len(ctl.journal)
        _, served = serve_burst(engine, ctl.step, n_steps)
        execution_counts(served, 1, into=counts)
        n_steps += 1
        quiet = 0 if len(ctl.journal) > before else quiet + 1
        for rec in ctl.journal[before:]:
            show(rec, served)
    calibrated = len(ctl.journal)
    log(f"[adapt] calibrate: {n_steps} steps of {ADAPT_BURST} requests, "
        f"{calibrated} remaps, "
        + ("settled" if quiet >= CALIBRATE_QUIET else "not settled")
        + f"; serving " + " ".join(engine.config.layer_configs)
        + f" fused {[f[:3] for f in engine.config.fused_segments]}")
    segment_times("calibrated", engine.config, tel.snapshot())
    pred = engine.config.segment_expected_times()
    stats = tel.stats()
    per_run = [max(stats[i].ewma if i in stats else 0.0, pred[i]) * batch
               for i, seg in enumerate(engine.config.segments())
               if seg.on_device]
    if not per_run:
        raise AssertionError("the calibrated mapping has no device segment")
    engine.tax_s = TAX_FACTOR * max(per_run)
    log(f"[adapt] contend: every device segment busy-waits "
        f"{engine.tax_s * 1e3:.3f} ms first ({TAX_FACTOR:g}x the largest "
        f"calibrated device segment, {max(per_run) * 1e3:.3f} ms a run)")
    contended = None
    for k in range(CONTEND_MAX):
        before = len(ctl.journal)
        _, served = serve_burst(engine, ctl.step, n_steps)
        execution_counts(served, 1, into=counts)
        n_steps += 1
        for rec in ctl.journal[before:]:
            show(rec, served)
            if contended is None and any(r.placement == "device"
                                         for r in rec.reports):
                contended = (k + 1, rec)
        if contended is not None:
            break
    if contended is None:
        raise AssertionError(f"no remap named a device segment within "
                             f"{CONTEND_MAX} contended steps")
    k, rec = contended
    if rec.new_expected_s > rec.old_expected_s * (1 + 1e-9):
        raise AssertionError(f"remap priced worse: {rec.new_expected_s} > "
                             f"{rec.old_expected_s}")
    engine.tax_s = 0.0
    for _ in range(2):                         # served after the swap
        _, served = serve_burst(engine, ctl.step, n_steps)
        execution_counts(served, 1, into=counts)
        n_steps += 1
    adapt_counts = launch_counts()
    if adapt_counts["segment_cuda"] == 0:
        raise AssertionError("segment_cuda never launched while serving "
                             "adaptively")
    log(f"[adapt] contended remap after {k} steps; {len(ctl.journal)} "
        f"journal entries over {n_steps} steps, every answer equal to plain "
        f"CPU forward_packed; launches {adapt_counts}")
    ws = ProfileStore(f"dir://{store_root}", device=dev).warm_start(
        model, batch_sizes=PROFILE_BATCHES)
    if ws is None or ws[1].layer_configs != ctl.journal[-1].new_configs:
        raise AssertionError("a fresh store did not warm-start the last "
                             "remapped mapping")
    log(f"[adapt] a fresh store warm-starts the last remapped mapping: "
        + " ".join(ws[1].layer_configs))

    # telemetry's cost: the same traffic on two engines under the DP
    # mapping, one sampling every step, in turns (on, off, off, on, ...)
    engines = {"on": ServingEngine(model, packed, config,
                                   allowed_batch_sizes=table.batch_sizes,
                                   device=dev,
                                   telemetry=SegmentTelemetry(warmup=0)),
               "off": ServingEngine(model, packed, config,
                                    allowed_batch_sizes=table.batch_sizes,
                                    device=dev)}
    walls: dict = {"on": [], "off": []}
    for i in range(2 * TELEMETRY_STEPS + 2):
        which = ("on", "off", "off", "on")[i % 4]
        wall, _ = serve_burst(engines[which], engines[which].step, i)
        if i >= 2:                                 # one warm-up step each
            walls[which].append(wall)
    p50 = {k: float(np.percentile(v, 50)) * 1e3 for k, v in walls.items()}
    log(f"[adapt] step wall p50 over {TELEMETRY_STEPS} steps of "
        f"{ADAPT_BURST} requests under the DP mapping: telemetry on "
        f"{p50['on']:.3f} ms, off {p50['off']:.3f} ms "
        f"({p50['on'] - p50['off']:+.3f} ms)")

    log(f"[adapt] phase 9: {time.perf_counter() - t_phase:.2f} s")

    # -- 10. the cache service over a write-back tiered store -------------
    t_phase = time.perf_counter()
    xs_dev = layer_inputs(prepare_input_packed(images(batch)).to(dev))
    xs_host = [x.cpu() for x in xs_dev]
    packed_host = [params_to(p, HOST) for p in packed]

    def measure_layer(layer, cfg, b):
        """Seconds per example of one layer under `cfg` at batch `b`: a
        device config on the card (CUDA events over 5 calls after a
        warm-up), a host config on the host clock (one call)."""
        if b != batch:
            raise AssertionError(f"explore at batch {b}, inputs at {batch}")
        spec = specs[layer]
        host = is_host_config(cfg)
        builder = (DEFAULT_REGISTRY.get(cfg).builder
                   if spec.kind in ("conv", "fc") else None)
        fn = layer_fn(spec, packed_host[layer] if host else packed[layer],
                      builder)
        x = xs_host[layer] if host else xs_dev[layer]
        if host:
            t0 = time.perf_counter()
            fn(x)
            return (time.perf_counter() - t0) / b
        return time_ms(lambda: fn(x), 5) / 1e3 / b

    back = LocalDirBackend(store_root / "shared")
    tier = TieredBackend(MemoryBackend(), back, write_back=True)
    svc_store = ProfileStore(tier, device=dev)
    svc_store.save_profile(warm_table)
    svc_store.save_mapping(engine.config)
    svc = CacheService(svc_store, profile_fn=no_profiling,
                       measure_fn=measure_layer, batch_sizes=PROFILE_BATCHES,
                       explore_min_count=n_steps + 1)
    svc.register("cifar10", model, packed)
    svc.enqueue_prewarm("cifar10")
    svc.drain()
    rec = svc.journal[-1]
    if rec.status != "done" or rec.result["profiled"] or rec.result["mapped"]:
        raise AssertionError(f"prewarm of a warm key: {rec.to_dict()}")
    log(f"[cachesvc] prewarm over {tier.uri()}: {rec.result}")
    reset_launch_counts()
    t0 = time.perf_counter()
    svc.enqueue_explore("cifar10", warm_table, batch=batch, counts=counts)
    svc.drain()
    explore_s = time.perf_counter() - t0
    explore_counts = launch_counts()
    rec = svc.journal[-1]
    if rec.status != "done" or not rec.result.get("measured"):
        raise AssertionError(f"explore: {rec.to_dict()}")
    if explore_counts["xnor_gemm_cuda"] == 0:
        raise AssertionError("the explore job never launched xnor_gemm_cuda")
    for row in rec.result["rows"]:
        log(f"[cachesvc]   L{specs[row['layer']].idx} {row['placement']} "
            f"{row['config']}: stored {row['stored_s'] * 1e6:.3f} us/example, "
            f"observed {row['observed_s'] * 1e6:.3f}, ratio "
            f"{row['ratio']:.3f}")
    log(f"[cachesvc] explore: {rec.result['measured']} rows re-measured (every "
        f"row served fewer than {n_steps + 1} times per layer; the fused span's "
        f"layers ran inside seg_cuda) in {explore_s:.2f} s, improved "
        f"{rec.result['improved']}, expected "
        f"{rec.result['old_expected_s'] * 1e6:.3f} -> "
        f"{rec.result['new_expected_s'] * 1e6:.3f} us/example; launches "
        f"{explore_counts}")
    dirty = len(tier.dirty())
    svc.enqueue_flush()
    svc.drain()
    rec = svc.journal[-1]
    if rec.status != "done" or rec.result["pushed"] <= 0 or not back.list():
        raise AssertionError(f"flush: {rec.to_dict()}")
    log(f"[cachesvc] flush: {rec.result} ({dirty} dirty keys, back tier "
        f"{back.uri()} holds {len(back.list())}); journal "
        + ", ".join(f"{r.kind} {r.status}" for r in svc.journal))
    log(f"[cachesvc] phase 10: {time.perf_counter() - t_phase:.2f} s")

    # -- 11. autotune: the open variant space on the card -----------------
    t_phase = time.perf_counter()
    tiles = tuple(TILE_VARIANTS)
    reset_launch_counts()
    t0 = time.perf_counter()
    auto = autotune_bnn_model(model, packed, batch_sizes=PROFILE_BATCHES,
                              prune_factor=3.0, device=dev)
    auto_s = time.perf_counter() - t0
    tuned = set()
    for b in auto.batch_sizes:
        for i, spec in enumerate(specs):
            row = auto.configs_for(b, i)
            if spec.kind not in ("conv", "fc"):
                if row != CONFIGS:
                    raise AssertionError(f"elementwise row L{spec.idx} B={b}: "
                                         f"{row}")
                continue
            if row[:len(CONFIGS)] != CONFIGS:
                raise AssertionError(f"GEMM row L{spec.idx} B={b}: {row}")
            cands = [v.name for v in DEFAULT_REGISTRY.applicable(
                gemm_shape_of(spec, packed[i], b), "cuda")
                if v.name not in CONFIGS]
            tuned |= set(cands)
            if b not in (1, 16):
                continue
            krow = auto.kernel_times[b][i]
            dev_row = {c: t for c, t in krow.items() if c != "CPU"}
            win = min(dev_row, key=dev_row.get)
            log(f"[autotune] L{spec.idx} {spec.notation} B={b}: candidates "
                f"{cands}, pruned {[c for c in cands if c not in row]}; row "
                f"best {auto.best_config(b, i)[0]}; device winner {win} "
                f"{dev_row[win] * 1e6:.3f} us/example against XYZ "
                f"{dev_row['XYZ'] * 1e6:.3f} ({dev_row[win] / dev_row['XYZ']:.3f}"
                f"x)")
    if tuned != set(tiles):
        raise AssertionError(f"the sweep timed tile variants {tuned}, "
                             f"registered {tiles}")
    sweep_launches = launch_counts()["xnor_gemm_cuda"]
    if sweep_launches == 0:
        raise AssertionError("the autotune sweep never launched "
                             "xnor_gemm_cuda")
    log(f"[autotune] autotune_bnn_model {PROFILE_BATCHES} measured on the "
        f"card, prune_factor 3.0: {auto_s:.1f} s (phase 5's fixed-8 "
        f"profile: {profile_s:.1f} s); every tile variant timed at some "
        f"layer; xnor_gemm_cuda launched {sweep_launches} times")

    dp_auto = map_efficient_configuration(auto, policy="dp")
    dp_fixed = map_efficient_configuration(auto, policy="dp", configs=CONFIGS)
    if dp_auto.expected_time_per_example > dp_fixed.expected_time_per_example:
        raise AssertionError("the autotuned DP is predicted slower than the "
                             "fixed-8 DP on the same table")
    fused_auto = fuse_mapping(model, packed, auto, dp_auto, device=dev)
    in_span = {i: name for s0, e0, name, _ in fused_auto.fused_segments
               for i in range(s0, e0)}
    log(f"[autotune] DP autotuned {dp_auto.expected_time_per_example * 1e6:.3f}"
        f" us/example at B {dp_auto.proper_batch_size} <= fixed-8 DP "
        f"{dp_fixed.expected_time_per_example * 1e6:.3f} at B "
        f"{dp_fixed.proper_batch_size}; fused "
        f"{build_plan(fused_auto).expected_time_per_example * 1e6:.3f}; "
        f"served by: " + " ".join(
            f"{lab.split(':')[0]}={in_span.get(i, c)}" for i, (lab, c) in
            enumerate(zip(dp_auto.layer_labels, dp_auto.layer_configs))))
    serve("serve autotuned", fused_auto, auto.batch_sizes)
    # the paper's comparison: the fully parallel GPU implementation at its
    # best batch against the DP mapping, predicted and served
    b_xyz, t_xyz = best_uniform(auto, "XYZ")
    uniform = price_mapping(auto, b_xyz, ("XYZ",) * len(specs))
    serve("serve uniform XYZ", uniform, auto.batch_sizes)
    serve("serve autotuned dp", dp_auto, auto.batch_sizes)
    auto_counts = launch_counts()
    if auto_counts["xnor_gemm_cuda"] == 0:
        raise AssertionError("phase 11 never launched xnor_gemm_cuda")
    log(f"[autotune] paper comparison: best uniform XYZ (B {b_xyz}) "
        f"{t_xyz * 1e6:.3f} us/example predicted, DP "
        f"{dp_auto.expected_time_per_example * 1e6:.3f} "
        f"({t_xyz / dp_auto.expected_time_per_example:.3f}x); served p50 "
        f"over the same {N_REQUESTS} requests: uniform XYZ "
        f"{p50s['serve uniform XYZ']:.3f} ms, DP "
        f"{p50s['serve autotuned dp']:.3f} ms "
        f"({p50s['serve uniform XYZ'] / p50s['serve autotuned dp']:.3f}x), "
        f"DP fused {p50s['serve autotuned']:.3f} ms; launches over phase 11 "
        f"{auto_counts}")

    # the analytic H100 model against the card's rows
    ratios: dict = {}
    for b in (1, 16):
        for i, spec in enumerate(specs):
            row = auto.configs_for(b, i)
            cfgs = ["XYZ"] + ([c for c in tiles if c in row]
                              if spec.kind in ("conv", "fc") else [])
            parts = []
            for cfg in cfgs:
                kern, h2d, d2h = layer_time_split_h100(spec, cfg, b)
                r = kern / b / auto.kernel_time(b, i, cfg)
                ratios.setdefault(spec.kind, []).append(r)
                parts.append(f"{cfg} {r:.3f}")
            for name, mod, meas in (("h2d", h2d, auto.h2d(b, i)),
                                    ("d2h", d2h, auto.d2h(b, i))):
                ratios.setdefault(name, []).append(mod / b / meas)
                parts.append(f"{name} {mod / b / meas:.3f}")
            log(f"[h100 model] L{spec.idx} {spec.notation} B={b}: analytic / "
                f"measured " + ", ".join(parts))
    log("[h100 model] analytic / measured per kind (B 1 and 16): " + "; ".join(
        f"{k} median {np.median(v):.4f} range {min(v):.4f}-{max(v):.4f} "
        f"(n={len(v)})" for k, v in ratios.items()))
    # ... and against kernel 1's traced device time per launch (phase 7)
    by_cfg: dict = {}
    for b in SWEEP_BATCHES:
        for name, *_ in per_layer[b]:
            spec = next(sp for sp in specs if f"L{sp.idx}" == name)
            for cfg in ASPECT_SETS + tiles:
                kern = layer_time_split_h100(spec, cfg, b)[0] * 1e3
                by_cfg.setdefault(cfg, []).append(
                    kern / sweep_dev[f"{name} B{b} {cfg}"])
    log("[h100 model] analytic kernel / traced device ms per launch (phase "
        "7, 8 GEMM layers x B 16 and 1): " + "; ".join(
            f"{k} median {np.median(v):.3f} range {min(v):.3f}-{max(v):.3f}"
            for k, v in by_cfg.items()))

    # the estimator: fitted on B 1 and 4, held out at B 16
    store.save_training_rows(training_rows_from_table(model, auto),
                             source="chip_smoke autotune")
    rows = store.load_training_rows()
    train = [r for r in rows if r["batch"] in (1, 4)]
    held = [r for r in rows if r["batch"] == 16]
    pred = LatencyPredictor().fit(train)
    errs: dict = {}
    for r in held:
        e = abs(math.log(pred.predict_kernel_s(r["geometry"], r["meta"])
                         / r["kernel_s"]))
        errs.setdefault(group_key(r["geometry"], r["meta"]), []).append(e)
    every = [e for v in errs.values() for e in v]
    log(f"[estimator] LatencyPredictor on {len(train)} rows (B 1, 4 of the "
        f"phase 5 and phase 11 tables), {len(held)} held out at B 16: "
        f"|log(predicted / measured)| median {np.median(every):.4f} max "
        f"{max(every):.4f}; per group: " + "; ".join(
            f"{k} median {np.median(v):.4f} max {max(v):.4f} (n={len(v)})"
            for k, v in sorted(errs.items())))
    refit_store = ProfileStore(f"dir://{store_root}", device=dev)
    svc = CacheService(refit_store, refit_min_new_rows=1)
    svc.enqueue_refit()
    svc.drain()
    rec = svc.journal[-1]
    meta = refit_store.predictor_meta()
    if (rec.kind != "refit" or rec.status != "done" or not rec.result["refit"]
            or meta is None or meta["source_rows"] != len(rows)
            or meta["n_rows"] != rec.result["n_rows"]):
        raise AssertionError(f"refit: {rec.to_dict()}, meta {meta}")
    log(f"[estimator] refit through CacheService on {refit_store.backend.uri()}"
        f": {rec.result}; predictor_meta {meta['n_rows']} rows fitted of "
        f"{meta['source_rows']} stored")
    log(f"[autotune] phase 11: {time.perf_counter() - t_phase:.2f} s")

    # -- 12. co-serving: fleet, elastic, cluster --------------------------
    fleet_phase(dev, model, packed, x_req, expected, store_root)

    # -- 13. train, pack, plan and serve ----------------------------------
    train_phase(dev, store_root, p50s["serve dp"])
    shutil.rmtree(store_root, ignore_errors=True)

    # -- 14. LM training ---------------------------------------------------
    lm_train = lm_train_phase(dev, k3["ms"])

    # -- 15. the sharding layer --------------------------------------------
    shard = shard_phase(dev, k3["ms"])

    # -- 16. the dry run ---------------------------------------------------
    dry = dryrun_phase(dev)

    # -- 17. the sharded step on 8 ranks -----------------------------------
    spmd_res = spmd_phase(dev)

    # -- 18. the examples ---------------------------------------------------
    ex = examples_phase(dev)
    ex_bnn = {k: v for k, v in ex["launches"].items() if isinstance(v, dict)}

    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "xnor_gemm_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xnor_gemm.cu",
         "replaces": "src/repro/kernels/xnor_popcount.py:61",
         "launches": main_counts["xnor_gemm_cuda"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "launches_phase_18": {k: v["xnor_gemm_cuda"]
                               for k, v in ex_bnn.items()}},
        {"name": "segment_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_fused.cu",
         "replaces": "src/repro/kernels/segment_fused.py:223",
         "launches": main_counts["segment_cuda"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "launches_phase_18": {k: v["segment_cuda"]
                               for k, v in ex_bnn.items()}},
        *({"name": f"bireal_{name}_cuda", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/bireal_unit.cu",
           "replaces": None, "max_abs_err": 0, "ms": v["ms"],
           "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
           "bound_by": "bytes", "library_ms": None,
           "path": f"the 16 units of bireal18 at B {BIREAL_BATCH}, summed"}
          for name, v in unit.items()),
        {"name": "flash_attention_cuda", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73",
         "launches": lm_counts["flash_attention_cuda"], "max_abs_err": err3,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "launches_by_path": {
             LM_ARCH: lm_counts["flash_attention_cuda"],
             **{arch if arch not in DEPTH_CUT else
                f"{arch} ({r['layers']} layers)": r["launches"]
                for arch, r in {**family, **dense}.items()},
             f"{LM_ARCH} train ({lm_train['steps']} steps)":
                 lm_train["train_launches"],
             f"{LM_ARCH} dry-run check, train step":
                 dry["launches"]["train"],
             f"{LM_ARCH} dry-run check, prefill":
                 dry["launches"]["prefill"],
             **{f"{LM_ARCH} {SPMD_WORLD}-rank prefill on {shape}, per rank":
                per_rank for shape, per_rank in spmd_res["launches"].items()}},
         "launches_per_train_step": {
             LM_ARCH: lm_train["train_launches"] / lm_train["steps"],
             **{f"{name} remat {'on' if r else 'off'}": v["launches"]
                for name, ab in lm_train["remat_ab"].items()
                for r, v in ab.items()}},
         "launches_phase_18": {
             **{k: v["flash_attention_cuda"] for k, v in ex_bnn.items()},
             "hep_shard_demo real step, per rank":
                 ex["launches"]["hep_shard_demo real step, per rank"]},
         "ms_by_shape": {a: r["ms"] for a, r in flash_times.items()},
         "bound_ms_by_shape": {a: r["bound_ms"]
                               for a, r in flash_times.items()},
         "plain_ms_by_shape": {a: r["plain_ms"]
                               for a, r in flash_times.items()},
         "library_ms_by_shape": {a: r["library_ms"]
                                 for a, r in flash_times.items()}},
        {"name": "flash_attention_cuda[return_lse]", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73",
         "launches": shard["launches"], "max_abs_err": shard["max_abs_err"],
         "ms": shard["ms"], "plain_ms": shard["plain_ms"],
         "bound_ms": shard["bound_ms"], "bound_by": shard["bound_by"],
         "library_ms": shard["library_ms"],
         "path": f"{LM_ARCH} context-parallel prefill, {KV_PARTS} KV parts "
                 f"a layer",
         "launches_by_path": {
             f"{LM_ARCH} {SPMD_WORLD}-rank context-parallel train step on "
             f"{shape}, per rank": lse
             for shape, lse in spmd_res["kvpar_lse"].items()},
         "attention_ms_per_layer": shard["attention_ms"],
         "attention_busy_ms_per_layer": shard["attention_busy_ms"]},
    ]
    log(device_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
