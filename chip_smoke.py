"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out FILE] [--profile] [--only 11,...,21]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the serving and training paths
   from ``vla_adapter_torch/csrc`` with nvcc (sm_90a), one nvcc per
   source, all started together, and print ptxas' register and spill
   lines.
2. attention kernel vs plain: at the shapes one serving forward gives it
   (Qwen2 14/2 heads, S=640, D=64, key padding, and causal; DINOv2 16
   heads, S=261, D=64; so400m 16 heads, S=256, D=72; for B=1 and B=2;
   and, on no serving path, the 7B full-train recipe's LLM attention:
   Vicuna-7B's 32/32 heads of D=128, non-causal, over 384 tokens with its
   key padding, at 32 rows), and every other B1 shape of PERF.md's table
   (:data:`B1_ROW_SHAPES`: the finetune's, tensor 2's, the prefill's,
   Phi-2's, the 7B zoo's, the 384/336-px towers'), print the kernel's
   plan (consumer warpgroups a CTA, ring stages, CTAs, CTAs per SM,
   waves, shared memory, registers), hold the kernel
   against its plain PyTorch version and time the kernel, the plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it).
3. w8a8 kernels vs plain: at the shapes one w8a8 serving forward gives
   them (derived from ``VLAConfig()`` by :func:`w8a8_shapes`, B=1 and B=4):
   the fused MLPs (Qwen2; DINOv2, so400m, projector), the w8a8 matmul at
   every distinct non-MLP shape, the head's stacked matmul, and (B=1) the
   whole-decoder-layer kernel of the "mega" backend at the Qwen2 layer with
   the prompt's key padding. Each fused MLP and the layer kernel first
   print their plan (the row tiles, the panel split, the K slices and
   panel groups, the work items, the persistent grid's CTAs and waves;
   :func:`mlp_plan`, :func:`megalayer_plan`);
   each matmul's line carries its plan (``w8a8_plan``: the narrow branch
   up to 32 rows, else the Hopper branch's tiles, stages, grid and
   pre-pass). The matmuls must equal their plain versions bit for bit, the fused MLPs
   agree within :func:`mlp_tolerance` (whether they are bit for bit is
   recorded), the layer kernel within :func:`check_megalayer`. The matmul is held both
   as the models call it (``w8a8_linear``: float x, the quantization
   inside) and with x quantized beforehand (``w8a8_matmul``, the JAX
   B4/B5 signature), bit for bit, in both output dtypes. Times: kernel,
   plain version, for the matmuls also the xq entry, the two-step chain
   (``quantize_rows`` then the xq entry), the kernel with L2 flushed
   before each call, and ``torch._int_mm`` (the int8 product alone, a
   yardstick: the port never calls it; at M <= 16, which it refuses, on x
   zero-padded to 24 rows); for the layer kernel the same layer through
   the "fused" backend's launches (B1, the o-projection, the norm, B2).
4. quantizer: the on-card weight quantizer against the JAX package's numpy
   ``quantize_kernel`` (copied below) on flagship weight matrices, bit for
   bit.
5. flagship bf16 forward: ``VLAConfig()`` at full width and depth (DINOv2-L
   + so400m @224, 2 images, Qwen2.5-0.5B, a 24-block Pro head, 640 LLM
   tokens), random bf16 weights from a seeded CUDA generator, served
   through ``Predictor`` (on the card a CUDA graph per key, replayed):
   predict_action (B=1) and predict_action_batch (B=4), with launch counts
   read around exactly those requests. The same rows then go through the
   plain attention for an end-to-end comparison.
6. flagship w8a8 forward: ``Predictor(act_int8=True)`` over the same
   weights quantized on the card, each backend ("fused", "dense", "auto"
   at B=1 and B=4; "mega" at B=1, where a B=4 call must raise) driven with
   the launch counts reset before and read after it and checked against
   the counts :func:`w8a8_shapes` derives; actions against the all-plain
   path and against bf16 (mega also against fused); then
   ``Predictor(int8=True)`` (weight-only) once.
7. CUDA graphs (:func:`phase_graph`): every tier replayed against its
   eager forward, bit for bit and launch for launch, over requests whose
   prompt lengths and images differ; capture time per key and each pool's
   bytes; a crossover in turns on the same rows (eager and graph for every
   tier at B=1; bf16, int8, fused and dense under graphs at B=2 and 4).
8. checkpoint (:func:`phase_checkpoint`): the flagship exported with the
   port's exporter and loaded back with ``load_vla`` (no JAX), bit for
   bit in weights and in bf16 and w8a8 "fused" actions; export and load
   timed.

9. the /act server (:func:`phase_server`): the port's ``ActionServer``
   with the dynamic batcher (max_batch=16, max_wait_ms=4) over the
   flagship in bf16 and w8a8 "auto", with the reference's center crop.
   The buckets no earlier phase runs (B=8 and 16; "auto" serves them with
   "dense") first: B1 at their attention shapes and B4/B5 at their w8a8
   matmuls against the plain versions (B4/B5 bit for bit), and each
   tier's B=8 and B=16 forwards against the all-plain path, within the
   bounds of phases 5-6. Then every bucket's graph (1-16) warmed; one
   request alone and one
   coalesced batch bit for bit against the Predictor; ``run_load`` at 1, 4
   and 16 closed-loop clients for a fixed window each (one JSON line per
   tier and client count: requests/s, actions/s, p50/p90/p99 ms, realized
   batch sizes, errors), and a bf16 server with ``preprocess_workers=4``
   at 16.
10. the original VLA-Adapter model (:func:`phase_original_film`):
   ``VLAConfig()`` with the original head and FiLM towers at full width
   and depth, every tier checked as phases 5-7 check the flagship (launch
   counts from :func:`w8a8_shapes`, graphs against eager bit for bit,
   kernel path against plain, quantized tiers against bf16 and
   ``forward_error_report``), B=1 latency in turns, B4 and B5 at the new
   call sites against their plain versions, and the checkpoint round trip
   of the original head without FiLM (the exporter refuses FiLM).

11. the finetune path (:func:`phase_train`): the attention backward
   kernel (B1-bwd) against its plain version at the training shapes of
   micro-batch 16 (LLM with the dummy batch's key padding, DINOv2,
   so400m; a causal case, a GQA case at S = 37 with empty rows, S = 4000,
   and the 7B full-train recipe's LLM shape of phase 2): its plan,
   dq/dk/dv within ``ATTENTION_BWD_RTOL``, a rerun bit for bit, and its
   time (and each of its three kernels' alone) beside the plain
   version's, SDPA's backward (the yardstick) and the bound, and
   B1's forward with and without its lse output; the straight-through
   w8a8 product (forward and dx) bit
   for bit with its plain version at every frozen-base shape, each B4
   call (forward on bf16 x, dx on f32 dy * ws) timed with its plan beside
   ``torch._int_mm`` and the bound, and B4's quantization pre-pass alone
   (``w8a8_quantize``) bit for bit with ``quantize_rows``; then
   ``train.loop.finetune`` of the flagship recipe ("vla-adapter+libero-
   spatial": LoRA r=64 over the int8 base, remat of the towers and the
   decoder) at batch 16 for 8 steps over one repeated dummy batch with a
   checkpoint every 5, the main path: falling finite losses, frozen
   tensors unchanged bit for bit, the launches of B1, B1-bwd, B4 and its
   pre-pass per step as :func:`expected_train_launches` derives them, s/step,
   samples/s and peak memory; each trainable tensor's gradient norm as
   the optimizer got it, at step 0 (a LoRA ``lora_a``, zero there, at
   step 1), against the plain path's own one-ulp spread
   (:func:`grads_vs_plain`, phase 21's check); one step through the
   kernels against the plain versions (:func:`kernel_vs_plain_step`);
   a step accumulated over 2 micro-batches with a bf16 carry and bf16
   moments;
   a resume from the main run's step-6 checkpoint whose losses equal the
   unbroken run's bit for bit; and a float-base run merged
   (``weights.merge.merge_checkpoint``), exported, loaded with
   ``load_vla`` and served under a CUDA graph within phase 5's bound of
   the trained LoRA model.

12. generation (:func:`phase_generate`) on the flagship's Qwen2.5-0.5B
   (the bf16 Predictor's language-model tensors; its w8a8 "fused" twin
   quantized on the card): first B1 at the causal prefill (B=1, 4; S=128)
   and B2/B4 at a decode step's rows (M=1, 2, 4; bit for bit with their
   plain versions); "mega" must refuse to decode. Then, for bf16 and w8a8
   at B=1 and 4, ``greedy_generate_cached`` of 8 tokens after prompts of
   128 seeded ids, the main path, through the captured decode step, with
   the launches of exactly that call against
   :func:`expected_generate_launches`; the same call eagerly (the same
   tokens) and 8 graphed steps against 8 eager steps from one prefill,
   every state tensor bit for bit; the kernel path against the plain path
   and the cached loop against the full recompute (``greedy_generate``'s
   logits), each teacher-forced on the generated tokens, by
   :func:`check_logits` (``GEN_LOGITS_ATOL``, ``GEN_W8A8_LOGITS_ATOL``).
   Prints prefill ms, per-token ms eager and graphed, tokens/s and the
   step's bound (:func:`decode_step_bound`).
13. actions from logits (:func:`phase_actions`): the flagship VLA's
   ``compute_logits`` forward (bidirectional, the tied head over the text
   positions) and ``discrete_actions_from_logits`` at B=1 and 4, and
   ``predict_action_autoregressive`` (7 tokens, B=1) on a PrismaticVLM over
   the flagship's towers, projector and LLM; launches counted, each
   against the plain path.
14. the token objective and VLM pretraining (:func:`phase_token_train`,
   :func:`phase_pretrain`): the flagship recipe with ``objective="token"``
   (labels: the action block's ids) at batch 16, one step kernel vs plain
   (:func:`kernel_vs_plain_step`, the VLM's gradients from the token
   loss), then 4 steps through ``make_train_step`` (falling CE, launches
   as :func:`expected_train_launches` derives them, s/step, peak memory);
   then B1-bwd at the causal LLM shape of pretraining against its plain
   version, and ``pretrain`` of the full-width PrismaticVLM in the stages
   "align" and "last-layer-finetune", 3 steps each on one seeded batch of 8:
   launches as :func:`expected_pretrain_launches` derives them, only the
   stage's tensors moved (in "last-layer-finetune" the embedding and layer
   23), s/step, peak memory.
15. Phi-2 at full width (:func:`phase_phi`, 2.78 B seeded bf16 parameters):
   B1 at 32 heads of D=80 causal and B4 at each of Phi's w8a8 shapes
   against their plain versions, then prompt + 8 uncached greedy tokens at
   B=1 in bf16 and w8a8 ("auto"), launches per step as
   :func:`llm_pass_launches` derives them, kernel vs plain teacher-forced.

16. the model zoo at 7B (:func:`phase_zoo`, after the flagship's models
   are freed): first B1 at D = 128 (Llama-2 MHA 32/32 and Mistral GQA
   32/8, causal, B=1 and 4, at each model's multimodal prompt and at the
   generation's prefill), at the 384-px towers (DINOv2 S = 734, so400m
   S = 729) and CLIP-L/14 @ 336 (S = 577); B1-bwd at Mistral's
   pretraining shape (batch 8, causal); B2 at Llama-2 7B, Mistral 7B and
   Llama-2 13B at a prefill's rows and M = 1, 2, 4 (K = 4096-5120 on
   the one TMA path of every K, bit for bit with plain; each plan
   printed); B3 at
   CLIP-L's and so400m@384's MLPs and both projectors; B4 at 4096^2 and
   at the lm_head's widths 4096 -> 32000 (bit for bit). Then
   ``prism-dinosiglip+7b`` (Llama-2 7B under the fused 384-px towers,
   resize-naive; 6.61 B LLM parameters, seeded bf16): teacher-forced
   multimodal logits of images through the entry's ``ImageProcessor`` and
   prompts of 64-127 ids through its prompt builder, kernel vs plain, and
   its w8a8 "fused" twin (quantized on the card) against plain and against
   bf16 (:data:`ZOO_W8A8_VS_BF16_SHARE`); ``greedy_generate_cached`` of 8
   tokens at B=1 and 4 in bf16 and w8a8 as phase 12 checks it
   (:func:`generate_run`), ms per token against the step's bound. Then
   ``mistral-instruct-v0.1+7b`` (CLIP-L @ 336 with letterbox, the gelu-mlp
   projector, Mistral 7B): letterboxed non-square images through its
   logits, kernel vs plain; ``pretrain`` in "align" (fp32 weights) at
   batch 8 for 2 steps under each remat policy over the towers and the LLM
   and without remat: s/step (``utils.profiling.StepTimer``), peak memory,
   B1 and B1-bwd launches per step against
   :func:`expected_remat_pretrain_launches`, and every run's losses and
   trained projector equal bit for bit. Every figure is printed with the
   card's name and power limit, and the phase's seconds.
17. finetuning on demonstrations (:func:`phase_finetune_rlds`): seeded
   synthetic trajectories in LIBERO's no-noops RLDS schema (JPEG frames of
   256 px from PIL, state 8, actions 7 with the gripper in [-1, 1]; 20 of
   100-300 steps for each of ``libero_spatial_no_noops`` and
   ``libero_object_no_noops``) through the port's numpy pipeline
   (``libero_dataset_transform``, restructure, statistics held equal to a
   direct numpy ``compute_statistics``, normalization, chunking, decode,
   lanczos3 to 224, augmentation) as ``RLDSDataset`` for the recipe
   "vla-adapter+libero-spatial" (its augmentation on, its shuffle buffer
   capped at 10,000, mock tokenizer ids), fed by ``data_loader`` with 4
   spawn workers that see no CUDA device; every batch has the dummy
   batch's keys, shapes and dtypes and actions in [-1, 1]. The pipeline's
   host frames/s in this process and with the workers; then
   ``train.loop.finetune`` trains the full-width flagship 3 steps at
   batch 16 on it as phase 11 sets it up, B1, B1-bwd and B4 launched per
   step as :func:`expected_train_launches` says; s/step and samples/s
   beside phase 11's dummy-data figure, the seconds the loop waits in
   ``next()`` per step (``utils.profiling.StepTimer``), peak memory, the
   per-dataset loss in the metrics; :func:`kernel_vs_plain_step` on an
   RLDS batch within phase 11's bound; the checkpoint's
   ``dataset_statistics.json`` equal to the pipeline's, and ``load_vla``
   (float weights of the same seed, exported with those statistics)
   unnormalizing a chunk with them; an interleaved pass over both
   datasets (host only) drawing each within a binomial bound of its
   weight over 2,000 frames.

18. closed-loop evaluation and training under a process group
   (:func:`eval_and_group_phase`): the flagship exported with seeded
   statistics for "libero_spatial_no_noops" and "calvin_abc_rlds" and
   loaded with ``load_vla`` in bf16 and w8a8 "auto"; for each tier
   ``eval_libero`` over an in-process stand-in for ``libero`` (one suite
   of 2 tasks, 2 trials each, 256-px agent-view and wrist frames, success
   at policy step 20) and CALVIN's ``evaluate_policy`` with
   ``CalvinPolicy`` over 3 five-subtask chains (200-px static and 84-px
   gripper frames, a scripted oracle, subtasks cut to 4 ensembling
   cycles), launches counted around each run against the B=1 counts of
   phases 5 and 6 per query; every executed action equals the
   controller's schedule (open loop over 8, or hi3) applied to chunks the
   same predictor returns when called directly, bit for bit; queries/s,
   query ms p50/p99, the host ms per env step of ``prepare_observation``
   (two JPEG round trips and resizes) and the episode's seconds. Then
   ``eval_calvin`` under a one-rank NCCL group with the depth gather on
   the card (the group destroyed after), ``parity_check`` record then
   check from the exported directory (PASS at 0.0) and ``verify_smoke``
   in its own process (its latency line). Last, in a child process
   (:func:`group_train_child`), the flagship recipe at batch 16 for 3
   steps without a group and on a one-rank NCCL "data" mesh, and under
   FSDP2 on a one-rank "fsdp" mesh for a step, a checkpoint written
   under the group, and the rest resumed from it: losses and trained
   tensors bit for bit, B1, B1-bwd and B4 launched per step as derived,
   s/step and peak memory. The FSDP2 run takes the code N ranks take: a
   group per decoder layer, the int8 base held as its parts and gathered
   one layer and pass at a time, those gathers per step against
   :func:`expected_int8_gathers`. Phase 18 prints its seconds.

19. the "tensor" mesh axis (:func:`tensor_phase`): kernel B4's int32
   output at every split shape of the recipe at tensor 2 (a row split's
   forward, a column split's dx; so400m's K 2152 and, at tensor 4, 1076,
   zero-padded to a K of 16s) at the micro-batch's rows and at 20 rows:
   each part bit for bit with the plain int32 product, the parts' sum
   dequantized bit for bit with the whole-K call, timed beside it,
   ``torch._int_mm`` and the bound; B1 and B1-bwd at each rank's heads
   (the LLM's 7/1, DINOv2's 8 and so400m's 8 at micro-batch 16) within
   phases 2's and 11's bounds; then the recipe's one-ulp spread in this
   process (:func:`one_process_spread`: TENSOR_TRAIN_STEPS steps from one
   init on each of TENSOR_SPREAD_SEEDS' perturbed pixels, and on the
   batch as it is, which the whole run takes from phase 11's main run),
   and phase 11's recipe at tensor 2 as two child processes on
   the one card (NCCL refuses two ranks on one device; the group is gloo,
   the tensor collectives go through CUDA IPC, :class:`SameCardTransport`,
   given to ``finetune`` as its ``tensor_transport``): TENSOR_TRAIN_STEPS
   steps, a checkpoint, TENSOR_RESUMED_STEPS resumed; each trainable
   tensor's step-0 gradient norm and each step's loss within
   TENSOR_SPREAD_MARGIN times the spread (:func:`spread_check`), every
   rank the same losses and norms, launches of B1, B1-bwd, B4 and B4's
   int32 output per step per rank as :func:`expected_tensor_launches`
   derives them, peak memory per rank, s/step (two processes
   time-sharing one card, not a tensor-parallel speed); the checkpoint
   loaded by this process (each rank's parts of a few split tensors bit
   for bit in it) and served through ``load_vla`` within phase 5's bound
   of the trained LoRA model. Phase 19 prints its seconds.

20. "fsdp" memory at the recipes' device counts (:func:`fsdp_memory_phase`),
   each run in a child process under torch's fake process group (one rank
   of N in one process; its collectives move no data, so the phase
   checks memory, launches and gathers, no value), through
   ``train.loop.finetune`` as a user calls it: ``siglip-224px+mx-bridge``
   (SigLIP so400m + Vicuna-7B, 7.518 B fp32 parameters, full train) as
   rank 1 of 8 at 32 rows (rank 1: its 90.2 GB checkpoint is larger than
   the card machine's free disk; rank 1 makes every gather of it and
   writes nothing), and the flagship LoRA recipe over the int8 base as
   rank 0 of 4 at 16 rows, which then resumes from its checkpoint for one
   step more; each at full width and depth, seeded weights, the recipe's
   remat, FSDP_MEMORY_STEPS steps and the closing checkpoint: peak
   memory in the steps, in the set-up (the whole model built before the
   placement; a resumed run's checkpoint read) and in the checkpoint,
   the memory the forward keeps, this rank's bytes of parameters,
   gradients, Adam moments and int8 base beside the whole model's and
   the rule's 1/N, the most decoder layers unsharded at once in the
   forward, recompute and backward, B1, B1-bwd and B4 launches and int8
   gathers per step against the derived counts.

21. the full-train recipe (:func:`full_train_phase`):
   ``prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup`` ("vla-train":
   no LoRA, a float base, every one of the 1.39 B parameters trained) at
   full width and depth, seeded weights, at one rank of its 8: 32 rows a
   step as 2 micro-batches of 16 (dummy batches), through
   ``train.loop.finetune`` in one process for 6 steps with the closing
   checkpoint. First B1 and B1-bwd at its LLM shape (its dummy batch's
   key padding) against their plain versions, timed beside SDPA and the
   bound. Then: falling finite losses; B1 and B1-bwd launched per step as
   :func:`expected_train_launches` derives them and no B4 (the base is
   float); s/step (median of steps 3-6), samples/s, peak memory; the
   checkpoint (every tensor and both Adam moments) read back with
   ``load_checkpoint`` bit for bit, write and read timed; the step-0 loss
   and every trainable tensor's step-0 gradient norm against the plain
   path (``build_runtime(kernels="plain")``, the same init, batch and
   noise) within GRAD_SPREAD_MARGIN times its one-ulp spread
   (:func:`grads_vs_plain`).

``--only 11,...,21`` runs the build and any of phases 11-21 alone (no
kernels or ok line; phases 11, 16, 17, 19, 20 and 21 alone build no
flagship; phase 17 alone has no phase-11 figure beside its s/step).

Phases 9 and 10 took 100 s on an NVIDIA H100 80GB HBM3 at 700 W beside
110 s for phases 1-8 (their per-phase seconds are printed; phase 9's
kernel checks at B=8 and 16 about 20 s of it). To hold the whole run near
twice phases 1-8 alone, phase 7 times 6 rounds at B=1
and 4 at B=2 and B=4 (were 8 and 6), and phase 9 runs its preprocess-pool
server for bf16 only. To make room for phase 19 in the 1200 s the whole
run may take, depth was cut, not checks: phase 9 measures 2 s
windows (were 4), phase 11 accumulates over 2 steps (were 3), phases 12
and 16 generate 16 tokens (were 32), and phase 17 trains 6 steps (were
10). To make room for phase 21 and phase 11's gradient check, again
depth: phase 9 measures 1.5 s windows after 0.5 s warm-ups (were 2 and
1), phase 11's main run takes 8 steps (were 10; its resume 2, were 4),
its accumulation run 1 (were 2) and its float-base run for the merge 2
(were 3), phases 12 and 16 generate 8 tokens (were 16), phase 17 trains
4 steps, phase 16's pretraining runs 2 (were 3), phase 18's group runs
4 (were 6), phase 19's tensor run 3 steps and 1 resumed (were 4 and 2),
phase 20 1 step (were 2). To hold the run within 900 s with B1's
phase-2 rows (every shape of PERF.md's B1 rows, timed at 10 reps x 3
rounds, the plain version at 2 reps), again depth, and two builds split
over the cores (``cuda_lib.SPLIT_COMPILE``): B1-bwd's rows (phases 11,
14, 16, 19, 21) time it and B1 at 10 reps x 3 rounds (were 20 x 5),
phase 7 times 4 rounds at B=1 and 3 at B=2 and B=4 (were 6 and 4),
phase 10 its B=1 latency 5 rounds (were 8), phase 17's loader drains 4
batches and times 8 (were 8 and 12) and its run trains 3 steps (were
4), phase 18's group runs 3 steps (were 4).

With ``--profile`` phase 7 also profiles one B=1 request per tier and
one B=4 request of the w8a8 "fused" and "dense" tiers, eager and
replayed, and checks that the eager w8a8 tiers launch at least 3,000
fewer kernels per request than before the quantization moved inside B4
(``KERNELS_PER_REQUEST_BEFORE``); phase 11 profiles the third step of its
main finetune run (device ms by kernel group, :class:`ProfiledStep`), and
phase 18 step 2 of its runs without a group, on "data" and under FSDP2.

Prints the card's name and power limit, one JSON line per kernel shape, a
``{"kernels": [...]}`` line (each kernel's ``launches`` on the bf16 or w8a8
flagship path, B1-bwd's and B4's pre-pass's on the train path, and
``launches_by_path`` for
every path), and as its last
line
``{"ok": true, "device": {...}}``. ``launches_by_path`` also covers the
paths of phases 12-18: "generate", "generate_w8a8", "actions",
"token_train", "pretrain", "phi", "zoo_logits", "zoo_generate",
"zoo_generate_w8a8", "zoo_pretrain", "finetune_rlds", "eval_libero",
"eval_calvin", "finetune_ddp", "finetune_fsdp", "finetune_tensor"
(rank 0 of phase 19), "finetune_fsdp8_full" and "finetune_fsdp4_lora"
(phase 20's runs, per step) and "finetune_full" (phase 21, per step);
each entry's ``zoo_7b`` lists its phase-16 call sites (per call: ms,
plain, bound, library). Exits non-zero without CUDA, and when the
``vla_adapter_torch`` package beside this script is missing.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet): bf16 tensor-core
# rate and HBM3 bandwidth; a power limit below 700 W lowers what is reached.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

SOURCES = ("fused_attention.cu", "w8a8_matmul.cu", "fused_mlp_w8a8.cu",
           "megalayer_w8a8.cu", "attention_bwd.cu")

# kernel vs plain: bf16 output of |out| < 4, the two differ in fp32
# summation order and exp rounding, so by about one bf16 ulp (2^-6 at 2-4).
KERNEL_ATOL = 2e-2
# the attention backward kernel (B1-bwd) vs its plain version (autograd
# through the twin of xla_attention), per output, max |kernel - plain| over
# max |plain|: the kernel rounds ds to bf16 for its dq/dk products (the
# plain version keeps it fp32 into an fp32 product), sums dk/dv of a GQA
# group in fp32 (the plain version rounds each head's to bf16 first) and
# sums in another order, each a relative 2^-9 per term, well inside 1e-2.
ATTENTION_BWD_RTOL = 1e-2
# flagship, kernel vs plain attention, normalized actions: 73 attention
# calls in bf16 through 24+23+26 random-weight layers and a 24-block head.
FLAGSHIP_ACTIONS_ATOL = 1e-1
# flagship w8a8, kernel path vs all-plain path, normalized actions: the
# w8a8 kernels equal their plain versions bit for bit, but the attention
# kernel's bf16 differences (0.027 in the bf16 forward) reach per-token
# int8 quantizations downstream, where one bf16 ulp of an activation near
# its row's absmax is as large as an int8 step and flips roundings.
W8A8_ACTIONS_ATOL = 0.3
# the whole-layer kernel (B6) vs its plain version, bf16 output: it sums
# the attention and RMSNorm2 in another order and takes the card's expf, so
# a bf16 ulp of the context or a float ulp of h2 can flip an int8 rounding
# of the o-projection or MLP input, which moves its row by a fraction of an
# int8 step through one more projection. Every output within four bf16 ulps
# of its row's largest output, at most 10% of the rows with an output more
# than two ulps of its own size away (an H100 read 0.9% of the row maximum
# and 6.1% of the rows at the Qwen2 layer, M=640).
MEGALAYER_ROW_ULPS = 4
MEGALAYER_ROW_SHARE = 0.10
# w8a8 (and weight-only int8) vs bf16 on the same weights, normalized
# actions, max abs over the chunk (the JAX package's forward_error_report
# quantity): a quarter of the [-1, 1] action range. The random flagship
# reads 0.16-0.20 here (PERF.md); beyond 0.5 a quantized tier no longer
# serves the same policy.
QUANTIZED_VS_BF16_LIMIT = 0.5

INSTRUCTION = "put both the alphabet soup and the tomato sauce in the basket"
# prompts of other lengths, so that a graph's replays see other prompt
# lengths (and other images) than the request it was captured at
GRAPH_INSTRUCTIONS = (INSTRUCTION, "pick up the black bowl",
                      "open the top drawer and put the bowl inside")

# Kernels per profiled B=1 request before the activation quantization
# moved inside kernel B4 (PERF.md: measured on an NVIDIA H100 80GB HBM3 at
# 700 W): each w8a8 tier must launch at least KERNELS_SAVED fewer (~10
# eager launches of quantize_rows per w8a8 matmul).
KERNELS_PER_REQUEST_BEFORE = {"w8a8 fused": 7807, "w8a8 dense": 9723,
                           "w8a8 mega": 7279}
KERNELS_SAVED = 3000
# A write of this many bytes evicts the 50 MB L2 between timed calls.
L2_FLUSH_BYTES = 64 << 20


def numpy_quantize_kernel(kernel: np.ndarray):
    """The JAX package's numpy ``quantize_kernel`` (models/quantize.py), the
    reference for the port's on-card weight quantizer: (..., in, out)
    float -> int8 and the float32 per-out-channel scale."""
    k = np.asarray(kernel, np.float32)
    absmax = np.max(np.abs(k), axis=-2, keepdims=True)
    scale = (absmax * np.float32(1.0 / 127.0)).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=-2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _event_ms(run, rounds: int) -> float:
    import torch

    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so host launch overhead leaves no gaps between them; median
    over ``rounds`` replays of CUDA-event time, divided by ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(graph.replay, rounds) / reps


def eager_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time per call of ``reps`` back-to-back eager calls: the device time
    or the host's launch time, whichever is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _event_ms(run, rounds) / reps


class MeasurementError(RuntimeError):
    """A timing that cannot be right (no device time, or calls the host
    did not queue ahead of the card)."""


# the card's spin ahead of the queued calls of :func:`queued_ms`, in
# clock cycles (torch.cuda._sleep; ~50 ms at an H100's 1.98 GHz)
QUEUE_SPIN_CYCLES = 100_000_000


def queued_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Device time of one call, for a call a CUDA graph cannot capture
    (SDPA's masked backward through cuDNN): ``reps`` calls queued behind a
    spin on the card (``torch.cuda._sleep``), so that the host has
    launched them all before the first one starts and no host gap falls
    between them; CUDA events around the calls alone, the median over
    ``rounds``, over ``reps``. CUDA events, not the profiler: late in a
    run, and after a process group, ``torch.profiler`` lost SDPA's kernels
    (0-65 µs read against 89-163 µs). Raises :class:`MeasurementError` if
    the spin ended before the host had queued the calls, or no time
    passed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        if start.query():
            raise MeasurementError("queued_ms: the card reached the calls "
                                   "before the host had queued them")
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    ms = statistics.median(times)
    if not ms > 0:
        raise MeasurementError(f"queued_ms: {ms} ms per call")
    return ms


def device_ms_cold(fn, reps: int = 20, rounds: int = 5) -> float:
    """:func:`device_ms` with L2 flushed before each call: a 64 MB write
    precedes every call in the graph, and the time of the writes alone is
    subtracted. In the forward a weight arrives cold from HBM."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        scratch.fill_(1)
        fn()

    return (device_ms(flushed, reps, rounds)
            - device_ms(lambda: scratch.fill_(1), reps, rounds))


def attention_bound_ms(b, h, hkv, s, d, valid, causal):
    """Least time for one call: max(FLOPs / bf16 peak, bytes / HBM rate).
    FLOPs count the (query, valid key) pairs these inputs need (4 h d per
    pair: q.k and p.v); bytes count q, k, v, o and valid once each."""
    key_ok = valid.astype(np.int64)
    if causal:
        pairs = int(np.cumsum(key_ok, axis=1).sum())
    else:
        pairs = int(s * key_ok.sum())
    flops = 4 * h * d * pairs
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 4 * valid.size
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def attention_shapes(cfg, tokenize, batches=(1, 2)):
    """(name, forward batch, batch, heads, kv heads, seq, head dim, key
    valid, causal, launches per forward) for serving forwards of each of
    ``batches``; the towers see 2 images per request."""
    from vla_adapter_torch.data.transform import inference_ids

    _, _, text_valid = inference_ids(cfg, tokenize, INSTRUCTION)
    mm_valid = np.concatenate([text_valid[:1], np.ones(cfg.num_patches,
                                                       np.int32),
                               text_valid[1:]])
    llm, dino, siglip = cfg.llm, cfg.vision.primary, cfg.vision.fused
    n_img = cfg.vision.num_images
    shapes = []
    for b in batches:
        valid = np.tile(mm_valid, (b, 1))
        s_llm = valid.shape[1]
        shapes += [
            ("llm", b, b, llm.num_heads, llm.num_kv_heads, s_llm, llm.head_dim,
             valid, False, llm.num_layers),
            ("llm_causal", b, b, llm.num_heads, llm.num_kv_heads, s_llm,
             llm.head_dim, valid, True, 0),
            ("dinov2", b, b * n_img, dino.num_heads, dino.num_heads,
             dino.num_patches + dino.num_prefix_tokens, dino.head_dim, None,
             False, dino.resolved_feature_layer + 1),
            ("so400m", b, b * n_img, siglip.num_heads, siglip.num_heads,
             siglip.num_patches + siglip.num_prefix_tokens, siglip.head_dim,
             None, False, siglip.resolved_feature_layer + 1),
        ]
    return shapes


# Every B1 shape of PERF.md's table of kernels beyond the serving shapes
# at B = 1 and 2 (:func:`attention_shapes`) and the 7B full-train recipe's
# (:func:`seven_b_attention_shape`): (name, batch, heads, kv heads, seq,
# head dim, padded keys, causal). The finetune's and full-train's LLM,
# DINOv2 and so400m at micro-batch 16 and each rank's heads at tensor 2;
# generation's causal prefill at B = 1, 4; Phi-2; the 7B zoo's causal
# prompts (Llama-2 MHA, Mistral GQA 32/8) and prefill; the 384/336-px
# towers at B = 1, 4. Padded: the first batch row's last seq // 16 keys
# are invalid, as a shorter prompt's.
B1_ROW_SHAPES = [
    ("llm_train", 16, 14, 2, 640, 64, True, False),
    ("llm_train_causal", 16, 14, 2, 640, 64, True, True),
    ("dinov2_train", 32, 16, 16, 261, 64, False, False),
    ("so400m_train", 32, 16, 16, 256, 72, False, False),
    ("llm_tensor2", 16, 7, 1, 640, 64, True, False),
    ("dinov2_tensor2", 32, 8, 8, 261, 64, False, False),
    ("so400m_tensor2", 32, 8, 8, 256, 72, False, False),
    ("llm_prefill_b1", 1, 14, 2, 128, 64, False, True),
    ("llm_prefill_b4", 4, 14, 2, 128, 64, False, True),
    ("phi2", 1, 32, 32, 136, 80, False, True),
    ("llama2_7b_b1", 1, 32, 32, 857, 128, True, True),
    ("llama2_7b_b4", 4, 32, 32, 857, 128, True, True),
    ("mistral_7b_b1", 1, 32, 8, 704, 128, True, True),
    ("mistral_7b_b4", 4, 32, 8, 704, 128, True, True),
    ("llama2_7b_prefill", 1, 32, 32, 96, 128, False, True),
    ("dinov2_384_b1", 1, 16, 16, 734, 64, False, False),
    ("dinov2_384_b4", 4, 16, 16, 734, 64, False, False),
    ("so400m_384_b1", 1, 16, 16, 729, 72, False, False),
    ("so400m_384_b4", 4, 16, 16, 729, 72, False, False),
    ("clip_l_336_b1", 1, 16, 16, 577, 64, False, False),
    ("clip_l_336_b4", 4, 16, 16, 577, 64, False, False),
]


# reps and rounds of their timings (the serving shapes' 20 and 5)
B1_ROW_TIMING = (10, 3)


def b1_row_shapes(names=None) -> list:
    """:data:`B1_ROW_SHAPES` (those named, or all) as
    :func:`phase_kernel_vs_plain` takes them, on no flagship serving path
    (0 calls a forward)."""
    out = []
    for name, b, h, hkv, s, d, padded, causal in B1_ROW_SHAPES:
        if names and name not in names:
            continue
        valid = None
        if padded:
            valid = np.ones((b, s), np.int32)
            valid[0, s - s // 16:] = 0
        out.append((name, b, b, h, hkv, s, d, valid, causal, 0))
    return out


def phase_kernel_vs_plain(shapes, timing=(20, 5), plain_reps=5):
    """B1 against its plain version at each of ``shapes`` (the tuples of
    :func:`attention_shapes`), its plan printed, timed (reps and rounds
    ``timing``, the plain version ``plain_reps`` reps) beside SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F

    from vla_adapter_torch.ops.attention_kernel import (
        attention_plan,
        attention_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for name, fwd_b, b, h, hkv, s, d, valid_np, causal, per_fwd in shapes:
        plan = attention_plan(b, h, hkv, s, d, sms, causal)
        q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        valid = (None if valid_np is None
                 else torch.from_numpy(valid_np).to(dev))
        got = fused_attention(q, k, v, valid, causal=causal)
        want = attention_reference(q, k, v, valid, causal=causal)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} b={b}: kernel output not finite")
        rows = (torch.ones(b, s, dtype=torch.bool, device=dev)
                if valid is None else valid.bool())
        err = float((got.float() - want.float()).abs()
                    .transpose(1, 2)[rows].max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name} b={b}: kernel vs plain max abs "
                                 f"err {err} > {KERNEL_ATOL}")
        # SDPA yardstick: GQA expanded outside the timed call, the same mask
        kx = k.repeat_interleave(h // hkv, dim=1)
        vx = v.repeat_interleave(h // hkv, dim=1)
        mask = None
        if valid is not None:
            mask = valid.bool()[:, None, None, :]
        if causal:
            tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            mask = tril if mask is None else mask & tril

        def kernel():
            fused_attention(q, k, v, valid, causal=causal)

        ms = device_ms(kernel, *timing)
        host_ms = eager_ms(kernel, *timing)
        plain_ms = device_ms(lambda: attention_reference(
            q, k, v, valid, causal=causal), plain_reps, timing[1])
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), *timing)
        key_valid = (np.ones((b, s), np.int32) if valid_np is None
                     else valid_np)
        bound, bound_by, flops, nbytes = attention_bound_ms(
            b, h, hkv, s, d, key_valid, causal)
        rec = {"shape": name, "forward_batch": fwd_b, "batch": b,
               "heads": h, "kv_heads": hkv,
               "seq": s, "head_dim": d, "causal": causal,
               "launches_per_forward": per_fwd,
               "max_abs_err": err, "ms": ms, "eager_ms": host_ms,
               "plain_ms": plain_ms,
               "sdpa_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes, "plan": plan}
        print("attention_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def attention_bwd_shapes(cfg, batch: int, seed: int):
    """(name, batch, heads, kv heads, seq, head dim, key valid, causal,
    calls per micro-batch) of the backward at the flagship finetune's
    micro-batch: the LLM with the dummy batch's key padding, the towers
    (2 images per sample), and three checks off the main path: the LLM
    shape causal, GQA at a sequence not a multiple of 16 whose first row
    has no valid key, and the LLM's heads at S = 4000 (no per-row storage,
    so no length limit), batch 1 with its last 500 keys padded."""
    from vla_adapter_torch.data.dummy import make_dummy_batch

    tv = make_dummy_batch(cfg, batch, np.random.default_rng(seed))[
        "text_valid"]
    mm_valid = np.concatenate([tv[:, :1], np.ones((batch, cfg.num_patches),
                                                  np.int32), tv[:, 1:]], 1)
    llm, dino, siglip = cfg.llm, cfg.vision.primary, cfg.vision.fused
    n_img = cfg.vision.num_images
    s_llm = mm_valid.shape[1]
    odd = np.ones((2, 37), np.int32)
    odd[0, :5] = 0
    odd[0, 30:] = 0
    long = np.ones((1, 4000), np.int32)
    long[0, 3500:] = 0
    return [
        ("llm", batch, llm.num_heads, llm.num_kv_heads, s_llm, llm.head_dim,
         mm_valid, False, llm.num_layers),
        ("dinov2", batch * n_img, dino.num_heads, dino.num_heads,
         dino.num_patches + dino.num_prefix_tokens, dino.head_dim, None,
         False, dino.resolved_feature_layer + 1),
        ("so400m", batch * n_img, siglip.num_heads, siglip.num_heads,
         siglip.num_patches + siglip.num_prefix_tokens, siglip.head_dim,
         None, False, siglip.resolved_feature_layer + 1),
        ("llm_causal", batch, llm.num_heads, llm.num_kv_heads, s_llm,
         llm.head_dim, mm_valid, True, 0),
        ("gqa_s37_d72", 2, 14, 2, 37, 72, odd, False, 0),
        ("llm_s4000", 1, llm.num_heads, llm.num_kv_heads, 4000, llm.head_dim,
         long, False, 0),
    ]


# the LLM attention of the 7B full-train recipe "siglip-224px+mx-bridge"
# (Vicuna-7B: 32/32 heads of D = 128, non-causal) at phase 20's rows a rank
SEVEN_B_RECIPE = "siglip-224px+mx-bridge"
SEVEN_B_ROWS = 32


def seven_b_attention_shape(seed: int) -> tuple:
    """SEVEN_B_RECIPE's LLM attention over its num_patches + max_text_tokens
    (384) tokens with its dummy batch's key padding, at SEVEN_B_ROWS rows:
    as a (phase 2 shape, phase 11 backward shape) pair, on no serving or
    micro-batch path of the flagship (0 calls)."""
    from vla_adapter_torch.core.experiments import get_experiment
    from vla_adapter_torch.data.dummy import make_dummy_batch

    cfg, rows = get_experiment(SEVEN_B_RECIPE).to_train_config().model, \
        SEVEN_B_ROWS
    tv = make_dummy_batch(cfg, rows, np.random.default_rng(seed))[
        "text_valid"]
    valid = np.concatenate([tv[:, :1], np.ones((rows, cfg.num_patches),
                                               np.int32), tv[:, 1:]], 1)
    llm, s = cfg.llm, valid.shape[1]
    return (("llm_7b_full_train", rows, rows, llm.num_heads,
             llm.num_kv_heads, s, llm.head_dim, valid, False, 0),
            ("llm_7b_full_train", rows, llm.num_heads, llm.num_kv_heads, s,
             llm.head_dim, valid, False, 0))


def attention_bwd_bound_ms(b, h, hkv, s, d, valid, causal):
    """Least time for one backward: five products of 2 h d operations per
    (query, valid key) pair (the recomputed q.k, dv, dp, dq, dk) at the
    bf16 peak, or q, k, v, dO read and dq, dk, dv written once at the HBM
    rate, whichever is longer."""
    key_ok = valid.astype(np.int64)
    pairs = (int(np.cumsum(key_ok, axis=1).sum()) if causal
             else int(s * key_ok.sum()))
    flops = 10 * h * d * pairs
    nbytes = 2 * (3 * b * h * s * d + 4 * b * hkv * s * d) + 4 * valid.size
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


# reps and rounds of phase 11's B1-bwd and B1 timings (were 20 and 5)
BWD_TIMING = (10, 3)


def phase_attention_bwd(shapes, card: str):
    """B1-bwd against its plain version at each shape: the plan, the
    relative error of dq, dk, dv, a rerun bit for bit, and the times of the
    kernel (its three launches together, and each alone on the row
    statistics of an earlier call), the plain version, SDPA's backward (the
    yardstick, GQA expanded before the call; the port never calls it: its
    kernels' device time, and eagerly, host launches included) and the
    bound; B1's forward with and without its lse output beside it."""
    import torch
    import torch.nn.functional as F

    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNELS,
        attention_bwd,
        attention_bwd_plan,
        attention_bwd_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    records = []
    for name, b, h, hkv, s, d, valid_np, causal, per_step in shapes:
        plan = attention_bwd_plan(b, h, hkv, s, d, cuda_lib.sm_count(dev))
        print(f"attention_bwd plan {name}: {json.dumps(plan)}", flush=True)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).bfloat16()

        # the model's layout: (B, S, H, D) buffers seen as (B, H, S, D)
        q, dout = (randn(b, s, h, d).transpose(1, 2) for _ in range(2))
        k, v = (randn(b, s, hkv, d).transpose(1, 2) for _ in range(2))
        valid = (None if valid_np is None
                 else torch.from_numpy(valid_np).to(dev))
        got = attention_bwd(q, k, v, valid, dout, causal=causal)
        again = attention_bwd(q, k, v, valid, dout, causal=causal)
        want = attention_bwd_reference(q, k, v, valid, dout, causal=causal)
        torch.cuda.synchronize()
        errs = {}
        for gname, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"attention_bwd {name}: {gname} not "
                                     f"finite")
            if not torch.equal(g, a):
                raise AssertionError(f"attention_bwd {name}: {gname} "
                                     f"differs between two runs")
            scale = float(w.float().abs().max())
            errs[gname] = float((g.float() - w.float()).abs().max()) / max(
                scale, 1e-30)
            if not errs[gname] <= ATTENTION_BWD_RTOL:
                raise AssertionError(
                    f"attention_bwd {name}: {gname} max |kernel - plain| / "
                    f"max |plain| = {errs[gname]} > {ATTENTION_BWD_RTOL}")
        # the training path's call: the forward's lse given
        lse = fused_attention(q, k, v, valid, causal=causal,
                              return_lse=True)[1]
        stats = torch.empty((2, b, h, -(-s // 64) * 64), dtype=torch.float32,
                            device=dev)
        ms = device_ms(lambda: attention_bwd(q, k, v, valid, dout,
                                             causal=causal, lse=lse,
                                             stats=stats), *BWD_TIMING)
        split_ms = {kn: device_ms(lambda kn=kn: attention_bwd(
            q, k, v, valid, dout, causal=causal, lse=lse, stats=stats,
            kernels=(kn,)), *BWD_TIMING) for kn in BWD_KERNELS}
        fwd_ms = device_ms(lambda: fused_attention(q, k, v, valid,
                                                   causal=causal),
                           *BWD_TIMING)
        fwd_lse_ms = device_ms(lambda: fused_attention(
            q, k, v, valid, causal=causal, return_lse=True), *BWD_TIMING)
        plain_ms = eager_ms(lambda: attention_bwd_reference(
            q, k, v, valid, dout, causal=causal), reps=3, rounds=3)
        # SDPA's backward: forward once outside the timed calls
        qx = q.detach().requires_grad_(True)
        kx = k.repeat_interleave(h // hkv, dim=1).detach().requires_grad_(True)
        vx = v.repeat_interleave(h // hkv, dim=1).detach().requires_grad_(True)
        mask = None
        if valid is not None:
            mask = valid.bool()[:, None, None, :]
        if causal:
            tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            mask = tril if mask is None else mask & tril
        out = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qx, kx, vx), dout,
                                       retain_graph=True)

        lib_ms = queued_ms(sdpa_bwd)
        lib_eager_ms = eager_ms(sdpa_bwd, reps=5, rounds=3)
        key_valid = (np.ones((b, s), np.int32) if valid_np is None
                     else valid_np)
        bound, bound_by, flops, nbytes = attention_bwd_bound_ms(
            b, h, hkv, s, d, key_valid, causal)
        rec = {"card": card, "shape": name, "batch": b, "heads": h,
               "kv_heads": hkv, "seq": s, "head_dim": d, "causal": causal,
               "calls_per_micro_batch": per_step, "rel_err": errs,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "deterministic": True, "ms": ms, "split_ms": split_ms,
               "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
               "plain_ms": plain_ms, "sdpa_bwd_ms": lib_ms,
               "sdpa_bwd_eager_ms": lib_eager_ms,
               "ratio_to_sdpa_bwd": ms / lib_ms, "bound_ms": bound,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "plan": plan}
        print("attention_bwd_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


BASE_OWNERS = ("fused_featurizer", "featurizer", "language_model",
               "projector")


def train_rows(cfg, batch: int, text: Optional[int] = None) -> dict:
    """Rows each part of the VLA's base multiplies in a pass over ``batch``
    samples: each tower's tokens of every image, the LLM's sequence
    (patches and ``text`` ids, the config's max_text_tokens by default),
    the projector's patches."""
    v, n_img = cfg.vision, cfg.vision.num_images
    text = cfg.max_text_tokens if text is None else text
    rows = {"featurizer": batch * n_img * (v.primary.num_patches
                                           + v.primary.num_prefix_tokens),
            "language_model": batch * (cfg.num_patches + text),
            "projector": batch * cfg.num_patches}
    if v.fused is not None:
        rows["fused_featurizer"] = batch * n_img * (
            v.fused.num_patches + v.fused.num_prefix_tokens)
    return rows


def base_owner(name: str) -> str:
    """The part of the base (:data:`BASE_OWNERS`) a module name is in."""
    return next(o for o in BASE_OWNERS if o in name.split("."))


def b4_call_launches(m: int, k: int, n: int, x_dtype="bf16",
                     name: Optional[str] = None, layers: int = 1) -> dict:
    """Kernel launches of one B4/B5 call of x (M, K) ("bf16", "f32" or
    "int8") against ``layers`` weight layers (N, K): the product (counted
    as ``name``, B4's by default) and, where its plan has one, the Hopper
    branch's quantization pre-pass. The plan is the card's where there is
    one (``card_plan``), else ``w8a8_plan``'s defaults."""
    import torch

    from vla_adapter_torch.ops import w8a8_matmul

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "int8": torch.int8}[x_dtype]
    out = torch.int32 if name == w8a8_matmul.INT32_KERNEL_NAME \
        else torch.bfloat16
    # on the card, its own plan (its SMs and narrow occupancy decide
    # whether a split over K stays narrow)
    plan = (w8a8_matmul.card_plan(m, n, k, layers, dtype, out,
                                  torch.device("cuda"))
            if torch.cuda.is_available()
            else w8a8_matmul.w8a8_plan(m, n, k, layers, dtype, out))
    return w8a8_matmul.plan_launches(plan, name or w8a8_matmul.KERNEL_NAME)


def ste_shapes(cfg, batch: int):
    """Distinct (M, in, out) of the frozen base's w8a8 matmuls at the
    finetune's micro-batch (the towers see 2 images per sample)."""
    from vla_adapter_torch.core.config import TrainConfig
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime

    rt = build_runtime(TrainConfig(model=cfg, base_int8=True))
    model = VLAModel(cfg, rt, device="meta")
    rows = train_rows(cfg, batch)
    shapes = set()
    for name, mod in model.named_modules():
        if getattr(mod, "ste", False):
            owner = base_owner(name)
            shapes.add((owner, rows[owner], mod.in_features, mod.features))
    return sorted(shapes)


def phase_ste(shapes, card: str):
    """The straight-through w8a8 product on the card (kernel B4 forward,
    and B4 on the transposed int8 weight for dx) against its plain version
    at the frozen base's shapes: forward and dx bit for bit; the backward
    timed (eager, one B4 call and two elementwise passes), and each B4 call
    alone (device time under graph replay: the forward on bf16 x, dx on
    f32 dy * ws with unit column scales) beside ``torch._int_mm`` on the
    same int8 operands and the bound, with the plan of each."""
    import torch

    from vla_adapter_torch.models.layers import W8A8STE
    from vla_adapter_torch.ops import w8a8_matmul as ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    records = []
    for owner, m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        dy = torch.randn(m, n, generator=gen, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-3
        wqt = wq.t().contiguous()
        got, want = [], []
        for kernels, out in (("kernel", got), ("plain", want)):
            xr = x.detach().requires_grad_(True)
            y = W8A8STE.apply(xr, wq, ws, wqt, kernels)
            (dx,) = torch.autograd.grad(y, xr, dy)
            out += [y, dx]
        torch.cuda.synchronize()
        for what, g, w in zip(("forward", "dx"), got, want):
            if not (torch.isfinite(g.float()).all() and torch.equal(g, w)):
                raise AssertionError(
                    f"STE {owner} ({m}, {k}->{n}) {what}: kernel differs from "
                    f"plain by {float((g.float() - w.float()).abs().max())}")

        def backward(kernels):
            xr = x.detach().requires_grad_(True)
            y = W8A8STE.apply(xr, wq, ws, wqt, kernels)
            return lambda: torch.autograd.grad(y, xr, dy, retain_graph=True)

        rec = {"card": card, "shape": owner, "m": m, "in": k, "out": n,
               "forward_bitwise": True, "dx_bitwise": True,
               "dx_ms": eager_ms(backward("kernel"), reps=5, rounds=3),
               "dx_plain_ms": eager_ms(backward("plain"), reps=2, rounds=2)}
        dys = dy.float() * ws
        ones = torch.ones(k, device=dev)
        for what, a, w, s, kk, nn in (("forward", x, wq, ws, k, n),
                                      ("dx", dys, wqt, ones, n, k)):
            aq, _ = ops.quantize_rows(a)
            bound, bound_by, _, _ = w8a8_bound(
                {"m": m, "k": kk, "n": nn},
                x_bytes=a.element_size())
            rec[what] = {
                "plan": ops.card_plan(m, nn, kk, 1, a.dtype, torch.bfloat16,
                                      dev),
                "ms": device_ms(lambda: ops.w8a8_linear(a, w, s), reps=10,
                                rounds=3),
                "int_mm_ms": _int_mm_ms(aq, w)[0],
                "bound_ms": bound, "bound_by": bound_by}
            # the Hopper branch's pre-pass alone against quantize_rows
            got_q, want_q = ops.w8a8_quantize(a), ops.quantize_rows(a)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got_q, want_q)):
                raise AssertionError(f"STE {owner} ({m}, {kk}) {what}: the "
                                     f"quantization pre-pass differs from "
                                     f"quantize_rows")
            rec[what]["prepass"] = {
                "ms": device_ms(lambda: ops.w8a8_quantize(a), reps=10,
                                rounds=3),
                "plain_ms": device_ms(lambda: ops.quantize_rows(a), reps=3,
                                      rounds=3),
                "bound_ms": 1e3 * (a.numel() * (a.element_size() + 1)
                                   + 4 * m) / PEAK_HBM_BYTES}
        print("ste_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def first_block_qkv(model) -> set:
    """ids of the first tower block's q/k/v Denses, which no gradient's dx
    reaches (they read the patch embeddings, which train nothing)."""
    from vla_adapter_torch.models.vit import ViTBlock

    out = set()
    for tower in model.vision_backbone.children():
        block0 = tower.blocks[0]
        assert isinstance(block0, ViTBlock)
        out |= {id(block0.attn.q_proj), id(block0.attn.k_proj),
                id(block0.attn.v_proj)}
    return out


def expected_train_launches(model, batch: int = 16) -> dict:
    """Kernel launches per micro-batch of ``batch`` samples (16 a rank in
    every recipe the smoke trains over the int8 base) of the finetune,
    from the training model: B1 on every attention layer, twice where its
    stack ("vit", "llm") recomputes; B1-bwd's three kernels once per
    attention layer; B4 once per frozen w8a8 matmul in the forward (bf16
    x), again where it recomputes, and once more for dx (f32 dy * ws
    against the (in, out) weight), except where no gradient reaches the
    matmul's input (:func:`first_block_qkv`); and B4's quantization
    pre-pass with each of those calls whose plan takes the Hopper branch
    (:func:`b4_call_launches`, at the rows of :func:`train_rows`)."""
    from vla_adapter_torch.models.qwen2 import Qwen2Attention
    from vla_adapter_torch.models.vit import ViTAttention
    from vla_adapter_torch.ops import w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_LAUNCHES_PER_CALL,
        KERNEL_NAME,
    )

    rt = model.rt
    rows = train_rows(model.cfg, batch)
    first = first_block_qkv(model)
    attn = 0
    b4 = collections.Counter({w8a8_matmul.KERNEL_NAME: 0})
    for name, mod in model.named_modules():
        stack = ("llm" if name.startswith("language_model") else
                 "vit" if name.startswith("vision_backbone") else None)
        twice = 2 if stack and rt.remat_policy_of(stack) else 1
        if isinstance(mod, (Qwen2Attention, ViTAttention)):
            attn += twice
        if getattr(mod, "ste", False):
            m, k, n = rows[base_owner(name)], mod.in_features, mod.features
            for _ in range(twice):
                b4.update(b4_call_launches(m, k, n, "bf16"))
            if id(mod) not in first:
                b4.update(b4_call_launches(m, n, k, "f32"))
    layers = sum(isinstance(m, (Qwen2Attention, ViTAttention))
                 for m in model.modules())
    return {KERNEL_NAME: attn,
            BWD_KERNEL_NAME: BWD_LAUNCHES_PER_CALL * layers, **b4}


def expected_int8_gathers(model) -> dict:
    """The all-gathers of the int8 base per micro-batch of the finetune
    under "fsdp" (``parallel/fsdp_int8.py``), by pass, from the placed
    model: each layer whose Denses hold parts of their int8 tensors
    (``Int8Layer``) gathers its forward weights once at its forward
    ("forward"), again where its stack ("vit", "llm") recomputes, and its
    "weight_qt" copies once for dx ("backward") where a gradient reaches
    the input of any of its straight-through Denses (all but the first
    tower block's q/k/v, as in :func:`expected_train_launches`)."""
    from vla_adapter_torch.models.layers import Dense

    rt = model.rt
    first = {id(d) for tower in model.vision_backbone.children()
             for d in (tower.blocks[0].attn.q_proj, tower.blocks[0].attn.k_proj,
                       tower.blocks[0].attn.v_proj)}
    forward, backward = {}, {}
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense) or mod.int8_parts is None:
            continue
        layer = id(mod.int8_parts.layer)
        stack = ("llm" if name.startswith("language_model") else
                 "vit" if name.startswith("vision_backbone") else None)
        forward[layer] = 2 if stack and rt.remat_policy_of(stack) else 1
        if mod.ste and "weight_qt" in mod.int8_parts.dims \
                and id(mod) not in first:
            backward[layer] = 1
    out = {"forward": sum(forward.values()),
           "backward": sum(backward.values())}
    return {k: v for k, v in out.items() if v}


def _check_train_launches(launches, per_micro, micro_batches, what):
    want = {k: v * micro_batches for k, v in per_micro.items()}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, derived {want}")
    extra = {k: v for k, v in launches.items() if k not in want and v}
    if extra:
        raise AssertionError(f"{what}: other kernels launched: {extra}")


# kernel path vs plain path, one finetune step of the flagship from the
# same weights, batch and noise. The loss is held to 0.5%, five times the
# 0.09% read on an H100. The VLM's gradients (LoRA pairs of the LLM and
# both towers, the projector) are taken under one upstream gradient, a
# seeded normal draw at the head's input (the hidden states it reads), so
# that the random-init 24-block head is out of their loop; each must reach
# a cosine of VLM_GRAD_COSINE with the plain path's. On an H100 they read
# 0.9969-0.9989; with the kernel path's attention backward missing the
# softmax's rowsum(dp * p) term (tests/torch_faults.py) the lowest read
# 0.40, with it missing the GQA sum 0.59, and the check failed. The
# head's own gradients pass through no kernel (its attention is plain, its
# matmuls float); they see the kernels only through the head's input, and
# in bf16 they are dominated by rounding: on an H100 the plain path
# against itself with its pixels scaled by 1 + 2^-8 (one bf16 ulp) read a
# cosine of 0.23 for block 0's q_proj. They are held only to that spread:
# the plain path's own cosine under the perturbation, less
# HEAD_GRAD_COSINE_MARGIN.
TRAIN_LOSS_RTOL = 5e-3
VLM_GRAD_COSINE = 0.99
HEAD_GRAD_COSINE_MARGIN = 0.1
PIXEL_PERTURBATION = 1.0 + 2.0 ** -8


# the flagship finetune's main run: steps, and the float-base run's
TRAIN_STEPS = 8
MERGE_TRAIN_STEPS = 2


def train_config(seed: int):
    """The flagship recipe's TrainConfig at micro-batch 16, TRAIN_STEPS
    steps, a checkpoint every 5."""
    from vla_adapter_torch.core.experiments import get_experiment

    tcfg = get_experiment("vla-adapter+libero-spatial").to_train_config()
    return dataclasses.replace(
        tcfg, batch_size=16, save_freq=5, log_freq=100, seed=seed,
        optim=dataclasses.replace(tcfg.optim, max_steps=TRAIN_STEPS))


# the extended Qwen tokenizer's length (+256 action tokens): the token
# objective's bin inverse
TOKENIZER_LEN = 151921
HEAD_GRAD_NAMES = ("action_head.blocks.0.q_proj.weight",
                   "action_head.fc_in.weight")
VLM_GRAD_NAMES = (
    "language_model.layers.0.self_attn.q_proj.lora_a",
    "language_model.layers.0.self_attn.q_proj.lora_b",
    "language_model.layers.23.mlp.down_proj.lora_b",
    "projector.fc1.lora_b",
    *(f"vision_backbone.featurizer.blocks.{i}.mlp.fc1.lora_b"
      for i in (1, 11, 21)),
    *(f"vision_backbone.fused_featurizer.blocks.{i}.attn.v_proj.lora_b"
      for i in (1, 12, 25)))


def kernel_vs_plain_step(tcfg, init, batch, dev, head_names=HEAD_GRAD_NAMES,
                         vlm_names=VLM_GRAD_NAMES,
                         objective: str = "l1") -> dict:
    """The first step's loss and gradients through the kernels, through
    their plain versions, and through the plain versions with the input
    pixels scaled by ``PIXEL_PERTURBATION``, from the same weights
    (``init``) and noise: ``head_names`` from the loss, ``vlm_names``
    from one seeded upstream gradient at the head's input. Returns the
    losses, and each gradient's max |kernel - plain| over max |plain| and
    cosines kernel/plain and perturbed/plain (1 where both are zero: a
    lora_a's gradient at the first step, its lora_b being 0). Under the
    token objective (no head) ``vlm_names`` take their gradients from the
    token loss itself."""
    import torch

    from vla_adapter_torch.models.layers import prepare_ste_
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train import step as tstep
    from vla_adapter_torch.train.loop import build_runtime
    from vla_adapter_torch.train.partition import mark_trainable_

    grads, loss, upstream = {}, {}, None
    for path, kernels, scale in (("plain", "plain", 1.0),
                                 ("kernel", "kernel", 1.0),
                                 ("perturbed", "plain", PIXEL_PERTURBATION)):
        device_batch = tstep.to_device(batch, dev)
        device_batch["pixel_values"] = device_batch["pixel_values"] * scale
        m = VLAModel(tcfg.model, build_runtime(tcfg, kernels), device="meta")
        m.load_state_dict(init, strict=True, assign=True)
        mark_trainable_(m, tcfg.lora.enabled)
        prepare_ste_(m)
        params = dict(m.named_parameters())
        inputs = {k: device_batch[k] for k in tstep.MODEL_INPUTS
                  if k in device_batch}
        gen = tstep.noise_generator(tcfg.seed, 0, 0, dev)
        if objective == "token":
            out = m(**inputs, train=True, generator=gen, compute_logits=True,
                    compute_actions=False)
            lval = tstep.token_prediction_loss(
                out["logits"], device_batch["labels"],
                device_batch["text_valid"], TOKENIZER_LEN,
                tcfg.model.constants.action_dim)[0]
            hidden = None
            gs = torch.autograd.grad(lval, [params[n] for n in vlm_names])
        else:
            out = m(**inputs, train=True, generator=gen,
                    return_hidden_states=True)
            lval = tstep.l1_action_loss(out["actions"],
                                        device_batch["actions"])[0]
            hidden = out["hidden_states"]
            if upstream is None:
                upstream = torch.randn(hidden.shape, device=dev, generator=(
                    torch.Generator(device=dev).manual_seed(tcfg.seed)))
            gs = torch.autograd.grad(lval, [params[n] for n in head_names],
                                     retain_graph=True)
            gs += torch.autograd.grad((hidden.float() * upstream).sum(),
                                      [params[n] for n in vlm_names])
        loss[path] = lval.item()
        grads[path] = {n: g.float() for n, g in
                       zip(head_names + vlm_names, gs)}
        del m, params, out, lval, hidden, gs
        torch.cuda.empty_cache()

    def cosine(g, w):
        if not (g.any() or w.any()):
            return 1.0
        return float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))

    out = {"loss": loss, "head_grads": list(head_names),
           "vlm_grads": list(vlm_names), "grad_rel_err": {},
           "grad_cosine": {}, "grad_cosine_perturbed": {}}
    for n in head_names + vlm_names:
        g, w = grads["kernel"][n], grads["plain"][n]
        out["grad_rel_err"][n] = float((g - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        out["grad_cosine"][n] = cosine(g, w)
        out["grad_cosine_perturbed"][n] = cosine(grads["perturbed"][n], w)
    return out


def check_kernel_vs_plain(rec) -> None:
    loss = rec["loss"]
    if abs(loss["kernel"] - loss["plain"]) > TRAIN_LOSS_RTOL * abs(
            loss["plain"]):
        raise AssertionError(f"kernel vs plain loss: {loss}")
    cos = rec["grad_cosine"]
    for n in rec["vlm_grads"]:
        if not cos[n] >= VLM_GRAD_COSINE:
            raise AssertionError(f"kernel vs plain gradient of {n} under "
                                 f"the upstream at the head's input: "
                                 f"cosine {cos[n]} < {VLM_GRAD_COSINE}")
    for n in rec["head_grads"]:
        floor = rec["grad_cosine_perturbed"][n] - HEAD_GRAD_COSINE_MARGIN
        if not cos[n] >= floor:
            raise AssertionError(f"kernel vs plain gradient of {n}: cosine "
                                 f"{cos[n]} < {floor}")


# device time of one finetune step by kernel, in the groups PERF.md reads
TRAIN_PROFILE_GROUPS = (
    ("B1-bwd D", ("attn_bwd_rows_kernel<", ", true>")),
    ("B1-bwd dq", ("attn_bwd_rows_kernel<", ", false>")),
    ("B1-bwd dk/dv", ("attn_bwd_dkdv_kernel",)),
    ("B1", ("fused_attention_kernel",)),
    ("B4 pre-pass dx", ("w8a8_quantize", "<float")),
    ("B4 pre-pass forward", ("w8a8_quantize",)),
    ("B4 Hopper products", ("w8a8_hopper",)),
    ("B4 dx", ("w8a8_", "<float")),
    ("B4 forward", ("w8a8_",)),
    ("GEMMs (LoRA, head, float products)", ("gemm",)),
    ("GEMMs (LoRA, head, float products)", ("nvjet",)),
    ("GEMMs (LoRA, head, float products)", ("cutlass",)),
    ("optimizer", ("multi_tensor",)),
    ("collectives (NCCL)", ("nccl",)),
    ("elementwise and reductions", ("elementwise",)),
    ("elementwise and reductions", ("reduce",)),
)


class ProfiledStep:
    """An endless iterator over one batch that profiles one finetune step
    (torch.profiler, CUDA activity): started at the fetch of step
    ``step``'s batch and stopped at the next fetch, each after a device
    sync, so the window holds that step's device work. ``summary`` then
    holds the device ms by kernel group and the largest kernels. With
    ``host``, CPU activity too: the window's wall ms, the host ms inside
    FSDP2's ranges (``FSDP::*``, by range over the groups, each
    inclusive), inside the int8 base's gathers
    (``parallel.fsdp_int8.Int8Layer._gather``, timed around each call)
    and the ops of most host time of their own."""

    def __init__(self, batch, step: int, host: bool = False):
        self.batch, self.step, self.host = batch, step, host
        self.fetches, self.prof, self.summary = 0, None, None
        self.t0, self.gather_s, self.gathers = None, 0.0, 0

    def __iter__(self):
        return self

    def __next__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        fetch, self.fetches = self.fetches, self.fetches + 1
        if fetch == self.step:
            torch.cuda.synchronize()
            acts = [ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if self.host else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            if self.host:
                self._time_gathers(True)
            self.t0 = time.perf_counter()
        elif fetch == self.step + 1 and self.prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            if self.host:
                self._time_gathers(False)
            self.prof.__exit__(None, None, None)
            self.summary = self._summarize(wall)
        return self.batch

    def _time_gathers(self, on: bool) -> None:
        from vla_adapter_torch.parallel.fsdp_int8 import Int8Layer

        if not on:
            Int8Layer._gather = self._plain_gather
            return
        self._plain_gather = plain = Int8Layer._gather

        def timed(layer, kind):
            t0 = time.perf_counter()
            try:
                return plain(layer, kind)
            finally:
                self.gather_s += time.perf_counter() - t0
                self.gathers += 1

        Int8Layer._gather = timed

    def _summarize(self, wall: float):
        from torch.autograd import DeviceType

        by_name = collections.Counter()
        fsdp = collections.Counter()
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3
            elif e.name.startswith("FSDP::"):   # "FSDP::<range> (<fqn>)"
                fsdp[e.name.split(" ")[0]] += e.cpu_time_total / 1e3
        groups = collections.Counter()
        for name, ms in by_name.items():
            low = name.lower()
            group = next((g for g, keys in TRAIN_PROFILE_GROUPS
                          if all(k.lower() in low for k in keys)), "other")
            groups[group] += ms
        out = {"step_index": self.step, "wall_ms": 1e3 * wall,
               "device_busy_ms": sum(by_name.values()),
               "kernels": len(by_name), "by_group_ms": dict(groups),
               "top": [[n[:90], ms] for n, ms in by_name.most_common(15)]}
        if self.host:
            own = sorted(self.prof.key_averages(),
                         key=lambda a: -a.self_cpu_time_total)
            out.update(
                fsdp_host_ms=dict(fsdp.most_common()),
                int8_gather_host_ms=1e3 * self.gather_s,
                int8_gathers=self.gathers,
                top_host_self_ms=[[a.key[:60], a.self_cpu_time_total / 1e3,
                                   a.count] for a in own[:15]])
        return out


def _train_run(tcfg, batch, steps, root, data_iter=None, **kw):
    """finetune over one repeated batch (or ``data_iter``), launches
    counted around it."""
    import itertools

    import torch

    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.train.loop import finetune

    tcfg = dataclasses.replace(tcfg, run_root_dir=str(root))
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = finetune(tcfg, data_iter=data_iter or itertools.repeat(batch),
                     max_steps=steps, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    memory = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "resident_before_bytes": resident}
    return state, launches, wall, memory


def phase_train(cfg, card: str, seed: int, profile: bool = False):
    """The finetune path on the flagship (phase 11; see the module
    docstring); with ``profile``, the main run's third step under
    torch.profiler. Returns (record, launches of the main run, B1-bwd
    records)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import (
        find_resume_checkpoint,
        load_params,
    )
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.partition import mark_trainable_
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla
    from vla_adapter_torch.weights.merge import merge_checkpoint

    dev = "cuda"
    tcfg = train_config(seed)
    batch_size = tcfg.batch_size
    if tcfg.model != cfg:
        raise AssertionError("the recipe does not train VLAConfig()")
    batch = make_dummy_batch(cfg, batch_size, np.random.default_rng(seed))
    rec = {"card": card, "batch_size": batch_size, "seconds": {}}
    t_last = [time.perf_counter()]

    def lap(name):  # wall seconds of each step group of the phase
        now = time.perf_counter()
        rec["seconds"][name], t_last[0] = now - t_last[0], now

    # 1. B1-bwd against plain at the training shapes, and at the 7B
    # full-train recipe's LLM shape
    bwd_records = phase_attention_bwd(
        attention_bwd_shapes(cfg, batch_size, seed)
        + [seven_b_attention_shape(seed)[1]], card)
    # 2. the STE product
    lap("1 attention_bwd")
    rec["ste"] = phase_ste(ste_shapes(cfg, batch_size), card)
    lap("2 ste")

    root = Path(tempfile.mkdtemp(prefix="vla_train_"))
    try:
        # 3. the flagship finetune over the int8 base: the main path
        rt = build_runtime(tcfg)
        model = VLAModel(cfg, rt, device="meta")
        per_micro = expected_train_launches(model)
        init = initial_state(tcfg, rt, dev)
        trainable_names = set(mark_trainable_(model, tcfg.lora.enabled))
        profiled = ProfiledStep(batch, 2) if profile else None
        # every checkpoint kept: step 6's is resumed from in part 6
        kept = dataclasses.replace(tcfg, save_latest_checkpoint_only=False)
        with first_grad_squares() as main_grads:
            state, launches, wall, memory = _train_run(
                kept, batch, TRAIN_STEPS, root / "main", data_iter=profiled,
                rt=rt)
        if profiled is not None:
            if profiled.summary is None:
                raise AssertionError("the profiled finetune step never ran")
            rec["profile"] = dict(profiled.summary, card=card)
            print("train_profile " + json.dumps(rec["profile"]), flush=True)
        losses = [h["loss"] for h in state.history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"finetune losses {losses}")
        _check_train_launches(launches, per_micro, TRAIN_STEPS, "finetune")
        final = state.model.state_dict()
        changed = [k for k, v in init.items()
                   if k not in trainable_names and not torch.equal(final[k], v)]
        if changed:
            raise AssertionError(f"frozen tensors changed: {changed[:5]}")
        ste_bytes = sum(m.weight_qt.numel() for m in state.model.modules()
                        if getattr(m, "ste", False))
        step_s = statistics.median(h["step_time"] for h in state.history[2:])
        main = {"losses": losses, "median_s_per_step_from_3": step_s,
                "samples_per_s": batch_size / step_s, "wall_s": wall,
                **memory,
                "launches": launches, "launches_per_step_derived": per_micro,
                "trainable_tensors": len(trainable_names),
                "trainable_params": sum(init[k].numel()
                                        for k in trainable_names),
                "transposed_int8_copy_bytes": ste_bytes,
                "frozen_unchanged": True}
        print("train_main " + json.dumps(dict(main, card=card)), flush=True)
        # phase 19's unperturbed one-process reference
        main["grad_norms"] = main_grads.norms()
        rec["main"] = main
        main_losses = losses
        del state, final
        torch.cuda.empty_cache()

        lap("3 finetune")

        # 3b. each trainable tensor's gradient against the plain path's
        # one-ulp spread: at step 0, a lora_a (zero there: its lora_b
        # starts at 0) at step 1 (phase 21's check, ``grads_vs_plain``)
        runs, starts = plain_spread(tcfg, batch, 2)
        later = kernel_updates_from(tcfg, batch, starts)
        del starts
        rec["grads_vs_plain"] = grads_vs_plain(
            {"losses": losses,
             "grad_norms_by_update": [main["grad_norms"], *later]}, runs)
        print("train_grads_vs_plain " + json.dumps(dict(
            rec["grads_vs_plain"], card=card)), flush=True)
        check_grads_vs_plain(rec["grads_vs_plain"], "finetune")
        del runs
        lap("3b grads_vs_plain")

        # 4. kernel against plain, one step's loss and named grads
        step4 = kernel_vs_plain_step(tcfg, init, batch, dev)
        print("train_kernel_vs_plain " + json.dumps(dict(step4, card=card)),
              flush=True)
        check_kernel_vs_plain(step4)
        rec["kernel_vs_plain"] = step4
        lap("4 kernel_vs_plain")

        # 5. accumulation: 2 micro-batches, bf16 carry and moments
        acfg = dataclasses.replace(
            tcfg, grad_accumulation_steps=2, accum_dtype="bfloat16",
            optim=dataclasses.replace(tcfg.optim, moments_dtype="bfloat16"))
        abatch = make_dummy_batch(cfg, batch_size,
                                  np.random.default_rng(seed), accum_steps=2)
        state, launches, wall, _ = _train_run(acfg, abatch, 1,
                                              root / "accum")
        alosses = [h["loss"] for h in state.history]
        if not np.isfinite(alosses).all():
            raise AssertionError(f"accumulation losses {alosses}")
        _check_train_launches(launches, per_micro, 2, "accumulation")
        mu = next(iter(state.opt_state["mu"].values()))
        if mu.dtype != torch.bfloat16:
            raise AssertionError(f"moments stored in {mu.dtype}")
        rec["accumulation"] = {"losses": alosses, "launches": launches,
                               "wall_s": wall}
        print("train_accumulation " + json.dumps(dict(rec["accumulation"],
                                                     card=card)), flush=True)
        del state
        shutil.rmtree(root / "accum")
        torch.cuda.empty_cache()

        lap("5 accumulation")

        # 6. resume: on to the end from the main run's step-6 checkpoint
        run_dir = root / "main" / tcfg.run_id
        shutil.rmtree(run_dir / f"step-{TRAIN_STEPS:06d}")
        ckpt = find_resume_checkpoint(run_dir)
        meta = json.loads((ckpt / "meta.json").read_text())
        state = _train_run(kept, batch, TRAIN_STEPS, root / "main",
                           resume=True)[0]
        steps = [h["step"] for h in state.history]
        rlosses = [h["loss"] for h in state.history]
        if meta != {"step": 6} or steps != list(range(6, TRAIN_STEPS)):
            raise AssertionError(f"resume: checkpoint {meta}, steps {steps}")
        if rlosses != main_losses[6:]:
            raise AssertionError(f"resumed losses {rlosses} != the unbroken "
                                 f"run's {main_losses[6:]}")
        rec["resume"] = {"checkpoint_meta": meta, "losses": rlosses,
                         "bitwise_equal_to_unbroken": True}
        print("train_resume " + json.dumps(dict(rec["resume"], card=card)),
              flush=True)
        del state
        shutil.rmtree(root / "main")
        torch.cuda.empty_cache()

        lap("6 resume")

        # 7. train -> merge -> export -> load_vla -> Predictor, float base
        fcfg = dataclasses.replace(tcfg, base_int8=False)
        state = _train_run(fcfg, batch, MERGE_TRAIN_STEPS, root / "float")[0]
        trained = {k: v.detach().clone() for k, v in
                   state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()
        ckpt = find_resume_checkpoint(root / "float" / fcfg.run_id)
        merged = load_params(merge_checkpoint(ckpt, root / "merged",
                                              fcfg.lora.scale, device=dev))
        srng = np.random.default_rng(seed)
        stats = {"libero_spatial": dataset_statistics(
            srng.uniform(-1, 1, size=(1000, 7)),
            proprio=srng.normal(size=(1000, 8)),
            action_mask=[True] * 6 + [False])}
        export_checkpoint_dir(merged, cfg, root / "export", norm_stats=stats)
        del merged
        tok = MockTokenizer()
        tokenize = lambda t: tok(t).input_ids  # noqa: E731
        served = load_vla(root / "export", tokenize=tokenize,
                          center_crop=False, device=dev)
        lora_rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                          lora_rank=fcfg.lora.rank,
                          lora_scale=fcfg.lora.scale)
        lora_pred = Predictor(cfg=cfg, params=trained, tokenize=tokenize,
                              norm_stats=stats, rt=lora_rt, center_crop=False,
                              device=dev, cuda_graph=False)
        rows = [served.preprocess(im, INSTRUCTION, p)
                for im, p in _requests(cfg, srng, 4)]
        got = served.normalized_actions(rows)
        want = lora_pred.normalized_actions(rows)
        diff = float(np.abs(got - want).max())
        if not (served.cuda_graph and np.isfinite(got).all()
                and got.shape == (4, cfg.constants.num_actions_chunk,
                                  cfg.constants.action_dim)
                and diff <= FLAGSHIP_ACTIONS_ATOL):
            raise AssertionError(f"merged model serves actions {diff} from "
                                 f"the trained LoRA model's")
        rec["merge_serve"] = {"max_abs_diff_normalized": diff,
                              "cuda_graph": served.cuda_graph}
        print("train_merge_serve " + json.dumps(dict(rec["merge_serve"],
                                                    card=card)), flush=True)
        del served, lora_pred, trained, init
        torch.cuda.empty_cache()
        lap("7 merge_serve")
        print("train_seconds " + json.dumps(rec["seconds"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec, rec["main"]["launches"], bwd_records


def attention_bwd_kernel_summary(records, launches):
    """B1-bwd's entry: per-call times and bounds of phase 11 summed over
    the calls of one micro-batch of 16 (24 LLM + 23 DINOv2 + 26 so400m
    calls, three kernel launches each), with each kernel's share."""
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_KERNELS,
        BWD_LAUNCHES_PER_CALL,
    )

    main = [r for r in records if r["calls_per_micro_batch"]]

    def total(key):
        return sum(r[key] * r["calls_per_micro_batch"] for r in main)

    ops = sum(r["flops"] * r["calls_per_micro_batch"] for r in main)
    nbytes = sum(r["bytes"] * r["calls_per_micro_batch"] for r in main)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return [{
        "name": BWD_KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/attention_bwd.cu",
        "replaces": "vla_adapter_tpu/ops/attention.py:100",
        "launches": launches.get(BWD_KERNEL_NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("sdpa_bwd_ms"),
        "split_ms": {kn: sum(r["split_ms"][kn] * r["calls_per_micro_batch"]
                             for r in main) for kn in BWD_KERNELS},
        "library_eager_ms": total("sdpa_bwd_eager_ms"),
        "per": f"sum over the {sum(r['calls_per_micro_batch'] for r in main)}"
               f" calls ({BWD_LAUNCHES_PER_CALL} kernel launches each) of one "
               "micro-batch of 16 (SDPA's backward on k and v expanded to "
               "every query head: its kernels' device time, and eager)",
    }]


def quantize_kernel_summary(ste_records, launches):
    """The kernels line's entry for B4's quantization pre-pass (the Hopper
    branch's, on float x): phase 11's per-call times and bounds, one call
    on x (forward, bf16) and one on dy * ws (dx, f32) at each finetune
    shape, summed; bit for bit with quantize_rows at each."""
    from vla_adapter_torch.ops import w8a8_matmul

    calls = [r[what]["prepass"] for r in ste_records
             for what in ("forward", "dx")]
    return [{
        "name": w8a8_matmul.QUANT_KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/w8a8_matmul.cu",
        "replaces": "vla_adapter_tpu/ops/pallas_matmul.py:140",
        "launches": launches.get(w8a8_matmul.QUANT_KERNEL_NAME, 0),
        "max_abs_err": 0.0,
        "ms": sum(c["ms"] for c in calls),
        "plain_ms": sum(c["plain_ms"] for c in calls),
        "bound_ms": sum(c["bound_ms"] for c in calls), "bound_by": "bytes",
        "library_ms": None,
        "per": f"sum of {len(calls)} calls, one at each of the "
               f"{len(ste_records)} finetune shapes' forward (bf16 x) and "
               "one at its dx (f32 dy * ws): kernel B4's "
               "per-row quantization (the JAX Dense's quantize_rows before "
               "B4), a launch of its own before the Hopper branch's "
               "product"}]


def build_flagship(seed: int):
    import torch

    from vla_adapter_torch.core.config import VLAConfig
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
    from vla_adapter_torch.models.layers import init_random_
    from vla_adapter_torch.models.vla import VLAModel

    cfg = VLAConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = init_random_(VLAModel(cfg, SERVING_RUNTIME, device="cuda"), gen)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    stats = {"libero_spatial": dataset_statistics(
        rng.uniform(-1, 1, size=(1000, 7)), proprio=rng.normal(size=(1000, 8)),
        action_mask=[True] * 6 + [False])}
    tok = MockTokenizer()
    predictor = Predictor(cfg=cfg, params=model.state_dict(),
                          tokenize=lambda t: tok(t).input_ids,
                          norm_stats=stats, center_crop=False, device="cuda")
    return cfg, predictor, n_params, rng


def phase_flagship(predictor, rng, card: str):
    import torch

    from vla_adapter_torch.ops import cuda_lib

    cfg = predictor.cfg
    size = cfg.vision.primary.image_size

    def request():
        images = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
                  for _ in range(cfg.vision.num_images)]
        return images, rng.normal(size=cfg.constants.proprio_dim)

    requests = [request() for _ in range(11)]
    batch = [request() for _ in range(4)]
    per_forward = (cfg.llm.num_layers
                   + cfg.vision.primary.resolved_feature_layer + 1
                   + cfg.vision.fused.resolved_feature_layer + 1)

    # --- the main path: launch counts around exactly these requests ---
    cuda_lib.reset_launches()
    chunk_s, outs = [], []
    for images, proprio in requests:
        t0 = time.perf_counter()
        outs.append(predictor.predict_action(images, INSTRUCTION, proprio))
        chunk_s.append(time.perf_counter() - t0)
    batch_s = []  # the first batch pays its one-time set-up (the capture)
    for _ in range(2):
        t0 = time.perf_counter()
        out_b = predictor.predict_action_batch(
            [im for im, _ in batch], [INSTRUCTION] * 4, [p for _, p in batch])
        batch_s.append(time.perf_counter() - t0)
    launches = dict(cuda_lib.LAUNCHES)
    forwards = len(requests) + 2

    for a in outs:
        if a.shape != (8, 7) or not np.isfinite(a).all():
            raise AssertionError(f"predict_action gave {a.shape}, finite="
                                 f"{np.isfinite(a).all()}")
    if out_b.shape != (4, 8, 7) or not np.isfinite(out_b).all():
        raise AssertionError(f"predict_action_batch gave {out_b.shape}")
    if launches.get("fused_attention", 0) != per_forward * forwards:
        raise AssertionError(f"attention launches {launches}, expected "
                             f"{per_forward} x {forwards} forwards")

    # --- the same rows with the attention forced to the plain version ---
    rows = [predictor.preprocess(im, INSTRUCTION, p) for im, p in batch]
    kernel_actions = predictor.normalized_actions(rows)
    plain = predictor.with_runtime(
        dataclasses.replace(predictor.rt, kernels="plain"))
    plain_actions = plain.normalized_actions(rows)
    if cuda_lib.LAUNCHES["fused_attention"] != launches["fused_attention"] \
            + per_forward:
        raise AssertionError("the plain runtime launched the kernel")
    diff = float(np.abs(kernel_actions - plain_actions).max())
    if not diff <= FLAGSHIP_ACTIONS_ATOL:
        raise AssertionError(f"flagship kernel vs plain attention: max abs "
                             f"diff of normalized actions {diff}")
    plain_s = []
    for images, proprio in requests[:4]:
        t0 = time.perf_counter()
        plain.predict_action(images, INSTRUCTION, proprio)
        plain_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()

    timed = chunk_s[1:]  # the first request pays one-time set-up
    rec = {"card": card, "requests_b1": len(requests),
           "b1_ms_median": 1e3 * statistics.median(timed),
           "b1_ms_min": 1e3 * min(timed), "b1_ms_max": 1e3 * max(timed),
           "b1_first_ms": 1e3 * chunk_s[0],
           "b4_first_ms": 1e3 * batch_s[0], "b4_ms": 1e3 * batch_s[1],
           "b4_ms_per_chunk": 1e3 * batch_s[1] / 4,
           "b1_plain_attention_ms_median": 1e3 * statistics.median(plain_s),
           "attention_launches": launches.get("fused_attention", 0),
           "forwards": forwards, "launches_per_forward": per_forward,
           "max_abs_diff_normalized_actions_kernel_vs_plain": diff,
           "max_abs_normalized_action": float(np.abs(kernel_actions).max()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("flagship " + json.dumps(rec), flush=True)
    return rec, launches


def profile_request(predictor, rows, label: str):
    """One forward of ``rows`` (forward, copy back, unnormalization; B =
    ``len(rows)``) under torch.profiler: the device's busy time (sum of kernel durations
    on the card) against the request's host wall time, and the kernels
    that take most of it. For a Predictor that serves through CUDA graphs
    also the device time of one bare replay of its graph (CUDA events);
    where the profiler sees no kernel inside the graph, that time stands
    for the busy time, and the line says so."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor.predict_action_rows(rows)  # builds, or captures the graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_action_rows(rows)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    rec = {"tier": label, "mode": "graph" if predictor.graphs else "eager",
           "batch": len(rows), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_kernels": len(kernels),
           "attention_kernel_ms": sum(v for k, v in by_name.items()
                                      if "fused_attention" in k),
           "w8a8_kernel_ms": {name: sum(v for k, v in by_name.items()
                                        if name in k)
                              for name in ("fused_mlp_kernel",
                                           "w8a8_wide_kernel",
                                           "w8a8_narrow_kernel",
                                           "megalayer_kernel")},
           "top": [[k, v] for k, v in by_name.most_common(10)]}
    if predictor.graphs:
        key = predictor.graph_key(len(rows), "proprio" in rows[0])
        graph = predictor.graphs.captures[key].graph
        rec["replay_event_ms"] = _event_ms(graph.replay, 5)
        if not kernels:
            rec["device_busy_ms"] = rec["replay_event_ms"]
            rec["note"] = ("the profiler saw no kernel inside the graph: "
                           "device_busy_ms is the CUDA-event time of a bare "
                           "replay")
    rec["device_idle_share"] = 1 - rec["device_busy_ms"] / wall_ms
    print("profile " + json.dumps(rec), flush=True)
    return rec


def kernel_summary(records, launches):
    """One entry per kernel: sums over the launches of one B=1 forward
    (24 Qwen2 + 23 DINOv2 + 26 so400m calls) of the per-call times and
    bounds measured in phase 2; max_abs_err is the worst over all shapes."""
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME

    fwd = [r for r in records if r["forward_batch"] == 1]

    def total(key):
        return sum(r[key] * r["launches_per_forward"] for r in fwd)

    ops = sum(r["flops"] * r["launches_per_forward"] for r in fwd)
    nbytes = sum(r["bytes"] * r["launches_per_forward"] for r in fwd)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/fused_attention.cu",
        "replaces": "vla_adapter_tpu/ops/pallas_attention.py:108",
        "launches": launches.get(KERNEL_NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("sdpa_ms"),
        "per": f"sum over the {sum(r['launches_per_forward'] for r in fwd)}"
               " launches of one B=1 serving forward",
    }]


def w8a8_shapes(cfg, tokenize, min_dim: int = 256, batches=(1, 4)):
    """Every w8a8 kernel call of one serving forward, for each of
    ``batches`` (B=1 and B=4 unless given), as
    dicts: kernel, shape name(s), forward batch, dims and launches per
    forward under the "fused" backend (for an MLP also ``dense_matmuls``,
    the w8a8 matmuls it becomes under "dense"), and at B=1 the decoder
    layer of the "mega" backend with its launches under "mega". Widths
    below ``min_dim`` (``Runtime.act_int8_min_dim``) take the weight-only
    upcast, as the models gate them; matmuls of one shape are merged.
    FiLM towers add two matmuls per block on each image's language vector;
    the original head's blocks keep three (q, o, ffn), their self stream's
    K/V being weight-only slices of the head's stacks, which (like the Pro
    head's four) run as two stacked launches per stream."""
    from vla_adapter_torch.data.transform import inference_ids
    from vla_adapter_torch.ops import fused_mlp, megalayer, w8a8_matmul

    _, _, text_valid = inference_ids(cfg, tokenize, INSTRUCTION)
    s_llm = len(text_valid) + cfg.num_patches
    mm_valid = np.concatenate([text_valid[:1], np.ones(cfg.num_patches,
                                                       np.int32),
                               text_valid[1:]])
    llm, head, consts = cfg.llm, cfg.head, cfg.constants
    d, hd = llm.hidden_size, llm.num_heads * llm.head_dim
    kv = llm.num_kv_heads * llm.head_dim
    towers = [("dinov2", cfg.vision.primary), ("so400m", cfg.vision.fused)]
    n_img = cfg.vision.num_images
    shapes = []
    for b in batches:
        mats = {}

        def mm(name, m, k, n, per):
            if min(k, n) >= min_dim:
                rec = mats.setdefault((b * m, k, n), {
                    "kernel": w8a8_matmul.KERNEL_NAME, "shape": [],
                    "forward_batch": b, "m": b * m, "k": k, "n": n,
                    "launches_per_forward": 0})
                rec["shape"].append(name)
                rec["launches_per_forward"] += per

        def mlp(name, m, k, f, dd, act, gated, per):
            if min(k, f, dd) >= min_dim:
                shapes.append({
                    "kernel": (fused_mlp.GATED_KERNEL_NAME if gated
                               else fused_mlp.KERNEL_NAME),
                    "shape": [name], "forward_batch": b, "m": b * m, "k": k,
                    "f": f, "d": dd, "act": act, "gated": gated,
                    "launches_per_forward": per,
                    "dense_matmuls": (3 if gated else 2) * per})

        n_llm = llm.num_layers
        if b == 1:  # "mega" serves batch 1 only
            shapes.append({
                "kernel": megalayer.KERNEL_NAME, "shape": ["qwen2_layer"],
                "forward_batch": 1, "m": s_llm, "k": d,
                "heads": llm.num_heads, "kv_heads": llm.num_kv_heads,
                "head_dim": llm.head_dim, "f": llm.intermediate_size,
                "key_valid": mm_valid.tolist(),
                "launches_per_forward": n_llm})
        mm("qwen2_q", s_llm, d, hd, n_llm)
        mm("qwen2_k_v", s_llm, d, kv, 2 * n_llm)
        mm("qwen2_o", s_llm, hd, d, n_llm)
        mlp("qwen2_mlp", s_llm, d, llm.intermediate_size, d, "silu", True,
            n_llm)
        for name, v in towers:
            if v is None:
                continue
            tokens = n_img * (v.num_patches + v.num_prefix_tokens)
            layers = v.resolved_feature_layer + 1
            mm(f"{name}_q_k_v_out", tokens, v.hidden_size, v.hidden_size,
               4 * layers)
            mlp(f"{name}_mlp", tokens, v.hidden_size, v.mlp_dim,
                v.hidden_size, v.mlp_activation, False, layers)
            if cfg.vision.use_film and v.film_llm_dim is not None:
                # film_scale and film_shift on each image's language vector
                mm(f"{name}_film", n_img, v.film_llm_dim, v.hidden_size,
                   2 * layers)
        e = cfg.vision.embed_dim
        if cfg.vision.fused is not None:  # FusedProjector
            mlp("projector_fc1_fc2", cfg.num_patches, e, 4 * e, d, "gelu",
                False, 1)
            mm("projector_fc3", cfg.num_patches, d, d, 1)
        else:
            mlp("projector_fc1_fc2", cfg.num_patches, e, d, d, "gelu",
                False, 1)
        if cfg.use_proprio:
            mm("proprio_fc1", 1, consts.proprio_dim, d, 1)
            mm("proprio_fc2", 1, d, d, 1)
        chunk, hh = consts.num_actions_chunk, head.hidden_dim
        mm("head_fc_in", chunk, consts.action_dim * d, hh, 1)
        if head.use_pro_version:
            mm("head_q_kself_vself_o_ffn", chunk, hh, hh,
               5 * head.num_blocks)
        else:  # the self stream's K/V: the stacks' slices, weight-only
            mm("head_q_o_ffn", chunk, hh, hh, 3 * head.num_blocks)
        mm("head_fc_out", chunk, hh, consts.action_dim, 1)
        shapes += list(mats.values())
        adapter = consts.num_action_query_tokens + int(cfg.use_proprio)
        for name, m in (("head_k_v_adapter", adapter),
                        ("head_k_v_task", cfg.num_patches)):
            if min(d, hh) >= min_dim:
                shapes.append({
                    "kernel": w8a8_matmul.STACKED_KERNEL_NAME, "shape": [name],
                    "forward_batch": b, "layers": head.num_blocks, "m": b * m,
                    "k": d, "n": hh, "launches_per_forward": 2})
    return shapes


def dense_shapes(shapes):
    """The w8a8 calls of ``shapes`` as the "dense" backend makes them: each
    fused MLP becomes its matmuls (fc1, and up where gated: K -> F; fc2:
    F -> D), merged with the matmuls of the same rows and dims; the stacked
    ones stay; the decoder-layer kernel ("mega" only) goes."""
    from vla_adapter_torch.ops import megalayer, w8a8_matmul

    out, mats = [], {}
    for sh in shapes:
        if sh["kernel"] == megalayer.KERNEL_NAME:
            continue
        if sh["kernel"] == w8a8_matmul.STACKED_KERNEL_NAME:
            out.append(sh)
            continue
        if "f" in sh:
            name = sh["shape"][0].removesuffix("_fc1_fc2")
            parts = [([f"{name}_fc1"], sh["k"], sh["f"]),
                     ([f"{name}_fc2"], sh["f"], sh["d"])]
            if sh["gated"]:
                parts.append(([f"{name}_up"], sh["k"], sh["f"]))
        else:
            parts = [(sh["shape"], sh["k"], sh["n"])]
        for names, k, n in parts:
            rec = mats.setdefault((sh["forward_batch"], sh["m"], k, n), {
                "kernel": w8a8_matmul.KERNEL_NAME, "shape": [],
                "forward_batch": sh["forward_batch"], "m": sh["m"], "k": k,
                "n": n, "launches_per_forward": 0})
            rec["shape"] += names
            rec["launches_per_forward"] += sh["launches_per_forward"]
    return list(mats.values()) + out


def expected_w8a8_launches(shapes, impl: str, batch: int = 1) -> dict:
    """Launches of each w8a8 kernel in one forward of ``batch`` under a
    backend; B4's quantization pre-pass with each B4/B5 call whose plan
    takes the Hopper branch (:func:`b4_call_launches`)."""
    from vla_adapter_torch.ops import fused_mlp, megalayer, w8a8_matmul

    counts = collections.Counter()

    def b4(m, k, n, per, name=w8a8_matmul.KERNEL_NAME, layers=1):
        for kernel, c in b4_call_launches(m, k, n, "bf16", name,
                                          layers).items():
            counts[kernel] += c * per

    for sh in shapes:
        if sh["forward_batch"] != batch:
            continue
        if sh["kernel"] == megalayer.KERNEL_NAME:
            if impl == "mega":  # one launch per layer, the o-proj inside
                counts[sh["kernel"]] += sh["launches_per_forward"]
                b4(sh["m"], sh["heads"] * sh["head_dim"], sh["k"],
                   -sh["launches_per_forward"])
        elif impl == "mega" and sh["kernel"] == fused_mlp.GATED_KERNEL_NAME:
            continue  # the Qwen2 MLP runs inside the layer kernel
        elif "f" in sh and impl == "dense":
            per = sh["launches_per_forward"]
            b4(sh["m"], sh["k"], sh["f"], per * (2 if sh["gated"] else 1))
            b4(sh["m"], sh["f"], sh["d"], per)
        elif sh["kernel"] == w8a8_matmul.STACKED_KERNEL_NAME:
            b4(sh["m"], sh["k"], sh["n"], sh["launches_per_forward"],
               sh["kernel"], sh["layers"])
        elif sh["kernel"] == w8a8_matmul.KERNEL_NAME:
            b4(sh["m"], sh["k"], sh["n"], sh["launches_per_forward"])
        else:
            counts[sh["kernel"]] += sh["launches_per_forward"]
    return {k: v for k, v in counts.items()
            if v or k != w8a8_matmul.QUANT_KERNEL_NAME}


def w8a8_bound(sh, xq_input: bool = False, x_bytes: int = 2):
    """(bound ms, bound_by, ops, bytes) of one call: int8 ops over the int8
    tensor-core peak against x, the int8 weights, scales, biases and the
    bf16 output, each counted once, over the HBM rate. A matmul reads x as
    bf16 (the entry with the quantization inside; ``x_bytes`` 4: f32), or
    with ``xq_input`` the int8 xq and its f32 row scales (the JAX B4/B5
    signature)."""
    m, k = sh["m"], sh["k"]
    if "f" in sh:
        f, d = sh["f"], sh["d"]
        ops = 2 * m * k * f * (2 if sh["gated"] else 1) + 2 * m * f * d
        nbytes = (2 * m * k + k * f * (2 if sh["gated"] else 1) + f * d
                  + 4 * (2 * f + d) + (0 if sh["gated"] else 4 * (f + d))
                  + 2 * m * d)
    else:
        n, layers = sh["n"], sh.get("layers", 1)
        ops = 2 * layers * m * k * n
        x_in = m * k + 4 * m if xq_input else x_bytes * m * k
        nbytes = layers * (x_in + n * k + 4 * n + 2 * m * n)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def megalayer_bound(sh):
    """(bound ms, bound_by, ops, bytes) of one call of the layer kernel.
    Operations: bf16 attention over the pairs of rows and valid keys this
    prompt has (4 H Dh per pair: q.k and p.v) at the bf16 peak, plus the
    int8 o-projection and gated MLP, 2 M (H Dh D + 3 D F), at the int8 peak,
    the two summed (both run on the tensor cores). Bytes: the int8 weights,
    their scales, the norm weight, x, q, k, v, the key validity and the
    output, each once."""
    m, d, f = sh["m"], sh["k"], sh["f"]  # k: the layer's width D
    hd, kvd = sh["heads"] * sh["head_dim"], sh["kv_heads"] * sh["head_dim"]
    pairs = m * int(sum(sh["key_valid"]))
    flops = 4 * hd * pairs
    int_ops = 2 * m * (hd * d + 3 * d * f)
    nbytes = (hd * d + 3 * d * f + 4 * (3 * d + 2 * f)
              + 2 * (2 * m * d + m * hd + 2 * m * kvd) + 4 * m)
    t_ops = flops / PEAK_BF16_FLOPS + int_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops + int_ops,
            nbytes)


def check_megalayer(got, want) -> dict:
    """The layer kernel against its plain version (bf16): the largest error
    as a share of its row's largest output, the rows with an output more
    than two bf16 ulps of its own size away, and whether both hold their
    bounds (MEGALAYER_ROW_ULPS, MEGALAYER_ROW_SHARE)."""
    import torch

    err = (got.float() - want.float()).abs()
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    beyond = (err > 2 * 2.0 ** -7 * want.float().abs()).any(dim=-1)
    rec = {"max_abs_err": float(err.max()),
           "max_err_over_row_max": float((err / row_max).max()),
           "rows_beyond_2ulp": int(beyond.sum()), "rows": int(got.shape[0])}
    rec["within_bound"] = bool(
        torch.isfinite(got.float()).all()
        and rec["max_err_over_row_max"] <= MEGALAYER_ROW_ULPS * 2.0 ** -7
        and rec["rows_beyond_2ulp"] <= MEGALAYER_ROW_SHARE * rec["rows"])
    return rec


def megalayer_record(sh, randn, weight):
    """The layer kernel at one shape against its plain version, timed, with
    the same layer through the "fused" backend's launches as a yardstick."""
    import torch

    from vla_adapter_torch.ops import megalayer
    from vla_adapter_torch.ops.attention_kernel import fused_attention
    from vla_adapter_torch.ops.fused_mlp import w8a8_gated_mlp
    from vla_adapter_torch.ops.w8a8_matmul import w8a8_linear

    m, d, f = sh["m"], sh["k"], sh["f"]  # k: the layer's width D
    h, hkv, dh = sh["heads"], sh["kv_heads"], sh["head_dim"]
    eps = 1e-6
    x = randn(m, d).bfloat16()
    # q, k, v as views of one projection's output, as the model hands them
    qkv = randn(m, (h + 2 * hkv) * dh).bfloat16()
    q = qkv[:, :h * dh].view(m, h, dh)
    k = qkv[:, h * dh:(h + hkv) * dh].view(m, hkv, dh)
    v = qkv[:, (h + hkv) * dh:].view(m, hkv, dh)
    valid = torch.tensor(sh["key_valid"], dtype=torch.int32, device=x.device)
    n2 = 1.0 + 0.2 * randn(d)
    (oq, os_), (gq, gs), (uq, us), (dq, ds) = (
        weight(d, h * dh), weight(f, d), weight(f, d), weight(d, f))
    args = (x, q, k, v, valid, n2, oq, os_, gq, gs, uq, us, dq, ds)

    def kernel():
        return megalayer.w8a8_qwen2_layer(*args, eps=eps)

    def plain():
        return megalayer.megalayer_reference(*args, eps=eps)

    def fused_chain():
        ctx = fused_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                              v.transpose(0, 1)[None], valid[None])
        xa = x + w8a8_linear(ctx[0].transpose(0, 1).reshape(m, h * dh), oq,
                             os_)
        xf = xa.float()
        h2 = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
              * n2).bfloat16()
        return xa + w8a8_gated_mlp(h2, gq, gs, uq, us, dq, ds)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    rec = dict(sh)
    del rec["key_valid"]
    rec.update(check_megalayer(got, want), valid_keys=int(valid.sum()),
               bitwise_equal=bool(torch.equal(got, want)))
    if not rec["within_bound"]:
        raise AssertionError(f"{sh['kernel']} vs plain: {rec}")
    bound, bound_by, ops, nbytes = megalayer_bound(sh)
    rec.update(ms=device_ms(kernel), plain_ms=device_ms(plain, reps=5),
               fused_chain_ms=device_ms(fused_chain), library_ms=None,
               bound_ms=bound, bound_by=bound_by, ops=ops, bytes=nbytes)
    return rec


def mlp_tolerance(want, h_max: float, w2, s2) -> tuple:
    """The fused MLP kernel against its plain version, bf16 output: every
    output within one int8 step of h through the down projection (the
    panel scale is at most h_max / 127, times the largest |w2| * s2) plus
    two bf16 ulps of the largest output, which covers an int8 rounding of h
    that flips where the card's expf/tanhf and PyTorch's land an ulp apart;
    and at most 2% of the rows (a flip moves its row only) differ by more
    than two bf16 ulps of an output. Returns (max abs err bound, row
    share)."""
    step = h_max / 127.0 * float((w2.float().abs() * s2[:, None]).max())
    return step + 2 * 2.0 ** -7 * float(want.float().abs().max()), 0.02


def _int_mm_ms(xq, w):
    """torch._int_mm (the int8 x int8 -> int32 product alone, no dequant)
    on the same operands, a loop over the layers of a stack; where it
    refuses M <= 16, on xq zero-padded to 24 rows. Returns (ms, padded)."""
    import torch

    m = xq.shape[-2]
    if m <= 16:
        xq = torch.cat([xq, xq.new_zeros(*xq.shape[:-2], 24 - m,
                                         xq.shape[-1])], dim=-2)
    if xq.dim() == 2:
        return device_ms(lambda: torch._int_mm(xq, w.t())), m <= 16
    return device_ms(lambda: [torch._int_mm(xq[i], w[i].t())
                              for i in range(xq.shape[0])]), m <= 16


def matmul_record(sh, randn, weight, timing=(20, 5)):
    """The w8a8 matmul at one shape: the entry the models call
    (``w8a8_linear``, float x, the quantization inside) and the xq entry
    (``w8a8_matmul``/``_stacked``) against their plain versions, bit for
    bit in both output dtypes; times of both, of the two-step chain
    (``quantize_rows`` then the xq entry), of the plain version, of the
    kernel with L2 flushed before each call, and of ``torch._int_mm``;
    ``timing``: (reps, rounds) of each :func:`device_ms`."""
    import torch

    from vla_adapter_torch.ops import w8a8_matmul as ops

    reps, rounds = timing
    m, k, n, layers = sh["m"], sh["k"], sh["n"], sh.get("layers")
    lead = () if layers is None else (layers,)
    x = randn(*lead, m, k).bfloat16()
    x[..., 3] *= 20.0                  # an outlier column
    x[..., min(1, m - 1), :] = 0.0     # an all-zero row: scale 1e-8 / 127
    w, ws = weight(n, k, layers)
    xq, rs = ops.quantize_rows(x)
    xq_entry = ops.w8a8_matmul if layers is None else ops.w8a8_matmul_stacked
    worst, exact = 0.0, True
    for out_dtype in (torch.bfloat16, torch.float32):
        want = ops.w8a8_linear_reference(x, w, ws, out_dtype=out_dtype)
        for got in (ops.w8a8_linear(x, w, ws, out_dtype=out_dtype),
                    xq_entry(xq, rs, w, ws, out_dtype=out_dtype)):
            torch.cuda.synchronize()
            worst = max(worst, float((got.float() - want.float())
                                     .abs().max()))
            exact = exact and torch.equal(got, want)
    rec = dict(sh, plan=ops.card_plan(m, n, k, layers or 1, torch.bfloat16,
                                       torch.bfloat16, x.device))
    rec.update(max_abs_err=worst, bitwise_equal=exact)
    if not exact:
        raise AssertionError(f"{sh['kernel']} {sh['shape']} B="
                             f"{sh['forward_batch']}: not bit-exact with "
                             f"its plain version: {rec}")

    def kernel():
        return ops.w8a8_linear(x, w, ws)

    def chain():
        return xq_entry(*ops.quantize_rows(x), w, ws)

    lib_ms, padded = _int_mm_ms(xq, w)
    bound, bound_by, ops_n, nbytes = w8a8_bound(sh)
    rec.update(ms=device_ms(kernel, reps, rounds),
               cold_ms=device_ms_cold(kernel, reps, rounds),
               xq_ms=device_ms(lambda: xq_entry(xq, rs, w, ws), reps, rounds),
               chain_ms=device_ms(chain, reps, rounds),
               plain_ms=device_ms(lambda: ops.w8a8_linear_reference(
                   x, w, ws), min(reps, 5), rounds),
               int_mm_ms=lib_ms, int_mm_padded_to_24_rows=padded,
               bound_ms=bound, bound_by=bound_by, ops=ops_n, bytes=nbytes,
               xq_bound_ms=w8a8_bound(sh, xq_input=True)[0])
    return rec


def phase_w8a8_kernels(shapes, timing=(20, 5)):
    """Each w8a8 kernel at each shape against its plain version, timed
    (the matmuls' :func:`device_ms` at ``timing``: reps, rounds)."""
    import torch

    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.ops import fused_mlp, megalayer
    from vla_adapter_torch.ops.w8a8_matmul import int_matmul, quantize_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def weight(n, k, layers=None):  # lecun-normal, quantized on the card
        lead = () if layers is None else (layers,)
        return quantize_weight(randn(*lead, n, k) / k ** 0.5)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for sh in shapes:
        if sh["kernel"] == megalayer.KERNEL_NAME:
            plan = megalayer.megalayer_plan(
                sh["m"], sh["k"], sh["heads"], sh["kv_heads"],
                sh["head_dim"], sh["f"], sms=sms)
            print(f"plan {sh['kernel']} {sh['shape']} B={sh['forward_batch']}"
                  f" " + json.dumps(plan), flush=True)
            rec = megalayer_record(sh, randn, weight)
            rec["plan"] = plan
            print("w8a8_shape " + json.dumps(rec), flush=True)
            records.append(rec)
            continue
        if "f" not in sh:
            rec = matmul_record(sh, randn, weight, timing)
            print("w8a8_shape " + json.dumps(rec), flush=True)
            records.append(rec)
            continue
        m, k = sh["m"], sh["k"]
        f, d, act = sh["f"], sh["d"], sh["act"]
        plan = fused_mlp.mlp_plan(m, k, f, d, gated=sh["gated"], sms=sms)
        print(f"plan {sh['kernel']} {sh['shape']} B={sh['forward_batch']} "
              + json.dumps(plan), flush=True)
        rec = dict(sh, plan=plan)
        x = randn(m, k).bfloat16()
        w1, s1 = weight(f, k)
        w2, s2 = weight(d, f)
        up = weight(f, k) if sh["gated"] else (None, None)
        b1 = None if sh["gated"] else 0.02 * randn(f)
        b2 = None if sh["gated"] else 0.02 * randn(d)
        if sh["gated"]:
            def kernel():
                return fused_mlp.w8a8_gated_mlp(x, w1, s1, *up, w2, s2,
                                                act=act)
        else:
            def kernel():
                return fused_mlp.w8a8_mlp(x, w1, s1, b1, w2, s2, b2,
                                          act=act)

        def plain():
            return fused_mlp.fused_mlp_reference(
                x, w1, s1, w2, s2, up_q=up[0], up_scale=up[1], b1=b1,
                b2=b2, act=act)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        xq, rs = quantize_rows(x)
        g = int_matmul(xq, w1).float() * rs * s1
        h = fused_mlp.kernel_activation(act)(g if b1 is None else g + b1)
        if sh["gated"]:
            h = h * (int_matmul(xq, up[0]).float() * rs * up[1])
        bound_err, row_share = mlp_tolerance(want, float(h.abs().max()),
                                             w2, s2)
        err = (got.float() - want.float()).abs()
        flipped = (err > 2 * 2.0 ** -7 * want.float().abs()).any(dim=-1)
        rec.update(max_abs_err=float(err.max()), err_bound=bound_err,
                   rows_beyond_2ulp=int(flipped.sum()), bitwise_equal=bool(
                       torch.equal(got, want)))
        if not (torch.isfinite(got.float()).all()
                and rec["max_abs_err"] <= bound_err
                and float(flipped.float().mean()) <= row_share):
            raise AssertionError(f"{sh['kernel']} {sh['shape']} B="
                                 f"{sh['forward_batch']}: {rec}")
        bound, bound_by, ops, nbytes = w8a8_bound(sh)
        rec.update(ms=device_ms(kernel), plain_ms=device_ms(plain, reps=5),
                   int_mm_ms=None, bound_ms=bound, bound_by=bound_by,
                   ops=ops, bytes=nbytes)
        print("w8a8_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def phase_quantizer(params):
    """The on-card weight quantizer (what ``Predictor(int8=...)`` runs)
    against the numpy ``quantize_kernel`` on flagship weights, bit for
    bit."""
    from vla_adapter_torch.models.quantize import quantize_kernel

    names = ["language_model.layers.0.mlp.gate_proj.weight",
             "language_model.layers.0.self_attn.q_proj.weight",
             "vision_backbone.featurizer.blocks.0.mlp.fc1.weight",
             "vision_backbone.fused_featurizer.blocks.0.mlp.fc2.weight",
             "projector.fc1.weight", "action_head.fc_in.weight",
             "action_head.k_task.kernel"]
    checked = []
    for name in names:
        w = params[name]
        # the port's Dense weight is (out, in); a BatchedDense kernel and
        # the numpy quantizer's input are (..., in, out)
        in_axis = -2 if name.endswith(".kernel") else -1
        q, s = quantize_kernel(w, in_axis=in_axis)
        host = w.float().cpu().numpy()
        if in_axis == -1:
            host = np.swapaxes(host, -1, -2)
        want_q, want_s = numpy_quantize_kernel(host)
        got_q = q.cpu().numpy()
        if in_axis == -1:
            got_q = np.swapaxes(got_q, -1, -2)
        if not (np.array_equal(got_q, want_q) and np.array_equal(
                s.cpu().numpy().view(np.int32), want_s.view(np.int32))):
            raise AssertionError(f"on-card quantizer differs from numpy on "
                                 f"{name}")
        checked.append([name, list(w.shape)])
    print("quantizer " + json.dumps({"bit_exact": checked}), flush=True)
    return checked


def _requests(cfg, rng, n):
    size = cfg.vision.primary.image_size
    return [([rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
              for _ in range(cfg.vision.num_images)],
             rng.normal(size=cfg.constants.proprio_dim)) for _ in range(n)]


def _serve(pred, requests, batch):
    """B=1 requests one by one, then the batch twice unless ``batch`` is
    empty (the first pays the B=4 key's one-time set-up): (per-request
    seconds, the second batch's seconds or None), the outputs checked."""
    chunk_s = []
    for images, proprio in requests:
        t0 = time.perf_counter()
        out = pred.predict_action(images, INSTRUCTION, proprio)
        chunk_s.append(time.perf_counter() - t0)
        if out.shape != (8, 7) or not np.isfinite(out).all():
            raise AssertionError(f"predict_action gave {out.shape}, finite="
                                 f"{np.isfinite(out).all()}")
    if not batch:
        return chunk_s, None
    for _ in range(2):
        t0 = time.perf_counter()
        out_b = pred.predict_action_batch([im for im, _ in batch],
                                          [INSTRUCTION] * len(batch),
                                          [p for _, p in batch])
        batch_s = time.perf_counter() - t0
    if out_b.shape != (len(batch), 8, 7) or not np.isfinite(out_b).all():
        raise AssertionError(f"predict_action_batch gave {out_b.shape}")
    return chunk_s, batch_s


def _latency(chunk_s, batch_s, n_batch):
    timed = chunk_s[1:]  # the first request pays one-time set-up
    rec = {"b1_ms_median": 1e3 * statistics.median(timed),
           "b1_ms_min": 1e3 * min(timed), "b1_ms_max": 1e3 * max(timed),
           "b1_first_ms": 1e3 * chunk_s[0]}
    if batch_s is not None:
        rec.update(b4_ms=1e3 * batch_s, b4_ms_per_chunk=1e3 * batch_s / n_batch)
    return rec


def _per_row_actions(pred, rows):
    """Normalized actions of each row served alone (B=1), stacked."""
    return np.concatenate([pred.normalized_actions([r]) for r in rows])


def phase_w8a8(bf16_pred, shapes, rng, card: str):
    """The w8a8 main path: Predictor(act_int8=True) over the bf16
    predictor's weights, quantized on the card; each backend driven at B=1
    (and, but for "mega", B=4) between a reset and a read of the launch
    counts."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import resolve_w8a8_impl
    from vla_adapter_torch.ops import attention_kernel, cuda_lib

    cfg = bf16_pred.cfg
    n_llm = cfg.llm.num_layers
    attn_per_forward = (n_llm
                        + cfg.vision.primary.resolved_feature_layer + 1
                        + cfg.vision.fused.resolved_feature_layer + 1)
    kernels = sorted({sh["kernel"] for sh in shapes})
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=False, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auto = Predictor(act_int8=True, **common)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    backends = {"fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
                "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
                "auto": auto,
                "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    requests, batch = _requests(cfg, rng, 6), _requests(cfg, rng, 4)
    rec = {"card": card, "quantize_on_card_s": quantize_s,
           "int8_bytes": sum(v.numel() for v in auto.params.values()
                             if v.dtype == torch.int8)}
    launches = collections.Counter()
    for name, pred in backends.items():
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        b1_only = name == "mega"
        chunk_s, batch_s = _serve(pred, requests, [] if b1_only else batch)
        counts = dict(cuda_lib.LAUNCHES)
        impls = [resolve_w8a8_impl(pred.w8a8_impl, 1)] * len(requests)
        sizes = [1] * len(requests)
        if not b1_only:
            impls += [resolve_w8a8_impl(pred.w8a8_impl, len(batch))] * 2
            sizes += [len(batch)] * 2
        want = collections.Counter()
        for impl, size in zip(impls, sizes):
            want.update(expected_w8a8_launches(shapes, impl, size))
            want[attention_kernel.KERNEL_NAME] += (
                attn_per_forward - (n_llm if impl == "mega" else 0))
        if {k: v for k, v in counts.items() if v} != \
                {k: v for k, v in want.items() if v}:
            raise AssertionError(f"w8a8 {name}: launches {counts}, expected "
                                 f"{dict(want)}")
        launches.update(counts)
        rec[name] = {"impl_b1": impls[0], "impl_b4": impls[-1],
                     **_latency(chunk_s, batch_s, len(batch)),
                     "launches": counts, "forwards": len(impls),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    for kernel in kernels:
        if not launches[kernel]:
            raise AssertionError(f"{kernel} was never launched on the w8a8 "
                                 f"main path")
    # "mega" refuses a batch before it runs anything
    before = dict(cuda_lib.LAUNCHES)
    try:
        backends["mega"].predict_action_batch(
            [im for im, _ in batch], [INSTRUCTION] * len(batch),
            [p for _, p in batch])
    except ValueError as err:
        rec["mega"]["b4_refused"] = str(err)
    else:
        raise AssertionError("w8a8 mega served a batch of 4")
    if dict(cuda_lib.LAUNCHES) != before:
        raise AssertionError("w8a8 mega launched kernels for a refused batch")

    # --- outside the counted runs: actions against plain and bf16 ---
    rows = [bf16_pred.preprocess(im, INSTRUCTION, p) for im, p in batch]
    a_bf16 = bf16_pred.normalized_actions(rows)

    def against_plain(name, act):
        pred = backends[name]
        a_kernel = act(pred, rows)
        plain = pred.with_runtime(dataclasses.replace(pred.rt,
                                                      kernels="plain"))
        before = dict(cuda_lib.LAUNCHES)
        a_plain = act(plain, rows)
        if any(cuda_lib.LAUNCHES[k] != before.get(k, 0) for k in kernels):
            raise AssertionError(f"the plain {name} runtime launched a w8a8 "
                                 f"kernel")
        return a_kernel, float(np.abs(a_kernel - a_plain).max())

    for name in ("fused", "dense"):
        a_kernel, vs_plain = against_plain(
            name, lambda pred, r: pred.normalized_actions(r))
        vs_bf16 = np.abs(a_kernel - a_bf16)
        rec[name].update(
            max_abs_diff_normalized_actions_kernel_vs_plain=vs_plain,
            max_abs_diff_vs_bf16=float(vs_bf16.max()),
            mean_abs_diff_vs_bf16=float(vs_bf16.mean()))
    # mega serves one row at a time: every comparison row by row at B=1
    a_mega, vs_plain = against_plain("mega", _per_row_actions)
    vs_bf16 = np.abs(a_mega - _per_row_actions(bf16_pred, rows))
    rec["mega"].update(
        max_abs_diff_normalized_actions_kernel_vs_plain=vs_plain,
        max_abs_diff_vs_bf16=float(vs_bf16.max()),
        mean_abs_diff_vs_bf16=float(vs_bf16.mean()),
        max_abs_diff_vs_fused=float(np.abs(
            a_mega - _per_row_actions(backends["fused"], rows)).max()))
    rec["max_abs_normalized_action_bf16"] = float(np.abs(a_bf16).max())
    del backends, auto

    # --- the weight-only tier, once ---
    torch.cuda.reset_peak_memory_stats()
    int8 = Predictor(int8=True, **common)
    cuda_lib.reset_launches()
    chunk_s, batch_s = _serve(int8, requests[:4], batch)
    if dict(cuda_lib.LAUNCHES) != {attention_kernel.KERNEL_NAME:
                                   attn_per_forward * 6}:
        raise AssertionError(f"int8: launches {dict(cuda_lib.LAUNCHES)}")
    vs_bf16 = np.abs(int8.normalized_actions(rows) - a_bf16)
    rec["int8"] = {**_latency(chunk_s, batch_s, len(batch)),
                   "max_abs_diff_vs_bf16": float(vs_bf16.max()),
                   "mean_abs_diff_vs_bf16": float(vs_bf16.mean()),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("flagship_w8a8 " + json.dumps(rec), flush=True)
    for name in ("fused", "dense", "mega", "int8"):
        if name != "int8" and not (
                rec[name]["max_abs_diff_normalized_actions_kernel_vs_plain"]
                <= W8A8_ACTIONS_ATOL):
            raise AssertionError(f"w8a8 {name}: kernel vs plain actions "
                                 f"differ beyond {W8A8_ACTIONS_ATOL}")
        if not rec[name]["max_abs_diff_vs_bf16"] <= QUANTIZED_VS_BF16_LIMIT:
            raise AssertionError(f"{name} vs bf16 actions differ beyond "
                                 f"{QUANTIZED_VS_BF16_LIMIT}")
    return rec, dict(launches)


def _spread(seconds) -> dict:
    ms = [1e3 * t for t in seconds]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "n": len(ms)}


def _counted(pred, rows):
    """Normalized actions of one forward over ``rows`` and the kernel
    launches of exactly that forward."""
    import torch

    from vla_adapter_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    out = pred.normalized_actions(rows)
    torch.cuda.synchronize()
    return out, {k: v for k, v in cuda_lib.LAUNCHES.items() if v}


def _in_turns(preds: dict, rows, rounds: int) -> dict:
    """Each Predictor serves ``rows`` once per round, the order rotated
    each round: {name: seconds per request}. Each is served once before,
    untimed (a graph is captured then)."""
    for pred in preds.values():
        pred.predict_action_rows(rows)
    names = list(preds)
    times = {name: [] for name in names}
    for i in range(rounds):
        shift = i % len(names)
        for name in names[shift:] + names[:shift]:
            t0 = time.perf_counter()
            preds[name].predict_action_rows(rows)
            times[name].append(time.perf_counter() - t0)
    return times


def phase_graph(bf16_pred, rng, card: str, profile: bool = False):
    """The forward as a CUDA graph (the default on the card) against the
    eager forward (``cuda_graph=False``) in every tier at full width:
    bf16, int8, w8a8 "fused", "dense" and "auto" at B=1 and B=4, "mega" at
    B=1. Over requests whose prompts (and prompt lengths) and images
    differ, the replayed normalized actions must equal the eager ones bit
    for bit, and the launches of each replayed request the eager ones.
    Records each key's warm-up and capture time and each pool's bytes, and
    times in turns on the same rows: eager against graph for every tier
    at B=1; bf16, int8, fused and dense at B=2 and B=4 under graphs."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor

    cfg = bf16_pred.cfg
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=False, device="cuda")
    auto = Predictor(act_int8=True, **common)
    tiers = {"bf16": bf16_pred.with_runtime(bf16_pred.rt),
             "int8": Predictor(int8=True, **common),
             "fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
             "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
             "auto": auto,
             "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    eager = {name: pred.with_runtime(pred.rt, cuda_graph=False)
             for name, pred in tiers.items()}
    rec = {"card": card, "tiers": {}}
    for name, pred in tiers.items():
        cell = {}
        for b in (1,) if name == "mega" else (1, 4):
            plens, launches = [], None
            for text in GRAPH_INSTRUCTIONS:
                rows = [pred.preprocess(im, text, p)
                        for im, p in _requests(cfg, rng, b)]
                want, want_n = _counted(eager[name], rows)
                got, got_n = _counted(pred, rows)
                if not (got.shape == (b, 8, 7) and np.isfinite(got).all()
                        and np.array_equal(got, want)):
                    raise AssertionError(
                        f"graph {name} B={b}: replayed actions differ from "
                        f"eager by {float(np.abs(got - want).max())}")
                if got_n != want_n:
                    raise AssertionError(f"graph {name} B={b}: launches "
                                         f"{got_n}, eager {want_n}")
                plens.append(int(rows[0]["plen"]))
                launches = got_n
            cell[f"b{b}"] = {"requests": len(GRAPH_INSTRUCTIONS),
                             "prompt_lens": plens, "bitwise_equal": True,
                             "launches_per_request": launches}
        cell.update(pred.graphs.stats())
        rec["tiers"][name] = cell
        print(f"graph {name} " + json.dumps(cell), flush=True)

    # --- in turns on the same rows ---
    rows1 = [bf16_pred.preprocess(im, INSTRUCTION, p)
             for im, p in _requests(cfg, rng, 1)]
    both = {f"{name} {mode}": (pred if mode == "graph" else eager[name])
            for name, pred in tiers.items() for mode in ("eager", "graph")}
    times = _in_turns(both, rows1, 4)
    rec["b1"] = {name: _spread(v) for name, v in times.items()}
    for name in tiers:
        rec["b1"][f"{name} graph"]["faster_than_eager_pairs"] = sum(
            g < e for g, e in zip(times[f"{name} graph"],
                                  times[f"{name} eager"]))
    for b, rounds in ((2, 3), (4, 3)):
        rows_b = [bf16_pred.preprocess(im, INSTRUCTION, p)
                  for im, p in _requests(cfg, rng, b)]
        times = _in_turns({name: tiers[name] for name in
                           ("bf16", "int8", "fused", "dense")}, rows_b, rounds)
        cell = {name: dict(_spread(v), chunks_per_s=b / statistics.median(v))
                for name, v in times.items()}
        cell["fused_faster_pairs"] = sum(
            f < d for f, d in zip(times["fused"], times["dense"]))
        rec[f"b{b}_graph"] = cell
    print("graph_crossover " + json.dumps(
        {k: rec[k] for k in ("b1", "b2_graph", "b4_graph")}), flush=True)

    if profile:
        rec["profiles"] = [profile_request(pred, rows1, name)
                           for name in tiers
                           for pred in (eager[name], tiers[name])]
        # rows_b: the B=4 rows timed in turns above
        rec["profiles"] += [profile_request(pred, rows_b, name)
                            for name in ("fused", "dense")
                            for pred in (eager[name], tiers[name])]
        for prof in rec["profiles"]:
            before = KERNELS_PER_REQUEST_BEFORE.get(f"w8a8 {prof['tier']}")
            if prof["mode"] == "eager" and prof["batch"] == 1 and before:
                prof["kernels_saved"] = before - prof["device_kernels"]
                if prof["kernels_saved"] < KERNELS_SAVED:
                    raise AssertionError(
                        f"{prof['tier']}: {prof['device_kernels']} kernels "
                        f"per B=1 request, not {KERNELS_SAVED} fewer than "
                        f"{before}")
    del tiers, eager, both, auto
    torch.cuda.empty_cache()
    return rec


def phase_checkpoint(bf16_pred, rng, card: str):
    """Checkpoint loading without JAX at full width: the flagship's bf16
    weights exported with the port's ``export_checkpoint_dir`` into a
    temporary directory, loaded back on the card with ``load_vla`` (bf16,
    and w8a8 "fused" quantized on the card). The loaded state dict must
    equal the source's and the loaded Predictors' actions the source
    Predictors', bit for bit; the loaded Predictors are driven between a
    reset and a read of the launch counts. The directory is deleted."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.ops import cuda_lib, fused_mlp, w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    cfg = bf16_pred.cfg
    src_fused = Predictor(cfg=cfg, params=bf16_pred.params,
                          tokenize=bf16_pred.tokenize,
                          norm_stats=bf16_pred.norm_stats, center_crop=False,
                          device="cuda", act_int8=True, w8a8_impl="fused")
    rows = [bf16_pred.preprocess(im, INSTRUCTION, p)
            for im, p in _requests(cfg, rng, 4)]
    tmp = Path(tempfile.mkdtemp(prefix="vla_ckpt_"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_checkpoint_dir(bf16_pred.params, cfg, tmp,
                              norm_stats=bf16_pred.norm_stats)
        export_s = time.perf_counter() - t0
        files = {f.name: f.stat().st_size for f in tmp.iterdir()}
        t0 = time.perf_counter()
        loaded = load_vla(tmp, tokenize=bf16_pred.tokenize, center_crop=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded_fused = load_vla(tmp, tokenize=bf16_pred.tokenize,
                                center_crop=False, act_int8=True,
                                w8a8_impl="fused")
        torch.cuda.synchronize()
        load_fused_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    if set(loaded.params) != set(bf16_pred.params):
        raise AssertionError("loaded state dict has other keys: "
                             f"{set(loaded.params) ^ set(bf16_pred.params)}")
    differ = [k for k, v in bf16_pred.params.items()
              if not (loaded.params[k].dtype == v.dtype
                      and torch.equal(loaded.params[k], v))]
    if differ:
        raise AssertionError(f"loaded weights differ: {differ[:5]}")

    # --- the loaded path: its launch counts around exactly these calls ---
    cuda_lib.reset_launches()
    got = {"bf16": (loaded.predict_action_rows(rows),
                    loaded.predict_action_rows(rows[:1])),
           "fused": (loaded_fused.predict_action_rows(rows),
                     loaded_fused.predict_action_rows(rows[:1]))}
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    for kernel in (KERNEL_NAME, w8a8_matmul.KERNEL_NAME,
                   w8a8_matmul.STACKED_KERNEL_NAME,
                   fused_mlp.GATED_KERNEL_NAME, fused_mlp.KERNEL_NAME):
        if not launches.get(kernel):
            raise AssertionError(f"{kernel} was never launched by the "
                                 f"loaded Predictors: {launches}")
    for name, src in (("bf16", bf16_pred), ("fused", src_fused)):
        want = (src.predict_action_rows(rows),
                src.predict_action_rows(rows[:1]))
        for g, w in zip(got[name], want):
            if not (np.isfinite(g).all() and np.array_equal(g, w)):
                raise AssertionError(f"loaded {name} actions differ from the "
                                     f"source's by {float(np.abs(g - w).max())}")
    rec = {"card": card, "export_s": export_s, "files": files,
           "checkpoint_bytes": sum(files.values()), "load_bf16_s": load_s,
           "load_w8a8_fused_s": load_fused_s, "state_dict_bitwise_equal": True,
           "actions_bitwise_equal": ["bf16", "fused"], "launches": launches}
    print("checkpoint " + json.dumps(rec), flush=True)
    del loaded, loaded_fused, src_fused
    torch.cuda.empty_cache()
    return rec


SERVER_CLIENTS = (1, 4, 16)
# the buckets that only the server runs: no earlier phase forwards them
SERVER_ONLY_BATCHES = (8, 16)
SERVER_WINDOW_S = 1.0
SERVER_WARMUP_S = 0.5
# (reps, rounds) of the server-only buckets' w8a8 timings (phase 3: 20, 5)
SERVER_TIMING = (5, 3)


def _server_request(cfg, seed):
    rng = np.random.default_rng(seed)
    size = cfg.vision.primary.image_size
    return ([rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
             for _ in range(cfg.vision.num_images)], INSTRUCTION,
            rng.normal(size=cfg.constants.proprio_dim).astype(np.float32))


def _check_served_exactly(pred, cfg, tier):
    """One request alone through the server equals ``predict_action`` on
    the same arrays; three requests that the batcher is made to coalesce
    (max_batch=3, a long max_wait_ms, sent in a known order) equal
    ``predict_action_rows`` on the same rows padded to the bucket of 4;
    both bit for bit."""
    import threading

    from vla_adapter_torch.serve.loadtest import post_act
    from vla_adapter_torch.serve.server import ActionServer

    server = ActionServer(pred, host="127.0.0.1", port=0, dynamic_batch=True,
                          max_batch=16, max_wait_ms=4.0)
    port = server.serve_background()
    try:
        req = _server_request(cfg, 900)
        got = post_act(f"http://127.0.0.1:{port}/act", *req, timeout=300)
    finally:
        server.shutdown()
    want = pred.predict_action(*req)
    if not (got.shape == (8, 7) and np.isfinite(got).all()
            and np.array_equal(got, want)):
        raise AssertionError(f"server {tier}: a single request differs from "
                             f"predict_action by "
                             f"{float(np.abs(got - want).max())}")
    server = ActionServer(pred, host="127.0.0.1", port=0, dynamic_batch=True,
                          max_batch=3, max_wait_ms=60_000.0)
    port = server.serve_background()
    reqs = [_server_request(cfg, 910 + i) for i in range(3)]
    out, errors = {}, []

    def call(i):
        try:
            out[i] = post_act(f"http://127.0.0.1:{port}/act", *reqs[i],
                              timeout=300)
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.5)  # enqueued in this order
        for t in threads:
            t.join(timeout=300)
        sizes = server.batcher.stats()["batch_sizes"]
    finally:
        server.shutdown()
    if errors or sizes != [3]:
        raise AssertionError(f"server {tier}: coalesced batch {sizes}, "
                             f"errors {errors}")
    rows = [pred.preprocess(*r) for r in reqs]
    want = pred.predict_action_rows(rows + rows[-1:])
    for i in range(3):
        if not np.array_equal(out[i], want[i]):
            raise AssertionError(
                f"server {tier}: coalesced row {i} differs from "
                f"predict_action_rows by {float(np.abs(out[i] - want[i]).max())}")
    return {"single_bitwise_equal": True, "coalesced_batch": sizes,
            "coalesced_bitwise_equal": True}


def _buckets_vs_plain(pred, cfg) -> dict:
    """The server-only buckets' forwards (their graphs replayed) against the
    all-plain path on the same center-cropped rows: the max abs diff of
    normalized actions per batch, within phase 5's bound (bf16) or phase
    6's (w8a8)."""
    plain = pred.with_runtime(dataclasses.replace(pred.rt, kernels="plain"),
                              cuda_graph=False)
    limit = W8A8_ACTIONS_ATOL if pred.act_int8 else FLAGSHIP_ACTIONS_ATOL
    out = {}
    for b in SERVER_ONLY_BATCHES:
        rows = [pred.preprocess(*_server_request(cfg, 930 + i))
                for i in range(b)]
        got = pred.normalized_actions(rows)
        if got.shape != (b, 8, 7) or not np.isfinite(got).all():
            raise AssertionError(f"B={b}: actions {got.shape}, finite="
                                 f"{np.isfinite(got).all()}")
        out[str(b)] = float(np.abs(got - plain.normalized_actions(rows)).max())
        if not out[str(b)] <= limit:
            raise AssertionError(f"B={b}: kernel vs plain actions differ by "
                                 f"{out[str(b)]} > {limit}")
    return {"max_abs_diff_normalized_actions_kernel_vs_plain": out,
            "limit": limit}


def _host_breakdown(pred, cfg, reps: int = 10) -> dict:
    """Median ms of what one B=1 request costs in the server process, part
    by part, outside the load: the JSON and base64 decoding of its payload,
    ``preprocess`` (prompt ids, the numpy center crop, proprio), and the
    forward on preprocessed rows with the copy back and unnormalization."""
    from vla_adapter_torch.serve.loadtest import act_payload
    from vla_adapter_torch.serve.server import decode_payload

    images, text, proprio = _server_request(cfg, 920)
    body = json.dumps(act_payload(images, text, proprio))
    row = pred.preprocess(images, text, proprio)

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    return {"payload_bytes": len(body),
            "decode_ms": median_ms(lambda: decode_payload(json.loads(body))),
            "preprocess_ms": median_ms(
                lambda: pred.preprocess(images, text, proprio)),
            "forward_ms": median_ms(lambda: pred.predict_action_rows([row]))}


def _load_line(server, tier, clients, workers, card):
    """run_load at ``clients`` closed-loop clients (in up to 4 spawned
    processes) against a running server: the JSON line of phase 9."""
    from vla_adapter_torch.serve.loadtest import run_load

    before = len(server.batcher.stats()["batch_sizes"])
    stats = run_load(f"http://127.0.0.1:{server.port}/act", clients,
                     SERVER_WINDOW_S, image_hw=224, proprio_dim=8,
                     instruction=INSTRUCTION, warmup_s=SERVER_WARMUP_S,
                     processes=min(clients, 4), action_shape=(8, 7))
    sizes = server.batcher.stats()["batch_sizes"][before:]
    rec = {"card": card, "tier": tier, "clients": clients,
           "preprocess_workers": workers,
           "requests_per_s": stats["requests_per_s"],
           "actions_per_s": 8 * stats["requests_per_s"],
           "latency_ms": stats["latency_ms"], "completed": stats["completed"],
           "errors": stats["errors"], "error_sample": stats["error_sample"],
           "window_s": stats["duration_s"],
           "batch_sizes": {str(k): v for k, v in sorted(
               collections.Counter(sizes).items())},
           "forwards": len(sizes)}
    graphs = server.predictor.graphs.stats()
    rec.update(graph_capture_s={k: v["capture_s"]
                                for k, v in graphs["keys"].items()},
               pool_bytes=graphs["pool_bytes"])
    print("server " + json.dumps(rec), flush=True)
    if rec["errors"] or not rec["completed"]:
        raise AssertionError(f"server {tier} at {clients} clients: "
                             f"{rec['errors']} errors, {rec['completed']} "
                             f"completed: {rec['error_sample']}")
    return rec


def phase_server(bf16_pred, card: str):
    """The /act server (path A): the port's ``ActionServer`` on 127.0.0.1
    with the dynamic batcher (max_batch=16, max_wait_ms=4), over the
    flagship in bf16 and in w8a8 "auto", with the reference's center crop
    (224 px images: no JPEG round-trip). Every bucket's graph (1, 2, 4, 8,
    16; "auto" serves 8 and 16 with "dense") is captured before the load.
    Then: one request alone and one coalesced batch, bit for bit against
    the Predictor; ``run_load`` at 1, 4 and 16 closed-loop clients for a
    fixed window each, every response a finite (8, 7) array, no error; a
    second server with ``preprocess_workers=4`` at 16 clients (bf16). The
    launch counts are read around the load of each tier. Before all this,
    the buckets only the server runs (``SERVER_ONLY_BATCHES``): B1 at their
    attention shapes, B4/B5 at the matmuls "auto" runs there ("dense"),
    each against its plain version, and each tier's forwards at those
    batches against the all-plain path (:func:`_buckets_vs_plain`)."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import resolve_w8a8_impl
    from vla_adapter_torch.ops import (
        attention_kernel,
        cuda_lib,
        fused_mlp,
        w8a8_matmul,
    )
    from vla_adapter_torch.serve.loadtest import prewarm
    from vla_adapter_torch.serve.server import ActionServer

    cfg = bf16_pred.cfg
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=True, device="cuda")
    rec = {"card": card, "tiers": {}}
    if any(resolve_w8a8_impl("auto", b) != "dense"
           for b in SERVER_ONLY_BATCHES):
        raise AssertionError("auto no longer serves the server-only buckets "
                             "with dense: check its kernels there")
    rec["attention_records"] = phase_kernel_vs_plain(attention_shapes(
        cfg, bf16_pred.tokenize, batches=SERVER_ONLY_BATCHES))
    rec["w8a8_records"] = phase_w8a8_kernels(dense_shapes(w8a8_shapes(
        cfg, bf16_pred.tokenize, batches=SERVER_ONLY_BATCHES)),
        timing=SERVER_TIMING)
    launches = collections.Counter()
    for tier in ("bf16", "auto"):
        pred = Predictor(act_int8=tier == "auto", **common)
        t0 = time.perf_counter()
        prewarm(pred, 16)
        warm_s = time.perf_counter() - t0
        cell = {"prewarm_s": warm_s, **_check_served_exactly(pred, cfg, tier),
                "buckets_vs_plain": _buckets_vs_plain(pred, cfg),
                "host": _host_breakdown(pred, cfg)}
        server = ActionServer(pred, host="127.0.0.1", port=0,
                              dynamic_batch=True, max_batch=16,
                              max_wait_ms=4.0)
        server.serve_background()
        try:
            cuda_lib.reset_launches()
            cell["load"] = [_load_line(server, tier, n, 0, card)
                            for n in SERVER_CLIENTS]
            counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        finally:
            server.shutdown()
        if tier == "bf16":  # the image pipeline in 4 worker processes
            server = ActionServer(pred, host="127.0.0.1", port=0,
                                  dynamic_batch=True, max_batch=16,
                                  max_wait_ms=4.0, preprocess_workers=4)
            server.serve_background()
            try:
                cell["pool"] = _load_line(server, tier, 16, 4, card)
            finally:
                server.shutdown()
        graphs = pred.graphs.stats()
        if len(graphs["keys"]) != 5:
            raise AssertionError(f"server {tier}: graph keys "
                                 f"{sorted(graphs['keys'])}")
        need = {attention_kernel.KERNEL_NAME}
        if pred.act_int8:
            need |= {w8a8_matmul.KERNEL_NAME, w8a8_matmul.STACKED_KERNEL_NAME,
                     fused_mlp.KERNEL_NAME, fused_mlp.GATED_KERNEL_NAME}
        if not all(counts.get(k) for k in need):
            raise AssertionError(f"server {tier}: launches {counts}, every "
                                 f"one of {sorted(need)} expected")
        cell.update(launches=counts, graphs=graphs)
        launches.update(counts)
        rec["tiers"][tier] = cell
        print(f"server_{tier} " + json.dumps(
            {k: v for k, v in cell.items() if k not in ("load", "pool")}),
            flush=True)
        del pred, server
        torch.cuda.empty_cache()
    return rec, dict(launches)


def original_film_config():
    """``VLAConfig()`` with the original head (``use_pro_version=False``)
    and FiLM on both towers, conditioned on the LLM's 896-wide prompt
    embedding: full width, full depth."""
    from vla_adapter_torch.core.config import VLAConfig

    cfg = VLAConfig()
    d = cfg.llm.hidden_size
    v = cfg.vision
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, use_pro_version=False),
        vision=dataclasses.replace(
            v, use_film=True,
            primary=dataclasses.replace(v.primary, film_llm_dim=d),
            fused=dataclasses.replace(v.fused, film_llm_dim=d)))


def phase_original_film(bf16_pred, rng, card: str, seed: int):
    """The original VLA-Adapter model (path B) at full width and depth:
    random bf16 weights from a seeded CUDA generator, served in every tier
    (bf16; int8; w8a8 "fused", "dense", "auto" at B=1 and B=4; "mega" at
    B=1). Per tier: the launch counts around its requests against those
    :func:`w8a8_shapes` derives; each replayed graph against its eager
    forward, bit for bit; the kernel path against the all-plain path;
    each quantized tier against bf16 (``forward_error_report``'s quantity,
    and the function itself on the card); B=1 latency under graphs in
    turns. The kernels at the new call sites (B4 at FiLM's projections, B5
    at the original head's shared stacks) against their plain versions.
    The checkpoint round trip without FiLM, and the exporter's refusal of
    FiLM."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
    from vla_adapter_torch.models.layers import (
        init_random_,
        resolve_w8a8_impl,
    )
    from vla_adapter_torch.models.quantize import forward_error_report
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import attention_kernel, cuda_lib, w8a8_matmul
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    cfg = original_film_config()
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    model = init_random_(VLAModel(cfg, SERVING_RUNTIME, device="cuda"), gen)
    params = model.state_dict()
    del model
    common = dict(cfg=cfg, params=params, tokenize=bf16_pred.tokenize,
                  norm_stats=bf16_pred.norm_stats, center_crop=False,
                  device="cuda")
    rec = {"card": card, "parameters": sum(v.numel() for v in params.values()),
           "film_parameters": sum(v.numel() for k, v in params.items()
                                  if ".film_" in k)}

    # --- the kernels at the new call sites ---
    shapes = w8a8_shapes(cfg, bf16_pred.tokenize)
    new_sites = [dict(sh, model="original_film") for sh in shapes
                 if any("film" in n for n in sh["shape"])
                 or sh["kernel"] == w8a8_matmul.STACKED_KERNEL_NAME]
    rec["kernel_records"] = phase_w8a8_kernels(new_sites)

    # --- every tier: launches, graph vs eager, kernel vs plain ---
    auto = Predictor(act_int8=True, **common)
    tiers = {"bf16": Predictor(**common), "int8": Predictor(int8=True,
                                                             **common),
             "fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
             "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
             "auto": auto,
             "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    n_llm = cfg.llm.num_layers
    attn_per_forward = (n_llm + cfg.vision.primary.resolved_feature_layer + 1
                        + cfg.vision.fused.resolved_feature_layer + 1)
    rows4 = [tiers["bf16"].preprocess(im, INSTRUCTION, p)
             for im, p in _requests(cfg, rng, 4)]
    a_bf16 = tiers["bf16"].normalized_actions(rows4)
    a_bf16_rows = _per_row_actions(tiers["bf16"], rows4)
    launches = collections.Counter()
    rec["tiers"] = {}
    for name, pred in tiers.items():
        eager = pred.with_runtime(pred.rt, cuda_graph=False)
        cell = {}
        cuda_lib.reset_launches()
        want = collections.Counter()
        for b in (1,) if name == "mega" else (1, 4):
            impl = (resolve_w8a8_impl(pred.w8a8_impl, b) if pred.act_int8
                    else None)
            for text in GRAPH_INSTRUCTIONS:
                rows = [pred.preprocess(im, text, p)
                        for im, p in _requests(cfg, rng, b)]
                got = pred.normalized_actions(rows)
                with cuda_lib.recording():  # the yardstick's launches apart
                    ref = eager.normalized_actions(rows)
                if not (got.shape == (b, 8, 7) and np.isfinite(got).all()
                        and np.array_equal(got, ref)):
                    raise AssertionError(
                        f"original_film {name} B={b}: replayed actions "
                        f"differ from eager by {float(np.abs(got - ref).max())}")
                if impl is not None:
                    want.update(expected_w8a8_launches(shapes, impl, b))
                want[attention_kernel.KERNEL_NAME] += (
                    attn_per_forward - (n_llm if impl == "mega" else 0))
        counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        if counts != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"original_film {name}: launches {counts}, "
                                 f"expected {dict(want)}")
        launches.update(counts)
        cell["launches"] = counts
        cell["graphs"] = pred.graphs.stats()
        cell["graph_bitwise_equal"] = True
        # the kernel path against the all-plain path, and against bf16
        plain = pred.with_runtime(dataclasses.replace(pred.rt,
                                                      kernels="plain"),
                                  cuda_graph=False)
        act = (_per_row_actions if name == "mega"
               else (lambda p, r: p.normalized_actions(r)))
        a_kernel, a_plain = act(pred, rows4), act(plain, rows4)
        cell["max_abs_diff_kernel_vs_plain"] = float(
            np.abs(a_kernel - a_plain).max())
        bound = W8A8_ACTIONS_ATOL if pred.act_int8 else FLAGSHIP_ACTIONS_ATOL
        if not cell["max_abs_diff_kernel_vs_plain"] <= bound:
            raise AssertionError(f"original_film {name}: kernel vs plain "
                                 f"{cell['max_abs_diff_kernel_vs_plain']}")
        if name != "bf16":
            ref = a_bf16_rows if name == "mega" else a_bf16
            cell["max_abs_diff_vs_bf16"] = float(np.abs(a_kernel - ref).max())
            if not cell["max_abs_diff_vs_bf16"] <= QUANTIZED_VS_BF16_LIMIT:
                raise AssertionError(f"original_film {name} vs bf16: "
                                     f"{cell['max_abs_diff_vs_bf16']}")
        rec["tiers"][name] = cell
        print(f"original_film {name} " + json.dumps(cell), flush=True)
    for kernel in {sh["kernel"] for sh in shapes}:
        if not launches[kernel]:
            raise AssertionError(f"{kernel} never launched on the original "
                                 f"model's path")

    # --- forward_error_report on the card ---
    rec["forward_error_report"] = {
        tier: forward_error_report(cfg, params, act_int8=act, device="cuda")
        for tier, act in (("int8", False), ("w8a8", True))}
    for tier, rep in rec["forward_error_report"].items():
        if not rep["max_abs_action_diff"] <= QUANTIZED_VS_BF16_LIMIT:
            raise AssertionError(f"forward_error_report {tier}: {rep}")

    # --- B=1 under graphs, in turns ---
    rows1 = rows4[:1]
    times = _in_turns(tiers, rows1, 5)
    rec["b1_graph"] = {name: _spread(v) for name, v in times.items()}
    print("original_film_b1 " + json.dumps(rec["b1_graph"]), flush=True)
    del tiers, auto, eager, plain
    torch.cuda.empty_cache()

    # --- checkpoints: the original head without FiLM; FiLM refused ---
    cfg_plain = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, use_film=False,
        primary=dataclasses.replace(cfg.vision.primary, film_llm_dim=None),
        fused=dataclasses.replace(cfg.vision.fused, film_llm_dim=None)))
    state = {k: v for k, v in params.items() if ".film_" not in k}
    tmp = Path(tempfile.mkdtemp(prefix="vla_ckpt_"))
    try:
        try:
            export_checkpoint_dir(params, cfg, tmp / "film")
        except NotImplementedError as err:
            rec["film_export_refused"] = str(err)
        else:
            raise AssertionError("the exporter wrote a FiLM checkpoint")
        t0 = time.perf_counter()
        export_checkpoint_dir(state, cfg_plain, tmp / "ckpt",
                              norm_stats=bf16_pred.norm_stats)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_vla(tmp / "ckpt", tokenize=bf16_pred.tokenize,
                          center_crop=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    differ = [k for k, v in state.items()
              if not (loaded.params[k].dtype == v.dtype
                      and torch.equal(loaded.params[k], v))]
    if set(loaded.params) != set(state) or differ:
        raise AssertionError(f"original head checkpoint: weights differ: "
                             f"{differ[:5]}")
    src = Predictor(cfg=cfg_plain, params=state, tokenize=bf16_pred.tokenize,
                    norm_stats=bf16_pred.norm_stats, center_crop=False,
                    device="cuda")
    got, want = loaded.predict_action_rows(rows4), src.predict_action_rows(rows4)
    if not (np.isfinite(got).all() and np.array_equal(got, want)):
        raise AssertionError("original head checkpoint: actions differ by "
                             f"{float(np.abs(got - want).max())}")
    rec["checkpoint"] = {"export_s": export_s, "load_bf16_s": load_s,
                         "state_dict_bitwise_equal": True,
                         "actions_bitwise_equal": True}
    print("original_film_checkpoint " + json.dumps(
        {k: rec[k] for k in ("checkpoint", "film_export_refused",
                             "forward_error_report")}), flush=True)
    del loaded, src, params, state
    torch.cuda.empty_cache()
    return rec, dict(launches)


def w8a8_kernel_summary(records, launches):
    """The kernels line's entries for the four w8a8 kernels: per-call
    times and bounds of phase 3 summed over the launches of one B=1 forward
    under the "fused" backend; max_abs_err is the worst over all shapes."""
    sources = {"w8a8_matmul": ("w8a8_matmul.cu",
                               "vla_adapter_tpu/ops/pallas_matmul.py:140"),
               "w8a8_matmul_stacked": ("w8a8_matmul.cu",
                                       "vla_adapter_tpu/ops/pallas_matmul.py:77"),
               "w8a8_gated_mlp": ("fused_mlp_w8a8.cu",
                                  "vla_adapter_tpu/ops/pallas_fused_mlp.py:152"),
               "w8a8_mlp": ("fused_mlp_w8a8.cu",
                            "vla_adapter_tpu/ops/pallas_fused_mlp.py:182")}
    out = []
    for name, (source, replaces) in sources.items():
        mine = [r for r in records if r["kernel"] == name]
        fwd = [r for r in mine if r["forward_batch"] == 1]

        def total(key, rows=fwd):
            return sum(r[key] * r["launches_per_forward"] for r in rows)

        ops, nbytes = total("ops"), total("bytes")
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
        lib = [r for r in fwd if r.get("int_mm_ms") is not None]
        extra = ({key: total(key) for key in ("cold_ms", "xq_ms",
                                              "chain_ms")}
                 if fwd and "xq_ms" in fwd[0] else {})
        calls = sum(r["launches_per_forward"] for r in fwd)
        entry = {
            "name": name, "route": "cuda",
            "source": f"vla_adapter_torch/csrc/{source}",
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (total("int_mm_ms", lib)
                           if name == "w8a8_matmul" and lib else None),
            **extra,
            "per": f"sum over the {calls} launches of one B=1 forward "
                   "(fused backend)"}
        if entry["library_ms"] is not None:
            entry["library"] = (
                "torch._int_mm, the int8 product alone (no quantization, no "
                "dequant); at M <= 16, which it refuses, on x zero-padded "
                "to 24 rows")
        out.append(entry)
    return out


def megalayer_kernel_summary(records, launches):
    """The kernels line's entry for the layer kernel: its phase-3 per-call
    times and bound summed over the launches of one B=1 forward under the
    "mega" backend (one per decoder layer)."""
    from vla_adapter_torch.ops import megalayer

    (r,) = [r for r in records if r["kernel"] == megalayer.KERNEL_NAME]
    n = r["launches_per_forward"]
    return [{
        "name": megalayer.KERNEL_NAME, "route": "cuda",
        "source": f"vla_adapter_torch/csrc/{megalayer.SOURCE}",
        "replaces": "vla_adapter_tpu/ops/pallas_megalayer.py:178",
        "launches": launches.get(megalayer.KERNEL_NAME, 0),
        "max_abs_err": r["max_abs_err"], "ms": n * r["ms"],
        "plain_ms": n * r["plain_ms"], "bound_ms": n * r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "fused_chain_ms": n * r["fused_chain_ms"],
        "per": f"sum over the {n} launches of one B=1 forward (mega "
               "backend); fused_chain_ms: the same layers through the fused "
               "backend's launches"}]


# --- phases 12-15: the causal language path --------------------------------

DEVICE = "cuda"       # where phases 14-15 build their models
GEN_PROMPT = 128      # seeded prompt ids per sequence
GEN_NEW = 8           # generated tokens per sequence
GEN_BATCHES = (1, 4)
DECODE_ROWS = (1, 2, 4)  # B2/B4 checked bit for bit at these decode rows
# kernel path vs plain path, bf16 logits of the flagship's language model
# (seeded weights, |logit| < 4 there): the paths differ by B1's bf16
# rounding in the prefill's attention (a decode step runs no hand-written
# kernel in bf16), which 24 layers carry into the cache and the logits.
# The bound is 16 bf16 ulps at 2-4; an H100 read 0.043-0.062 (generation,
# both actions paths). A token may differ only where the plain path's
# top-2 margin is within twice it (each logit moves by at most the bound).
GEN_LOGITS_ATOL = 0.25
# the same under w8a8 "fused": B2/B4 equal their plain versions bit for
# bit, but a bf16 ulp of an activation from B1 can flip a per-token int8
# rounding downstream (as W8A8_ACTIONS_ATOL explains for the actions); an
# H100 read 0.10-0.15.
GEN_W8A8_LOGITS_ATOL = 0.5
PHI_PROMPT, PHI_NEW = 128, 8
PRETRAIN_BATCH, PRETRAIN_TEXT, PRETRAIN_STEPS = 8, 128, 3
TOKEN_TRAIN_STEPS = 4


def llm_pass_launches(model, attention: bool, rows: int = 1,
                      head_rows: int = 1) -> dict:
    """Kernel launches of one pass of a decoder (Qwen2Model or PhiModel)
    over ``rows`` tokens, derived from the model: B1 once per layer on a
    full-sequence pass (``attention``; a cached decode step attends in
    plain PyTorch), B2 once per Qwen2 MLP under the fused backend, B4 once
    per other Dense that runs w8a8 (both widths at least
    ``act_int8_min_dim``; Phi's untied lm_head included, on ``head_rows``
    rows: the last positions), with its quantization pre-pass where the
    call's plan takes the Hopper branch."""
    from vla_adapter_torch.models.layers import Dense
    from vla_adapter_torch.models.qwen2 import Qwen2MLP
    from vla_adapter_torch.ops import fused_mlp
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME

    rt = model.rt
    counts = collections.Counter()
    fused = set()
    for mod in model.modules():
        if isinstance(mod, Qwen2MLP) and rt.fused_mlp(*mod.dims):
            counts[fused_mlp.GATED_KERNEL_NAME] += 1
            fused |= {id(mod.gate_proj), id(mod.up_proj), id(mod.down_proj)}
    for name, mod in model.named_modules():
        if (isinstance(mod, Dense) and id(mod) not in fused
                and rt.act_int8 and rt.w8a8(mod.in_features, mod.features)):
            counts.update(b4_call_launches(
                head_rows if name == "lm_head" else rows, mod.in_features,
                mod.features))
    if attention:
        counts[KERNEL_NAME] += len(model.layers)
    return dict(counts)


def expected_generate_launches(model, new_tokens: int, batch: int = 1,
                               prompt: int = 1) -> dict:
    """One ``greedy_generate_cached`` call on ``batch`` sequences: the
    prefill's pass over ``prompt`` ids each and ``new_tokens`` decode steps
    of one row a sequence (the JAX package's loop runs every step)."""
    total = collections.Counter(llm_pass_launches(
        model, attention=True, rows=batch * prompt, head_rows=batch))
    for name, n in llm_pass_launches(model, attention=False, rows=batch,
                                     head_rows=batch).items():
        total[name] += new_tokens * n
    return dict(total)


def expected_pretrain_launches(model, trainable) -> dict:
    """One pretraining step of a PrismaticVLM (no remat): B1 once per
    attention layer; B1-bwd's kernels once per attention layer that the
    gradient passes through, which is every LLM layer when anything from
    the towers to the embedding or an earlier layer trains (so for every
    stage), and a tower's layers only when that tower trains."""
    from vla_adapter_torch.models.qwen2 import Qwen2Attention
    from vla_adapter_torch.models.vit import ViTAttention
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_LAUNCHES_PER_CALL,
        KERNEL_NAME,
    )

    trainable = set(trainable)
    attn = bwd = 0
    for name, mod in model.named_modules():
        if not isinstance(mod, (Qwen2Attention, ViTAttention)):
            continue
        attn += 1
        stack, kind, layer = name.rsplit(".", 3)[:3]
        earlier = tuple(f"{stack}.{kind}.{i}." for i in range(int(layer) + 1))
        if stack == "language_model":  # after the towers and the projector
            before = ("language_model.embed.", "vision_backbone.",
                      "projector.")
            upstream = any(t.startswith(before + earlier) for t in trainable)
        else:  # a tower: its own embeddings and blocks (pixels train nothing)
            upstream = any(t.startswith(earlier) or (
                t.startswith(stack + ".") and f".{kind}." not in t)
                for t in trainable)
        bwd += upstream
    return {KERNEL_NAME: attn, BWD_KERNEL_NAME: BWD_LAUNCHES_PER_CALL * bwd}


def decode_step_bound(model, batch: int, total: int):
    """(bound ms, bound_by) of one cached decode step: the bytes it must
    move (every weight at its storage width, the tied head reading the
    whole embedding table, the KV cache at the buffer's length read, the
    logits written) over the HBM rate, against its operations (2 per weight
    element and row, int8 ones at the int8 peak, the rest at the bf16 peak,
    plus 4 H Dh per cached key and row) over the peak."""
    import torch

    cfg = model.cfg
    elt = 2  # bf16 cache and logits
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = 2 * cfg.num_layers * batch * total * cfg.num_kv_heads * cfg.head_dim
    nbytes += kv * elt + batch * cfg.vocab_size * elt
    int8 = sum(p.numel() for p in model.parameters() if p.dtype == torch.int8)
    flt = sum(p.numel() for p in model.parameters()) - int8
    t_ops = (2 * batch * int8 / PEAK_INT8_OPS
             + (2 * batch * flt + 4 * batch * cfg.num_heads * cfg.head_dim
                * total * cfg.num_layers) / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def decode_shapes(cfg, rows=DECODE_ROWS):
    """The w8a8 kernels of one decode step of the flagship's language model
    under "fused" at each number of rows (the batch): B4 at q and o, B2
    at the MLP; k and v (896 -> 128) stay weight-only."""
    from vla_adapter_torch.ops import fused_mlp, w8a8_matmul

    llm = cfg.llm
    d, hd = llm.hidden_size, llm.num_heads * llm.head_dim
    shapes = []
    for m in rows:
        shapes.append({"kernel": w8a8_matmul.KERNEL_NAME,
                       "shape": ["decode_q", "decode_o"], "forward_batch": m,
                       "m": m, "k": d, "n": hd,
                       "launches_per_forward": 2 * llm.num_layers})
        shapes.append({"kernel": fused_mlp.GATED_KERNEL_NAME,
                       "shape": ["decode_mlp"], "forward_batch": m, "m": m,
                       "k": d, "f": llm.intermediate_size, "d": d,
                       "act": "silu", "gated": True,
                       "launches_per_forward": llm.num_layers,
                       "dense_matmuls": 3 * llm.num_layers})
    return shapes


def generation_models(predictor):
    """The flagship's language model over the bf16 Predictor's tensors, its
    w8a8 "fused" twin quantized on the card, their plain twins over the
    same tensors, and a "mega" model (which must refuse to decode)."""
    from vla_adapter_torch.models.qwen2 import Qwen2Model
    from vla_adapter_torch.models.quantize import quantize_state_dict

    cfg, dev, rt = predictor.cfg, predictor.device, predictor.rt
    sub = {k[len("language_model."):]: v for k, v in predictor.params.items()
           if k.startswith("language_model.")}

    def build(rt_, state):
        m = Qwen2Model(cfg.llm, rt_, device="meta")
        m.load_state_dict(state, strict=True, assign=True)
        return m.eval()

    rt8 = dataclasses.replace(rt, weights_int8=True, act_int8=True,
                              w8a8_impl="fused")
    q = quantize_state_dict(sub, Qwen2Model(cfg.llm, rt8, device="meta")
                            .state_dict(), dev)
    plain = dict(kernels="plain")
    return {
        "bf16": (build(rt, sub), build(dataclasses.replace(rt, **plain), sub)),
        "w8a8": (build(rt8, q), build(dataclasses.replace(rt8, **plain), q)),
        "mega": build(dataclasses.replace(rt8, w8a8_impl="mega"), q),
    }


def teacher_forced_logits(model, ids, prompt_len: int, steps: int):
    """The logits the cached loop sees at each of ``steps`` steps when the
    tokens it is fed are those of ``ids``: the prefill's last position,
    then one decode step per token. (B, steps, V)."""
    import torch

    from vla_adapter_torch.models.generate import prefill_state

    with torch.inference_mode():
        s = prefill_state(model, ids, prompt_len)
        out = [s["logits"].clone()]
        for i in range(steps - 1):
            pos = prompt_len + i
            logits, _ = model.decode_step(
                ids[:, pos:pos + 1], (s["k"], s["v"]),
                torch.full((1,), pos, dtype=torch.long, device=ids.device))
            out.append(logits)
    return torch.stack(out, dim=1)


def check_logits(got, want, tokens, atol: float, what: str) -> dict:
    """``got`` (the kernel path's logits, whose argmax gave ``tokens``)
    within ``atol`` of ``want``; the tokens equal ``want``'s argmax wherever
    its top-2 margin exceeds 2 ``atol``."""
    import torch

    diff = float((got.float() - want.float()).abs().max())
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    agree = want.float().argmax(-1) == tokens
    rec = {"max_abs_diff": diff, "atol": atol,
           "positions": int(clear.numel()),
           "positions_clear": int(clear.sum()),
           "tokens_differ": int((~agree).sum()),
           "tokens_differ_where_clear": int((clear & ~agree).sum()),
           "max_abs_logit": float(want.float().abs().max())}
    if not (torch.isfinite(got.float()).all() and diff <= atol
            and rec["tokens_differ_where_clear"] == 0):
        raise AssertionError(f"{what}: {rec}")
    return rec


# device time of a decode step by kernel, in the groups PERF.md reads
DECODE_PROFILE_GROUPS = (
    ("B2 (w8a8 MLP)", ("fused_mlp",)),
    ("B4 (w8a8 matmul)", ("w8a8_",)),
    ("GEMMs and GEMVs", ("gemm",)), ("GEMMs and GEMVs", ("gemv",)),
    ("GEMMs and GEMVs", ("nvjet",)), ("GEMMs and GEMVs", ("cutlass",)),
    ("softmax and reductions", ("softmax",)),
    ("softmax and reductions", ("reduce",)),
    ("cache writes and gathers", ("index",)),
    ("elementwise", ("elementwise",)),
)


def profile_decode(model, buf, prompt: int, steps: int = 8) -> dict:
    """``steps`` cached decode steps from one prefill under torch.profiler,
    eagerly and as graph replays: per step, the host wall ms, the device's
    busy ms (the sum of its kernels' durations), the kernels launched, the
    idle share, and the busy ms by kernel group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vla_adapter_torch.infer.graph import decode_graphs
    from vla_adapter_torch.models.generate import (
        decode_key,
        decode_step_fn,
        prefill_state,
    )
    from vla_adapter_torch.models.qwen2 import Qwen2Decode

    b, total = buf.shape
    step = decode_step_fn(Qwen2Decode(model), None, 0.0)
    graphs = decode_graphs(model, buf.device)
    key = decode_key(model, b, total, None, 0.0)
    out = {}
    for mode in ("eager", "graph"):
        with torch.inference_mode():
            state = prefill_state(model, buf, prompt)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if mode == "eager":
                    for _ in range(steps):
                        step(state)
                else:
                    graphs(key, step, state, steps)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / steps
        by_name = collections.Counter()
        count = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
                count += 1
        groups = collections.Counter()
        for name, ms in by_name.items():
            low = name.lower()
            group = next((g for g, keys in DECODE_PROFILE_GROUPS
                          if all(k in low for k in keys)), "other")
            groups[group] += ms
        busy = sum(by_name.values())
        out[mode] = {"wall_ms_per_step": wall, "device_busy_ms": busy,
                     "kernels_per_step": count / steps,
                     "idle_share": 1 - busy / wall,
                     "by_group_ms": dict(groups)}
    return out


def generate_run(model, plain, buf, prompt: int, new: int, atol: float,
                 what: str) -> tuple:
    """One batch of the generation path (phase 12, and phase 16 at 7B):
    ``greedy_generate_cached`` of ``new`` tokens after ``prompt`` ids of
    ``buf`` through the captured decode step, the main path, its launches
    read around exactly that call against
    :func:`expected_generate_launches`; the same call eagerly (the same
    tokens), and ``new`` graphed steps against as many eager steps from one
    prefill (every state tensor bit for bit); kernel vs plain and cached vs
    uncached logits, teacher-forced on the generated tokens, within
    ``atol`` (:func:`check_logits`); prefill and per-token ms against the
    step's bound, and a profiled window of steps. Returns (record,
    launches)."""
    import torch

    from vla_adapter_torch.infer.graph import decode_graphs
    from vla_adapter_torch.models.generate import (
        decode_key,
        decode_step_fn,
        greedy_generate_cached,
        prefill_state,
    )
    from vla_adapter_torch.models.qwen2 import Qwen2Decode
    from vla_adapter_torch.ops import cuda_lib

    b, total = buf.shape
    dev = buf.device
    what = f"{what} B={b}"
    run = {"batch": b}
    greedy_generate_cached(model, buf, prompt, new)  # capture
    torch.cuda.synchronize()
    # --- the main path: launches counted around exactly this call ---
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = greedy_generate_cached(model, buf, prompt, new)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    want = expected_generate_launches(model, new, b, prompt)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, derived {want}")
    # --- eager, and the graphed step against the eager step ---
    t0 = time.perf_counter()
    out_eager = greedy_generate_cached(model, buf, prompt, new,
                                       cuda_graph=False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if not torch.equal(out, out_eager):
        raise AssertionError(f"{what}: graphed and eager tokens differ")
    # the steps alone from one prefill, timed on the host clock (each ends
    # in a sync): eager, then as graph replays (3 rounds)
    step = decode_step_fn(Qwen2Decode(model), None, 0.0)
    graphs = decode_graphs(model, dev)
    key = decode_key(model, b, total, None, 0.0)
    steps_ms = {"eager": [], "graph": []}
    with torch.inference_mode():
        state = prefill_state(model, buf, prompt)
        ends = {}
        for mode in ("eager", "graph", "graph", "graph"):
            s = {k: v.clone() for k, v in state.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                for _ in range(new):
                    step(s)
            else:
                graphs(key, step, s, new)
            torch.cuda.synchronize()
            steps_ms[mode].append(1e3 * (time.perf_counter() - t0))
            ends[mode] = s
    per_step = llm_pass_launches(model, attention=False, rows=b,
                                 head_rows=b)
    if graphs.captures[key].launches != per_step:
        raise AssertionError(f"{what}: a decode step launches "
                             f"{graphs.captures[key].launches}, derived "
                             f"{per_step}")
    differ = [k for k in state
              if not torch.equal(ends["eager"][k], ends["graph"][k])]
    if differ:
        raise AssertionError(f"{what}: the graphed steps differ from eager "
                             f"in {differ}")

    def prefill():
        with torch.inference_mode():
            prefill_state(model, buf, prompt)

    prefill_ms = eager_ms(prefill, reps=5, rounds=3)
    # --- kernel vs plain, and cached vs uncached, teacher-forced ---
    tokens = out[:, prompt:]
    lk = teacher_forced_logits(model, out, prompt, new)
    if not torch.equal(lk.argmax(-1), tokens):
        raise AssertionError(f"{what}: the teacher-forced logits do not give "
                             "the generated tokens")
    lp = teacher_forced_logits(plain, out, prompt, new)
    run["kernel_vs_plain"] = check_logits(lk, lp, tokens, atol,
                                          f"{what} kernel vs plain")
    with torch.inference_mode():
        lu = model(input_ids=out[:, :total - 1],
                   valid=torch.ones((b, total - 1), dtype=torch.int32,
                                    device=dev),
                   causal=True, compute_logits=True)["logits"][
                       :, prompt - 1:]
    run["cached_vs_uncached"] = check_logits(lk, lu, tokens, atol,
                                             f"{what} cached vs uncached")
    bound, bound_by = decode_step_bound(model, b, total)
    run["profile"] = profile_decode(model, buf, prompt)
    run.update(
        launches=launches, prefill_ms=prefill_ms,
        graph_call_ms=1e3 * graph_s, eager_call_ms=1e3 * eager_s,
        steps_ms=steps_ms, token_ms_graphed=min(steps_ms["graph"]) / new,
        token_ms_eager=steps_ms["eager"][0] / new,
        tokens_per_s_graphed=b * new / graph_s,
        tokens_per_s_eager=b * new / eager_s,
        step_bound_ms=bound, step_bound_by=bound_by,
        graph=graphs.captures[key].launches)
    return run, launches


def phase_generate(predictor, card: str) -> tuple:
    """Phase 12: generation on the flagship's Qwen2.5-0.5B (module
    docstring). Returns (record, launches by path, kernel records)."""
    import torch

    from vla_adapter_torch.models.generate import greedy_generate_cached

    cfg, dev = predictor.cfg, predictor.device
    llm = cfg.llm
    total = GEN_PROMPT + GEN_NEW
    rec = {"card": card, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
           "runs": []}
    # the kernels at this path's new call sites
    ones = {b: np.ones((b, GEN_PROMPT), np.int32) for b in GEN_BATCHES}
    kernel_records = {"attention": phase_kernel_vs_plain([
        ("llm_prefill_causal", b, b, llm.num_heads, llm.num_kv_heads,
         GEN_PROMPT, llm.head_dim, ones[b], True, llm.num_layers)
        for b in GEN_BATCHES])}
    kernel_records["w8a8"] = phase_w8a8_kernels(decode_shapes(cfg))
    for r in kernel_records["w8a8"]:
        if not r["bitwise_equal"]:
            raise AssertionError(f"{r['kernel']} at decode M={r['m']}: not "
                                 f"bit for bit with its plain version: {r}")
    models = generation_models(predictor)
    try:
        greedy_generate_cached(models["mega"], torch.zeros(
            (1, 8), dtype=torch.long, device=dev), 4, 2)
        raise AssertionError("greedy_generate_cached under 'mega' ran")
    except NotImplementedError as err:
        rec["mega_refused"] = str(err)
    rng = np.random.default_rng(12)
    paths = {"generate": collections.Counter(),
             "generate_w8a8": collections.Counter()}
    for backend, path in (("bf16", "generate"), ("w8a8", "generate_w8a8")):
        model, plain = models[backend]
        atol = GEN_LOGITS_ATOL if backend == "bf16" else GEN_W8A8_LOGITS_ATOL
        for b in GEN_BATCHES:
            buf = np.zeros((b, total), np.int64)
            buf[:, :GEN_PROMPT] = rng.integers(0, 151643, (b, GEN_PROMPT))
            buf = torch.from_numpy(buf).to(dev)
            run, launches = generate_run(model, plain, buf, GEN_PROMPT,
                                         GEN_NEW, atol, f"generate {backend}")
            run = {"backend": backend, **run}
            paths[path].update(launches)
            print("generate " + json.dumps(run), flush=True)
            rec["runs"].append(run)
    del models
    torch.cuda.empty_cache()
    return rec, {k: dict(v) for k, v in paths.items()}, kernel_records


def phase_actions(predictor, card: str) -> tuple:
    """Phase 13: the discrete decode from the flagship VLA's logits (B=1
    and 4) and the autoregressive action path on a PrismaticVLM over the
    flagship's towers, projector and LLM (B=1, 7 tokens); each against the
    plain path. Returns (record, launches)."""
    import torch

    from vla_adapter_torch.data.action_tokenizer import (
        ActionTokenizer,
        qwen_extended_tokenizer_len,
    )
    from vla_adapter_torch.models.generate import (
        discrete_actions_from_logits,
        predict_action_autoregressive,
    )
    from vla_adapter_torch.models.vlm import PrismaticVLM
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME

    cfg, dev = predictor.cfg, predictor.device
    consts = cfg.constants
    tok_len = qwen_extended_tokenizer_len()
    per_forward = (cfg.llm.num_layers
                   + cfg.vision.primary.resolved_feature_layer + 1
                   + cfg.vision.fused.resolved_feature_layer + 1)
    plain_pred = predictor.with_runtime(
        dataclasses.replace(predictor.rt, kernels="plain"), cuda_graph=False)
    rng = np.random.default_rng(13)
    size = cfg.vision.primary.image_size

    def inputs(b):
        rows = [predictor.preprocess(
            [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
             for _ in range(cfg.vision.num_images)], INSTRUCTION,
            rng.normal(size=consts.proprio_dim)) for _ in range(b)]
        px = torch.from_numpy(np.stack([r["pixels"] for r in rows])).to(dev)
        px = ((px.float() / 255.0 - predictor._pix_mean)
              / predictor._pix_std).to(predictor.rt.dtype)
        return (torch.from_numpy(np.stack([r["ids"] for r in rows])).to(dev),
                torch.as_tensor([r["plen"] for r in rows], device=dev),
                torch.from_numpy(np.stack([r["valid"] for r in rows])).to(dev),
                px, torch.from_numpy(np.stack([r["proprio"] for r in rows]))
                .to(dev))

    rec = {"card": card, "discrete": [], "autoregressive": None}
    launches = collections.Counter()
    n = consts.num_actions_chunk * consts.action_dim
    for b in GEN_BATCHES:
        ids, plen, valid, px, proprio = inputs(b)
        cuda_lib.reset_launches()
        with torch.inference_mode():
            logits = predictor.model(ids, plen, valid, px, proprio,
                                     compute_logits=True,
                                     compute_actions=False)["logits"]
            acts = discrete_actions_from_logits(
                logits, plen, consts.num_actions_chunk, consts.action_dim,
                tok_len)
            torch.cuda.synchronize()
        got = dict(cuda_lib.LAUNCHES)
        if got.get(KERNEL_NAME, 0) != per_forward or len(got) != 1:
            raise AssertionError(f"discrete actions B={b}: launches {got}")
        launches.update(got)
        with torch.inference_mode():
            plain_logits = plain_pred.model(
                ids, plen, valid, px, proprio, compute_logits=True,
                compute_actions=False)["logits"]
        idx = (plen.long() - 1)[:, None] + torch.arange(n, device=dev)
        sel = idx[..., None].expand(-1, -1, logits.shape[-1])
        lk, lp = torch.gather(logits, 1, sel), torch.gather(plain_logits, 1,
                                                            sel)
        check = check_logits(lk, lp, lk.argmax(-1), GEN_LOGITS_ATOL,
                             f"discrete actions B={b} kernel vs plain")
        if acts.shape != (b, consts.num_actions_chunk, consts.action_dim) \
                or not torch.isfinite(acts).all() or acts.abs().max() > 1:
            raise AssertionError(f"discrete actions B={b}: {acts.shape}")
        rec["discrete"].append({"batch": b, "launches": got,
                                "kernel_vs_plain": check})
    # --- the autoregressive path on the plain VLM of the same weights ---
    def vlm_of(rt):
        vlm = PrismaticVLM(cfg, rt, device="meta")
        keys = vlm.state_dict().keys()
        vlm.load_state_dict({k: predictor.params[k] for k in keys},
                            strict=True, assign=True)
        return vlm.eval()

    vlm, vlm_plain = vlm_of(predictor.rt), vlm_of(plain_pred.rt)
    ids, plen, valid, px, _ = inputs(1)
    p = int(plen[0])
    ids = ids.clone()
    ids[:, p:] = 0
    valid = (torch.arange(ids.shape[1], device=dev) < p).to(
        torch.int32)[None]
    tokenizer = ActionTokenizer(tok_len)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    acts, toks = predict_action_autoregressive(
        vlm, ids, valid, px, plen, tokenizer, consts.action_dim,
        return_token_ids=True)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    got = dict(cuda_lib.LAUNCHES)
    if got != {KERNEL_NAME: per_forward * consts.action_dim}:
        raise AssertionError(f"autoregressive actions: launches {got}")
    launches.update(got)
    final = ids.clone()
    final[0, p:p + consts.action_dim] = torch.from_numpy(toks[0]).to(dev)
    fvalid = (torch.arange(ids.shape[1], device=dev)
              < p + consts.action_dim).to(torch.int32)[None]
    at = torch.arange(consts.action_dim, device=dev) + p - 1
    with torch.inference_mode():
        lk = vlm(final, fvalid, px)["logits"][:, at]
        lp = vlm_plain(final, fvalid, px)["logits"][:, at]
    tokens = torch.from_numpy(toks).to(dev)
    rec["autoregressive"] = {
        "tokens": toks.tolist(), "actions": acts.tolist(), "launches": got,
        "seconds": ar_s,
        "teacher_forced_vs_steps": check_logits(
            lk, lk, tokens, GEN_LOGITS_ATOL, "autoregressive: one forward "
            "over the final tokens against the steps"),
        "kernel_vs_plain": check_logits(lk, lp, tokens, GEN_LOGITS_ATOL,
                                        "autoregressive kernel vs plain")}
    if acts.shape != (1, consts.action_dim) or not np.isfinite(acts).all():
        raise AssertionError(f"autoregressive actions {acts.shape}")
    print("actions " + json.dumps(rec), flush=True)
    del vlm, vlm_plain, plain_pred
    torch.cuda.empty_cache()
    return rec, dict(launches)


def check_token_kernel_vs_plain(rec) -> None:
    """The token objective's first step, kernel vs plain: the loss within
    TRAIN_LOSS_RTOL; each VLM gradient (from the CE itself: there is no
    head) at a cosine of VLM_GRAD_COSINE with the plain path's, or, where
    bf16 rounding alone moves it further (the plain path's cosine with
    itself under a one-ulp pixel perturbation), within
    HEAD_GRAD_COSINE_MARGIN of that spread."""
    loss = rec["loss"]
    if abs(loss["kernel"] - loss["plain"]) > TRAIN_LOSS_RTOL * abs(
            loss["plain"]):
        raise AssertionError(f"token objective kernel vs plain loss: {loss}")
    for n in rec["vlm_grads"]:
        cos = rec["grad_cosine"][n]
        floor = min(VLM_GRAD_COSINE, rec["grad_cosine_perturbed"][n]
                    - HEAD_GRAD_COSINE_MARGIN)
        if not cos >= floor:
            raise AssertionError(f"token objective kernel vs plain gradient "
                                 f"of {n}: cosine {cos} < {floor}")


def token_batch(cfg, batch: int, seed: int):
    """A dummy batch with ``labels``, the action block's ids (the JAX
    package's tests/test_model_extras.py recipe; data/dummy.py makes no
    labels in either package)."""
    from vla_adapter_torch.data.dummy import make_dummy_batch

    out = make_dummy_batch(cfg, batch, np.random.default_rng(seed))
    labels = np.full_like(out["input_ids"], -100)
    q = cfg.constants.num_action_query_tokens
    for i in range(batch):
        p = out["prompt_len"][i]
        labels[i, p - 1:p + q] = out["input_ids"][i, p - 1:p + q]
    out["labels"] = labels
    return out


def phase_token_train(cfg, card: str, seed: int) -> tuple:
    """Phase 14a: the flagship recipe with ``objective="token"``: one step
    kernel vs plain, then TOKEN_TRAIN_STEPS steps through
    ``make_train_step`` with launches counted. Returns (record,
    launches)."""
    import torch

    from vla_adapter_torch.models.layers import prepare_ste_
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.train import step as tstep
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.optim import make_optimizer

    dev = DEVICE
    tcfg = dataclasses.replace(train_config(seed), objective="token")
    batch = token_batch(cfg, tcfg.batch_size, seed)
    rt = build_runtime(tcfg)
    init = initial_state(tcfg, rt, dev)
    rec = {"card": card, "batch_size": tcfg.batch_size}
    rec["kernel_vs_plain"] = kernel_vs_plain_step(
        tcfg, init, batch, dev, head_names=(), objective="token")
    print("token_train kernel_vs_plain " + json.dumps(rec["kernel_vs_plain"]),
          flush=True)
    check_token_kernel_vs_plain(rec["kernel_vs_plain"])
    model = VLAModel(cfg, rt, device="meta")
    model.load_state_dict(init, strict=True, assign=True)
    per_micro = expected_train_launches(model)
    tx = make_optimizer(tcfg.optim)
    state = tstep.init_train_state(model, tx, tcfg.lora.enabled)
    prepare_ste_(model)
    step = tstep.make_train_step(model, tx, tcfg)
    device_batch = tstep.to_device(batch, dev)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses, seconds = [], []
    for i in range(TOKEN_TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, device_batch, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    _check_train_launches(launches, per_micro, TOKEN_TRAIN_STEPS,
                          "token objective")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"token objective losses {losses}")
    rec.update(losses=losses, seconds=seconds,
               s_per_step=statistics.median(seconds[1:]),
               launches=launches, launches_per_step=per_micro,
               accuracy=float(m["curr_action_accuracy"]),
               peak_mem_gib=(torch.cuda.max_memory_allocated()
                             - resident) / 2**30)
    print("token_train " + json.dumps(rec), flush=True)
    del model, state, init
    torch.cuda.empty_cache()
    return rec, launches


def pretrain_batch(cfg, seed: int):
    """A seeded chat-style batch for the full-width VLM: texts of half to
    all of PRETRAIN_TEXT tokens, the loss on every token after the first,
    normalized pixels."""
    rng = np.random.default_rng(seed)
    b, t = PRETRAIN_BATCH, PRETRAIN_TEXT
    v = cfg.vision
    ids = rng.integers(0, 151643, (b, t)).astype(np.int32)
    valid = np.zeros((b, t), np.int32)
    labels = np.full((b, t), -100, np.int32)
    for i in range(b):
        n = int(rng.integers(t // 2, t))
        valid[i, :n] = 1
        labels[i, 1:n] = ids[i, 1:n]
    px = rng.normal(size=(b, v.num_images, v.primary.image_size,
                          v.primary.image_size, v.channels_per_image))
    return {"input_ids": ids, "text_valid": valid, "labels": labels,
            "pixel_values": px.astype(np.float32)}


def phase_pretrain(cfg, card: str, seed: int) -> tuple:
    """Phase 14b: ``pretrain`` of the full-width PrismaticVLM in the stages
    "align" and "last-layer-finetune" (PRETRAIN_STEPS steps each on one
    seeded batch): launches against :func:`expected_pretrain_launches`,
    which tensors moved, s/step, peak memory; B1-bwd at the causal LLM
    shape against its plain version. Returns (record, launches, B1-bwd
    records)."""
    import itertools

    import torch

    from vla_adapter_torch.models.layers import init_random_
    from vla_adapter_torch.models.vlm import PrismaticVLM
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.train import pretrain as tpretrain
    from vla_adapter_torch.train.stages import split_by_stage

    dev = DEVICE
    batch = pretrain_batch(cfg, seed)
    llm = cfg.llm
    mm_valid = np.concatenate([batch["text_valid"][:, :1],
                               np.ones((PRETRAIN_BATCH, cfg.num_patches),
                                       np.int32),
                               batch["text_valid"][:, 1:]], axis=1)
    bwd_records = phase_attention_bwd([
        ("pretrain_llm_causal", PRETRAIN_BATCH, llm.num_heads,
         llm.num_kv_heads, mm_valid.shape[1], llm.head_dim, mm_valid, True,
         llm.num_layers)], card)
    rec = {"card": card, "batch": PRETRAIN_BATCH, "steps": PRETRAIN_STEPS,
           "stages": {}}
    launches = collections.Counter()
    pcfg = tpretrain.PretrainConfig(
        model=dataclasses.replace(cfg, use_proprio=False), seed=seed,
        optim=tpretrain.OptimizerConfig(learning_rate=1e-3,
                                        max_steps=PRETRAIN_STEPS,
                                        num_steps_before_decay=1000))
    for stage, moving in (("align", ("projector.",)),
                          ("last-layer-finetune",
                           (f"language_model.layers.{llm.num_layers - 1}.",
                            "language_model.embed."))):
        cfg_s = dataclasses.replace(pcfg, stage=stage)
        model = init_random_(PrismaticVLM(cfg_s.model, device=dev),
                             torch.Generator(device=dev).manual_seed(seed))
        init = {k: v.clone() for k, v in model.state_dict().items()}
        trainable, _ = split_by_stage(init, stage)
        per_step = expected_pretrain_launches(model, trainable)
        del model
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, metrics = tpretrain.pretrain(
            cfg_s, itertools.repeat(batch), PRETRAIN_STEPS,
            init_params=init, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        _check_train_launches(got, per_step, PRETRAIN_STEPS,
                              f"pretrain {stage}")
        launches.update(got)
        moved = sorted(k for k in init if not torch.equal(init[k], params[k]))
        allowed = sorted(k for k in trainable if k.startswith(moving))
        # every weight matrix of the moving modules must move; a bias or a
        # norm may get an exactly zero gradient (softmax is blind to a key
        # bias), so of those only "at most the allowed ones"
        required = [k for k in allowed if k.endswith(".weight")
                    and "norm" not in k]
        if set(moved) - set(allowed) or set(required) - set(moved):
            raise AssertionError(
                f"pretrain {stage}: moved outside {moving}: "
                f"{sorted(set(moved) - set(allowed))[:8]}; did not move: "
                f"{sorted(set(required) - set(moved))[:8]}")
        if not np.isfinite(metrics["loss"]):
            raise AssertionError(f"pretrain {stage}: loss {metrics}")
        rec["stages"][stage] = {
            "launches": got, "launches_per_step": per_step,
            "tensors_moved": len(moved), "tensors_allowed": len(allowed),
            "trainable_tensors": len(trainable),
            "last_loss": metrics["loss"], "wall_s": wall,
            "s_per_step": wall / PRETRAIN_STEPS,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - resident)
            / 2**30}
        del params, init
        torch.cuda.empty_cache()
    print("pretrain " + json.dumps(rec), flush=True)
    return rec, dict(launches), bwd_records


def phi_b4_shapes(phi, rows: int):
    """B4's calls in one full-sequence pass of Phi-2 under w8a8 at ``rows``
    tokens (q, k, v, dense at 2560^2, fc1, fc2) and the untied lm_head on
    the last position's row."""
    from vla_adapter_torch.ops import w8a8_matmul

    d, f, layers = phi.hidden_size, phi.intermediate_size, phi.num_layers
    name = w8a8_matmul.KERNEL_NAME
    return [
        {"kernel": name, "shape": ["phi_q_k_v_dense"], "forward_batch": 1,
         "m": rows, "k": d, "n": d, "launches_per_forward": 4 * layers},
        {"kernel": name, "shape": ["phi_fc1"], "forward_batch": 1,
         "m": rows, "k": d, "n": f, "launches_per_forward": layers},
        {"kernel": name, "shape": ["phi_fc2"], "forward_batch": 1,
         "m": rows, "k": f, "n": d, "launches_per_forward": layers},
        {"kernel": name, "shape": ["phi_lm_head"], "forward_batch": 1,
         "m": 1, "k": d, "n": phi.vocab_size, "launches_per_forward": 1},
    ]


def phase_phi(card: str, seed: int) -> tuple:
    """Phase 15: Phi-2 at full width (module docstring). Returns (record,
    launches, kernel records)."""
    import torch

    from vla_adapter_torch.infer.predict import SERVING_RUNTIME
    from vla_adapter_torch.models.generate import greedy_generate
    from vla_adapter_torch.models.layers import (
        init_random_,
        resolve_w8a8_impl,
    )
    from vla_adapter_torch.models.phi import PhiModel
    from vla_adapter_torch.models.quantize import quantize_state_dict
    from vla_adapter_torch.models.registry import get_llm_backbone
    from vla_adapter_torch.ops import cuda_lib

    dev = torch.device(DEVICE)
    phi = get_llm_backbone("phi-2-3b")
    total = PHI_PROMPT + PHI_NEW
    kernel_records = {
        "attention": phase_kernel_vs_plain([
            ("phi_causal", 1, 1, phi.num_heads, phi.num_kv_heads, total,
             phi.head_dim, np.ones((1, total), np.int32), True,
             phi.num_layers)]),
        "w8a8": phase_w8a8_kernels(phi_b4_shapes(phi, total))}
    rt = SERVING_RUNTIME
    model = init_random_(PhiModel(phi, rt, device=dev),
                         torch.Generator(device=dev).manual_seed(seed)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    rt8 = dataclasses.replace(rt, weights_int8=True, act_int8=True,
                              w8a8_impl=resolve_w8a8_impl("auto", 1))

    def twin(rt_, state):
        m = PhiModel(phi, rt_, device="meta")
        m.load_state_dict(state, strict=True, assign=True)
        return m.eval()

    q = quantize_state_dict(model.state_dict(), PhiModel(
        phi, rt8, device="meta").state_dict(), dev)
    plain = dict(kernels="plain")
    models = {"bf16": (model, twin(dataclasses.replace(rt, **plain),
                                   model.state_dict())),
              "w8a8": (twin(rt8, q), twin(dataclasses.replace(rt8, **plain),
                                          q))}
    rng = np.random.default_rng(15)
    buf = np.zeros((1, total), np.int64)
    buf[0, :PHI_PROMPT] = rng.integers(0, 50256, PHI_PROMPT)
    buf = torch.from_numpy(buf).to(dev)
    plen = torch.full((1,), PHI_PROMPT, device=dev)
    rec = {"card": card, "parameters": n_params, "runs": {}}
    launches_all = collections.Counter()
    logits = {}
    for backend, (m, m_plain) in models.items():
        atol = GEN_LOGITS_ATOL if backend == "bf16" else GEN_W8A8_LOGITS_ATOL
        greedy_generate(m, buf, plen, 1)  # first use: builds, plans
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = greedy_generate(m, buf, plen, PHI_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        per = llm_pass_launches(m, attention=True, rows=PHI_PROMPT)
        want = {k: PHI_NEW * v for k, v in per.items()}
        if got != want:
            raise AssertionError(f"phi {backend}: launches {got}, derived "
                                 f"{want}")
        launches_all.update(got)
        ones = torch.ones((1, total - 1), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            lk = m(input_ids=out[:, :total - 1], valid=ones, causal=True,
                   compute_logits=True)["logits"][:, PHI_PROMPT - 1:]
            lp = m_plain(input_ids=out[:, :total - 1], valid=ones,
                         causal=True, compute_logits=True)["logits"][
                             :, PHI_PROMPT - 1:]
        tokens = out[:, PHI_PROMPT:]
        logits[backend] = lk
        rec["runs"][backend] = {
            "launches": got, "launches_per_step": per, "wall_s": wall,
            "ms_per_token": 1e3 * wall / PHI_NEW,
            "tokens": tokens[0].tolist(),
            "teacher_forced_vs_steps": check_logits(
                lk, lk, tokens, atol, f"phi {backend}: one forward over the"
                " final tokens against the steps"),
            "kernel_vs_plain": check_logits(lk, lp, tokens, atol,
                                            f"phi {backend} kernel vs plain")}
    rec["w8a8_vs_bf16_max_abs_logit_diff"] = float(
        (logits["w8a8"].float() - logits["bf16"].float()).abs().max())
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("phi " + json.dumps(rec), flush=True)
    del models, model, q, logits
    torch.cuda.empty_cache()
    return rec, dict(launches_all), kernel_records


# --- phase 16: the model zoo at 7B -------------------------------------------

# Llama-2 7B under the fused DINOv2 + SigLIP towers at 384 px, resize-naive
ZOO_GENERATE = "prism-dinosiglip+7b"
# Mistral 7B (GQA 32/8) under CLIP-L/14 at 336 px, letterbox
ZOO_PRETRAIN = "mistral-instruct-v0.1+7b"
ZOO_13B = "llama2-13b-pure"   # B2's widest MLP, checked as a kernel only
ZOO_TEXT = (64, 127)          # text ids per prompt, drawn in this range
ZOO_GEN_TEXT = 96             # the cached generation's uniform prompt
ZOO_NEW = 8                   # generated tokens per sequence
ZOO_BATCHES = (1, 4)
ZOO_PRETRAIN_BATCH, ZOO_PRETRAIN_STEPS = 8, 2
# the pretrain runs: each remat policy over the towers and the LLM, then
# no remat (last: where it does not fit, nothing runs after its failure)
ZOO_POLICIES = ("nothing", "attn_only", "dots", "dots_no_batch",
                "mlp_saved", None)
# a quantized twin's logits against bf16 on the same weights: within a
# quarter of the largest |logit| (QUANTIZED_VS_BF16_LIMIT's share of the
# action range, applied to the logit range)
ZOO_W8A8_VS_BF16_SHARE = 0.25
ZOO_WORDS = ("the", "robot", "picks", "up", "a", "red", "cup", "from",
             "table", "and", "places", "it", "in", "blue", "bowl", "near",
             "window", "what", "is", "on", "left", "of", "image", "describe")


def zoo_model(model_id: str):
    """(entry, VLAConfig) of a zoo model; one image per sample (the
    entry's image_sequence_len)."""
    from vla_adapter_torch.models.zoo import build_vlm_config, get_zoo_entry

    entry = get_zoo_entry(model_id)
    return entry, build_vlm_config(entry, max_text_tokens=ZOO_TEXT[1] + 1)


def zoo_prompts(entry, vocab: int, lengths, seed: int):
    """Prompts of exactly ``lengths`` ids through the entry's prompt
    builder (a seeded question of as many words as fill the length; the
    mock tokenizer gives one id per word, ids below ``vocab``): ids (B, T)
    int64 right-padded with 0 to the longest, and text_valid (B, T)."""
    from vla_adapter_torch.data.prompting import PROMPT_BUILDERS
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.models.registry import LLM_PROMPT_FAMILY

    builder = PROMPT_BUILDERS[LLM_PROMPT_FAMILY[entry.llm_backbone_id]]
    tok = MockTokenizer(max_prompt_id=vocab)
    rng = np.random.default_rng(seed)

    def ids_of(words):
        b = builder("prismatic")
        b.add_turn("human", "<image>\n" + " ".join(words))
        return tok(b.get_prompt()).input_ids

    base = len(ids_of(["x"])) - 1
    rows = [ids_of(list(rng.choice(ZOO_WORDS, size=n - base)))
            for n in lengths]
    if [len(r) for r in rows] != list(lengths):
        raise AssertionError(f"prompt lengths {[len(r) for r in rows]}, "
                             f"wanted {list(lengths)}")
    t = max(lengths)
    ids = np.zeros((len(rows), t), np.int64)
    valid = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        valid[i, :len(r)] = 1
    return ids, valid


def zoo_pixels(entry, cfg, batch: int, seed: int):
    """Seeded uint8 camera frames of other shapes than the towers' (wide,
    tall, 4:3) through ``ImageProcessor`` with the entry's resize strategy,
    normalized on the host: (B, 1, S, S, C) float32."""
    from vla_adapter_torch.data.image_processing import image_processor_for

    proc = dataclasses.replace(image_processor_for(cfg.vision),
                               resize_strategy=entry.image_resize_strategy)
    rng = np.random.default_rng(seed)
    shapes = ((480, 640, 3), (512, 288, 3), (360, 480, 3))
    return np.stack([proc(rng.integers(0, 256, size=shapes[i % 3],
                                       dtype=np.uint8))
                     for i in range(batch)])[:, None]


def vlm_pass_launches(vlm, batch: int, text: int) -> dict:
    """Kernel launches of one multimodal forward of a PrismaticVLM, derived
    from the model: B1 once per attention layer (towers and LLM); under the
    fused w8a8 backend B2 once per Qwen2 MLP and B3 once per ViT MLP and
    projector whose widths clear ``act_int8_min_dim``; B4 once per other
    Dense that runs w8a8, with its quantization pre-pass where the call's
    plan takes the Hopper branch (``batch`` prompts of ``text`` ids:
    :func:`train_rows`)."""
    from vla_adapter_torch.models.layers import Dense
    from vla_adapter_torch.models.projector import FusedProjector, Projector
    from vla_adapter_torch.models.qwen2 import Qwen2Attention, Qwen2MLP
    from vla_adapter_torch.models.vit import ViTAttention, ViTMLP
    from vla_adapter_torch.ops import fused_mlp, w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME

    rt = vlm.rt
    counts = collections.Counter()
    fused = set()
    for mod in vlm.modules():
        if isinstance(mod, (Qwen2Attention, ViTAttention)):
            counts[KERNEL_NAME] += 1
        dims = (mod.dims if isinstance(mod, (Qwen2MLP, Projector,
                                             FusedProjector))
                else (mod.cfg.hidden_size, mod.cfg.mlp_dim)
                if isinstance(mod, ViTMLP) else None)
        if dims is None or not rt.fused_mlp(*dims):
            continue
        gated = isinstance(mod, Qwen2MLP)
        counts[fused_mlp.GATED_KERNEL_NAME if gated
               else fused_mlp.KERNEL_NAME] += 1
        fused |= {id(m) for m in ((mod.gate_proj, mod.up_proj, mod.down_proj)
                                  if gated else (mod.fc1, mod.fc2))}
    rows = train_rows(vlm.cfg, batch, text)
    for name, mod in vlm.named_modules():
        if (isinstance(mod, Dense) and id(mod) not in fused
                and getattr(mod, "weight_q", None) is not None
                and rt.w8a8(mod.in_features, mod.features)):
            counts.update(b4_call_launches(rows[base_owner(name)],
                                           mod.in_features, mod.features))
    return dict(counts)


def zoo_vlms(cfg, seed: int, dev, w8a8: bool):
    """A seeded bf16 PrismaticVLM of ``cfg`` on the card, its plain twin
    over the same tensors, and (``w8a8``) its w8a8 "fused" twin quantized
    on the card with that twin's plain twin: {"bf16": (kernel, plain),
    "w8a8": (kernel, plain)}."""
    import torch

    from vla_adapter_torch.infer.predict import SERVING_RUNTIME
    from vla_adapter_torch.models.layers import init_random_
    from vla_adapter_torch.models.quantize import quantize_state_dict
    from vla_adapter_torch.models.vlm import PrismaticVLM

    rt = SERVING_RUNTIME
    vlm = init_random_(PrismaticVLM(cfg, rt, device=dev),
                       torch.Generator(device=dev).manual_seed(seed)).eval()

    def twin(rt_, state):
        m = PrismaticVLM(cfg, rt_, device="meta")
        m.load_state_dict(state, strict=True, assign=True)
        return m.eval()

    plain = dict(kernels="plain")
    out = {"bf16": (vlm, twin(dataclasses.replace(rt, **plain),
                              vlm.state_dict()))}
    if w8a8:
        rt8 = dataclasses.replace(rt, weights_int8=True, act_int8=True,
                                  w8a8_impl="fused")
        q = quantize_state_dict(vlm.state_dict(), PrismaticVLM(
            cfg, rt8, device="meta").state_dict(), dev)
        out["w8a8"] = (twin(rt8, q), twin(dataclasses.replace(rt8, **plain),
                                          q))
    return out


def zoo_logits(models, ids, valid, pixels, what: str) -> tuple:
    """Each backend's teacher-forced multimodal logits, kernel path against
    plain path at the text positions (:func:`check_logits`), launches of the
    kernel path's forward read around exactly it against
    :func:`vlm_pass_launches`; a w8a8 twin's logits against bf16 within
    ZOO_W8A8_VS_BF16_SHARE of the largest |logit|. Returns (record,
    launches)."""
    import torch

    from vla_adapter_torch.ops import cuda_lib

    dev = pixels.device
    rows = torch.from_numpy(valid).bool().to(dev)
    args = (torch.from_numpy(ids).to(dev), torch.from_numpy(valid).to(dev),
            pixels)
    rec, launches, logits = {}, collections.Counter(), {}
    for backend, (model, plain) in models.items():
        atol = GEN_LOGITS_ATOL if backend == "bf16" else GEN_W8A8_LOGITS_ATOL
        with torch.inference_mode():
            model(*args)  # first use: builds, plans
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            lk = model(*args)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            lp = plain(*args)["logits"]
        want = vlm_pass_launches(model, *ids.shape)
        if got != want:
            raise AssertionError(f"{what} {backend}: launches {got}, "
                                 f"derived {want}")
        launches.update(got)
        logits[backend] = lk[rows].float()
        rec[backend] = {
            "launches": got, "forward_ms": 1e3 * wall,
            "kernel_vs_plain": check_logits(
                lk[rows], lp[rows], lk[rows].argmax(-1), atol,
                f"{what} {backend} kernel vs plain")}
    if "w8a8" in logits:
        diff = float((logits["w8a8"] - logits["bf16"]).abs().max())
        limit = ZOO_W8A8_VS_BF16_SHARE * float(logits["bf16"].abs().max())
        agree = float((logits["w8a8"].argmax(-1)
                       == logits["bf16"].argmax(-1)).float().mean())
        rec["w8a8_vs_bf16"] = {"max_abs_diff": diff, "limit": limit,
                               "top1_agreement": agree}
        if not diff <= limit:
            raise AssertionError(f"{what}: w8a8 vs bf16 logits {diff} > "
                                 f"{limit}")
    return rec, dict(launches)


def zoo_kernel_shapes(gen_cfg, pre_cfg, llm13):
    """The kernels at this phase's call sites: B1 shapes (the tuples of
    :func:`phase_kernel_vs_plain`), B1-bwd's (of
    :func:`phase_attention_bwd`) and the w8a8 ones (dicts of
    :func:`phase_w8a8_kernels`)."""
    from vla_adapter_torch.ops import fused_mlp, w8a8_matmul

    attention, w8a8 = [], []
    llm_rows = {}
    for tag, cfg in (("llama2_7b", gen_cfg), ("mistral_7b", pre_cfg)):
        llm = cfg.llm
        s = cfg.vision.num_patches_per_image + ZOO_TEXT[1] + 1
        llm_rows[tag] = s
        for b in ZOO_BATCHES:
            valid = np.ones((b, s), np.int32)
            valid[0, s - 20:] = 0  # a shorter prompt's padding
            attention.append((f"{tag}_causal", b, b, llm.num_heads,
                              llm.num_kv_heads, s, llm.head_dim, valid,
                              True, llm.num_layers))
        for t in (cfg.vision.primary, cfg.vision.fused):
            if t is None:
                continue
            attention += [(t.name, b, b, t.num_heads, t.num_heads,
                           t.num_patches + t.num_prefix_tokens, t.head_dim,
                           None, False, t.resolved_feature_layer + 1)
                          for b in ZOO_BATCHES]
    llm = gen_cfg.llm
    attention += [("llama2_7b_prefill_causal", b, b, llm.num_heads,
                   llm.num_kv_heads, ZOO_GEN_TEXT, llm.head_dim,
                   np.ones((b, ZOO_GEN_TEXT), np.int32), True,
                   llm.num_layers) for b in ZOO_BATCHES]
    pre = pre_cfg.llm
    s = pre_cfg.vision.num_patches_per_image + ZOO_TEXT[1] + 1
    bwd_valid = np.ones((ZOO_PRETRAIN_BATCH, s), np.int32)
    bwd_valid[:, s - 30:] = 0
    bwd = [("mistral_7b_pretrain_causal", ZOO_PRETRAIN_BATCH, pre.num_heads,
            pre.num_kv_heads, s, pre.head_dim, bwd_valid, True,
            pre.num_layers)]
    for tag, llm_c, rows in (("llama2_7b", gen_cfg.llm, llm_rows["llama2_7b"]),
                             ("mistral_7b", pre, llm_rows["mistral_7b"]),
                             ("llama2_13b", llm13, llm_rows["llama2_7b"])):
        d, f, n = llm_c.hidden_size, llm_c.intermediate_size, llm_c.num_layers
        for m in (rows, 1, 2, 4) + ((4 * rows,) if tag == "llama2_7b"
                                    else ()):
            w8a8.append({"kernel": fused_mlp.GATED_KERNEL_NAME,
                         "shape": [f"{tag}_mlp"], "forward_batch": 1,
                         "m": m, "k": d, "f": f, "d": d, "act": "silu",
                         "gated": True, "launches_per_forward": n})
    clip = pre_cfg.vision.primary
    so400m = gen_cfg.vision.fused
    rows_clip = clip.num_patches + clip.num_prefix_tokens
    rows_so = so400m.num_patches + so400m.num_prefix_tokens
    e_gen, e_pre = gen_cfg.vision.embed_dim, pre_cfg.vision.embed_dim
    w8a8 += [
        {"kernel": fused_mlp.KERNEL_NAME, "shape": ["clip_l_336_mlp"],
         "forward_batch": 1, "m": rows_clip, "k": clip.hidden_size,
         "f": clip.mlp_dim, "d": clip.hidden_size, "act": "quick_gelu",
         "gated": False, "launches_per_forward": clip.resolved_feature_layer
         + 1},
        {"kernel": fused_mlp.KERNEL_NAME, "shape": ["so400m_384_mlp"],
         "forward_batch": 1, "m": rows_so, "k": so400m.hidden_size,
         "f": so400m.mlp_dim, "d": so400m.hidden_size, "act": "gelu_tanh",
         "gated": False, "launches_per_forward":
             so400m.resolved_feature_layer + 1},
        {"kernel": fused_mlp.KERNEL_NAME, "shape": ["gelu_mlp_projector"],
         "forward_batch": 1, "m": clip.num_patches, "k": e_pre,
         "f": pre.hidden_size, "d": pre.hidden_size, "act": "gelu",
         "gated": False, "launches_per_forward": 1},
        {"kernel": fused_mlp.KERNEL_NAME, "shape": ["fused_projector"],
         "forward_batch": 1, "m": gen_cfg.vision.num_patches_per_image,
         "k": e_gen, "f": 4 * e_gen, "d": llm.hidden_size, "act": "gelu",
         "gated": False, "launches_per_forward": 1},
    ]
    d = llm.hidden_size
    for m, tag in ((1, "decode"), (llm_rows["llama2_7b"], "prefill")):
        w8a8 += [
            {"kernel": w8a8_matmul.KERNEL_NAME, "shape": [f"q_k_v_o_{tag}"],
             "forward_batch": 1, "m": m, "k": d, "n": d,
             "launches_per_forward": 4 * llm.num_layers},
            {"kernel": w8a8_matmul.KERNEL_NAME,
             "shape": [f"lm_head_shape_{tag}"], "forward_batch": 1, "m": m,
             "k": d, "n": llm.vocab_size, "launches_per_forward": 0}]
    return attention, bwd, w8a8


def phase_zoo_kernels(card: str) -> dict:
    """B1, B1-bwd, B2, B3 and B4 at the 7B zoo models' shapes against their
    plain versions, each with its plan, time, plain time, library yardstick
    and bound; B2 and B4 bit for bit."""
    from vla_adapter_torch.models.registry import get_llm_backbone

    _, gen_cfg = zoo_model(ZOO_GENERATE)
    _, pre_cfg = zoo_model(ZOO_PRETRAIN)
    attention, bwd, w8a8 = zoo_kernel_shapes(gen_cfg, pre_cfg,
                                             get_llm_backbone(ZOO_13B))
    records = {"attention": phase_kernel_vs_plain(attention),
               "attention_bwd": phase_attention_bwd(bwd, card),
               "w8a8": phase_w8a8_kernels(w8a8)}
    for r in records["w8a8"]:
        if r["kernel"] != "w8a8_mlp" and not r["bitwise_equal"]:
            raise AssertionError(f"{r['kernel']} {r['shape']} M={r['m']}: "
                                 f"not bit for bit with its plain version")
        if "plan" in r:
            plan = r["plan"]  # B4's names a branch; B2/B3's its splits
            route = plan.get("branch") or (
                f"{plan['up_splits']} K slices x {plan['down_splits']} "
                "panel groups")
            print(f"zoo {r['kernel']} {r['shape'][0]} M={r['m']}: branch "
                  f"{route}, {plan['smem_bytes']} B of "
                  f"shared memory, {1e3 * r['ms']:.1f} us (plain "
                  f"{1e3 * r['plain_ms']:.1f}, bound "
                  f"{1e3 * r['bound_ms']:.2f}); card {card}", flush=True)
    return records


def phase_zoo_generate(card: str, seed: int) -> tuple:
    """prism-dinosiglip+7b: teacher-forced multimodal logits (bf16 and its
    w8a8 "fused" twin, kernel vs plain, w8a8 vs bf16) at B=2, then
    ``greedy_generate_cached`` of ZOO_NEW tokens at B=1 and 4 in both, as
    phase 12 checks it. Returns (record, launches by path)."""
    import torch

    entry, cfg = zoo_model(ZOO_GENERATE)
    dev = torch.device(DEVICE)
    models = zoo_vlms(cfg, seed, dev, w8a8=True)
    n_llm = sum(p.numel() for p in models["bf16"][0].language_model
                .parameters())
    rec = {"card": card, "model": entry.model_id,
           "llm_parameters": n_llm, "vlm_parameters": sum(
               p.numel() for p in models["bf16"][0].parameters())}
    rng = np.random.default_rng(seed + 16)
    lengths = rng.integers(ZOO_TEXT[0], ZOO_TEXT[1] + 1, size=2)
    ids, valid = zoo_prompts(entry, cfg.llm.vocab_size, lengths, seed)
    pixels = torch.from_numpy(zoo_pixels(entry, cfg, 2, seed)).to(
        dev, torch.bfloat16)
    rec["logits"], logit_launches = zoo_logits(
        models, ids, valid, pixels, entry.model_id)
    print(f"zoo logits {entry.model_id}: " + json.dumps(rec["logits"]),
          flush=True)
    paths = {"zoo_logits": collections.Counter(logit_launches),
             "zoo_generate": collections.Counter(),
             "zoo_generate_w8a8": collections.Counter()}
    total = ZOO_GEN_TEXT + ZOO_NEW
    rec["runs"] = []
    for backend, path in (("bf16", "zoo_generate"),
                          ("w8a8", "zoo_generate_w8a8")):
        vlm, plain = models[backend]
        atol = GEN_LOGITS_ATOL if backend == "bf16" else GEN_W8A8_LOGITS_ATOL
        for b in ZOO_BATCHES:
            prompt, _ = zoo_prompts(entry, cfg.llm.vocab_size,
                                    [ZOO_GEN_TEXT] * b, seed + b)
            buf = torch.zeros((b, total), dtype=torch.long, device=dev)
            buf[:, :ZOO_GEN_TEXT] = torch.from_numpy(prompt).to(dev)
            run, launches = generate_run(
                vlm.language_model, plain.language_model, buf, ZOO_GEN_TEXT,
                ZOO_NEW, atol, f"zoo generate {backend}")
            run = {"backend": backend, **run}
            paths[path].update(launches)
            print(f"zoo generate {json.dumps(run)}; card {card}", flush=True)
            rec["runs"].append(run)
    del models
    torch.cuda.empty_cache()
    return rec, {k: dict(v) for k, v in paths.items()}


def zoo_pretrain_batch(entry, cfg, seed: int):
    """ZOO_PRETRAIN_BATCH prompts of 64-127 ids through the entry's
    builder, the loss on every id after the first, and letterboxed
    pixels."""
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(ZOO_TEXT[0], ZOO_TEXT[1] + 1,
                           size=ZOO_PRETRAIN_BATCH)
    ids, valid = zoo_prompts(entry, cfg.llm.vocab_size, lengths, seed + 2)
    labels = np.where(valid > 0, ids, -100)
    labels[:, 0] = -100
    return {"input_ids": ids.astype(np.int32), "text_valid": valid,
            "labels": labels.astype(np.int32),
            "pixel_values": zoo_pixels(entry, cfg, ZOO_PRETRAIN_BATCH,
                                       seed + 3)}


def expected_remat_pretrain_launches(model, trainable) -> dict:
    """One pretraining step under remat of the towers and the LLM: the
    launches of :func:`expected_pretrain_launches`, and B1 once more for
    every attention layer the gradient passes through, whose forward
    every policy recomputes (none keeps B1's output)."""
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_LAUNCHES_PER_CALL,
        KERNEL_NAME,
    )

    out = dict(expected_pretrain_launches(model, trainable))
    out[KERNEL_NAME] += out[BWD_KERNEL_NAME] // BWD_LAUNCHES_PER_CALL
    return out


def phase_zoo_pretrain(card: str, seed: int) -> tuple:
    """mistral-instruct-v0.1+7b: letterboxed non-square images through the
    bf16 VLM's logits, kernel vs plain; then ``pretrain`` in "align" (fp32
    weights, the projector trained) at batch ZOO_PRETRAIN_BATCH for
    ZOO_PRETRAIN_STEPS steps without remat (where it fits) and under each
    remat policy over the towers and the LLM: s/step by ``StepTimer``,
    peak memory, launches of B1 and B1-bwd per step against the derived
    counts, and the losses and the trained projector equal across the runs
    bit for bit. Returns (record, launches by path)."""
    import itertools

    import torch

    from vla_adapter_torch.core.config import OptimizerConfig
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vlm import PrismaticVLM
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.train import pretrain as tpretrain
    from vla_adapter_torch.train.stages import split_by_stage
    from vla_adapter_torch.utils.profiling import StepTimer

    entry, cfg = zoo_model(ZOO_PRETRAIN)
    dev = torch.device(DEVICE)
    models = zoo_vlms(cfg, seed, dev, w8a8=False)
    rng = np.random.default_rng(seed + 17)
    lengths = rng.integers(ZOO_TEXT[0], ZOO_TEXT[1] + 1, size=2)
    ids, valid = zoo_prompts(entry, cfg.llm.vocab_size, lengths, seed)
    pixels = torch.from_numpy(zoo_pixels(entry, cfg, 2, seed)).to(
        dev, torch.bfloat16)
    rec = {"card": card, "model": entry.model_id}
    rec["logits"], logit_launches = zoo_logits(models, ids, valid, pixels,
                                               entry.model_id)
    print(f"zoo logits {entry.model_id}: " + json.dumps(rec["logits"]),
          flush=True)
    del models
    torch.cuda.empty_cache()
    batch = zoo_pretrain_batch(entry, cfg, seed)
    pcfg = tpretrain.PretrainConfig(
        model=cfg, stage="align", seed=seed, device=DEVICE,
        optim=OptimizerConfig(learning_rate=1e-3,
                              max_steps=ZOO_PRETRAIN_STEPS,
                              num_steps_before_decay=1000))
    rec["pretrain"] = {"batch": ZOO_PRETRAIN_BATCH,
                       "steps": ZOO_PRETRAIN_STEPS, "runs": {}}
    launches, first = collections.Counter(), None
    for policy in ZOO_POLICIES:
        name = policy or "no remat"
        rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.float32,
                     remat=policy is not None,
                     remat_policy=policy or "nothing",
                     remat_components=("vit", "llm"))
        meta = PrismaticVLM(cfg, rt, device="meta")
        trainable, _ = split_by_stage(meta.state_dict(), "align")
        per_step = (expected_remat_pretrain_launches(meta, trainable)
                    if policy else expected_pretrain_launches(meta,
                                                              trainable))
        del meta
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        timer = StepTimer(warmup=1)
        oom = None
        try:
            params, metrics = tpretrain.pretrain(
                pcfg, itertools.repeat(batch), ZOO_PRETRAIN_STEPS, rt=rt,
                device=DEVICE, timer=timer)
        except torch.cuda.OutOfMemoryError as err:
            if policy is not None:
                raise
            oom = str(err).splitlines()[0]
        if oom is not None:  # the failed run's tensors are released now
            rec["pretrain"]["runs"][name] = {
                "fits": False, "error": oom,
                "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                 - resident) / 2**30}
            print(f"zoo pretrain {name}: does not fit ({oom}); card {card}",
                  flush=True)
            torch.cuda.empty_cache()
            continue
        got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        _check_train_launches(got, per_step, ZOO_PRETRAIN_STEPS,
                              f"zoo pretrain {name}")
        launches.update(got)
        projector = {k: v for k, v in params.items()
                     if k.startswith("projector.")}
        if not all(np.isfinite(metrics["losses"])):
            raise AssertionError(f"zoo pretrain {name}: {metrics}")
        if first is None:
            first = (name, metrics["losses"], projector)
        else:
            same_loss = metrics["losses"] == first[1]
            differ = sorted(k for k, v in projector.items()
                            if not torch.equal(v, first[2][k]))
            if not same_loss or differ:
                raise AssertionError(
                    f"zoo pretrain {name} against {first[0]}: losses "
                    f"{metrics['losses']} vs {first[1]}, projector tensors "
                    f"that differ: {differ}")
        timing = timer.summary()
        run = {"fits": True, "losses": metrics["losses"],
               "s_per_step": timing["median_s"], "timing": timing,
               "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                - resident) / 2**30,
               "launches": got, "launches_per_step": per_step}
        rec["pretrain"]["runs"][name] = run
        print(f"zoo pretrain {name}: {timing['median_s']:.3f} s/step, peak "
              f"{run['peak_mem_gib']:.2f} GiB, per step {per_step}, losses "
              f"{metrics['losses']}; card {card}", flush=True)
        del params, projector
        torch.cuda.empty_cache()
    rec["pretrain"]["bit_for_bit_with"] = first[0]
    return rec, {"zoo_logits": logit_launches,
                 "zoo_pretrain": dict(launches)}


def zoo_kernel_summary(records) -> dict:
    """Each kernel's phase-16 call sites for the kernels line: per call,
    ms / plain / bound / library and the shape."""
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        KERNEL_NAME,
    )

    out = collections.defaultdict(list)
    for r in records["attention"]:
        out[KERNEL_NAME].append({
            "shape": f"{r['shape']} B={r['batch']} S={r['seq']} "
                     f"D={r['head_dim']} {r['heads']}/{r['kv_heads']}",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["sdpa_ms"], "max_abs_err": r["max_abs_err"]})
    for r in records["attention_bwd"]:
        out[BWD_KERNEL_NAME].append({
            "shape": f"{r['shape']} B={r['batch']} S={r['seq']} "
                     f"D={r['head_dim']} {r['heads']}/{r['kv_heads']}",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["sdpa_bwd_ms"], "max_abs_err": r["max_abs_err"]})
    for r in records["w8a8"]:
        out[r["kernel"]].append({
            "shape": f"{r['shape'][0]} M={r['m']} K={r['k']}",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("int_mm_ms"),
            "max_abs_err": r["max_abs_err"],
            "branch": r.get("plan", {}).get("branch")})
    return dict(out)


def phase_zoo(card: str, seed: int) -> tuple:
    """Phase 16: the model zoo at 7B (module docstring): the kernels at
    the new shapes, prism-dinosiglip+7b's logits and generation, and
    mistral-instruct-v0.1+7b's logits and pretraining. Returns (record,
    launches by path, the kernels' call sites)."""
    import torch

    t0 = time.perf_counter()
    print(f"zoo: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in use at "
          f"the start; card {card}", flush=True)
    kernel_records = phase_zoo_kernels(card)
    gen, paths = phase_zoo_generate(card, seed)
    pre, pre_paths = phase_zoo_pretrain(card, seed)
    paths["zoo_logits"] = dict(collections.Counter(paths["zoo_logits"])
                               + collections.Counter(pre_paths["zoo_logits"]))
    paths["zoo_pretrain"] = pre_paths["zoo_pretrain"]
    rec = {"card": card, "generate": gen, "pretrain": pre,
           "seconds": time.perf_counter() - t0}
    print(f"zoo: {rec['seconds']:.1f} s; card {card}", flush=True)
    return rec, paths, zoo_kernel_summary(kernel_records)


# --- phase 17: finetuning on demonstrations -----------------------------------

LIBERO_INSTRUCTIONS = (
    "pick up the black bowl between the plate and the ramekin and place it "
    "on the plate",
    "pick up the black bowl next to the ramekin and place it on the plate",
    "pick up the alphabet soup and place it in the basket",
    "pick up the tomato sauce and place it in the basket",
)


def synthetic_libero_trajectories(seed: int, num_trajs: int,
                                  lengths=(100, 300), image_size: int = 256,
                                  pool: int = 48) -> list:
    """Raw trajectories in LIBERO's no-noops RLDS schema, seeded:
    ``observation/image`` and ``observation/wrist_image`` as JPEG bytes
    (PIL) of smooth uint8 frames (each camera's steps cycle through a pool
    of ``pool`` encoded frames), ``observation/state`` (8, float32),
    ``action`` (7, float32; the gripper uniform in [-1, 1]) and the
    instruction as bytes."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)

    def frame():
        low = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
        img = Image.fromarray(low).resize((image_size, image_size),
                                          Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    frames = {cam: [frame() for _ in range(pool)]
              for cam in ("image", "wrist_image")}
    trajs = []
    for _ in range(num_trajs):
        n = int(rng.integers(lengths[0], lengths[1] + 1))
        idx = (int(rng.integers(pool)) + np.arange(n)) % pool
        instruction = LIBERO_INSTRUCTIONS[int(rng.integers(
            len(LIBERO_INSTRUCTIONS)))].encode()
        trajs.append({
            "observation": {
                cam: np.array([frames[cam][i] for i in idx], dtype=object)
                for cam in frames} | {
                "state": rng.normal(size=(n, 8)).astype(np.float32)},
            "action": np.concatenate(
                [rng.normal(0, 0.3, size=(n, 6)),
                 rng.uniform(-1, 1, size=(n, 1))], axis=1).astype(np.float32),
            "language_instruction": np.array([instruction] * n, dtype=object),
        })
    return trajs


# the interleaved pass of phase 17: draws over both datasets, host only
MIXTURE_FRAMES = 2000
LOADER_WORKERS = 4
# batches drawn from the loader before the workers' rate is timed (their
# first wave and the prefetched queue), then the batches timed
LOADER_DRAIN, LOADER_TIMED = 4, 8


def libero_kwargs(name: str, trajs: list, **over) -> dict:
    """The OXE factory's kwargs of a LIBERO dataset with ``trajs`` as its
    in-memory source (no TFDS reader, no statistics cache)."""
    from vla_adapter_torch.data.rlds.oxe.materialize import (
        make_oxe_dataset_kwargs,
    )

    kw = make_oxe_dataset_kwargs(name, "in-memory",
                                 load_camera_views=("primary", "wrist"))
    kw.update(data_dir=None, traj_source=trajs, **over)
    return kw


def direct_libero_statistics(trajs: list) -> dict:
    """The statistics of LIBERO trajectories computed directly in numpy:
    the gripper clipped and flipped as ``libero_dataset_transform`` does,
    the proprio the state's EEF (6) and gripper (2) dimensions."""
    from vla_adapter_torch.data.normalization import compute_statistics

    acts = np.concatenate([np.concatenate(
        [t["action"][:, :6], 1.0 - np.clip(t["action"][:, -1:], 0, 1)], 1)
        for t in trajs])
    state = np.concatenate([t["observation"]["state"] for t in trajs])
    return {"action": compute_statistics(acts),
            "proprio": compute_statistics(np.concatenate(
                [state[:, :6], state[:, -2:]], 1)),
            "num_transitions": len(acts), "num_trajectories": len(trajs)}


def check_rlds_batch(batch, reference, where: str) -> None:
    """Every key, shape and dtype of the dummy batch, normalized actions
    in [-1, 1], and a dataset name per row."""
    for key, want in reference.items():
        got = batch.get(key)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{where}: {key} is {getattr(got, 'shape', None)} "
                f"{getattr(got, 'dtype', None)}, the dummy batch's "
                f"{want.shape} {want.dtype}")
    if not (np.isfinite(batch["pixel_values"]).all()
            and np.abs(batch["actions"]).max() <= 1.0):
        raise AssertionError(f"{where}: pixels not finite or actions "
                             f"outside [-1, 1]")
    if len(batch["dataset_name"]) != len(batch["actions"]):
        raise AssertionError(f"{where}: no dataset name per row")


class TimedBatches:
    """The loader's batches, each checked, with the host's wait in
    ``next()`` timed by ``StepTimer`` (the first, before the model is
    built, not kept)."""

    def __init__(self, it, reference):
        from vla_adapter_torch.utils.profiling import StepTimer

        self.it, self.reference = it, reference
        self.timer, self.count = StepTimer(warmup=1), 0

    def __iter__(self):
        return self

    def __next__(self):
        with self.timer:
            batch = next(self.it)
        check_rlds_batch(batch, self.reference, f"batch {self.count}")
        self.count += 1
        return batch


def rlds_mixture_shares(sources: dict, cfg, seed: int) -> dict:
    """Dataset shares over MIXTURE_FRAMES frames of the training mixture of
    ``sources`` (equal weights; host only, the cameras left out: the draw
    does not look at them), each within four binomial sigmas."""
    from vla_adapter_torch.data.rlds.dataset import make_interleaved_dataset
    from vla_adapter_torch.data.rlds_dataset import vla_traj_transform_kwargs

    kwargs = [libero_kwargs(n, t, image_obs_keys={})
              for n, t in sources.items()]
    frames, _ = make_interleaved_dataset(
        kwargs, [1.0] * len(kwargs), train=True, shuffle_buffer_size=1000,
        traj_transform_kwargs=vla_traj_transform_kwargs(cfg),
        frame_transform_kwargs=dict(resize_size={}), seed=seed)
    names = [bytes(f["dataset_name"]).decode()
             for _, f in zip(range(MIXTURE_FRAMES), frames)]
    p = 1.0 / len(sources)
    bound = 4 * np.sqrt(p * (1 - p) / len(names))
    shares = {n: names.count(n) / len(names) for n in sources}
    if len(names) != MIXTURE_FRAMES or any(abs(v - p) > bound
                                           for v in shares.values()):
        raise AssertionError(f"mixture shares {shares} over {len(names)} "
                             f"frames, expected {p} within {bound}")
    return {"frames": len(names), "shares": shares, "bound": bound}


# steps of phase 17's finetune on RLDS batches
RLDS_TRAIN_STEPS = 3


def phase_finetune_rlds(card: str, seed: int,
                        dummy_s_per_step=None) -> tuple:
    """Phase 17 (module docstring): the flagship recipe trained on
    synthetic LIBERO demonstrations through the port's RLDS pipeline.
    Returns (record, launches of the training run)."""
    import dataclasses as dc
    import gc
    import multiprocessing
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.core.constants import NormalizationType
    from vla_adapter_torch.data.action_tokenizer import ActionTokenizer
    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.data.image_processing import image_processor_for
    from vla_adapter_torch.data.normalization import unnormalize
    from vla_adapter_torch.data.rlds_dataset import RLDSDataset, data_loader
    from vla_adapter_torch.data.tokenization import MockTokenizer, TextToIds
    from vla_adapter_torch.data.transform import VLABatchTransform
    from vla_adapter_torch.models.lora import merge_lora
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import find_resume_checkpoint
    from vla_adapter_torch.train.finetune import config_from_experiment
    from vla_adapter_torch.parallel.sharding import per_process_seed
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_norm_stats, load_vla

    t_start = time.perf_counter()
    dev = "cuda"
    rec = {"card": card, "seconds": {}}
    t_last = [t_start]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name], t_last[0] = now - t_last[0], now

    # 1. the data and the recipe's pipeline
    cli = config_from_experiment("vla-adapter+libero-spatial")
    tcfg = dc.replace(train_config(seed), save_freq=1000)
    cfg = tcfg.model
    sources = {"libero_spatial_no_noops": synthetic_libero_trajectories(
                   seed, 20),
               "libero_object_no_noops": synthetic_libero_trajectories(
                   seed + 1, 20)}
    name = cli.data.mixture
    tok = MockTokenizer()
    transform = VLABatchTransform(
        cfg, TextToIds(tok), ActionTokenizer(len(tok)),
        image_processor=image_processor_for(cfg.vision),
        seed=per_process_seed(seed))
    ds = RLDSDataset(cfg, transform, [libero_kwargs(name, sources[name])],
                     batch_size=tcfg.batch_size, train=True,
                     image_aug=cli.data.image_aug,
                     shuffle_buffer_size=cli.data.shuffle_buffer_size,
                     seed=per_process_seed(seed))
    stats = ds.dataset_statistics[name]
    direct = direct_libero_statistics(sources[name])
    if {k: v for k, v in stats["action"].items() if k != "mask"} != \
            direct["action"] or any(stats[k] != direct[k] for k in (
                "proprio", "num_transitions", "num_trajectories")):
        raise AssertionError("pipeline statistics differ from numpy's")
    rec["data"] = {
        "datasets": {n: {"trajectories": len(t),
                         "steps": int(sum(len(x["action"]) for x in t))}
                     for n, t in sources.items()},
        "image_aug": cli.data.image_aug,
        "shuffle_buffer": ds.shuffle_buffer_size,
        "statistics_equal_numpy": True}
    reference = make_dummy_batch(cfg, tcfg.batch_size,
                                 np.random.default_rng(seed))
    lap("1 data")

    # 2. the pipeline's host rate alone, in this process
    it0 = iter(ds)
    rlds_batch = next(it0)
    check_rlds_batch(rlds_batch, reference, "in-process batch")
    t0 = time.perf_counter()
    for _ in range(2):
        check_rlds_batch(next(it0), reference, "in-process batch")
    rate0 = 2 * tcfg.batch_size / (time.perf_counter() - t0)
    del it0
    lap("2 pipeline in process")

    # 3. kernel against plain, one step on an RLDS batch
    rt = build_runtime(tcfg)
    init = initial_state(tcfg, rt, dev)
    step3 = kernel_vs_plain_step(tcfg, init, rlds_batch, dev)
    print("rlds_kernel_vs_plain " + json.dumps(dict(step3, card=card)),
          flush=True)
    check_kernel_vs_plain(step3)
    rec["kernel_vs_plain"] = step3
    del init
    torch.cuda.empty_cache()
    lap("3 kernel_vs_plain")

    # 4. the pipeline's rate with the workers, alone
    t_loader = time.perf_counter()
    loader = data_loader(ds, LOADER_WORKERS)
    next(loader)
    startup = time.perf_counter() - t_loader
    for _ in range(LOADER_DRAIN):
        next(loader)
    t0 = time.perf_counter()
    for _ in range(LOADER_TIMED):
        check_rlds_batch(next(loader), reference, "loader batch")
    rate_n = LOADER_TIMED * tcfg.batch_size / (time.perf_counter() - t0)
    rec["pipeline"] = {"frames_per_s_in_process": rate0,
                       "frames_per_s_workers": rate_n,
                       "workers": LOADER_WORKERS,
                       "first_batch_s": startup, "spawn": True}
    print("rlds_pipeline " + json.dumps(dict(rec["pipeline"], card=card)),
          flush=True)
    lap("4 pipeline workers")

    root = Path(tempfile.mkdtemp(prefix="vla_rlds_"))
    try:
        # 5. the flagship recipe trained on it: the main path
        model = VLAModel(cfg, rt, device="meta")
        per_micro = expected_train_launches(model)
        del model
        timed = TimedBatches(loader, reference)
        state, launches, wall, memory = _train_run(
            tcfg, None, RLDS_TRAIN_STEPS, root, data_iter=timed, rt=rt,
            dataset_statistics=ds.dataset_statistics)
        losses = [h["loss"] for h in state.history]
        if not np.isfinite(losses).all():
            raise AssertionError(f"RLDS finetune losses {losses}")
        _check_train_launches(launches, per_micro, RLDS_TRAIN_STEPS,
                              "RLDS finetune")
        step_s = statistics.median(h["step_time"] for h in state.history[2:])
        wait = timed.timer.summary()
        run_dir = root / tcfg.run_id
        lines = [json.loads(x) for x in
                 (run_dir / "metrics.jsonl").read_text().splitlines()]
        per_dataset = sorted({k for line in lines for k in line
                              if k.startswith(name + "/")})
        if f"{name}/loss" not in per_dataset:
            raise AssertionError(f"no per-dataset loss in {lines[:1]}")
        main = {"losses": losses, "median_s_per_step_from_3": step_s,
                "samples_per_s": tcfg.batch_size / step_s,
                "dummy_data_s_per_step_phase_11": dummy_s_per_step,
                "data_wait_s_per_step": wait.get("mean_s"),
                "data_wait": wait, "data_waits_s": timed.timer.times(),
                "batches_checked": timed.count,
                "wall_s": wall, **memory, "launches": launches,
                "launches_per_step_derived": per_micro,
                "per_dataset_metrics": per_dataset}
        print("rlds_finetune " + json.dumps(dict(main, card=card)),
              flush=True)
        rec["main"] = main
        timed.it = None
        del state, loader
        gc.collect()
        torch.cuda.empty_cache()
        leftover = multiprocessing.active_children()
        if leftover:
            raise AssertionError(f"loader workers still running: {leftover}")
        lap("5 finetune")

        # 6. the checkpoint's statistics, served: load_vla unnormalizes
        ckpt = find_resume_checkpoint(run_dir)
        saved = load_norm_stats(ckpt)
        if saved != json.loads(json.dumps(ds.dataset_statistics)):
            raise AssertionError("checkpoint statistics differ from the "
                                 "pipeline's")
        fcfg = dc.replace(tcfg, base_int8=False)
        weights = merge_lora(initial_state(fcfg, build_runtime(fcfg), dev),
                             fcfg.lora.scale)
        export_checkpoint_dir(weights, cfg, root / "export",
                              norm_stats=saved)
        del weights
        served = load_vla(root / "export", tokenize=TextToIds(tok),
                          center_crop=False, device=dev, cuda_graph=False)
        (images, proprio), = _requests(cfg, np.random.default_rng(seed), 1)
        chunk = served.predict_action(images, INSTRUCTION, proprio=proprio)
        norm = served.normalized_actions(
            [served.preprocess(images, INSTRUCTION, proprio)])[0]
        want = unnormalize(norm, saved[name]["action"],
                           NormalizationType.BOUNDS_Q99)
        diff = float(np.abs(chunk - want).max())
        if not (served.norm_stats == saved and diff <= 1e-6
                and np.isfinite(chunk).all()
                and not np.allclose(chunk[:, :6], norm[:, :6])):
            raise AssertionError(f"load_vla's chunk {diff} from the "
                                 "checkpoint statistics' unnormalization")
        rec["serve"] = {"statistics_equal": True,
                        "unnormalize_max_abs_diff": diff}
        del served
        torch.cuda.empty_cache()
        lap("6 checkpoint_serve")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 7. the interleaved mixture, host only
    rec["mixture"] = rlds_mixture_shares(sources, cfg, seed)
    lap("7 mixture")
    rec["seconds"]["phase"] = time.perf_counter() - t_start
    print("rlds_phase " + json.dumps(
        {"card": card, "pipeline": rec["pipeline"],
         "s_per_step": step_s, "dummy_data_s_per_step": dummy_s_per_step,
         "data_wait_s_per_step": main["data_wait_s_per_step"],
         "peak_memory_bytes": memory["max_memory_allocated_bytes"],
         "mixture": rec["mixture"]["shares"], "seconds": rec["seconds"]}),
        flush=True)
    return rec, launches


# --- phase 18: closed-loop evaluation, and training under a process group -----

# the stand-in LIBERO suite: 2 tasks, 2 trials each, every episode a success
# at this policy step (below TASK_MAX_STEPS["libero_spatial"] = 220)
EVAL_LIBERO_TASKS = 2
EVAL_LIBERO_TRIALS = 2
EVAL_LIBERO_SUCCESS_STEP = 20
# CALVIN: 3 chains of 5 subtasks; chain c passes its first depth(c)
# subtasks, each at this env step, and fails the next after ep_len cycles
EVAL_CALVIN_DEPTHS = (2, 1, 0)
EVAL_CALVIN_EP_LEN = 4
EVAL_CALVIN_SUCCESS_STEP = 12
EVAL_UNNORM = {"libero": "libero_spatial_no_noops",
               "calvin": "calvin_abc_rlds"}


def _camera_frame(size: int, seed: int) -> np.ndarray:
    """A seeded camera-like frame: smooth gradients with mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = rng.uniform(0, 6, size=3)
    img = np.stack([128 + 90 * np.sin(5 * yy + 3 * xx + p) for p in phase], -1)
    return (img + rng.normal(0, 6, img.shape)).clip(0, 255).astype(np.uint8)


class _ScriptedLiberoEnv:
    """OffScreenRenderEnv's surface for ``eval_libero``: seeded 256-px
    agent-view and wrist frames, eef pose and gripper qpos; success at
    policy step ``EVAL_LIBERO_SUCCESS_STEP``. Records each action."""

    episodes = []  # each episode's actions

    def __init__(self, bddl_file_name, camera_heights, camera_widths):
        self.size = camera_heights
        self.task = int(os.path.basename(bddl_file_name)[-1])
        self.init = 0

    def seed(self, s):
        pass

    def reset(self):
        self.t = 0
        self.actions = []
        _ScriptedLiberoEnv.episodes.append(self.actions)

    def set_init_state(self, state):
        self.init = int(np.asarray(state).reshape(-1)[0])
        return self._obs()

    def _obs(self):
        seed = 10_000 * self.task + 100 * self.init + self.t
        return {"agentview_image": _camera_frame(self.size, seed),
                "robot0_eye_in_hand_image": _camera_frame(self.size,
                                                          seed + 50_000),
                "robot0_eef_pos": np.array([0.1, -0.2, 1.0 + 0.01 * self.t]),
                "robot0_eef_quat": np.array([0.99, 0.05, 0.1, 0.02]),
                "robot0_gripper_qpos": np.array([0.039, -0.039])}

    def step(self, action):
        self.t += 1
        self.actions.append(np.asarray(action, np.float64))
        from vla_adapter_torch.eval.libero import NUM_STEPS_WAIT

        return self._obs(), 0.0, \
            self.t == NUM_STEPS_WAIT + EVAL_LIBERO_SUCCESS_STEP, {}

    def close(self):
        pass


def _libero_modules():
    """An in-process stand-in for the ``libero`` package: one suite
    ("libero_spatial") of EVAL_LIBERO_TASKS tasks over
    :class:`_ScriptedLiberoEnv`."""
    import types

    class Suite:
        n_tasks = EVAL_LIBERO_TASKS

        def get_task(self, i):
            return types.SimpleNamespace(
                language=f"pick up the black bowl number {i} and place it "
                         f"on the plate", problem_folder="spatial",
                bddl_file=f"task{i}", name=f"TASK_{i}")

        def get_task_init_states(self, i):
            return [np.array([k]) for k in range(EVAL_LIBERO_TRIALS)]

    pkg = types.ModuleType("libero.libero")
    bench = types.ModuleType("libero.libero.benchmark")
    envs = types.ModuleType("libero.libero.envs")
    bench.get_benchmark_dict = lambda: {"libero_spatial": Suite}
    envs.OffScreenRenderEnv = _ScriptedLiberoEnv
    pkg.benchmark, pkg.envs = bench, envs
    pkg.get_libero_path = lambda kind: kind
    root = types.ModuleType("libero")
    root.libero = pkg
    return {"libero": root, "libero.libero": pkg,
            "libero.libero.benchmark": bench, "libero.libero.envs": envs}


class _ScriptedCalvinEnv:
    """CALVIN's env surface: seeded 200-px static and 84-px gripper
    frames, robot_obs of 15; the chain's index rides in robot_obs[0] of
    its initial state. Records each action."""

    def reset(self, robot_obs=None, scene_obs=None):
        self.chain, self.t, self.actions = int(robot_obs[0]), 0, []

    def get_obs(self):
        seed = 1000 * self.chain + self.t
        return {"rgb_obs": {"rgb_static": _camera_frame(200, seed),
                            "rgb_gripper": _camera_frame(84, seed + 7)},
                "robot_obs": np.linspace(-0.5, 0.5, 15) + 0.01 * self.t}

    def get_info(self):
        return {"t": self.t}

    def step(self, action):
        self.t += 1
        self.actions.append(np.asarray(action, np.float64))
        return self.get_obs(), 0.0, False, {"t": self.t}


class _ScriptedOracle:
    """Subtask k of chain c succeeds EVAL_CALVIN_SUCCESS_STEP steps into
    its rollout iff k < EVAL_CALVIN_DEPTHS[c]."""

    def __init__(self, env):
        self.env = env

    def get_task_info_for_set(self, start_info, info, subtasks):
        (sub,) = subtasks
        k = int(sub.rsplit("_", 1)[1])
        steps = info["t"] - start_info["t"]
        ok = (k < EVAL_CALVIN_DEPTHS[self.env.chain]
              and steps == EVAL_CALVIN_SUCCESS_STEP)
        return set(subtasks) if ok else set()


def _calvin_assets(n_chains: int):
    env = _ScriptedCalvinEnv()
    chains = [({"robot_obs": np.full(15, float(c)), "scene_obs": np.zeros(24)},
               [f"task_{k}" for k in range(5)]) for c in range(n_chains)]
    annotations = {f"task_{k}": [f"do the calvin task {k} now"]
                   for k in range(5)}
    return env, _ScriptedOracle(env), annotations, chains


class _QueryLog:
    """A policy's calls: the inputs, the outputs and each call's seconds
    (the card synchronized before the clock stops)."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, [], []

    def __call__(self, *args):
        import torch

        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.calls.append((args, np.array(out)))
        return out


def expected_forward_launches(shapes, impl: Optional[str], cfg) -> dict:
    """Kernel launches of one B=1 forward: B1 on every attention layer, and
    under w8a8 (``impl``) the w8a8 kernels as :func:`expected_w8a8_launches`
    derives them (phases 5 and 6)."""
    from vla_adapter_torch.ops import attention_kernel

    want = collections.Counter()
    n_attn = (cfg.llm.num_layers + cfg.vision.primary.resolved_feature_layer
              + 1 + cfg.vision.fused.resolved_feature_layer + 1)
    if impl is not None:
        want.update(expected_w8a8_launches(shapes, impl))
        if impl == "mega":
            n_attn -= cfg.llm.num_layers
    want[attention_kernel.KERNEL_NAME] += n_attn
    return dict(want)


def _check_query_launches(launches, per_query, queries, what):
    want = {k: v * queries for k, v in per_query.items() if v}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} "
                             f"({queries} queries)")


def eval_libero_run(pred, tier: str, per_query: dict, card: str) -> tuple:
    """``eval_libero`` over the stand-in suite with ``pred``: launches
    counted around exactly this call; executed actions against
    ``process_action`` of chunks the same predictor returns directly
    for the prepared observations. Returns (record, launches)."""
    import vla_adapter_torch.eval.libero as libero
    from vla_adapter_torch.eval.robot_utils import process_action
    from vla_adapter_torch.ops import cuda_lib

    def policy(obs, task):
        return pred.predict_action([obs["full_image"], obs["wrist_image"]],
                                   task, proprio=obs["state"],
                                   unnorm_key=EVAL_UNNORM["libero"])

    log = _QueryLog(policy)
    host_s = []
    prepare = libero.prepare_observation

    def timed_prepare(obs, size):
        t0 = time.perf_counter()
        out = prepare(obs, size)
        host_s.append(time.perf_counter() - t0)
        return out

    saved = {k: sys.modules.get(k) for k in _libero_modules()}
    sys.modules.update(_libero_modules())
    libero.prepare_observation = timed_prepare
    _ScriptedLiberoEnv.episodes = []
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        result = libero.eval_libero(log, libero.LiberoEvalConfig(
            num_trials_per_task=EVAL_LIBERO_TRIALS))
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    finally:
        libero.prepare_observation = prepare
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    episodes = _ScriptedLiberoEnv.episodes
    n_eps = EVAL_LIBERO_TASKS * EVAL_LIBERO_TRIALS
    if (result["episodes"], result["successes"]) != (n_eps, n_eps) or \
            len(episodes) != n_eps:
        raise AssertionError(f"eval_libero ({tier}): {result}")
    per_episode = -(-EVAL_LIBERO_SUCCESS_STEP // 8)  # ceil(steps / 8)
    if len(log.calls) != per_episode * n_eps:
        raise AssertionError(f"eval_libero ({tier}): {len(log.calls)} "
                             f"queries, expected {per_episode} x {n_eps}")
    _check_query_launches(launches, per_query, len(log.calls),
                          f"eval_libero ({tier})")
    # outside the counted run: the same predictor called directly
    from vla_adapter_torch.eval.libero import NUM_STEPS_WAIT

    q = 0
    for actions in episodes:
        policy_actions = actions[NUM_STEPS_WAIT:]
        if len(policy_actions) != EVAL_LIBERO_SUCCESS_STEP:
            raise AssertionError(f"an episode ran {len(policy_actions)} "
                                 "policy steps")
        for step, action in enumerate(policy_actions):
            (obs, task), chunk = log.calls[q + step // 8]
            if step % 8 == 0:
                direct = policy(obs, task)
                if not np.array_equal(direct, chunk):
                    raise AssertionError(f"eval_libero ({tier}): a chunk "
                                         "differs from the direct call by "
                                         f"{np.abs(direct - chunk).max()}")
            if not np.array_equal(action, process_action(chunk[step % 8])):
                raise AssertionError(f"eval_libero ({tier}): executed "
                                     f"action {step} is not the chunk's")
        q += per_episode
    ms = np.asarray(log.seconds) * 1e3
    rec = {"tier": tier, "card": card, "episodes": n_eps,
           "policy_steps_per_episode": EVAL_LIBERO_SUCCESS_STEP,
           "queries": len(log.calls), "queries_per_s": len(ms) / wall,
           "query_ms_p50": float(np.percentile(ms, 50)),
           "query_ms_p99": float(np.percentile(ms, 99)),
           "prepare_observation_host_ms_per_step": 1e3 * float(np.mean(host_s)),
           "episode_s": wall / n_eps, "wall_s": wall,
           "launches": launches, "actions_equal_direct_chunks": True}
    print("eval_libero " + json.dumps(rec), flush=True)
    return rec, launches


def calvin_run(pred, tier: str, per_query: dict, card: str,
               n_chains: int = len(EVAL_CALVIN_DEPTHS),
               gather: bool = False) -> tuple:
    """``evaluate_policy`` with ``CalvinPolicy`` over the scripted chains
    (``gather``: ``eval_calvin`` instead, under the caller's process
    group): launches counted around exactly this call; per subtask three
    queries per ten steps, and every executed action the hi3 schedule
    applied to chunks the same policy returns directly for the recorded
    observations. Returns (record, launches)."""
    from vla_adapter_torch.eval import calvin
    from vla_adapter_torch.eval.openloop import _HI3_SCHEDULE, HI3_CYCLE_LEN
    from vla_adapter_torch.eval.robot_utils import process_action
    from vla_adapter_torch.ops import cuda_lib

    env, oracle, annotations, chains = _calvin_assets(n_chains)
    cfg = calvin.CalvinEvalConfig(ep_len=EVAL_CALVIN_EP_LEN,
                                  unnorm_key=EVAL_UNNORM["calvin"])
    direct = calvin.CalvinPolicy(pred, cfg)
    log = _QueryLog(direct)
    rollouts = []  # (env steps, queries before) per subtask rollout
    step_env = env.step

    def counting_step(action):
        out = step_env(action)
        rollouts[-1][0].append(np.asarray(action, np.float64))
        return out

    env.step = counting_step
    policy_cls = calvin.CalvinPolicy
    rollout = calvin.rollout_subtask

    def tracked_rollout(*args, **kw):
        rollouts.append(([], len(log.calls)))
        return rollout(*args, **kw)

    calvin.CalvinPolicy = lambda p, c: log
    calvin.rollout_subtask = tracked_rollout
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        if gather:
            result = calvin.eval_calvin(pred, (env, oracle, annotations,
                                               chains), cfg)
            depths = None
        else:
            depths = calvin.evaluate_policy(log, env, oracle, annotations,
                                            chains, cfg)
            result = {"avg_seq_len": calvin.avg_seq_len(depths),
                      "num_chains": len(depths)}
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    finally:
        calvin.CalvinPolicy = policy_cls
        calvin.rollout_subtask = rollout
    want_depths = list(EVAL_CALVIN_DEPTHS[:n_chains])
    if depths is not None and depths != want_depths:
        raise AssertionError(f"CALVIN ({tier}): depths {depths}, expected "
                             f"{want_depths}")
    if result["num_chains"] != n_chains or result["avg_seq_len"] != \
            float(np.mean(want_depths)):
        raise AssertionError(f"CALVIN ({tier}): {result}")
    _check_query_launches(launches, per_query, len(log.calls),
                          f"CALVIN ({tier})")
    for i, (actions, q0) in enumerate(rollouts):
        n = len(actions)
        full, rem = divmod(n, HI3_CYCLE_LEN)
        queries = 3 * full + min(rem, 3)
        q1 = rollouts[i + 1][1] if i + 1 < len(rollouts) else len(log.calls)
        if q1 - q0 != queries:
            raise AssertionError(f"CALVIN ({tier}): {q1 - q0} queries in "
                                 f"{n} steps, expected {queries}")
        buffers, q = {}, q0
        for t, action in enumerate(actions):
            slot, combo = _HI3_SCHEDULE[t % HI3_CYCLE_LEN]
            if slot is not None:
                (obs, instruction), chunk = log.calls[q]
                again = direct(obs, instruction)
                if not np.array_equal(again, chunk):
                    raise AssertionError(f"CALVIN ({tier}): a chunk differs "
                                         "from the direct call")
                buffers[slot], q = again, q + 1
            want = process_action(np.mean([buffers[b][c] for b, c in combo],
                                          axis=0))
            if not np.array_equal(action, want):
                raise AssertionError(f"CALVIN ({tier}): executed action {t} "
                                     "is not the hi3 schedule's")
    ms = np.asarray(log.seconds) * 1e3
    steps = sum(len(a) for a, _ in rollouts)
    rec = {"tier": tier, "card": card, "gather": gather,
           "chains": n_chains, "result": result, "env_steps": steps,
           "queries": len(log.calls), "queries_per_s": len(ms) / wall,
           "query_ms_p50": float(np.percentile(ms, 50)),
           "query_ms_p99": float(np.percentile(ms, 99)),
           "wall_s": wall, "launches": launches,
           "actions_equal_hi3_of_direct_chunks": True}
    print("eval_calvin " + json.dumps(rec), flush=True)
    return rec, launches


def eval_tools_run(ckpt, card: str) -> dict:
    """parity_check record then check from the exported directory (it
    must PASS at 0.0), and verify_smoke in its own process."""
    import contextlib
    import io
    import shutil
    import tempfile

    from vla_adapter_torch.eval import parity_check

    tmp = tempfile.mkdtemp(prefix="vla_parity_")
    try:
        obs = os.path.join(tmp, "obs.npz")
        np.savez(obs, full_image=_camera_frame(256, 1),
                 wrist_image=_camera_frame(256, 2),
                 state=np.random.default_rng(3).normal(size=8))
        golden = os.path.join(tmp, "golden.json")
        common = ["--ckpt_dir", str(ckpt), "--obs", obs, "--instruction",
                  INSTRUCTION, "--unnorm_key", EVAL_UNNORM["libero"],
                  "--mock_tokenizer", "true"]
        parity_check.main(["--mode", "record", "--out", golden, *common])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            parity_check.main(["--mode", "check", "--golden", golden,
                               "--atol", "0", *common])
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        if line != {"parity": "PASS", "max_abs_diff": 0.0, "atol": 0.0}:
            raise AssertionError(f"parity_check: {line}")
        proc = subprocess.run(
            [sys.executable, "-m", "vla_adapter_torch.eval.verify_smoke",
             "--ckpt_dir", str(ckpt), "--mock_tokenizer", "true", "--iters",
             "5", "--unnorm_key", EVAL_UNNORM["libero"]], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        latency = [ln for ln in proc.stderr.splitlines() if "latency" in ln]
        if proc.returncode != 0 or not latency:
            raise AssertionError(f"verify_smoke: rc {proc.returncode}\n"
                                 f"{proc.stderr[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"card": card, "parity_check": line,
           "verify_smoke": latency[-1].split(":: ")[-1]}
    print("eval_tools " + json.dumps(rec), flush=True)
    return rec


def phase_eval(predictor, shapes, card: str, seed: int) -> tuple:
    """Phase 18 (a): the flagship exported with seeded statistics for
    LIBERO and CALVIN, loaded with ``load_vla`` in bf16 and w8a8 "auto",
    driven through ``eval_libero`` and CALVIN's ``evaluate_policy``, then
    ``eval_calvin`` under a one-rank NCCL group (the depth gather runs,
    and the group is destroyed after), then the parity and smoke tools.
    Returns (record, launches by path)."""
    import shutil
    import tempfile
    import torch

    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.models.layers import resolve_w8a8_impl
    from vla_adapter_torch.parallel.sharding import initialize_distributed
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    cfg = predictor.cfg
    rng = np.random.default_rng(seed + 18)
    stats = {key: dataset_statistics(
        rng.uniform(-1, 1, size=(1000, 7)), proprio=rng.normal(size=(1000, 8)),
        action_mask=[True] * 6 + [False]) for key in EVAL_UNNORM.values()}
    tmp = tempfile.mkdtemp(prefix="vla_eval_")
    rec = {"card": card}
    paths = {"eval_libero": collections.Counter(),
             "eval_calvin": collections.Counter()}
    try:
        export_checkpoint_dir(predictor.params, cfg, tmp, norm_stats=stats)
        tiers = {"bf16": (load_vla(tmp, tokenize=predictor.tokenize), None),
                 "w8a8 auto": (load_vla(tmp, tokenize=predictor.tokenize,
                                        act_int8=True, w8a8_impl="auto"),
                               resolve_w8a8_impl("auto", 1))}
        for tier, (pred, impl) in tiers.items():
            # the first request captures the B=1 graph: outside the runs
            t0 = time.perf_counter()
            pred.predict_action(
                [_camera_frame(224, 0)] * cfg.vision.num_images, INSTRUCTION,
                proprio=np.zeros(cfg.constants.proprio_dim),
                unnorm_key=EVAL_UNNORM["libero"])
            rec[f"first_query_ms {tier}"] = 1e3 * (time.perf_counter() - t0)
            per_query = expected_forward_launches(shapes, impl, cfg)
            rec[f"libero {tier}"], counts = eval_libero_run(
                pred, tier, per_query, card)
            paths["eval_libero"].update(counts)
            rec[f"calvin {tier}"], counts = calvin_run(pred, tier, per_query,
                                                       card)
            paths["eval_calvin"].update(counts)
        import torch.distributed as dist

        initialize_distributed(f"tcp://localhost:{_free_port()}", 1, 0,
                               device="cuda")
        try:
            from vla_adapter_torch.eval.calvin import gather_depths

            pred = tiers["bf16"][0]
            rec["eval_calvin_group"], counts = calvin_run(
                pred, "bf16", expected_forward_launches(shapes, None, cfg),
                card, n_chains=2, gather=True)
            paths["eval_calvin"].update(counts)
            # one rank gathers nothing in eval_calvin: the gather itself,
            # an all_gather of a card tensor over NCCL
            depths = list(EVAL_CALVIN_DEPTHS)
            if gather_depths(depths, len(depths)) != depths:
                raise AssertionError("gather_depths on one rank")
            rec["eval_calvin_group"]["gather_depths_nccl"] = depths
        finally:
            dist.destroy_process_group()
        del tiers, pred
        torch.cuda.empty_cache()
        rec["tools"] = eval_tools_run(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, {k: dict(v) for k, v in paths.items()}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# steps of each run of phase 18's training under a process group: of a
# run's step times (read one step late) the first holds the set-up and
# the last only the final read, so 2 are timed (1 of the FSDP2 run,
# resumed at step 1)
GROUP_TRAIN_STEPS = 3


def _file_digest(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def group_train_child(out_path: str, seed: int, profile: bool = False
                      ) -> None:
    """Phase 18 (b), in its own process: the flagship recipe at batch 16
    for GROUP_TRAIN_STEPS steps (i) without a process group and (ii)
    under a one-rank NCCL group on "data"; (iii) under FSDP2 on a
    one-rank "fsdp" mesh (a group per decoder layer, the int8 base held
    as its parts and gathered per layer and pass, the same code as at N
    ranks)
    the first step, a checkpoint written under the group, then the rest
    resumed from it. (ii) and (iii) must equal (i) bit for bit in losses
    and trained tensors, launch B1, B1-bwd and B4 per step as
    :func:`expected_train_launches` derives them, and (iii) gather the
    int8 base per step as :func:`expected_int8_gathers` derives and write
    the checkpoint files (i) writes, byte for byte. With
    ``profile``, step 2 of each (i), (ii) and (iii) runs under
    :class:`ProfiledStep`. Writes the record as JSON to ``out_path``."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.parallel import fsdp_int8, sharding
    from vla_adapter_torch.parallel.sharding import initialize_distributed
    from vla_adapter_torch.train.loop import build_runtime

    cuda_lib.load_libraries(SOURCES)
    card = card_line()
    tcfg = dataclasses.replace(train_config(seed), save_freq=1000)
    batch = make_dummy_batch(tcfg.model, tcfg.batch_size,
                             np.random.default_rng(seed))
    per_micro = expected_train_launches(
        VLAModel(tcfg.model, build_runtime(tcfg), device="meta"))
    root = Path(tempfile.mkdtemp(prefix="vla_group_"))
    runs, rec = {}, {"card": card, "steps": GROUP_TRAIN_STEPS}

    def one(name, steps=GROUP_TRAIN_STEPS, profiled_fetch=None, **kw):
        # step 2 is the window's: the fetch of its batch, counted from the
        # run's first (a resumed run starts at step 1)
        prof = (ProfiledStep(batch, profiled_fetch, host=True)
                if profile and profiled_fetch is not None else None)
        fsdp_int8.reset_gathers()
        state, launches, wall, memory = _train_run(tcfg, batch, steps,
                                                   root / name,
                                                   data_iter=prof, **kw)
        # the checkpoint's gathers (Sharding.full) are no step's
        gathers = {k: v for k, v in fsdp_int8.GATHERS.items()
                   if k != "checkpoint"}
        per_step = expected_int8_gathers(state.model)
        full = {n: (state.sharding.full(p, n) if state.sharding else p
                    ).detach().clone()
                for n, p in state.trainable.items()}
        dtensors = sum(type(p).__name__ == "DTensor"
                       for p in state.model.parameters())
        losses = [h["loss"] for h in state.history]
        # read one step late: the first interval holds the set-up, the
        # last only the final read
        step_s = [h["step_time"] for h in state.history]
        del state
        torch.cuda.empty_cache()
        runs[name] = (losses, full)
        rec[name] = {"losses": losses, "step_s": step_s,
                     "s_per_step": (statistics.median(step_s[1:-1])
                                    if len(step_s) > 2 else None),
                     "wall_s": wall,
                     "peak_gib": memory["max_memory_allocated_bytes"] / 2**30,
                     "dtensor_params": dtensors, "launches": launches,
                     "int8_gathers": gathers,
                     "int8_gathers_per_step_derived": per_step}
        _check_train_launches(launches, per_micro, len(losses), name)
        want = {k: v * len(losses) for k, v in per_step.items()}
        if gathers != want:
            raise AssertionError(f"{name}: int8 gathers {gathers}, derived "
                                 f"{want}")
        if prof is not None:
            rec[name]["profile"] = prof.summary
        print(f"group_train {name} " + json.dumps(dict(rec[name],
                                                       card=card)),
              flush=True)

    try:
        one("alone", profiled_fetch=2)
        initialize_distributed(f"tcp://localhost:{_free_port()}", 1, 0,
                               device="cuda")
        one("data", profiled_fetch=2)
        # FSDP2 on the one-rank "fsdp" mesh: a step and a checkpoint under
        # the group, then resumed
        sharding.MIN_FSDP_RANKS = 1
        one("fsdp", steps=1)
        first = runs.pop("fsdp")[0]
        rec["fsdp_first_step"] = rec.pop("fsdp")
        one("fsdp", resume=True, profiled_fetch=1)
        runs["fsdp"] = (first + runs["fsdp"][0], runs["fsdp"][1])
        if rec["data"]["dtensor_params"] or not rec["fsdp"]["dtensor_params"]:
            raise AssertionError("FSDP2 placed no parameter, or 'data' did")
        if not rec["fsdp"]["int8_gathers"].get("backward"):
            raise AssertionError("FSDP2's run gathered no int8 base")
        for name in ("data", "fsdp"):
            losses, full = runs[name]
            if losses != runs["alone"][0]:
                raise AssertionError(f"{name}: losses {losses} != "
                                     f"{runs['alone'][0]}")
            differ = [n for n, v in full.items()
                      if not torch.equal(v, runs["alone"][1][n])]
            if differ:
                raise AssertionError(f"{name}: trained tensors differ: "
                                     f"{differ[:5]}")
        # the checkpoint the FSDP2 run wrote (the int8 base gathered from
        # its parts by Sharding.full) is the one-process run's, file for
        # file, byte for byte
        from vla_adapter_torch.train.checkpoints import find_resume_checkpoint
        from vla_adapter_torch.train.loop import get_run_id

        dirs = [find_resume_checkpoint(root / name / get_run_id(tcfg))
                for name in ("alone", "fsdp")]
        files = sorted(f.name for f in dirs[0].iterdir())
        if files != sorted(f.name for f in dirs[1].iterdir()) or any(
                _file_digest(dirs[0] / f) != _file_digest(dirs[1] / f)
                for f in files):
            raise AssertionError(f"the FSDP2 checkpoint differs from one "
                                 f"process's: {files}")
        rec["checkpoint_equal_files"] = files
        rec["bitwise_equal"] = ["data", "fsdp (resumed at step 1)",
                                "fsdp checkpoint files"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(out_path, "w") as f:
        json.dump(rec, f)


def phase_group_train(card: str, seed: int, profile: bool = False
                      ) -> tuple:
    """Runs :func:`group_train_child` in a child process (no process
    group outlives it) and returns (record, launches of the "data"
    run)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="vla_group_rec_")
    out = os.path.join(tmp, "rec.json")
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--group-train-child", out, "--seed",
                               str(seed)] + (["--profile"] if profile else []),
                              cwd=HERE, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"the process-group training child exited "
                                 f"{proc.returncode}")
        with open(out) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, rec["data"]["launches"]


def eval_and_group_phase(predictor, shapes, card: str, seed: int,
                         lap, profile: bool = False) -> tuple:
    """Phase 18, lapped: (record, launches by path)."""
    t0 = time.perf_counter()
    rec, paths = phase_eval(predictor, shapes, card, seed)
    rec["group_train"], paths["finetune_ddp"] = phase_group_train(
        card, seed, profile)
    paths["finetune_fsdp"] = rec["group_train"]["fsdp"]["launches"]
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 18 seconds: {rec['seconds']:.1f} ({card})", flush=True)
    print(f"kernels launched on the eval and group paths: "
          f"{ {k: sorted(v) for k, v in paths.items()} }", flush=True)
    lap("18 eval group_train")
    return rec, paths


def causal_language_path(predictor, cfg, card: str, seed: int, phases,
                         lap) -> dict:
    """Phases 12-15 (those in ``phases``), each lapped: their records, the
    kernel records at their call sites, and their launches by path."""
    out = {"launches_by_path": {}, "kernel_records": {}}
    paths = out["launches_by_path"]
    if 12 in phases:
        out["generate"], gen_paths, out["kernel_records"]["generate"] = \
            phase_generate(predictor, card)
        paths.update(gen_paths)
        print(f"kernels launched on the generation paths: {gen_paths}",
              flush=True)
        lap("12 generate")
    if 13 in phases:
        out["actions"], paths["actions"] = phase_actions(predictor, card)
        lap("13 actions")
    if 14 in phases:
        out["token_train"], paths["token_train"] = phase_token_train(
            cfg, card, seed)
        out["pretrain"], paths["pretrain"], \
            out["kernel_records"]["pretrain_attention_bwd"] = phase_pretrain(
                cfg, card, seed)
        print(f"kernels launched on the token-train and pretrain paths: "
              f"{paths['token_train']}, {paths['pretrain']}", flush=True)
        lap("14 token_train pretrain")
    if 15 in phases:
        out["phi"], paths["phi"], out["kernel_records"]["phi"] = phase_phi(
            card, seed)
        print(f"kernels launched on the phi path: {paths['phi']}",
              flush=True)
        lap("15 phi")
    return out


def zoo_phase(card: str, seed: int, lap) -> tuple:
    """Phase 16 after the flagship's models are freed (the caller dropped
    its last reference): (record, launches by path, the kernels' call
    sites), lapped."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out = phase_zoo(card, seed)
    print(f"kernels launched on the zoo paths: {out[1]}", flush=True)
    lap("16 zoo")
    return out


def rlds_phase(card: str, seed: int, lap, dummy_s_per_step=None) -> tuple:
    """Phase 17 after the earlier phases' models are freed, lapped:
    (record, launches of its training run)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out = phase_finetune_rlds(card, seed, dummy_s_per_step)
    print(f"kernels launched on the RLDS finetune path: {sorted(out[1])}",
          flush=True)
    lap("17 finetune_rlds")
    return out


# --- phase 19: the "tensor" mesh axis ------------------------------------------

TENSOR = 2
# the flagship recipe at tensor 2: steps of the first run (a checkpoint at
# its end), then the steps resumed from that checkpoint
TENSOR_TRAIN_STEPS = 3
TENSOR_RESUMED_STEPS = 1
# rows of B4's narrow design (M <= 32) at the split shapes
TENSOR_NARROW_ROWS = 20
# tensor 2 against one process. The base's split products are exact
# (int32 partials summed before one dequant) and each head is the same
# computation; what differs is the order of the bf16 sums a split adds up
# across ranks (the LoRA partials x[:, lo:hi] @ lora_a[lo:hi], the head's
# row-split float products, the gradients summed over the group), and
# every int8 requantization downstream turns such an ulp into a rounding
# flip now and then. The yardstick is the recipe's own spread under one
# bf16 ulp of its input: one process again with each pixel scaled by
# 1 +- 2^-8 (signs drawn from each of TENSOR_SPREAD_SEEDS), from the same
# init, in the same phase. The split run is held, at step 0 in each
# trainable tensor's gradient norm and at every step in the loss, within
# TENSOR_SPREAD_MARGIN times the largest distance of a perturbed run from
# the unperturbed one. A sum over the group at the wrong scale, or one
# made twice, moves a gradient by its own size. The ranks' whole
# trainable tensors must also stay equal bit for bit.
TENSOR_SPREAD_SEEDS = (1, 2, 3)
TENSOR_SPREAD_MARGIN = 3.0


class first_grad_squares:
    """Within the block, the first optimizer update's gradients (the train
    step's, after its reductions over the process group: a rank's parts
    of the split tensors) as {name: sum of squares} in ``self.sq`` (float64
    scalars on the card)."""

    def __enter__(self):
        from vla_adapter_torch.train import optim

        self.sq, self._update = {}, optim.AdamW.update
        sq, update = self.sq, self._update

        def record(tx, grads, *args, **kw):
            if not sq:
                sq.update({n: g.detach().double().square().sum()
                           for n, g in grads.items()})
            return update(tx, grads, *args, **kw)

        optim.AdamW.update = record
        return self

    def __exit__(self, *exc):
        from vla_adapter_torch.train import optim

        optim.AdamW.update = self._update

    def host(self) -> dict:
        """{name: sum of squares} as floats (waits for the card)."""
        names = sorted(self.sq)
        import torch

        values = torch.stack([self.sq[n] for n in names]).cpu().tolist()
        return dict(zip(names, values))

    def norms(self) -> dict:
        """{name: gradient norm} (waits for the card)."""
        return {n: v ** 0.5 for n, v in self.host().items()}


def perturbed_pixels(pixels: np.ndarray, seed: int) -> np.ndarray:
    """Each pixel scaled by 1 + 2^-8 or 1 - 2^-8 (one bf16 ulp), the signs
    drawn from ``seed``."""
    sign = np.random.default_rng(seed).choice(
        np.float32([-1.0, 1.0]), size=pixels.shape)
    return (pixels * (np.float32(1.0) + sign * np.float32(2.0 ** -8))
            ).astype(pixels.dtype)


def one_process_spread(tcfg, batch, steps: int, reference=None) -> list:
    """The recipe in one process from one init, ``steps`` steps on the
    batch as it is (unless ``reference``, phase 11's main run, has them)
    and then on each of TENSOR_SPREAD_SEEDS' perturbed pixels, each run
    from the init again (the trainable tensors restored, the optimizer
    started afresh, the steps counted from 0: the same head noise). Per
    run its losses and the step-0 norm of each trainable tensor's
    gradient. The model is built as ``finetune`` builds it, once."""
    import torch

    from vla_adapter_torch.train.step import to_device

    state, step_fn = _train_model(tcfg, "kernel", "cuda")
    start = _snapshot(state)
    runs, seeds = [], (None,) + TENSOR_SPREAD_SEEDS
    if reference is not None:
        runs.append({"seed": None, "losses": reference["losses"][:steps],
                     "grad_norms": reference["grad_norms"],
                     "from": "phase 11"})
        seeds = TENSOR_SPREAD_SEEDS
    for seed in seeds:
        b = dict(batch)
        if seed is not None:
            b["pixel_values"] = perturbed_pixels(b["pixel_values"], seed)
        _restore(state, start, 0)
        dev = to_device(b, "cuda")
        with first_grad_squares() as grads:
            losses = [step_fn(state, dev, i)["loss"] for i in range(steps)]
        runs.append({"seed": seed, "losses": [float(x) for x in losses],
                     "grad_norms": grads.norms()})
    del state, start
    torch.cuda.empty_cache()
    return runs


def _train_model(tcfg, kernels: str, dev):
    """(a training state at step 0 over the seeded init, its train step)
    on the ``kernels`` path, built as ``finetune`` builds it."""
    from vla_adapter_torch.models.layers import prepare_ste_
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.optim import make_optimizer
    from vla_adapter_torch.train.step import init_train_state, make_train_step

    rt = build_runtime(tcfg, kernels)
    model = VLAModel(tcfg.model, rt, device="meta")
    model.load_state_dict(initial_state(tcfg, rt, dev), strict=True,
                          assign=True)
    tx = make_optimizer(tcfg.optim)
    state = init_train_state(model, tx, tcfg.lora.enabled)
    prepare_ste_(model)
    model.train()
    return state, make_train_step(model, tx, tcfg)


def _copy_opt(opt_state: dict) -> dict:
    return {k: v.clone() if k == "count" else
            {n: t.clone() for n, t in v.items()}
            for k, v in opt_state.items()}


def _snapshot(state) -> dict:
    """The trainable tensors and the optimizer state, copied."""
    return {"trainable": {n: p.detach().clone()
                          for n, p in state.trainable.items()},
            "opt_state": _copy_opt(state.opt_state)}


def _restore(state, snap: dict, step: int) -> None:
    """``state`` set to ``snap`` at ``step`` (the moments copied again: an
    update works on them in place)."""
    import torch

    with torch.no_grad():
        for n, p in state.trainable.items():
            p.copy_(snap["trainable"][n])
    state.opt_state = _copy_opt(snap["opt_state"])
    state.step = step


def stacked_norms(norms: dict) -> dict:
    """Per-tensor norms {name: norm} combined over the layers of each stack
    ({name with its layer indices as "*": root of the sum of squares}),
    the JAX package's leaves (its layers are scanned, each tensor stacked
    over them)."""
    import re

    out = collections.defaultdict(float)
    for n, v in norms.items():
        out[re.sub(r"\.\d+\.", ".*.", n)] += v * v
    return {n: v ** 0.5 for n, v in out.items()}


def spread_check(got, ref, perturbed, what: str) -> dict:
    """``got`` (a list or dict of numbers) against ``ref`` within
    TENSOR_SPREAD_MARGIN times the largest |perturbed - ref| of each entry
    over the perturbed runs; the readings, worst first. ``what`` names the
    entries in the error."""
    keys = sorted(ref) if isinstance(ref, dict) else range(len(ref))
    rows = []
    for k in keys:
        spread = max(abs(p[k] - ref[k]) for p in perturbed)
        diff = abs(got[k] - ref[k])
        rows.append({"entry": k, "got": got[k], "ref": ref[k], "diff": diff,
                     "spread": spread,
                     "ratio": diff / spread if spread > 0 else (
                         0.0 if diff == 0 else float("inf"))})
    rows.sort(key=lambda r: -r["ratio"])
    bad = [r for r in rows if not r["diff"] <= TENSOR_SPREAD_MARGIN
           * r["spread"]]
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} of {len(rows)} beyond "
            f"{TENSOR_SPREAD_MARGIN} x the one-ulp spread: {bad[:5]}")
    return {"entries": len(rows), "worst_ratio_to_spread": rows[0]["ratio"],
            "worst": rows[:5],
            "ratio_quartiles": [rows[len(rows) * q // 4]["ratio"]
                                for q in (1, 2, 3)]}


def _digest(t) -> str:
    """A hash of a tensor's values (bit for bit)."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def tensor_split_modes(model, tensor: int) -> dict:
    """{Dense name: "col", "row" or None} of every straight-through
    (frozen w8a8) Dense of the training model, by ``param_pspec``'s rule at
    ``tensor``."""
    from vla_adapter_torch.parallel.sharding import model_pspecs

    specs = model_pspecs(model, 1, tensor)
    out = {}
    for name, mod in model.named_modules():
        if getattr(mod, "ste", False):
            spec = specs[f"{name}.weight_q"]
            out[name] = (None if "tensor" not in spec
                         else "col" if spec.index("tensor") == 0 else "row")
    return out


def expected_tensor_launches(model, tensor: int, batch: int = 16) -> dict:
    """:func:`expected_train_launches` per rank of a ``tensor`` split: B1
    and B1-bwd as one process (each rank attends over its heads in one
    call); a column-split Dense runs its forward on B4 (twice where it
    recomputes) and its dx on B4's int32 output, a row-split one its
    forward on the int32 output and its dx on B4; B4's pre-pass with each
    float-x call whose plan takes the Hopper branch (the int32 output's
    calls take xq)."""
    from vla_adapter_torch.ops import w8a8_matmul

    out = dict(expected_train_launches(model, batch))
    modes = tensor_split_modes(model, tensor)
    rt = model.rt
    rows = train_rows(model.cfg, batch)
    first = {f"{tower}.blocks.0.attn.{p}" for tower in (
        "vision_backbone.featurizer", "vision_backbone.fused_featurizer")
        for p in ("q_proj", "k_proj", "v_proj")}
    b4 = collections.Counter({w8a8_matmul.KERNEL_NAME: 0})
    i32 = 0
    for name, mode in modes.items():
        mod = model.get_submodule(name)
        m, k, n = rows[base_owner(name)], mod.in_features, mod.features
        stack = ("llm" if name.startswith("language_model") else
                 "vit" if name.startswith("vision_backbone") else None)
        twice = 2 if stack and rt.remat_policy_of(stack) else 1
        dx = 0 if name in first else 1
        if mode is None:
            fwd, back = [(m, k, n)] * twice, [(m, n, k)] * dx
        elif mode == "col":
            fwd, back, i32 = [(m, k, n // tensor)] * twice, [], i32 + dx
        else:
            fwd, back, i32 = [], [(m, n, w8a8_matmul.padded_k(
                k // tensor))] * dx, i32 + twice
        for mm, kk, nn in fwd:
            b4.update(b4_call_launches(mm, kk, nn, "bf16"))
        for mm, kk, nn in back:
            b4.update(b4_call_launches(mm, kk, nn, "f32"))
    out.pop(w8a8_matmul.QUANT_KERNEL_NAME, None)
    out.update(b4)
    out[w8a8_matmul.INT32_KERNEL_NAME] = i32
    return out


def tensor_b4_shapes(cfg, batch: int, tensor: int = TENSOR):
    """The int32-output products of the flagship recipe at ``tensor``:
    (owner, M, local K, N, whole K, {what: calls}, int32 launches per
    micro-batch) per distinct shape, a row split's forward (K its part of
    the input; twice where its stack recomputes) and a column split's dx
    (K its part of the output; none for the first tower block's q/k/v), at
    the micro-batch's rows and at TENSOR_NARROW_ROWS rows; and so400m's
    fc2 at tensor 4 (K 1076, no launch at tensor 2)."""
    from vla_adapter_torch.core.config import TrainConfig
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime

    model = VLAModel(cfg, build_runtime(TrainConfig(model=cfg,
                                                    base_int8=True)),
                     device="meta")
    rows = {o: m for o, m, _, _ in ste_shapes(cfg, batch)}
    rt = model.rt
    out = {}
    for name, mode in tensor_split_modes(model, tensor).items():
        if mode is None:
            continue
        mod = model.get_submodule(name)
        owner = next(o for o in ("fused_featurizer", "featurizer",
                                 "language_model", "projector")
                     if o in name.split("."))
        stack = {"language_model": "llm", "projector": None}.get(owner,
                                                                 "vit")
        leaf = name.rsplit(".", 1)[-1]
        if mode == "row":
            whole, n, what = mod.in_features, mod.features, "forward"
            calls = 2 if stack and rt.remat_policy_of(stack) else 1
        else:
            whole, n, what = mod.features, mod.in_features, "dx"
            calls = 0 if ".blocks.0.attn." in name else 1
        for m in (rows[owner], TENSOR_NARROW_ROWS):
            key = (owner, m, whole // tensor, n)
            entry = out.setdefault(key, {
                "owner": owner, "m": m, "k": whole // tensor, "n": n,
                "whole_k": whole, "calls": collections.Counter(),
                "launches_per_micro_batch": 0})
            entry["calls"][f"{leaf} {what}"] += 1
            if m == rows[owner]:
                entry["launches_per_micro_batch"] += calls
    so400m = model.vision_backbone.fused_featurizer.blocks[0].mlp.fc2
    for m in (rows["fused_featurizer"], TENSOR_NARROW_ROWS):
        out[("fused_featurizer", m, so400m.in_features // 4,
             so400m.features)] = {
            "owner": "fused_featurizer", "m": m,
            "k": so400m.in_features // 4, "n": so400m.features,
            "whole_k": so400m.in_features,
            "calls": {"fc2 forward at tensor 4": 1},
            "launches_per_micro_batch": 0}
    return [dict(v, calls=dict(v["calls"])) for _, v in sorted(out.items())]


def tensor_b4_record(sh, gen, card: str) -> dict:
    """B4's int32 output at one split shape: x (M, whole K) bf16 with row
    scales over the whole K, each part of K quantized into a zeroed tail
    (a K of 16s) and multiplied against its zero-padded weight part; every
    part bit for bit with the plain int32 product, and the parts' sum
    dequantized bit for bit with the whole-K call (B4's own dequant).
    Times: the part's kernel, the whole-K call, the plain product and
    ``torch._int_mm`` at the part's padded shape, against the bound."""
    import torch

    from vla_adapter_torch.ops import w8a8_matmul as ops

    m, k, n, whole = sh["m"], sh["k"], sh["n"], sh["whole_k"]
    dev = torch.device("cuda")
    x = torch.randn(m, whole, generator=gen, device=dev).bfloat16()
    x[:, 3] *= 20.0   # an outlier column, in the first part
    x[1::2, whole - 2] *= 40.0   # odd rows peak in the last part
    w = torch.randint(-127, 128, (n, whole), generator=gen, device=dev,
                      dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-3
    rs = ops.row_scale(x.float().abs().amax(-1, keepdim=True))
    kp = ops.padded_k(k)
    parts, acc = [], None
    for r in range(whole // k):
        xr, wr = x[:, r * k:(r + 1) * k], w[:, r * k:(r + 1) * k]
        xq, wq = ops.quantize_to(xr, rs, kp), ops.pad_k(wr)
        got = ops.w8a8_matmul(xq, None, wq, None, out_dtype=torch.int32)
        want = ops.int_matmul(ops.quantize_to(xr, rs), wr).to(torch.int32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 int32 {sh}: part {r} differs from the "
                                 f"plain product by "
                                 f"{int((got - want).abs().max())}")
        parts.append((xq, wq, xr, wr))
        acc = got if acc is None else acc + got
    xq_whole = ops.quantize_to(x, rs)
    whole_out = ops.w8a8_matmul(xq_whole, rs, w, ws)
    summed = (acc.float() * rs * ws).to(torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(summed, whole_out):
        raise AssertionError(f"B4 int32 {sh}: the parts' sum dequantized "
                             f"differs from the whole-K call by "
                             f"{float((summed.float() - whole_out.float()).abs().max())}")
    xq, wq, xr, wr = parts[0]
    lib_ms, padded = _int_mm_ms(xq, wq)
    ops_n = 2 * m * k * n
    nbytes = m * kp + n * kp + 4 * m * n
    t_ops, t_bytes = ops_n / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    rec = dict(sh, card=card, padded_k=kp, parts=whole // k,
               bitwise_equal=True, sum_bitwise_equal_to_whole=True,
               max_abs_err=0.0,
               ms=device_ms(lambda: ops.w8a8_matmul(
                   xq, None, wq, None, out_dtype=torch.int32), reps=10,
                   rounds=3),
               whole_k_ms=device_ms(lambda: ops.w8a8_matmul(
                   xq_whole, rs, w, ws), reps=10, rounds=3),
               plain_ms=device_ms(lambda: ops.w8a8_matmul_reference(
                   xq, None, wq, None, out_dtype=torch.int32), reps=5),
               int_mm_ms=lib_ms, int_mm_padded_to_24_rows=padded,
               bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops=ops_n, bytes=nbytes)
    print("tensor_b4_shape " + json.dumps(rec), flush=True)
    return rec


def tensor_attention_shapes(cfg, batch: int, seed: int, tensor: int = TENSOR):
    """B1-bwd's training shapes (:func:`attention_bwd_shapes`: the LLM,
    DINOv2, so400m) with each rank's heads at ``tensor``."""
    out = []
    for name, b, h, hkv, s, d, valid, causal, calls in \
            attention_bwd_shapes(cfg, batch, seed)[:3]:
        out.append((f"{name}_tensor{tensor}", b, h // tensor,
                    max(hkv // tensor, 1), s, d, valid, causal, calls))
    return out


def phase_tensor_attention(shapes, card: str) -> list:
    """B1 at each rank's heads against its plain version (phase 2's
    KERNEL_ATOL), then B1-bwd and B1 as phase 11 holds and times them."""
    import torch

    from vla_adapter_torch.ops.attention_kernel import (
        attention_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    fwd_err = {}
    for name, b, h, hkv, s, d, valid_np, causal, _ in shapes:
        q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        valid = (None if valid_np is None
                 else torch.from_numpy(valid_np).to(dev))
        got = fused_attention(q, k, v, valid, causal=causal)
        want = attention_reference(q, k, v, valid, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"B1 {name}: {err} from plain")
        fwd_err[name] = err
    records = phase_attention_bwd(shapes, card)
    for rec in records:
        rec["fwd_max_abs_err"] = fwd_err[rec["shape"]]
    return records


class SameCardTransport:
    """Phase 19's tensor collectives: all-reduce and all-gather among the
    processes of a tensor group that share one card, through CUDA IPC
    (NCCL refuses two ranks on one device, and gloo moves a CUDA tensor
    through host memory and TCP: the recipe at tensor 2 took 103 s a step
    that way on an H100). Passed to ``finetune`` as its
    ``tensor_transport``: ``SameCardTransport(group, rank, size, device)``. Each rank owns a device buffer of two slots that every rank maps
    (``torch.multiprocessing``'s CUDA sharing) and two interprocess events
    per slot, "written" and "read". A collective (on slot s, alternating)
    waits until every rank has read this rank's slot s of two collectives
    ago, copies its tensor there, records "written", meets the others at
    one host barrier (gloo, on the CPU), waits for their "written", reads
    every rank's slot in rank order and records "read". Tensors above the
    slot's size go in pieces."""

    SLOT_BYTES = 64 << 20

    def __init__(self, group, rank: int, size: int, device):
        import torch
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor

        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self.buf = torch.empty(2 * self.SLOT_BYTES, dtype=torch.uint8,
                               device=self.device)
        self.events = [[torch.cuda.Event(interprocess=True,
                                         blocking=False)
                        for _ in range(2)] for _ in range(2)]  # [kind][slot]
        mine = (reduce_tensor(self.buf),
                [[bytes(e.ipc_handle()) for e in kind]
                 for kind in self.events])
        every = [None] * size
        dist.all_gather_object(every, mine, group=group)
        self.bufs, self.peer_events = [], []
        for r, ((rebuild, args), handles) in enumerate(every):
            if r == rank:
                self.bufs.append(self.buf)
                self.peer_events.append(self.events)
            else:
                self.bufs.append(rebuild(*args))
                self.peer_events.append([[torch.cuda.Event.from_ipc_handle(
                    self.device, h) for h in kind] for kind in handles])
        self.slot = 0

    def _exchange(self, flat: torch.Tensor, read):
        """One collective on ``flat`` (1-D, at most a slot): ``read(parts)``
        gets every rank's part in rank order, on this rank's stream."""
        import torch
        import torch.distributed as dist

        n = flat.numel() * flat.element_size()
        s, self.slot = self.slot, self.slot ^ 1
        stream = torch.cuda.current_stream(self.device)
        written, done = 0, 1
        for r in range(self.size):
            if r != self.rank:   # every reader is done with my slot s
                stream.wait_event(self.peer_events[r][done][s])
        lo = s * self.SLOT_BYTES
        self.buf[lo:lo + n].view(flat.dtype).copy_(flat)
        self.events[written][s].record(stream)
        dist.barrier(group=self.group)
        for r in range(self.size):
            if r != self.rank:
                stream.wait_event(self.peer_events[r][written][s])
        out = read([b[lo:lo + n].view(flat.dtype) for b in self.bufs])
        self.events[done][s].record(stream)
        return out

    def _pieces(self, t: torch.Tensor):
        flat = t.reshape(-1)
        step = self.SLOT_BYTES // t.element_size()
        return [flat[i:i + step] for i in range(0, flat.numel(), step)]

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """t (contiguous) replaced by the elementwise SUM or MAX over the
        ranks, taken in rank order."""
        import torch
        import torch.distributed as dist

        fn = {dist.ReduceOp.SUM: torch.add,
              dist.ReduceOp.MAX: torch.maximum}[op]

        def read(parts):
            acc = parts[0].clone()
            for part in parts[1:]:
                acc = fn(acc, part)
            return acc

        if not t.is_contiguous():
            raise ValueError("SameCardTransport.all_reduce: a contiguous "
                             "tensor is reduced in place")
        for piece in self._pieces(t):
            piece.copy_(self._exchange(piece, read))
        return t

    def all_gather(self, t: torch.Tensor):
        """Every rank's t (same shape), in rank order."""
        import torch

        outs = [torch.empty_like(t) for _ in range(self.size)]
        views = [o.reshape(-1) for o in outs]
        step = self.SLOT_BYTES // t.element_size()
        for i, piece in enumerate(self._pieces(t.contiguous())):
            got = self._exchange(piece, lambda parts: [p.clone()
                                                       for p in parts])
            for v, g in zip(views, got):
                v[i * step:i * step + g.numel()].copy_(g)
        return outs


def tensor_train_child(rank: int, port: int, out_path: str, seed: int
                       ) -> None:
    """One rank of phase 19's training: the flagship recipe at batch 16 on
    the mesh (1, 1, TENSOR), two processes on the one card over gloo
    (NCCL refuses two ranks on one card): TENSOR_TRAIN_STEPS steps and
    their checkpoint, then TENSOR_RESUMED_STEPS resumed from it; the
    launches per step checked against :func:`expected_tensor_launches`;
    each rank's losses, s/step, peak memory and sums of its parts of a
    few split tensors written as JSON to ``out_path``."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.parallel.sharding import initialize_distributed
    from vla_adapter_torch.train.loop import build_runtime

    cuda_lib.load_libraries(SOURCES)
    initialize_distributed(f"tcp://localhost:{port}", TENSOR, rank,
                           local_rank=0, device="cuda", backend="gloo")

    tcfg = dataclasses.replace(train_config(seed), tensor_axis=TENSOR,
                               save_freq=1000)
    batch = make_dummy_batch(tcfg.model, tcfg.batch_size,
                             np.random.default_rng(seed))
    per_micro = expected_tensor_launches(
        VLAModel(tcfg.model, build_runtime(tcfg), device="meta"), TENSOR)
    root = Path(out_path).parent / "runs"
    rec = {"rank": rank, "card": card_line()}
    go, deadline = Path(out_path).parent / "go", time.monotonic() + 600
    while not go.exists():   # the parent's one-process runs hold the card
        if time.monotonic() > deadline:
            raise TimeoutError("phase 19: no go from the parent")
        time.sleep(0.1)
    with first_grad_squares() as grads:
        state, launches, wall, memory = _train_run(
            tcfg, batch, TENSOR_TRAIN_STEPS, root,
            tensor_transport=SameCardTransport)
    _check_train_launches(launches, per_micro, TENSOR_TRAIN_STEPS,
                          f"tensor rank {rank}")
    step_s = [h["step_time"] for h in state.history]
    sh = state.sharding
    # each trainable tensor's step-0 gradient norm over the whole tensor:
    # a split one's squares summed over the group
    import math

    import torch.distributed as dist

    sq = grads.host()
    split = sorted(n for n in sq if n in sh.tensor_dims)
    summed = torch.tensor([sq[n] for n in split], dtype=torch.float64)
    dist.all_reduce(summed)
    sq.update(zip(split, summed.tolist()))
    rec["grad_norms"] = {n: math.sqrt(v) for n, v in sq.items()}
    probes = ("action_head.blocks.0.q_proj.weight",
              "language_model.layers.0.self_attn.o_proj.lora_a",
              "action_head.fc_out.weight")
    rec.update(
        losses=[h["loss"] for h in state.history], step_s=step_s,
        s_per_step=statistics.median(step_s[1:-1]), wall_s=wall,
        peak_gib=memory["max_memory_allocated_bytes"] / 2**30,
        launches=launches, launches_per_step_derived=per_micro,
        split_tensors=len(sh.tensor_dims),
        partial_tensors=len(sh.tensor_partial),
        int8_bytes=sum(p.numel() for p in state.model.parameters()
                       if p.dtype == torch.int8),
        probes={n: sh.tensor_dims.get(n) for n in probes})
    del state
    torch.cuda.empty_cache()
    state, launches, _, _ = _train_run(
        tcfg, batch, TENSOR_TRAIN_STEPS + TENSOR_RESUMED_STEPS, root,
        resume=True, tensor_transport=SameCardTransport)
    _check_train_launches(launches, per_micro, TENSOR_RESUMED_STEPS,
                          f"tensor rank {rank} resumed")
    rec["resumed_losses"] = [h["loss"] for h in state.history]
    rec["resumed_steps"] = [h["step"] for h in state.history]
    rec["checkpoint"] = str(root / tcfg.run_id / "latest")
    # this rank's parts of the probes as it wrote the checkpoint, and its
    # copy of every whole trainable tensor (the same on every rank)
    rec["ckpt_probes"] = {n: _digest(state.trainable[n])
                          for n in rec["probes"]}
    rec["whole_trainable_digest"] = _digest(torch.cat([
        p.detach().float().reshape(-1) for n, p in state.trainable.items()
        if n not in state.sharding.tensor_dims]))
    print("tensor_rank " + json.dumps({k: v for k, v in rec.items()
                                       if k not in ("ckpt_probes",
                                                    "grad_norms")}),
          flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_tensor_train(cfg, card: str, seed: int, reference=None
                       ) -> tuple:
    """Phase 19 (c): the recipe's one-ulp spread in one process
    (:func:`one_process_spread`), then the two ranks of
    :func:`tensor_train_child` as child processes, held against it
    (:func:`spread_check`: each stack's step-0 gradient norm, each
    step's loss), then the checkpoint they wrote loaded by this process
    and served through ``load_vla`` within phase 5's bound of the trained
    LoRA model. The ranks start (imports, kernels, process group) while
    the spread runs, and train after it. ``reference``: phase 11's main
    run, the unperturbed one. Returns (record, launches of rank 0)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.lora import merge_lora
    from vla_adapter_torch.models.quantize import dequantize_params
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import load_checkpoint
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.optim import make_optimizer
    from vla_adapter_torch.train.step import init_train_state
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    tcfg = dataclasses.replace(train_config(seed), save_freq=1000)
    rec = {"card": card, "tensor": TENSOR, "ranks_on_one_card": TENSOR,
           "backend": "gloo", "collectives": "CUDA IPC (SameCardTransport)",
           "steps": TENSOR_TRAIN_STEPS,
           "resumed_steps": TENSOR_RESUMED_STEPS}
    tmp = Path(tempfile.mkdtemp(prefix="vla_tensor_"))
    try:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tensor-child",
             str(tmp / f"rank{r}.json"), "--tensor-rank", str(r),
             "--tensor-port", str(port), "--seed", str(seed)], cwd=HERE)
            for r in range(TENSOR)]
        try:
            batch = make_dummy_batch(cfg, tcfg.batch_size,
                                     np.random.default_rng(seed))
            t0 = time.perf_counter()
            alone, *perturbed = one_process_spread(
                tcfg, batch, TENSOR_TRAIN_STEPS, reference)
            rec["one_process_spread_s"] = time.perf_counter() - t0
            rec["reference_from"] = alone.get("from", "phase 19")
            (tmp / "go").touch()   # the ranks train now
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0] * TENSOR:
            raise AssertionError(f"tensor ranks exited {rcs}")
        rec["ranks_s"] = time.perf_counter() - t0 - rec[
            "one_process_spread_s"]
        ranks = [json.load(open(tmp / f"rank{r}.json"))
                 for r in range(TENSOR)]
        r0 = ranks[0]
        for r in ranks:
            if r["losses"] != r0["losses"] or \
                    r["resumed_losses"] != r0["resumed_losses"]:
                raise AssertionError("the tensor ranks read different "
                                     f"losses: {[x['losses'] for x in ranks]}")
            if r["grad_norms"] != r0["grad_norms"]:
                raise AssertionError("the tensor ranks read different "
                                     "step-0 gradient norms")
            if r["resumed_steps"] != list(range(
                    TENSOR_TRAIN_STEPS,
                    TENSOR_TRAIN_STEPS + TENSOR_RESUMED_STEPS)):
                raise AssertionError(f"resumed steps {r['resumed_steps']}")
            if r["whole_trainable_digest"] != r0["whole_trainable_digest"]:
                raise AssertionError("the ranks' whole trainable tensors "
                                     "differ")
        if not (np.isfinite(r0["losses"]).all()
                and np.isfinite(r0["resumed_losses"]).all()):
            raise AssertionError(f"tensor {TENSOR} losses {r0['losses']}, "
                                 f"resumed {r0['resumed_losses']}")
        if set(r0["grad_norms"]) != set(alone["grad_norms"]):
            raise AssertionError("the tensor ranks' trainable tensors are "
                                 "not one process's")
        ref = alone["losses"]
        rel = lambda xs: [abs(x - y) / abs(y)  # noqa: E731
                          for x, y in zip(xs, ref)]
        norms = [stacked_norms(r["grad_norms"])
                 for r in (r0, alone, *perturbed)]
        print("tensor_spread " + json.dumps({
            "losses": r0["losses"], "one_process_losses": ref,
            "perturbed_losses": [p["losses"] for p in perturbed],
            "grad_norms": norms[0], "one_process_grad_norms": norms[1],
            "perturbed_grad_norms": norms[2:]}), flush=True)
        losses = spread_check(r0["losses"], ref,
                              [p["losses"] for p in perturbed],
                              f"tensor {TENSOR} loss at step")
        grads = spread_check(norms[0], norms[1], norms[2:],
                             f"tensor {TENSOR} step-0 gradient norm of")
        rec.update(losses=r0["losses"], one_process_losses=ref,
                   perturbed_losses=[p["losses"] for p in perturbed],
                   spread_seeds=list(TENSOR_SPREAD_SEEDS),
                   spread_margin=TENSOR_SPREAD_MARGIN,
                   loss_rel_diff=rel(r0["losses"]),
                   loss_rel_spread=[max(a) for a in zip(
                       *[rel(p["losses"]) for p in perturbed])],
                   loss_check=losses, grad_norm_check=grads,
                   whole_trainable_equal_across_ranks=True,
                   resumed_losses=r0["resumed_losses"],
                   s_per_step=[r["s_per_step"] for r in ranks],
                   s_per_step_note="two processes time-sharing one card, "
                                   "not a tensor-parallel speed",
                   peak_gib=[r["peak_gib"] for r in ranks],
                   int8_bytes_per_rank=[r["int8_bytes"] for r in ranks],
                   launches_per_rank=[r["launches"] for r in ranks],
                   launches_per_step_derived=r0["launches_per_step_derived"],
                   split_tensors=r0["split_tensors"],
                   partial_tensors=r0["partial_tensors"])
        # the checkpoint (written at step 6 by rank 0) in one process
        rt = build_runtime(tcfg)
        model = VLAModel(cfg, rt, device="meta")
        model.load_state_dict(initial_state(tcfg, rt, "cuda"), strict=True,
                              assign=True)
        state = init_train_state(model, make_optimizer(tcfg.optim),
                                 tcfg.lora.enabled)
        load_checkpoint(r0["checkpoint"], state)
        if state.step != TENSOR_TRAIN_STEPS + TENSOR_RESUMED_STEPS:
            raise AssertionError(f"checkpoint at step {state.step}")
        for r in ranks:
            for n, got in r["ckpt_probes"].items():
                dim = r["probes"][n]
                whole = state.trainable[n]
                part = whole if dim is None else whole.chunk(
                    TENSOR, dim=dim)[r["rank"]]
                if _digest(part) != got:
                    raise AssertionError(f"checkpoint {n}: rank "
                                         f"{r['rank']}'s part differs")
        trained = {k: v.detach().clone() for k, v in
                   dequantize_params(state.model.state_dict()).items()}
        del state, model
        torch.cuda.empty_cache()
        srng = np.random.default_rng(seed)
        stats = {"libero_spatial": dataset_statistics(
            srng.uniform(-1, 1, size=(1000, 7)),
            proprio=srng.normal(size=(1000, 8)),
            action_mask=[True] * 6 + [False])}
        export_checkpoint_dir(merge_lora(trained, tcfg.lora.scale), cfg,
                              tmp / "export", norm_stats=stats)
        tok = MockTokenizer()
        tokenize = lambda t: tok(t).input_ids  # noqa: E731
        served = load_vla(tmp / "export", tokenize=tokenize,
                          center_crop=False, device="cuda")
        lora_rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                          lora_rank=tcfg.lora.rank,
                          lora_scale=tcfg.lora.scale)
        lora_pred = Predictor(cfg=cfg, params=trained, tokenize=tokenize,
                              norm_stats=stats, rt=lora_rt,
                              center_crop=False, device="cuda",
                              cuda_graph=False)
        rows = [served.preprocess(im, INSTRUCTION, p)
                for im, p in _requests(cfg, srng, 4)]
        got = served.normalized_actions(rows)
        want = lora_pred.normalized_actions(rows)
        diff = float(np.abs(got - want).max())
        if not (np.isfinite(got).all() and diff <= FLAGSHIP_ACTIONS_ATOL):
            raise AssertionError(f"tensor checkpoint served {diff} from the "
                                 f"trained LoRA model")
        rec["served_max_abs_diff_normalized"] = diff
        del served, lora_pred, trained
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("tensor_train " + json.dumps(rec), flush=True)
    return rec, r0["launches"]


def tensor_phase(cfg, card: str, seed: int, lap, reference=None
                 ) -> tuple:
    """Phase 19, lapped: (record, launches of rank 0's run)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = train_config(seed).batch_size
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    rec = {"b4": [tensor_b4_record(sh, gen, card)
                  for sh in tensor_b4_shapes(cfg, batch)]}
    t1 = time.perf_counter()
    rec["attention"] = phase_tensor_attention(
        tensor_attention_shapes(cfg, batch, seed), card)
    t2 = time.perf_counter()
    rec["train"], launches = phase_tensor_train(cfg, card, seed,
                                                reference)
    rec["seconds"] = time.perf_counter() - t0
    rec["seconds_by_part"] = {"b4": t1 - t0, "attention": t2 - t1,
                              "train": rec["seconds"] - (t2 - t0)}
    print(f"phase 19 parts: {json.dumps(rec['seconds_by_part'])}",
          flush=True)
    print(f"phase 19 seconds: {rec['seconds']:.1f} ({card})", flush=True)
    print(f"kernels launched on the tensor path (rank 0): "
          f"{sorted(launches)}", flush=True)
    lap("19 tensor")
    return rec, launches


def tensor_kernel_summary(rec, launches):
    """The kernels line's entry for B4's int32 output: per-call times and
    bounds of phase 19 summed over the calls of one micro-batch on a rank
    of the tensor-2 recipe (each split shape's calls at the micro-batch's
    rows, from :func:`expected_tensor_launches`' modes)."""
    from vla_adapter_torch.ops import w8a8_matmul

    rows = rec["b4"]

    def total(key):
        return sum(r[key] * r["launches_per_micro_batch"] for r in rows)

    t_ops = total("ops") / PEAK_INT8_OPS
    t_bytes = total("bytes") / PEAK_HBM_BYTES
    return [{
        "name": w8a8_matmul.INT32_KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/w8a8_matmul.cu",
        "replaces": "vla_adapter_tpu/ops/pallas_matmul.py:140",
        "launches": launches.get(w8a8_matmul.INT32_KERNEL_NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in rec["b4"]),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("int_mm_ms"),
        "library": "torch._int_mm at the same padded operands",
        "per": f"sum over the {int(sum(r['launches_per_micro_batch'] for r in rows))}"
               " int32 launches of one micro-batch of 16 on a rank of the "
               "tensor-2 recipe (row-split forwards, recomputed ones "
               "included, and column-split dx)"}]



# --- phase 20: "fsdp" memory at the recipes' device counts ---------------------

# (recipe, ranks: its expected_devices, the rank run, rows a rank, resumed):
# one rank of each under torch's fake process group, whose collectives move
# no data. The 7B recipe's checkpoint (90.2 GB) is larger than the card
# machine's disk (75 GB free): its run is rank 1, which makes every gather
# of the checkpoint and writes nothing (shards are even, so a rank's device
# memory is rank 0's; rank 0 streams each whole tensor from the host).
FSDP_MEMORY_RUNS = (("siglip-224px+mx-bridge", 8, 1, 32, False),
                    ("vla-adapter+libero-spatial", 4, 0, 16, True))
FSDP_MEMORY_STEPS = 1
FSDP_MEMORY_NOTE = ("torch's fake process group: the collectives move no "
                    "data, so the gathered tensors hold no values; no value "
                    "is checked and no loss is read, only memory, launches "
                    "and gathers")


class UnshardedLayers:
    """How many decoder layers (``parallel.sharding.decoder_layers``) hold
    their FSDP2 parameters unsharded at once, the most seen in each phase
    of a step: probed at every forward of a module inside a layer
    ("forward"; in the backward, "recompute") and as each Dense's output
    gradient is ready ("backward"). A layer counts while any parameter
    FSDP2 holds for it (a DTensor when the model is built, between steps)
    is a plain tensor: FSDP2 swaps the gathered tensors in for its forward
    and backward and the DTensors back after. Use as a context around the
    steps; the hooks change no value and no autograd node."""

    PHASES = ("forward", "recompute", "backward")

    def __init__(self, model):
        from vla_adapter_torch.models.layers import Dense
        from vla_adapter_torch.parallel.sharding import decoder_layers

        self.layers = []
        for layer in decoder_layers(model):
            held = [(m, leaf) for m in layer.modules()
                    for leaf, p in m.named_parameters(recurse=False)
                    if _is_dtensor(p)]
            if held:
                self.layers.append(held)
        self.most = dict.fromkeys(self.PHASES, 0)
        self._modules = [m for layer in decoder_layers(model)
                         for m in layer.modules()]
        self._dense = [m for m in self._modules if isinstance(m, Dense)]
        self._handles = []

    def unsharded(self) -> int:
        return sum(any(not _is_dtensor(getattr(m, leaf)) for m, leaf in held)
                   for held in self.layers)

    def _probe(self, phase: str) -> None:
        self.most[phase] = max(self.most[phase], self.unsharded())

    @staticmethod
    def _in_backward() -> bool:
        import torch

        return torch._C._current_graph_task_id() != -1

    def _pre_forward(self, module, args):
        self._probe("recompute" if self._in_backward() else "forward")

    def _post_forward(self, module, args, out):
        import torch

        if torch.is_tensor(out) and out.requires_grad \
                and not self._in_backward():
            out.register_hook(lambda g: self._probe("backward"))

    def __enter__(self):
        self._handles = [m.register_forward_pre_hook(self._pre_forward)
                         for m in self._modules]
        self._handles += [m.register_forward_hook(self._post_forward)
                          for m in self._dense]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _placed_bytes(model, trainable, world: int) -> dict:
    """Per category ("trainable", "frozen_float", "int8_base": weight_q
    and its straight-through copies weight_qt, weight_qk), the bytes of
    the whole model and those ``param_pspec`` leaves a rank: 1/world of
    each tensor it shards on "fsdp", the rest whole (a weight_qt follows
    its weight_q). Call on the whole model, before the placement."""
    from vla_adapter_torch.parallel import sharding

    specs = sharding.model_pspecs(model, world,
                                  min_fsdp_size=sharding.MIN_FSDP_SIZE)
    out = {k: {"whole": 0, "rule": 0.0}
           for k in ("trainable", "frozen_float", "int8_base")}
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for leaf, p in module.named_parameters(recurse=False):
            name = prefix + leaf
            kind = ("trainable" if name in trainable else "int8_base"
                    if not p.is_floating_point() else "frozen_float")
            share = world if sharding.FSDP_AXIS in specs[name] else 1
            copies = 2 if leaf == "weight_q" and getattr(module, "ste",
                                                         False) else 1
            nbytes = p.numel() * p.element_size() * copies
            out[kind]["whole"] += nbytes
            out[kind]["rule"] += nbytes / share
    return out


def _rank_bytes(model, trainable, opt_state) -> dict:
    """This rank's bytes as placed: trainable and frozen float parameters
    (a DTensor's local shard), the int8 base (weight_q, weight_qt,
    weight_qk as held) and the Adam moments."""
    from vla_adapter_torch.parallel.sharding import local

    def nbytes(t):
        t = local(t)
        return t.numel() * t.element_size()

    out = {"trainable": 0, "frozen_float": 0, "int8_base": 0}
    seen = set()
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for leaf, p in module.named_parameters(recurse=False):
            kind = ("trainable" if prefix + leaf in trainable else
                    "int8_base" if not p.is_floating_point() else
                    "frozen_float")
            if kind == "int8_base" and leaf == "weight_q" and getattr(
                    module, "weight_qk", None) is not None:
                continue   # a view of weight_qk
            out[kind] += nbytes(p)
        for leaf in ("weight_qt", "weight_qk"):
            t = getattr(module, leaf, None)
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out["int8_base"] += nbytes(t)
    out["adam_moments"] = sum(nbytes(v) for part in ("mu", "nu")
                              for v in opt_state[part].values())
    return out


def fsdp_memory_child(out_path: str, seed: int, index: int) -> None:
    """One run of phase 20 in its own process: one rank of the recipe
    ``FSDP_MEMORY_RUNS[index]`` on a (1, N, 1) mesh of N = its
    expected_devices under torch's fake process group (its collectives
    move no data: a memory estimate), through ``train.loop.finetune`` as
    a user calls it: seeded random weights at full width and depth, the
    recipe's remat, FSDP_MEMORY_STEPS steps at its rows a rank, then the
    closing checkpoint; a resumed run then reads that checkpoint back,
    takes one step and writes it again. Records, per finetune call, the
    set-up's peak memory (the whole model built, a resumed one's
    checkpoint read, before the placement), the steps' peak and the
    checkpoint's; for the first, this rank's bytes beside the whole
    model's and the rule's 1/N, the most decoder layers unsharded at once
    (:class:`UnshardedLayers`), launches and int8 gathers per step beside
    the derived counts. An out-of-memory is recorded with the stage it
    stopped at. Writes the record as JSON to ``out_path``."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from vla_adapter_torch.core.experiments import get_experiment
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.parallel import fsdp_int8
    from vla_adapter_torch.parallel.sharding import decoder_layers, local
    from vla_adapter_torch.train import loop
    from vla_adapter_torch.train.partition import mark_trainable_

    vla_id, world, rank, rows, resumed = FSDP_MEMORY_RUNS[index]
    cuda_lib.load_libraries(SOURCES)
    gib = 2 ** 30
    rec = {"recipe": vla_id, "ranks": world, "rank": rank,
           "rows_per_rank": rows, "steps": FSDP_MEMORY_STEPS,
           "card": card_line(), "note": FSDP_MEMORY_NOTE,
           "stage": "set-up"}
    calls = []   # one record per finetune call
    root = tempfile.mkdtemp(prefix="vla_fsdp_mem_")

    def write():
        with open(out_path, "w") as f:
            json.dump(rec, f)

    def synced_gib(fn):
        torch.cuda.synchronize()
        return fn() / gib

    torch.cuda.set_device(0)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    place, save = loop.place_state_, loop.save_checkpoint
    try:
        base = get_experiment(vla_id).to_train_config()
        tcfg = dataclasses.replace(base, fsdp_axis=world,
                                   batch_size=rows * world, seed=seed,
                                   run_root_dir=root)
        if tcfg.save_freq <= FSDP_MEMORY_STEPS:
            raise ValueError(f"{vla_id}: save_freq {tcfg.save_freq}")
        rec.update(lora=tcfg.lora.enabled, base_int8=tcfg.base_int8,
                   remat_components=list(tcfg.remat_components)
                   if tcfg.remat_llm else [])
        meta = VLAModel(tcfg.model, loop.build_runtime(tcfg), device="meta")
        names = set(mark_trainable_(meta, tcfg.lora.enabled))
        rec["bytes"] = _placed_bytes(meta, names, world)
        rec["parameters"] = sum(p.numel() for p in meta.parameters())
        rec["decoder_layers"] = len(decoder_layers(meta))
        per_micro = expected_train_launches(meta)
        del meta

        def placed(state, sh, tx=None):
            call = calls[-1]
            place(state, sh, tx)
            call["setup_peak_gib"] = synced_gib(
                torch.cuda.max_memory_allocated)
            call["resident_before_steps_gib"] = synced_gib(
                torch.cuda.memory_allocated)
            call["rank_bytes"] = _rank_bytes(state.model, state.trainable,
                                             state.opt_state)
            call["moment_itemsize"] = local(next(iter(
                state.opt_state["mu"].values()))).element_size()
            call["int8_gathers_per_step_derived"] = expected_int8_gathers(
                state.model)
            update = tx.update

            def recorded(g, *args, **kw):
                call.setdefault("gradient_bytes", sum(
                    local(v).numel() * local(v).element_size()
                    for v in g.values()))
                return update(g, *args, **kw)

            tx.update = recorded

            def at_forward_end(module, args, out):
                # the first step's forward: what it keeps for the
                # backward, its peak
                call.setdefault("forward_end_allocated_gib",
                                torch.cuda.memory_allocated() / gib)
                call.setdefault("forward_peak_gib",
                                torch.cuda.max_memory_allocated() / gib)

            call["hooks"] = [UnshardedLayers(state.model).__enter__(),
                             state.model.register_forward_hook(at_forward_end)]
            torch.cuda.reset_peak_memory_stats()
            cuda_lib.reset_launches()
            fsdp_int8.reset_gathers()
            rec["stage"] = f"{call['call']}: steps"
            call["t0"] = time.perf_counter()
            return state

        def saved(run_dir, state, *args, **kw):
            call = calls[-1]
            torch.cuda.synchronize()
            call["s_per_step"] = ((time.perf_counter() - call.pop("t0"))
                                  / call["steps"])
            call["peak_gib"] = torch.cuda.max_memory_allocated() / gib
            probe, hook = call.pop("hooks")
            probe.__exit__()
            hook.remove()
            call["most_decoder_layers_unsharded"] = probe.most
            call["launches"] = {k: v for k, v in cuda_lib.LAUNCHES.items()
                                if v}
            call["int8_gathers"] = dict(fsdp_int8.GATHERS)
            fsdp_int8.reset_gathers()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec["stage"] = f"{call['call']}: checkpoint"
            path = save(run_dir, state, *args, **kw)
            torch.cuda.synchronize()
            call["checkpoint"] = {
                "s": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / gib,
                "gathers": dict(fsdp_int8.GATHERS),
                "bytes_written": sum(f.stat().st_size
                                     for f in path.glob("*") if f.is_file())
                if path.exists() else 0}
            return path

        loop.place_state_, loop.save_checkpoint = placed, saved
        runs = [("first", FSDP_MEMORY_STEPS, False)]
        if resumed:   # one step more from the first call's checkpoint
            runs.append(("resumed", 1, True))
        for call, steps, resume in runs:
            calls.append({"call": call, "steps": steps})
            rec["stage"] = f"{call}: set-up"
            torch.cuda.reset_peak_memory_stats()
            end = FSDP_MEMORY_STEPS + (steps if resume else 0)
            state = loop.finetune(tcfg, max_steps=end, device="cuda",
                                  resume=resume)
            if state.step != end:
                raise AssertionError(f"{vla_id} {call}: at step {state.step}")
            del state
            torch.cuda.empty_cache()
        rec["stage"] = "done"
        for call in calls:
            _check_train_launches(call["launches"], per_micro, call["steps"],
                                  f"{vla_id} {call['call']}")
            want = {k: v * call["steps"] for k, v in
                    call["int8_gathers_per_step_derived"].items()}
            if call["int8_gathers"] != want:
                raise AssertionError(f"{vla_id} {call['call']}: int8 gathers "
                                     f"{call['int8_gathers']}, derived {want}")
        first = calls[0]
        for kind, n in first["rank_bytes"].items():
            rec["bytes"].setdefault(kind, {})["rank"] = n
        # two moments per trainable fp32 element, in the moments' dtype
        ratio = 2 * first["moment_itemsize"] / 4
        rec["bytes"]["adam_moments"].update(
            rule=ratio * rec["bytes"]["trainable"]["rule"],
            whole=ratio * rec["bytes"]["trainable"]["whole"])
        rec["bytes"]["gradients"] = {"rank": first.get("gradient_bytes"),
                                     "rule": rec["bytes"]["trainable"]["rule"],
                                     "whole": rec["bytes"]["trainable"]["whole"]}
        rec.update({k: first[k] for k in (
            "setup_peak_gib", "resident_before_steps_gib", "peak_gib",
            "s_per_step", "forward_end_allocated_gib", "forward_peak_gib",
            "most_decoder_layers_unsharded", "launches",
            "int8_gathers", "int8_gathers_per_step_derived", "checkpoint")
            if k in first})
        rec["launches_per_step_derived"] = per_micro
        if resumed:
            rec["resumed"] = {k: calls[1][k] for k in (
                "setup_peak_gib", "peak_gib", "checkpoint")}
    except torch.cuda.OutOfMemoryError as e:
        rec["out_of_memory"] = str(e).splitlines()[0][:300]
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / gib
        rec["calls"] = [{k: v for k, v in c.items()
                         if k not in ("hooks", "t0")} for c in calls]
    finally:
        loop.place_state_, loop.save_checkpoint = place, save
        write()
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def phase_fsdp_memory(card: str, seed: int) -> tuple:
    """Phase 20: each of FSDP_MEMORY_RUNS in a child process
    (:func:`fsdp_memory_child`), one after the other; fails if any run
    ran out of memory or failed. Returns (records, launches by path)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="vla_fsdp_mem_")
    recs, paths, failed = [], {}, []
    try:
        for i, (vla_id, world, *_) in enumerate(FSDP_MEMORY_RUNS):
            out = os.path.join(tmp, f"run{i}.json")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--fsdp-memory-child", out,
                                   "--fsdp-memory-run", str(i),
                                   "--seed", str(seed)], cwd=HERE,
                                  timeout=600, stdout=subprocess.DEVNULL)
            rec = json.load(open(out)) if os.path.exists(out) else {
                "recipe": vla_id, "ranks": world, "stage": "no record"}
            rec["exit_code"] = proc.returncode
            recs.append(rec)
            print("fsdp_memory " + json.dumps(dict(rec, card=card)),
                  flush=True)
            if proc.returncode != 0 or "out_of_memory" in rec:
                failed.append(f"{vla_id} at {world} ranks: exit "
                              f"{proc.returncode}, stage {rec.get('stage')}")
                continue
            tag = "finetune_fsdp%d_%s" % (world, "lora" if rec["lora"]
                                          else "full")
            paths[tag] = {k: v // FSDP_MEMORY_STEPS
                          for k, v in rec["launches"].items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError(f"phase 20: {failed}")
    return recs, paths


def fsdp_memory_phase(card: str, seed: int, lap) -> tuple:
    """Phase 20, lapped: (records, launches by path)."""
    t0 = time.perf_counter()
    recs, paths = phase_fsdp_memory(card, seed)
    for rec in recs:
        b = rec["bytes"]
        resumed = rec.get("resumed")
        print(f"fsdp_memory {rec['recipe']} rank {rec['rank']} of "
              f"{rec['ranks']}: peak {rec['peak_gib']:.2f} GiB in the steps "
              f"(set-up {rec['setup_peak_gib']:.2f}, checkpoint "
              f"{rec['checkpoint']['peak_gib']:.2f} in "
              f"{rec['checkpoint']['s']:.1f} s"
              + (f"; resumed: set-up {resumed['setup_peak_gib']:.2f}, step "
                 f"{resumed['peak_gib']:.2f}, checkpoint "
                 f"{resumed['checkpoint']['peak_gib']:.2f}"
                 if resumed else "") + "), "
              + ", ".join(f"{k} {b[k]['rank'] / 2**30:.3f} GiB (rule "
                          f"{b[k]['rule'] / 2**30:.3f}, whole "
                          f"{b[k]['whole'] / 2**30:.3f})"
                          for k in ("trainable", "gradients", "frozen_float",
                                    "int8_base")
                          if b[k].get("whole"))
              + f", Adam moments {b['adam_moments']['rank'] / 2**30:.3f} GiB"
              f"; decoder layers unsharded at most "
              f"{rec['most_decoder_layers_unsharded']} of "
              f"{rec['decoder_layers']} ({card}; {FSDP_MEMORY_NOTE})",
              flush=True)
    print(f"phase 20 seconds: {time.perf_counter() - t0:.1f} ({card})",
          flush=True)
    lap("20 fsdp memory")
    return recs, paths


# --- phase 21: the full-train recipe ---------------------------------------

FULL_TRAIN_RECIPE = "prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup"
FULL_TRAIN_STEPS = 6
FULL_TRAIN_MICRO = 16        # rows a micro-batch: a rank's 32 as 2 of 16
# The kernel path against the plain path (phases 11 and 21), from the
# same seeded init, batch and head noise: the step-0 loss and each
# trainable tensor's gradient norm as the optimizer got it (over every
# micro-batch) at its first nonzero update, against the plain path's own
# one-ulp spread (:func:`plain_spread`): the largest distance from the
# plain run of a plain run with the pixels scaled by 1 +- 2^-8 (one bf16
# ulp) and one ulp put on every element the attention puts out, forward
# and backward (signs drawn from each of TENSOR_SPREAD_SEEDS), each run
# taking an update from where the plain run stood before it. The pixels
# alone, phase 19's yardstick, were too narrow here: the kernels differ
# from the plain versions by up to an ulp at every attention call, which
# reaches the early tower layers through every layer above them (a first
# card run read 5 of phase 11's 922 tensors at 3.3-4.7 times the
# pixels' spread). The margin: a lost gradient moves its norm by all of
# it, a halved one by half, while the spreads read a small share of a
# norm (the record counts the share of tensors where a halving would
# exceed GRAD_SPREAD_MARGIN times the spread); phase 19's 3x the largest
# of 3 runs failed 2 of 1,418 tensors (3.0x, 3.5x) and 7 of 589 (up to
# 6.4x) on the card: were the kernel's rounding one more draw of the
# spread's size, one tensor beyond 3x the largest of 3 would be a ~3%
# event, beyond 10x one under 1e-3; and the kernel's reads smaller (on
# an H100 with 4 seeds the ratios' median was 0.39-0.41, their 99th
# percentile 1.71-1.72, the largest 2.84-2.91, over 1,253 and 1,279
# tensors). Some norms are set by rounding: the towers' key biases,
# whose gradient vanishes in exact arithmetic (the softmax ignores a
# shift shared by all of a query's scores), and any tensor whose one-ulp
# spread exceeds GRAD_NOISE_SHARE of its norm (on the card the head's
# lora_a at step 1, 1e-14 to 1e-8 behind gates that start at 0, their
# spreads 22-89% of them, the kernel path 0.7-2.2 times them away): those
# are held below the margin times the largest norm the plain runs read
# and, but for the key biases, above the smallest over the margin (on an
# H100 the least kernel reading was 0.48 of the smallest in phase 11,
# 0.76 in phase 21, against 0.038 of the largest: a gating factor's
# scalar norm); so a lost gradient fails everywhere but on a key bias.
# ``tests/test_torch_full_train.py`` and ``tests/test_torch_train.py``
# plant a lost and a halved gradient on the CPU.
GRAD_SPREAD_MARGIN = 10.0
GRAD_NOISE_SHARE = 0.1


def rounding_gradient(name: str) -> bool:
    """A tower's key bias: its gradient is zero in exact arithmetic."""
    return name.startswith("vision_backbone.") and name.endswith(
        ".attn.k_proj.bias")


def one_ulp(t, gen):
    """``t`` with each nonzero finite element moved one ulp of its dtype up
    or down in magnitude, a sign per element drawn from ``gen``."""
    import torch

    bits = {2: torch.int16, 4: torch.int32}[t.element_size()]
    step = torch.randint(0, 2, t.shape, generator=gen, device=t.device,
                         dtype=bits) * 2 - 1
    moved = (t.contiguous().view(bits) + step).view(t.dtype)
    return torch.where((t != 0) & torch.isfinite(t), moved, t)


class attention_ulp_noise:
    """Within the block the plain path's attention
    (``ops.attention.plain_attention``, the forward, and
    ``ops.attention.attention_bwd_reference``, the backward) has each
    element of its output and of its dq, dk, dv moved by one ulp
    (:func:`one_ulp`), the signs drawn from ``seed``: the rounding the
    kernels are held to beside it (B1 within 0.0039, one bf16 ulp at 1),
    put on the plain path at every call."""

    def __init__(self, seed: int, dev):
        self.seed, self.dev = seed, dev

    def __enter__(self):
        import torch

        from vla_adapter_torch.ops import attention

        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        fwd = self._fwd = attention.plain_attention
        bwd = self._bwd = attention.attention_bwd_reference
        attention.plain_attention = lambda *a, **kw: one_ulp(fwd(*a, **kw),
                                                             gen)
        attention.attention_bwd_reference = lambda *a, **kw: tuple(
            one_ulp(g, gen) for g in bwd(*a, **kw))
        return self

    def __exit__(self, *exc):
        from vla_adapter_torch.ops import attention

        attention.plain_attention = self._fwd
        attention.attention_bwd_reference = self._bwd


def plain_spread(tcfg, batch, updates: int, dev: str = "cuda") -> tuple:
    """The plain path's runs that :func:`grads_vs_plain` holds a kernel
    run against, from the seeded init: the batch as it is, and each of
    TENSOR_SPREAD_SEEDS' pixels scaled by 1 +- 2^-8 with one ulp on every
    output of the attention (:class:`attention_ulp_noise`), ``updates``
    updates each, every run taking update u from the state (weights,
    moments) the unperturbed run reached before it: a spread of that
    update alone, not of the runs' drift. Returns (runs, each update's
    starting state) for :func:`kernel_updates_from`."""
    import contextlib

    from vla_adapter_torch.train.step import to_device

    state, step_fn = _train_model(tcfg, "plain", dev)
    seeds = (None,) + TENSOR_SPREAD_SEEDS
    runs = [{"seed": s, "losses": [], "grad_norms_by_update": []}
            for s in seeds]
    batches = {}
    for s in seeds:
        b = dict(batch)
        if s is not None:
            b["pixel_values"] = perturbed_pixels(b["pixel_values"], s)
        batches[s] = to_device(b, dev)
    starts, start = [], _snapshot(state)
    for u in range(updates):
        starts.append(start)
        for run in runs:
            _restore(state, start, u)
            noise = (attention_ulp_noise(run["seed"], dev)
                     if run["seed"] is not None
                     else contextlib.nullcontext())
            with first_grad_squares() as grads, noise:
                loss = step_fn(state, batches[run["seed"]], u)["loss"]
            run["losses"].append(float(loss))
            run["grad_norms_by_update"].append(grads.norms())
            if run["seed"] is None and u + 1 < updates:
                after = _snapshot(state)
        if u + 1 < updates:
            start = after
    del state
    if dev == "cuda":
        import torch

        torch.cuda.empty_cache()
    return runs, starts


def kernel_updates_from(tcfg, batch, starts: list, dev: str = "cuda"
                        ) -> list:
    """The kernel path's gradient norms at each update u >= 1 taken from
    ``starts[u]`` (:func:`plain_spread`'s: where the plain run stood)."""
    from vla_adapter_torch.train.step import to_device

    if len(starts) < 2:
        return []
    state, step_fn = _train_model(tcfg, "kernel", dev)
    device_batch, out = to_device(batch, dev), []
    for u in range(1, len(starts)):
        _restore(state, starts[u], u)
        with first_grad_squares() as grads:
            step_fn(state, device_batch, u)
        out.append(grads.norms())
    del state
    return out


def grads_vs_plain(kernel: dict, plain_runs: list) -> dict:
    """The kernel path's first updates (``kernel``: {"losses",
    "grad_norms_by_update"}, as :class:`first_grad_squares` reads them)
    against the plain path's runs (:func:`plain_spread`, the unperturbed
    run first): the step-0 loss, and each trainable tensor's gradient
    norm at the first recorded update where the plain path's is not zero
    (a LoRA ``lora_a`` at step 1: its ``lora_b`` starts at 0), each
    reading with its spread (the largest distance of a perturbed plain
    run from the plain run) and its ratio to it. A tensor whose plain
    gradient is zero at every recorded update must read zero there; one
    set by rounding (:func:`rounding_gradient`, or a spread beyond
    GRAD_NOISE_SHARE of its norm) at most GRAD_SPREAD_MARGIN times the
    largest norm the plain runs read and, unless a key bias's, at least
    the smallest over GRAD_SPREAD_MARGIN. Returns the readings, worst
    first, and the failures (:func:`check_grads_vs_plain`)."""
    plain, *perturbed = plain_runs
    ref, got = plain["grad_norms_by_update"], kernel["grad_norms_by_update"]
    if len(got) < len(ref) or set(got[0]) != set(ref[0]):
        return {"failures": [f"the kernel run recorded {len(got)} updates "
                             f"of {len(got[0])} tensors, the plain run "
                             f"{len(ref)} of {len(ref[0])}"]}
    failures, rows, zero, rounding = [], [], [], {}

    def reading(what, k, r, ps):
        spread = max(abs(p - r) for p in ps)
        diff = abs(k - r)
        row = {"entry": what, "got": k, "ref": r, "diff": diff,
               "spread": spread, "ratio": diff / spread if spread > 0 else (
                   0.0 if diff == 0 else float("inf"))}
        if not diff <= GRAD_SPREAD_MARGIN * spread:
            failures.append(f"{what}: {row}")
        return row

    loss = reading("step-0 loss", kernel["losses"][0], plain["losses"][0],
                   [p["losses"][0] for p in perturbed])
    for n in sorted(ref[0]):
        u = next((i for i, g in enumerate(ref) if g[n] > 0), None)
        if u is None:
            zero.append(n)
            if any(g[n] != 0 for g in got[:len(ref)]):
                failures.append(f"gradient of {n} is zero on the plain path, "
                                f"not on the kernel path")
            continue
        spread = max(abs(r["grad_norms_by_update"][u][n] - ref[u][n])
                     for r in perturbed)
        # a key bias's norm, zero in exact arithmetic, may be zero in fp32
        # too; any other gradient the plain path reads must arrive
        if not (got[u][n] > 0 or rounding_gradient(n)):
            failures.append(f"step-{u} gradient of {n} is zero on the "
                            f"kernel path, {ref[u][n]} on the plain path")
        if rounding_gradient(n) or spread > GRAD_NOISE_SHARE * ref[u][n]:
            norms = [r["grad_norms_by_update"][u][n] for r in plain_runs]
            rounding[n] = {"step": u, "got": got[u][n],
                           "plain_min": min(norms), "plain_max": max(norms),
                           "spread_share": spread / ref[u][n]}
            if not (got[u][n] <= GRAD_SPREAD_MARGIN * max(norms) and (
                    rounding_gradient(n)
                    or got[u][n] >= min(norms) / GRAD_SPREAD_MARGIN)):
                failures.append(f"rounding gradient of {n}: {rounding[n]}")
            continue
        rows.append(dict(reading(
            f"step-{u} gradient norm of {n}", got[u][n], ref[u][n],
            [p["grad_norms_by_update"][u][n] for p in perturbed]), step=u))
    rows.sort(key=lambda r: -r["ratio"])
    ratios = [r["ratio"] for r in rows]
    # a halved gradient moves a norm by half of it: caught where that is
    # beyond the margin times the spread
    halving = [r["spread"] * GRAD_SPREAD_MARGIN < r["ref"] / 2 for r in rows]
    return {"loss": loss, "tensors_held": len(rows),
            "tensors_held_by_step": dict(collections.Counter(
                r["step"] for r in rows)),
            "worst": rows[:8], "worst_ratio_to_spread": ratios[0],
            "ratio_quantiles": {q: ratios[int(len(ratios) * (1 - q))]
                                for q in (0.5, 0.9, 0.99)},
            "ratios_above": {m: sum(x > m for x in ratios)
                             for m in (1, 3, GRAD_SPREAD_MARGIN)},
            "halving_caught_share": sum(halving) / len(halving),
            "zero_gradient_tensors": zero, "rounding_gradients": rounding,
            "spread_seeds": [r["seed"] for r in perturbed],
            "spread_margin": GRAD_SPREAD_MARGIN, "failures": failures}


def check_grads_vs_plain(rec: dict, what: str) -> None:
    if rec["failures"]:
        raise AssertionError(f"{what}: {len(rec['failures'])} readings "
                             f"beyond the plain path's one-ulp spread: "
                             f"{rec['failures'][:5]}")


def full_train_config(seed: int):
    """``FULL_TRAIN_RECIPE``'s TrainConfig at one rank of its
    expected_devices (its rows a rank as micro-batches of
    FULL_TRAIN_MICRO), FULL_TRAIN_STEPS steps, the closing checkpoint
    the only one."""
    from vla_adapter_torch.core.experiments import get_experiment

    exp = get_experiment(FULL_TRAIN_RECIPE)
    tcfg = exp.to_train_config()
    rows = exp.global_batch_size // exp.expected_devices
    return dataclasses.replace(
        tcfg, batch_size=rows,
        grad_accumulation_steps=rows // FULL_TRAIN_MICRO,
        seed=seed, log_freq=100, save_freq=10 * FULL_TRAIN_STEPS,
        optim=dataclasses.replace(tcfg.optim, max_steps=FULL_TRAIN_STEPS))


def phase_full_train(card: str, seed: int) -> tuple:
    """Phase 21 (see the module docstring). Returns (record, launches of
    the main run)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import w8a8_matmul
    from vla_adapter_torch.train import loop
    from vla_adapter_torch.train.checkpoints import (
        find_resume_checkpoint,
        load_checkpoint,
    )
    from vla_adapter_torch.train.partition import mark_trainable_

    dev = DEVICE
    tcfg = full_train_config(seed)
    cfg, accum = tcfg.model, tcfg.grad_accumulation_steps
    if tcfg.lora.enabled or tcfg.base_int8 or not tcfg.remat_llm:
        raise AssertionError(f"{FULL_TRAIN_RECIPE} is not a full-train "
                             f"recipe over a float base with remat")
    rec = {"card": card, "recipe": FULL_TRAIN_RECIPE,
           "rows_per_rank": tcfg.batch_size, "micro_batches": accum,
           "steps": FULL_TRAIN_STEPS, "seconds": {}}
    t_last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name], t_last[0] = now - t_last[0], now

    batch = make_dummy_batch(cfg, tcfg.batch_size,
                             np.random.default_rng(seed), accum_steps=accum)
    # B1 and B1-bwd at this recipe's LLM shape (its dummy batch's padding;
    # the towers' shapes are phase 11's)
    tv = batch["text_valid"][0]
    valid = np.concatenate([tv[:, :1], np.ones((FULL_TRAIN_MICRO,
                                                cfg.num_patches), np.int32),
                            tv[:, 1:]], 1)
    llm = cfg.llm
    rec["b1"] = phase_kernel_vs_plain([(
        "llm_full_train", FULL_TRAIN_MICRO, FULL_TRAIN_MICRO, llm.num_heads,
        llm.num_kv_heads, valid.shape[1], llm.head_dim, valid, False, 0)])
    rec["b1_bwd"] = phase_attention_bwd([(
        "llm_full_train", FULL_TRAIN_MICRO, llm.num_heads, llm.num_kv_heads,
        valid.shape[1], llm.head_dim, valid, False, 0)], card)
    lap("1 attention")

    meta = VLAModel(cfg, loop.build_runtime(tcfg), device="meta")
    names = mark_trainable_(meta, tcfg.lora.enabled)
    per_micro = expected_train_launches(meta)
    if per_micro[w8a8_matmul.KERNEL_NAME] != 0 or len(names) != len(
            list(meta.parameters())):
        raise AssertionError(f"full train: {len(names)} trainable tensors "
                             f"of {len(list(meta.parameters()))}, B4 "
                             f"launches derived {per_micro}")
    per_micro = {k: v for k, v in per_micro.items() if v}
    rec["parameters"] = sum(p.numel() for p in meta.parameters())
    del meta

    root = Path(tempfile.mkdtemp(prefix="vla_full_train_"))
    save, timed = loop.save_checkpoint, {}

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*args, **kw)
        timed["write_s"] = time.perf_counter() - t0
        return out

    try:
        # 1. the main path: finetune over every tensor, with the closing
        # checkpoint
        loop.save_checkpoint = timed_save
        try:
            with first_grad_squares() as grads:
                state, launches, wall, memory = _train_run(
                    tcfg, batch, FULL_TRAIN_STEPS, root / "main")
        finally:
            loop.save_checkpoint = save
        losses = [h["loss"] for h in state.history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"full train losses {losses}")
        _check_train_launches(launches, per_micro, accum * FULL_TRAIN_STEPS,
                              "full train")
        step_s = statistics.median(h["step_time"]
                                   for h in state.history[2:])
        main = {"losses": losses, "median_s_per_step_3_6": step_s,
                "samples_per_s": tcfg.batch_size / step_s, "wall_s": wall,
                **memory, "launches": launches,
                "launches_per_micro_batch_derived": per_micro,
                "trainable_tensors": len(state.trainable),
                "trainable_params": rec["parameters"],
                "checkpoint_write_s": timed.get("write_s")}
        print("full_train_main " + json.dumps(dict(main, card=card)),
              flush=True)
        rec["main"] = main
        kernel = {"losses": losses, "grad_norms_by_update": [grads.norms()]}
        lap("2 finetune")

        # 2. the checkpoint read back by load_checkpoint: every tensor and
        # both moments bit for bit with the state that wrote it
        ckpt = find_resume_checkpoint(root / "main" / tcfg.run_id)
        files = sorted(p.name for p in ckpt.iterdir())
        written = {n: p.detach().clone() for n, p in state.trainable.items()}
        moments = state.opt_state
        t0 = time.perf_counter()
        load_checkpoint(ckpt, state)
        read_s = time.perf_counter() - t0
        bad = [n for n, p in state.trainable.items()
               if not torch.equal(p, written[n])]
        for part in ("mu", "nu"):
            if set(state.opt_state[part]) != set(written):
                raise AssertionError(f"checkpoint: {part} misses tensors")
            bad += [f"{part}/{n}" for n, v in state.opt_state[part].items()
                    if not torch.equal(v.to(dev), moments[part][n])]
        if bad or state.step != FULL_TRAIN_STEPS or \
                "frozen.safetensors" in files or \
                int(state.opt_state["count"]) != int(moments["count"]):
            raise AssertionError(f"full-train checkpoint: {len(bad)} tensors "
                                 f"differ ({bad[:5]}), step {state.step}, "
                                 f"files {files}")
        rec["checkpoint"] = {
            "files": files, "bytes": sum(p.stat().st_size
                                         for p in ckpt.iterdir()),
            "write_s": timed.get("write_s"), "read_s": read_s,
            "tensors_and_moments_bitwise": True}
        print("full_train_checkpoint " + json.dumps(dict(rec["checkpoint"],
                                                        card=card)),
              flush=True)
        del state, written, moments
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        lap("3 checkpoint")

        # 3. the kernel path against the plain path's one-ulp spread
        runs = plain_spread(tcfg, batch, 1, dev)[0]
        rec["vs_plain"] = grads_vs_plain(kernel, runs)
        print("full_train_vs_plain " + json.dumps(dict(
            rec["vs_plain"], plain_losses=[r["losses"] for r in runs],
            card=card)), flush=True)
        check_grads_vs_plain(rec["vs_plain"], "full train")
        lap("4 vs plain")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("full_train_seconds " + json.dumps(rec["seconds"]), flush=True)
    return rec, launches


def full_train_phase(card: str, seed: int, lap) -> tuple:
    """Phase 21, lapped: (record, launches per step)."""
    t0 = time.perf_counter()
    rec, launches = phase_full_train(card, seed)
    m, ckpt = rec["main"], rec["checkpoint"]
    worst = rec["vs_plain"]["worst_ratio_to_spread"]
    print(f"full_train {FULL_TRAIN_RECIPE}: {rec['parameters'] / 1e9:.3f} B "
          f"parameters, all trained, {rec['rows_per_rank']} rows a step as "
          f"{rec['micro_batches']} x {FULL_TRAIN_MICRO}: "
          f"{m['median_s_per_step_3_6']:.3f} s/step (median of steps 3-6), "
          f"{m['samples_per_s']:.1f} samples/s, peak "
          f"{m['max_memory_allocated_bytes'] / 2**30:.2f} GiB; checkpoint "
          f"{ckpt['bytes'] / 1e9:.2f} GB written in {ckpt['write_s']:.1f} s, "
          f"read in {ckpt['read_s']:.1f} s; kernel vs plain worst "
          f"{worst:.2f} x the spread ({card})", flush=True)
    print(f"phase 21 seconds: {time.perf_counter() - t0:.1f} ({card})",
          flush=True)
    lap("21 full train")
    return rec, {k: v // FULL_TRAIN_STEPS for k, v in launches.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also profile one B=1 request per tier and "
                             "one B=4 request of the w8a8 \"fused\" and "
                             "\"dense\" tiers, eager and replayed "
                             "(torch.profiler)")
    parser.add_argument("--only", default="",
                        help="comma-separated phases among 11-21 to run "
                             "after the build, skipping phases 2-10; such a "
                             "partial run prints no kernels or ok line")
    # phase 18's training under a process group runs in a child process
    # started with this flag (the file its record goes to), and phase 19's
    # ranks in child processes started with the three after it
    parser.add_argument("--group-train-child", help=argparse.SUPPRESS)
    parser.add_argument("--tensor-child", help=argparse.SUPPRESS)
    parser.add_argument("--tensor-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tensor-port", type=int, help=argparse.SUPPRESS)
    # and phase 20's runs in child processes started with these two
    parser.add_argument("--fsdp-memory-child", help=argparse.SUPPRESS)
    parser.add_argument("--fsdp-memory-run", type=int,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    only = {int(p) for p in args.only.split(",") if p}
    if only - set(range(11, 22)):
        parser.error(f"--only takes phases among 11-21, got {args.only}")

    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import vla_adapter_torch
    from vla_adapter_torch.ops import cuda_lib

    pkg = os.path.dirname(os.path.abspath(vla_adapter_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: vla_adapter_torch comes from {pkg}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    if args.group_train_child:
        group_train_child(args.group_train_child, args.seed, args.profile)
        return 0
    if args.tensor_child:
        tensor_train_child(args.tensor_rank, args.tensor_port,
                           args.tensor_child, args.seed)
        return 0
    if args.fsdp_memory_child:
        fsdp_memory_child(args.fsdp_memory_child, args.seed,
                          args.fsdp_memory_run)
        return 0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    phase_s = {}
    t_start = time.perf_counter()

    def lap(name):  # wall seconds of each phase, printed and kept
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    cuda_lib.load_libraries(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for source in SOURCES:
        for line in cuda_lib.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: " + line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    lap("1 build")

    if only:
        causal = {}
        if 11 in only:
            from vla_adapter_torch.core.config import VLAConfig

            causal["train"] = phase_train(VLAConfig(), card, args.seed,
                                          profile=args.profile)[0]
            lap("11 train")
        if only & {12, 13, 14, 15}:
            cfg, predictor, n_params, _ = build_flagship(args.seed)
            causal = causal_language_path(predictor, cfg, card, args.seed,
                                          only, lap)
            del predictor
        if 16 in only:
            causal["zoo"], _, causal["zoo_kernels"] = zoo_phase(card,
                                                                args.seed,
                                                                lap)
        if 17 in only:
            causal["finetune_rlds"], _ = rlds_phase(card, args.seed, lap)
        if 18 in only:
            cfg, predictor, _, _ = build_flagship(args.seed)
            causal["eval_group"], _ = eval_and_group_phase(
                predictor, w8a8_shapes(cfg, predictor.tokenize), card,
                args.seed, lap, profile=args.profile)
            del predictor
        if 19 in only:
            from vla_adapter_torch.core.config import VLAConfig

            causal["tensor"], _ = tensor_phase(VLAConfig(), card, args.seed,
                                               lap)
        if 20 in only:
            causal["fsdp_memory"], _ = fsdp_memory_phase(card, args.seed,
                                                         lap)
        if 21 in only:
            causal["full_train"], _ = full_train_phase(card, args.seed, lap)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "phase_s": phase_s, **causal}, f,
                          indent=1)
        print(f"card: {card}", flush=True)
        print(f"partial run (phases {sorted(only)}): no kernels line",
              flush=True)
        return 0

    # 2. attention kernel vs plain at the main path's shapes
    cfg, predictor, n_params, rng = build_flagship(args.seed)
    print(f"flagship: {n_params / 1e9:.3f} B parameters in bf16", flush=True)
    records = phase_kernel_vs_plain(attention_shapes(cfg, predictor.tokenize)
                                    + [seven_b_attention_shape(args.seed)[0]])
    records += phase_kernel_vs_plain(b1_row_shapes(), B1_ROW_TIMING, 2)
    lap("2 attention")

    # 3. the w8a8 kernels vs plain at the w8a8 main path's shapes
    shapes = w8a8_shapes(cfg, predictor.tokenize)
    w8a8_records = phase_w8a8_kernels(shapes)
    (mega,) = [r for r in w8a8_records if "fused_chain_ms" in r]
    print(f"megalayer: {1e3 * mega['ms']:.1f} us per call, the fused "
          f"backend's launches of the same layer "
          f"{1e3 * mega['fused_chain_ms']:.1f} us", flush=True)
    lap("3 w8a8 kernels")

    # 4. the on-card weight quantizer
    quantizer = phase_quantizer(predictor.params)
    lap("4 quantizer")

    # 5. the bf16 flagship forward through Predictor
    flagship, launches = phase_flagship(predictor, rng, card)
    print(f"kernels launched on the bf16 main path: {sorted(launches)}",
          flush=True)
    lap("5 flagship bf16")

    # 6. the w8a8 and int8 flagship forwards through Predictor
    w8a8, w8a8_launches = phase_w8a8(predictor, shapes, rng, card)
    print(f"kernels launched on the w8a8 main path: {sorted(w8a8_launches)}",
          flush=True)
    lap("6 flagship w8a8")

    # 7. every tier as a CUDA graph against eager
    graphs = phase_graph(predictor, rng, card, profile=args.profile)
    lap("7 graphs")

    # 8. the flagship exported and loaded back without JAX
    checkpoint = phase_checkpoint(predictor, rng, card)
    lap("8 checkpoint")

    # 9. the /act server with dynamic batching (path A)
    server, server_launches = phase_server(predictor, card)
    print(f"kernels launched on the server path: {sorted(server_launches)}",
          flush=True)
    lap("9 server")

    # 10. the original head with FiLM towers, every tier (path B)
    original, original_launches = phase_original_film(predictor, rng, card,
                                                      args.seed)
    print(f"kernels launched on the original model's path: "
          f"{sorted(original_launches)}", flush=True)
    lap("10 original_film")

    # 11. the finetune path: B1-bwd, the STE product, the flagship finetune
    train, train_launches, bwd_records = phase_train(cfg, card, args.seed,
                                                     profile=args.profile)
    print(f"kernels launched on the train path: {sorted(train_launches)}",
          flush=True)
    lap("11 train")

    # 12-15. the causal language path
    causal = causal_language_path(predictor, cfg, card, args.seed,
                                  {12, 13, 14, 15}, lap)

    # 16. the model zoo at 7B, with the flagship's models freed first
    del predictor
    zoo, zoo_paths, zoo_kernels = zoo_phase(card, args.seed, lap)

    # 17. finetuning on demonstrations through the RLDS pipeline
    rlds, rlds_launches = rlds_phase(
        card, args.seed, lap,
        dummy_s_per_step=train["main"]["median_s_per_step_from_3"])

    # 18. closed-loop evaluation and training under a process group, on
    # the flagship built again (phase 16 freed it)
    cfg, predictor, _, _ = build_flagship(args.seed)
    eval_group, eval_paths = eval_and_group_phase(predictor, shapes, card,
                                                  args.seed, lap,
                                                  profile=args.profile)
    del predictor

    # 19. the "tensor" mesh axis: B4's int32 output at the split shapes,
    # B1/B1-bwd at each rank's heads, the recipe at tensor 2 on two ranks
    tensor, tensor_launches = tensor_phase(cfg, card, args.seed, lap,
                                           reference=train["main"])

    # 20. "fsdp" memory: rank 0 of the 7B full-train recipe at 8 ranks and
    # of the flagship LoRA recipe at 4, under the fake process group
    fsdp_memory, fsdp_paths = fsdp_memory_phase(card, args.seed, lap)

    # 21. the full-train recipe: every tensor trained over a float base
    full_train, full_train_launches = full_train_phase(card, args.seed, lap)
    kernels = (kernel_summary(records, launches)
               + w8a8_kernel_summary(w8a8_records, w8a8_launches)
               + megalayer_kernel_summary(w8a8_records, w8a8_launches)
               + attention_bwd_kernel_summary(bwd_records, train_launches)
               + quantize_kernel_summary(train["ste"], train_launches)
               + tensor_kernel_summary(tensor, tensor_launches))
    paths = {"flagship_bf16": launches, "flagship_w8a8": w8a8_launches,
             "server": server_launches, "original_film": original_launches,
             "train": train_launches, **causal["launches_by_path"],
             **zoo_paths, "finetune_rlds": rlds_launches, **eval_paths,
             "finetune_tensor": tensor_launches, **fsdp_paths,
             "finetune_full": full_train_launches}
    for entry in kernels:
        entry["launches_by_path"] = {path: counts.get(entry["name"], 0)
                                     for path, counts in paths.items()}
        entry["zoo_7b"] = zoo_kernels.get(entry["name"], [])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": records,
                       "w8a8_shapes": w8a8_records, "quantizer": quantizer,
                       "flagship": flagship, "flagship_w8a8": w8a8,
                       "graph": graphs, "checkpoint": checkpoint,
                       "server": server, "original_film": original,
                       "train": train, "attention_bwd_shapes": bwd_records,
                       **causal, "zoo": zoo, "finetune_rlds": rlds,
                       "eval_group": eval_group, "tensor": tensor,
                       "fsdp_memory": fsdp_memory, "full_train": full_train,
                       "kernels": kernels, "phase_s": phase_s}, f, indent=1)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
