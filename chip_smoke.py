#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tf_operator_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints its own lines; any failure raises and exits non-zero):
  card     the card's name and power limit (nvidia-smi), torch and CUDA versions
  build    nvcc-builds the kernels from ops/csrc (one process per part of
           the source, all at once), prints the build time and each
           instantiation's registers and spills (ptxas), and fails if any
           instantiation spills or the built instantiations are not
           attention.INSTANTIATED's; prints each cluster kernel's shared
           memory beside a block's 232,448 bytes and the clusters the card
           holds at once (cudaOccupancyMaxActiveClusters)
  kernels  each hand-written kernel (flash forward, dq, dk/dv) against its
           plain PyTorch version in f32 on the same inputs, at the LM's
           main-path shape and at GQA / ragged T / non-causal / window+sink /
           head_dim 128, and since the tenth slice in fp16 and f32, at head
           dims 32, 80 and 100, scales -0.125 and 0, batch*heads 70,400 and
           blocks (256, 512) and (8, 128), and since the twelfth slice at
           head dims 160-256 (Gemma 2B's 8 query heads of 256 over one KV
           head at B 4, T 2048 in bf16, fp16 and f32; non-causal, window +
           sink, scale -0.0625, head dims 160 and 250), and since the
           thirteenth slice 6 query heads over one KV head (dk/dv's query
           heads split over 5 slices, which do not divide 6) and the sum of
           dk/dv's slices (`dkv_reduce`, bit for bit its plain version, its
           time against its bytes and, since the fourteenth slice,
           `ws.sum(1)`'s), each printing the
           tiles its blocks resolve to and dk/dv's slices; prints the error
           against the stated
           tolerance (f32: RTOL_F32, FRO_F32), the
           kernel's time, the plain version's, the bound, and as a yardstick
           only F.scaled_dot_product_attention's (which the port never calls):
           its forward beside the forward kernel, its backward alone
           (autograd.grad on a retained graph) beside dq + dk/dv, and since
           the fourteenth slice, at head dims 129-256, the forward's and
           SDPA's forward's device time by the profiler, and since the
           fifteenth slice at the encoders' shapes (vit_b16, bert_base and
           their tp 2 halves, where the forward and dk/dv, and since the
           sixteenth slice dq, take the encoders' kernels:
           attention.short_route) all three kernels' and SDPA's forward's
           and backward's device time (since the sixteenth slice at
           gpt_small_tp2 and llama_tp2 too); since the seventeenth slice
           at head dims above 256, the sliced kernels (attention.SLICED):
           4 query heads of 512 over one KV head at B 4, T 2048 in bf16,
           fp16 and f32 (d512_mqa), head dims 264, 300 (padded to 304),
           384 non-causal, 512 with window + sink and at scale -0.0625
           with GQA 8/2, and 1024, all three kernels' device time and
           SDPA's beside the kernel SDPA ran (its backend); since the
           eighteenth slice dq and dk/dv there on the cluster kernels
           (attention.cluster_route: every launch theirs, the count
           checked per case), SDPA timed also under its memory-efficient
           backend with K and V expanded to the query heads as views (the
           kernels line's library_ms where it runs; its math path under
           library_math_ms), and head dim 2112 (above the cluster's reach:
           the sliced dq and dk/dv, no cluster launch); since the
           nineteenth slice the forward up to head dim 512 in bf16 and fp16
           on the pair kernel (attention.pair_route: every launch its, the
           count checked per case; d1024 and d2112 on the sliced forward,
           whose kernels-line row is d2112's); each kernel launched a
           second time on the same inputs must give the same bits
  autotune the tenth slice: every instantiation (each dtype, head-dim
           class 64, 128 and 256, tile and forward route) against its plain version at a
           ragged causal shape with a window and a sink (since the
           fifteenth slice also at T 200, the encoders' kernels, dq's
           since the sixteenth);
           `ops/autotune.tune_flash_blocks` in bf16 at GPT-small, ViT-B/16
           and BERT-base, each candidate's fwd+bwd ms and tiles and the
           winner against (128, 128), no candidate failing; the caches (a
           second call launches nothing, after _CACHE.clear() the file
           serves it, a changed kernel hash searches again); the LM (5
           steps) on the GPT-small winner through TPUJOB_FLASH_BLOCK_Q/K,
           its losses within TOL_PIPE_LOSS of the slice phase's run on the
           default blocks and 12 launches a step of each kernel
  slice    the LM workload (`workloads.lm.main`) at GPT-small full width
           (12 x 768, seq 2048, batch 8, vocab 32000) for 6 steps with
           checkpoints, checking every kernel launched 12 x steps times; a
           resumed run to step 11 checks the resume and that the loss fell;
           a third run reads its own step time (step ms, tokens/s, peak
           memory) and a fourth profiles two steps through its --profile-dir
  llama    the llama/GQA arch through the workload (4 layers, 2 steps) with
           the same launch check, and a small model whose logits with the
           kernels agree with the plain attention path on the card
  gemma    the twelfth path: the llama-style LM at Gemma 2B's attention
           widths (d_model 2048, 18 layers, 8 query heads of 256 over one
           KV head, d_ff 5461, vocab 32000; ~0.84 B params) from seeded
           weights, 6 steps at B 4, T 2048 through the LM workload's train
           step, loss and AdamW recipe, and 2 more under the profiler: 18
           launches a step of each kernel (their head-dim class 256) and,
           since the thirteenth slice, of the sum of dk/dv's slices where
           `dkv_splits` splits it, losses finite, step ms, tokens/s, MFU,
           peak memory, device time by kernel; then 2 layers of it with
           the kernels against the plain attention path (the logits
           rule)
  wide_head the seventeenth slice: the same at Gemma 2B's widths with its 8
           query heads of 256 regrouped into 4 of 512 over one KV head
           (~0.86 B params; no public model has these widths): 6 + 2
           steps, 18 launches a step of each kernel, every one the sliced
           kernels' (head dims above 256) and since the eighteenth slice
           every dq and dk/dv launch the cluster kernels' and since the
           nineteenth every forward launch the pair kernel's, losses finite
           and falling (as the gemma phase's since then), step ms,
           tokens/s, MFU, peak memory, device time by kernel; 2 layers of
           it against the plain attention path; then the LM with one head
           of 2112 (2 layers, B 1, T 1024, 2 steps), above the pair's and
           the cluster's reach, whose launches are the sliced kernels'
  f32      `flash_attention` on f32 tensors (no workload computes in f32)
           at main_f32, gemma_2b_f32 and d512_mqa_f32, forward and
           backward under autograd, each kernel launched once (f32 dq and
           dk/dv on the tensor cores, on their clusters at d512_mqa_f32),
           the gradients against the plain versions in f64 by the f32
           rule and against the plain attention's autograd as a whole
  lse      `flash_attention_lse` (the kernels through their (o, lse) entry)
           forward and backward with cotangents on both outputs, at ring-hop
           shapes of GPT-small (T 1024 = 2048 / sp 2, T 512 = 2048 / sp 4;
           causal and not; GQA 12/4; head_dim 128; head_dim 256 over GQA
           8/1), against f32 autograd of the plain `attention_lse`; a planted fault (the backward given
           delta where it needs delta' = delta - dlse) must be rejected
  ring     ring attention's hop loop (`ring_hops`) for every rank of n = 2
           and 4, in one process, the blocks handed over in place of the
           ring shift, against the plain f32 attention over the whole
           sequence (by the kernel rule; its backward given the ring's f32
           merge, whose rowsum(dO * O) the hops' backward reads) and
           `flash_attention` (as a whole), output and dq/dk/dv; at n = 4 a ring that leaves out
           its last shift (a planted fault) must fail; prints the hop
           launches (causal: n(n+1)/2 forward hops per layer) and the hops'
           summed time beside one full forward and backward
  dist     the LM workload at GPT-small width through the distributed step
           over a one-rank NCCL group (the group made here: the workload
           makes none for one process), 11 steps, against the plain
           one-process run: losses equal within 1e-5 relative, step times
           taken in turns; then two profiled steps in the group and the
           gradient all-reduce alone
  resnet   the third path: the ResNet workload (`workloads.resnet.main`) at
           full width (ResNet-50, 224x224, batch 256, bf16 convs, SGD) on
           the native image loader, which the log must name: loss finite at
           every step, step time and images/s from its step time line, MFU
           from the convs' and the head's FLOPs (counted from their shapes
           in a forward pass), peak memory, two profiled steps (idle share,
           top device operations); then the bf16 model's train-mode logits
           against the f32 model's with the same weights (every block's
           last BatchNorm scale set to 0.1 so the residual branches count)
           on the same batch
  vit      the ViT workload at ViT-B/16 width (224x224, patch 16: T 197,
           batch 256) and
  bert     the BERT workload at BERT-base width (T 128, batch 32): each as
           resnet, plus the kernels' launches (12 per step each, counted
           from zero just before the run; since the fifteenth slice every
           forward and dk/dv launch, and since the sixteenth every dq
           launch, must be the encoders' kernels', which the kernels line
           lists apart), and the model's logits with the
           kernels against the same model on the plain attention path;
           for bert one more plain run whose losses, in full precision,
           must equal the workload run's over the 10 steps
  shard    the fourth path: the LM workload at GPT-small width over a
           one-rank NCCL group with the mesh {"fsdp": 1, "tp": 1} (FSDP2
           per block and the tensor-parallel layout, each at size 1),
           11 steps, between two plain runs: losses equal within 1e-5
           relative, 12 launches per step of each kernel, step ms, tokens/s
           and peak memory, two profiled steps, a checkpoint saved under
           the mesh resumed by a plain run; and the ZeRO plan's optimizer
           bytes per rank for GPT-small at dp 8, computed
  encoder_mesh the eighth path: ViT-B/16 and BERT-base under {"tp": 1}
           (the tensor-parallel layout on 1-way slices, BERT's
           vocab-sharded lookup) and under {"dp": 1, "fsdp": 1} with the
           ZeRO knob (dense at dp 1, as the JAX workload), and the LM
           under the latter, each over a one-rank NCCL group in turns
           with two plain runs: losses equal within 1e-5 relative, 12
           launches per step of each kernel, step ms, items/s, peak
           memory; and what the ZeRO plan shards at {"dp": 2, "fsdp": 4}
           (how many entries on a head_dim), computed.  The kernel cases
           vit_b16_tp2 and bert_base_tp2 hold the kernels at one tp
           rank's heads, the ring cases bert_n2_full and bert_n4_full at
           BERT's per-shard lengths under sp 2 and 4
  pod      the ninth path: GPT-small at full width through the per-pod
           launcher (`workloads.launch --local-ranks 1`, the spawn path at
           L = 1), its one child over a one-rank NCCL group, 11 steps: the
           child's losses in full precision equal to the encoder_mesh
           phase's two in-process plain runs, its kernels launched 12
           times a step each, step ms and tokens/s beside theirs; then
           SIGTERM to the launcher alone after the first checkpoint (2
           layers, 15 steps): exit 143, the child gone, the saved state
           restored bit for bit, and the rerun resumes from it and
           finishes
  mnist    the fifth path, the small workloads: the MNIST workload
           (`workloads.mnist.main`, BASELINE config 1) with the MLP and the
           CNN at the JAX defaults (B 64, Adam 1e-3), 200 steps each: final
           loss below 1.0, step time and images/s from its step time line,
           two profiled steps (idle share); the TF32 settings in force; each
           model's logits on the card against the same weights in f32 on
           the CPU, with cuDNN's TF32 off (TOL_MNIST_F32) and on (TOL_LOGITS)
  preempt  BASELINE config 5: an MNIST run with --checkpoint-dir and
           --preempt-at-step 5 must exit 143; the state restored from that
           checkpoint equals the saved one bit for bit; the rerun prints
           `resumed from checkpoint step 5` and finishes
  dist_mnist BASELINE config 2: 2 PS + 4 workers started here as processes
           with TF_CONFIG (the PS in host memory, the four workers on the
           card), 200 steps, once per transport (python, native): every
           worker's final loss finite and below 1.5; worker steps/s and the
           pull and push ms per step from the workers' logs
  estimator chief + worker + 1 PS + evaluator as processes: DONE published
           and at least one checkpoint evaluated
  multislice `workloads.multislice_check` as 4 processes on the card with
           the env the controller injects for 4 workers of a 2-host slice
           topology (2 slices): one NCCL group (no NCCL communicator is
           made), the fabric table gathered over gloo and checked
  smoke    `workloads.smoke` (a bf16 1024 x 1024 matmul, checksum n^3) and
           `workloads.allreduce_check` at one process (its early exit: NCCL
           refuses two ranks on one card)
  decode   the sixth path: `models.generate.generate` at GPT-small full
           width from seeded weights, B 8, a 1024-token prompt, 128 greedy
           tokens, with the bf16 cache, the int8 cache and llama (4 KV
           heads, RoPE) with window 256 + sink 4 (a 260-slot rolling
           cache): prefill ms, median ms per token, decode tokens/s, cache
           bytes, peak memory, no kernel launched (the decode path is the
           plain one, as the JAX package's); each step's logits held by
           the model-logits rule against the training forward on the
           kernels over the generated sequence, and the greedy tokens
           equal to the forward's wherever its top-2 margin exceeds the
           rule; the int8 cache fed the bf16 run's tokens agrees with its
           greedy choices at least 0.9 of the steps; then `lm.py --steps 2
           --sample-tokens 32` prints a 40-token sample
  moe      `lm.py --moe-experts 8` at GPT-small defaults (top-2, capacity
           factor 1.25, 6 MoE blocks), 11 steps: 12 launches per step of
           each kernel, loss and load-balancing loss finite, the loss
           falling, step ms, tokens/s, peak memory; the same over a
           one-rank NCCL group with {"dp": 1, "ep": 1}: equal losses; two
           profiled steps; one MoE layer on the card against its CPU f32
           run with the card's dispatch (tokens the CPU routes otherwise
           counted apart)
  pipeline the seventh path: `models/pipeline_lm.PipelinedTransformerLM`
           at GPT-small width (T 2048, B 8) as the JAX package's pp dryrun
           arms drive it.  Over a one-rank NCCL group with
           TPUJOB_MESH_SHAPE={"pp": 1}, at M 4 and M 8: GPipe, 1F1B and
           1F1B's primal under autograd (GPipe's forward, the head per
           microbatch): 1F1B's loss within 1e-4 relative of GPipe's, its
           gradients by the per-leaf rule against its primal's, and the
           primal's against GPipe's by the head-tiling rule, one profiled
           step of GPipe and 1F1B each (device busy, idle share); three
           SGD steps, the interleaved schedule at V 2, M 1; then every
           rank of P 2 (M 4) and P 4 (M 8) in this process (the hops as
           hand-overs, the times serialising the ranks), GPipe against the
           one-rank GPipe and 1F1B against the one-rank primal at the same
           M; two 1F1B faults planted at P 4 (invalid forwards that
           overwrite their slot; a backward that re-runs the previous
           microbatch's input) must leave the rule.  Each run: ms,
           tokens/s, peak memory, and each kernel's launches held to the
           schedule's count (M x 12 each; 1F1B's forward kernel twice
           that)
  hlo      the eleventh path: `analysis/hlo.capture_workload` at full
           width (each workload's own `build` at its defaults) over a
           one-rank NCCL group with the ZeRO knob (dense at dp 1): one
           recorded step each of GPT-small (B 8, T 2048), ViT-B/16
           (B 256), BERT-base (B 32) and ResNet-50 in bf16 (B 256, SGD
           momentum), each printing its collective signature, the peak
           (over a plain step, net of what the process held before),
           resident bytes and the admission lower bound, and the kernels'
           launches in the recorded step; held: no finding under the
           card's memory, peak >= the lower bound, half the peak fires
           hlo-memory-infeasible alone, 12 launches of each kernel in
           the transformer steps, the gradient all-reduce over a group
           of 1, and since the fourteenth slice the bytes still allocated
           once the capture is deleted and cuBLAS's workspaces cleared
           (none); then
           `python -m tf_operator_tpu_torch.analysis --hlo
           all --devices 1`, its rank on the card, exit 0

The last lines are the card line, one JSON object with every kernel's
numbers (`ms` and `library_ms` by CUDA events around back-to-back calls,
the host inside, for every row; `device_ms` and `library_device_ms` by
the profiler where measured, else null), and `{"ok": true, "device":
{...}}`.  With `--out-dir DIR` the
longer output (compiler report, profile summary) is also written under DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional, Tuple

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 and fp16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores
# f32 products on the tensor cores in three TF32 passes (f32 dq and dk/dv:
# csrc/tf32.cuh): three products at the TF32 rate for each f32 one
TF32_PASSES = 3
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SOURCE = "tf_operator_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "flash_forward": "tf_operator_tpu/ops/attention.py:255",
    "flash_backward_dq": "tf_operator_tpu/ops/attention.py:419",
    "flash_backward_dkv": "tf_operator_tpu/ops/attention.py:485",
    # the sum of dk/dv's slices: the second pass of dk/dv's port (the
    # Pallas kernel carries the group's sum in VMEM along its grid)
    "dkv_reduce": "tf_operator_tpu/ops/attention.py:485",
    # the encoders' kernels (T <= 256 at head-dim class 64) behind the
    # three wrappers
    "flash_forward_short": "tf_operator_tpu/ops/attention.py:255",
    "flash_backward_dq_short": "tf_operator_tpu/ops/attention.py:419",
    "flash_backward_dkv_short": "tf_operator_tpu/ops/attention.py:485",
    # the sliced kernels (head dims above 256) behind the three wrappers
    "flash_forward_sliced": "tf_operator_tpu/ops/attention.py:255",
    "flash_backward_dq_sliced": "tf_operator_tpu/ops/attention.py:419",
    "flash_backward_dkv_sliced": "tf_operator_tpu/ops/attention.py:485",
    # the cluster kernels (dq and dk/dv up to attention.CLUSTER_LD)
    "flash_backward_dq_cluster": "tf_operator_tpu/ops/attention.py:419",
    "flash_backward_dkv_cluster": "tf_operator_tpu/ops/attention.py:485",
    # the pair forward (up to attention.PAIR_LD)
    "flash_forward_pair": "tf_operator_tpu/ops/attention.py:255",
    # f32 dk/dv on the tensor cores (dkv_tf32_kernel, every f32 launch): at
    # the head-dim classes, and on its cluster above 256
    "flash_backward_dkv_tf32": "tf_operator_tpu/ops/attention.py:485",
    "flash_backward_dkv_tf32_cluster": "tf_operator_tpu/ops/attention.py:485",
    # f32 dq on the tensor cores (dq_tf32_kernel, every f32 launch): the
    # same two routes
    "flash_backward_dq_tf32": "tf_operator_tpu/ops/attention.py:419",
    "flash_backward_dq_tf32_cluster": "tf_operator_tpu/ops/attention.py:419",
}
# Kernel against plain version, held per element and as a whole:
#   |got - ref| <= RTOL * (|ref| + rms(row of ref) + 0.05 * rms(ref))
#   ||got - ref|| <= FRO * ||ref||          (Frobenius)
# The kernels round P and dS to bf16 before their second product and write
# bf16 outputs (unit roundoff 2^-8), while the plain version runs in f32 on
# the same bf16 inputs.  The rounding of a product's operand errs by about
# 2^-8/sqrt(3) of the size of its row, and of an output by at most 2^-8 of
# the element, so the per-element limit sits ~9 sigma above the first and
# 5x above the second.  The row's own RMS scales the limit, so late rows
# (small values, many keys) are held as tightly as early ones; the 0.05 *
# rms(ref) floor covers rows that are exactly zero (dq of row 0).
RTOL = 2e-2
FRO = 1e-2
# lse: f32 in both, from the same bf16 inputs; only exp/sum order differ
TOL_LSE = 1e-3
# fp16 inputs are held by the same rule (fp16 rounds P, dS and the outputs
# with a unit roundoff of 2^-11, finer than bf16's).  f32 inputs run the f32
# kernels (f32 products and sums, expf; dq's and dk/dv's products in three
# TF32 passes): against the plain version only the order of the sums
# differs, so the rule's factor shrinks from RTOL to RTOL_F32 and the whole
# from FRO to FRO_F32, and lse to TOL_LSE_F32 (one TF32 pass leaves it:
# tests/test_torch_f32_dkv.py, tests/test_torch_f32_dq.py).  At large
# logits (scale -1) plain f32's own order of sums leaves the rule against
# the exact result, so f32 dq and dk/dv are held against the plain version
# in f64 (the exact result, rounded to f32).
RTOL_F32 = 1e-4
FRO_F32 = 1e-5
TOL_LSE_F32 = 1e-5
# ptxas's -v report: each kernel instantiation's entry (its template
# arguments: element type, head-dim class, warpgroups, step and for the
# forward its route; DMAX for the f32 forward; element type and query step
# for dk/dv at head-dim class 256, whose 64 keys two warpgroups share, and
# the element type for dq there, whose tile is fixed, and for
# kernel_variants.py's split-ring forward there, with its route; the
# element type, and the forward's route, for the encoders' kernels, whose
# tile is attention.SHORT's, and for the sliced kernels above head dim
# 256, whose tile is INSTANTIATED[...][SLICED]'s; the slice width for the
# sliced f32 kernels; the element type and the slices (the cluster's
# blocks) for the cluster kernels, whose tile is
# INSTANTIATED[...][CLUSTER]'s; the element type and the route for the pair
# forward, whose tile is INSTANTIATED["fwd"][PAIR]'s; the columns a block
# takes and whether it is a cluster's or a streamed slice's for f32 dq and
# dk/dv on the tensor cores, whose tiles are attention.F32_DQ's and
# F32_DKV's), then its spills and its registers at launch
PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?(fwd|dq|dkv)"
                         r"(_f32|_split|_wide|_short|_sliced_f32|_sliced"
                         r"|_cluster|_pair|_tf32)?"
                         r"_kernelI"
                         r"((?:13__nv_bfloat16|6__half|L[ib]\d+E)+)E")
PTXAS_ARG = re.compile(r"13__nv_bfloat16|6__half|L[ib](\d+)E")
PTXAS_TYPES = {"13__nv_bfloat16": "bfloat16", "6__half": "float16"}
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
# the workloads' own step-time line (`workloads/runner.StepTimer`)
STEP_TIME = re.compile(r"^step time (\S+) ms over steps \S+, (\S+) "
                       r"(tokens|images|sequences)/s$", re.M)
# logits of a model on the kernels against the same model on the plain
# attention path (both bf16), and of the bf16 ResNet against the f32 one:
# max |got - ref| <= TOL_LOGITS * max |ref|
TOL_LOGITS = 5e-2
# the MNIST models' logits on the card against the same weights in f32 on
# the CPU, with TF32 off for cuBLAS and cuDNN (both f32; the products
# summed in other orders, cuDNN's algorithms included), by the rule above
TOL_MNIST_F32 = 1e-4
# the pipeline's schedules against each other and against the one-rank
# run on the same weights: losses within TOL_PIPE_LOSS relative (the JAX
# dryrun's rule).  Gradients: every leaf within its rule in relative
# Frobenius norm, the whole gradient within FRO.  1F1B against its primal
# under autograd, and the in-process ranks against the one-rank run of the
# same function, round at the same points (the stage's products at the
# same shapes, the head per microbatch in both): only the f32 order of the
# microbatches' sum differs (the phase reads whole errors ~5e-9), so
# TOL_PIPE_GRAD, which a backward fed the previous microbatch's input
# leaves by a factor above 1e4.  The primal against GPipe
# differs in the head alone: GPipe's runs on the whole batch, and the bf16
# readout's backward (16384 or 2048 rows by a 32000-wide contraction) then
# rounds otherwise, which 12 layers of bf16 backward carry to block 0's
# small attention gradients: TOL_PIPE_HEAD, 2.8x the phase's own reading of
# that gap at M 8 (1.08e-2 on block 0's query kernel)
TOL_PIPE_LOSS = 1e-4
TOL_PIPE_GRAD = 1e-4
TOL_PIPE_HEAD = 3e-2
# the small workloads' processes: the seconds each may take
PROCESS_TIMEOUT = 300


def tolerance_ratios(got, ref, rtol: float = RTOL):
    """(worst per-element error over its limit, relative Frobenius error);
    the kernel passes when the first is <= 1 and the second <= FRO."""
    import torch

    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rms_row = ref.pow(2).mean(-1, keepdim=True).sqrt()
    limit = rtol * (ref.abs() + rms_row + 0.05 * ref.pow(2).mean().sqrt())
    # a reference that is all zeros (dq and dk at scale 0) is held exactly
    worst = float(torch.where(limit > 0, diff / limit,
                              torch.where(diff > 0, torch.inf, 0.0)).max())
    rel = float(diff.norm() / ref.norm().clamp_min(1e-30))
    return worst, rel


def ptxas_instantiation(m) -> tuple:
    """(name, (kernel, dtype, head-dim class, rows, step)) of a PTXAS_ENTRY
    match; the second is `attention.instantiations()`'s form."""
    kernel, kind = m.group(1), m.group(2)
    args = [PTXAS_TYPES.get(a.group(0)) or int(a.group(1))
            for a in PTXAS_ARG.finditer(m.group(3))]
    if kind == "_f32":
        return (f"{kernel}_f32_kernel<D {args[0]}>",
                (kernel, "float32", args[0], 64, 32))
    if kind == "_tf32":  # f32 dq and dk/dv on the tensor cores
        from tf_operator_tpu_torch.ops.attention import (CLUSTER, F32_DKV,
                                                         F32_DQ, SLICED)

        cols, clustered, streamed = args[:3]
        route = CLUSTER if clustered else SLICED if streamed else cols
        what = ("cluster" if clustered else "streamed slices" if streamed
                else f"D {cols}")
        tiles = F32_DQ if kernel == "dq" else F32_DKV
        return (f"{kernel}_tf32_kernel<{what}>",
                (kernel, "float32", route, *tiles[route]))
    if kind == "_split":
        dtype, step = args[:2]
        return (f"dkv_split_kernel<{dtype}, D 256, rows 64, step {step}>",
                (kernel, dtype, 256, 64, step))
    if kind == "_short":  # the encoders' kernels (T <= 256 at D 64)
        from tf_operator_tpu_torch.ops.attention import SHORT

        rows, step = SHORT[kernel]
        route = f", scaled {args[1]}" if kernel == "fwd" else ""
        return (f"{kernel}_short_kernel<{args[0]}, D 64, rows {rows}, step "
                f"{step}{route}>", (kernel, args[0], 64, rows, step))
    if kind == "_cluster":  # dq and dk/dv up to attention.CLUSTER_LD
        from tf_operator_tpu_torch.ops.attention import CLUSTER, INSTANTIATED

        (rows,), (step,) = INSTANTIATED[kernel][CLUSTER]
        return (f"{kernel}_cluster_kernel<{args[0]}, {args[1]} slices, rows "
                f"{rows}, step {step}>", (kernel, args[0], CLUSTER, rows, step))
    if kind == "_pair":  # the forward up to attention.PAIR_LD
        from tf_operator_tpu_torch.ops.attention import INSTANTIATED, PAIR

        (rows,), (step,) = INSTANTIATED[kernel][PAIR]
        return (f"fwd_pair_kernel<{args[0]}, rows {rows}, step {step}, scaled"
                f" {args[1]}>", (kernel, args[0], PAIR, rows, step))
    if kind in ("_sliced", "_sliced_f32"):  # head dims above 256
        from tf_operator_tpu_torch.ops.attention import INSTANTIATED, SLICED

        if kind == "_sliced_f32":
            return (f"{kernel}_sliced_f32_kernel<slice {args[0]}>",
                    (kernel, "float32", SLICED, 64, 32))
        (rows,), (step,) = INSTANTIATED[kernel][SLICED]
        route = f", scaled {args[1]}" if kernel == "fwd" else ""
        return (f"{kernel}_sliced_kernel<{args[0]}, rows {rows}, step "
                f"{step}{route}>", (kernel, args[0], SLICED, rows, step))
    if kind == "_wide":  # dq's one tile at head-dim class 256, and
        # kernel_variants.py's split-ring forward over 128 rows there
        route = f", scaled {args[1]}" if kernel == "fwd" else ""
        return (f"{kernel}_wide_kernel<{args[0]}, D 256, rows 128, step 64"
                f"{route}>", (kernel, args[0], 256, 128, 64))
    dtype, d, wg, step = args[:4]
    name = (f"{kernel}_kernel<{dtype}, D {d}, rows {64 * wg}, step {step}"
            + (f", scaled {args[4]}>" if kernel == "fwd" else ">"))
    return name, (kernel, dtype, d, 64 * wg, step)


def ptxas_report(log: str):
    """[(instantiation, registers at launch, spill store bytes, spill load
    bytes, its `attention.instantiations()` key)] from nvcc's -Xptxas=-v
    output."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            name, spill = ptxas_instantiation(m), None
            continue
        m = PTXAS_SPILL.search(line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = PTXAS_REGS.search(line)
        if m and name and spill:
            out.append((name[0], int(m.group(1)), *spill, name[1]))
            name = None
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Tee(io.TextIOBase):
    """stdout that is also kept, so a phase can read the workload's log."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_module(name: str, argv=None) -> tuple:
    """(exit code, log) of workloads.<name>.main(argv) (main() when argv is
    None), its log captured."""
    import importlib

    module = importlib.import_module(f"tf_operator_tpu_torch.workloads.{name}")
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = module.main() if argv is None else module.main(argv)
    return rc, tee.buf.getvalue()


def run_workload(name: str, argv):
    """workloads.<name>.main(argv) with its log captured; raises unless it
    exits 0."""
    rc, log = run_module(name, argv)
    if rc != 0:
        raise RuntimeError(f"{name}.main({argv}) exited {rc}")
    return log


def run_lm(argv):
    return run_workload("lm", argv)


def step_losses(log: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+) loss (\S+)$", log, re.M)}


ROUTES = {"short": "the encoders' kernels", "sliced": "the sliced kernels"}


def check_route_launches(route: str, expected: int, what: str) -> dict:
    """The kernels of one route behind the three wrappers (the encoders',
    `attention.short_launches`, or the sliced kernels of head dims above
    256, `attention.sliced_launches`): each launched `expected` times, so
    that every attention call of the path took them."""
    from tf_operator_tpu_torch.ops import attention as A

    counts = getattr(A, f"{route}_launches")()
    print(f"{what}: {ROUTES[route]}' launches {counts} (expected "
          f"{expected} each)", flush=True)
    for name, n in counts.items():
        if n != expected:
            raise RuntimeError(f"{what}: {ROUTES[route][:-1]} behind {name} "
                               f"launched {n} times, expected {expected}")
    return counts


def check_launches(expected: int, what: str) -> dict:
    from tf_operator_tpu_torch.ops import attention as A

    counts = A.launches()
    print(f"{what}: kernel launches {counts} (expected {expected} each)",
          flush=True)
    for name, n in counts.items():
        if n != expected:
            raise RuntimeError(f"{what}: {name} launched {n} times, "
                               f"expected {expected}")
    return counts


# ---------------------------------------------------------------------------
# kernels against their plain versions

class Case(NamedTuple):
    name: str
    b: int
    h: int
    hkv: int
    t: int
    d: int
    causal: bool
    window: Optional[int] = None
    sink: int = 0
    blocks: Tuple[int, int] = (128, 128)  # (block_q, block_k)
    dtype: str = "bfloat16"
    scale: Optional[float] = None  # None: d ** -0.5


CASES = [
    Case("main", 8, 12, 12, 2048, 64, True),
    Case("gqa", 8, 12, 4, 2048, 64, True),
    Case("ragged", 2, 4, 2, 1000, 64, True, blocks=(64, 64)),
    Case("noncausal", 2, 4, 4, 1000, 64, False),
    Case("window_sink", 2, 4, 4, 2048, 64, True, 256, 4),
    Case("wide_sink_gqa", 1, 4, 2, 1000, 64, True, 64, 70, blocks=(64, 64)),
    Case("d128", 2, 8, 4, 1024, 128, True),
    Case("d128_b64", 1, 4, 4, 300, 128, False, blocks=(64, 64)),
    # the third path: ViT-B/16 at 224x224 (196 patches + CLS) and BERT-base
    # at T 128, both non-causal at their workloads' batch
    Case("vit_b16", 256, 12, 12, 197, 64, False),
    Case("bert_base", 32, 12, 12, 128, 64, False),
    # the eighth path: each tp rank's heads at tp 2 (ViT-B/16 and BERT-base
    # 12 -> 6)
    Case("vit_b16_tp2", 256, 6, 6, 197, 64, False),
    Case("bert_base_tp2", 32, 6, 6, 128, 64, False),
    # the fourth path: each tp rank's heads at tp 2 (GPT-small 12 -> 6,
    # llama 12/4 -> 6/2)
    Case("gpt_small_tp2", 8, 6, 6, 2048, 64, True),
    Case("llama_tp2", 8, 6, 2, 2048, 64, True),
    # the seventh path: GPT-small's microbatches in the pipeline, B 8 split
    # in 4 (B 2) and in 8 (B 1)
    Case("pipeline_mb4", 2, 12, 12, 2048, 64, True),
    Case("pipeline_mb8", 1, 12, 12, 2048, 64, True),
    # the tenth slice: the main shape in fp16 and f32; head dims 32 (a
    # 64-column box over a 32-column tensor), 80 (on D 128) and 100 (padded
    # to 104); scale -0.125 (ragged, window + sink, GQA) and 0; more
    # batch*heads than a grid's y (65,535); blocks the TPU autotuner writes
    # (256, 512) and the smallest the env takes (8, 128)
    Case("main_fp16", 8, 12, 12, 2048, 64, True, dtype="float16"),
    Case("main_f32", 8, 12, 12, 2048, 64, True, dtype="float32"),
    Case("d32", 8, 12, 12, 2048, 32, True),
    Case("d80", 8, 12, 12, 2048, 80, True),
    Case("d100", 8, 12, 12, 2048, 100, True),
    Case("scale_neg", 2, 4, 2, 1000, 64, True, 64, 70, scale=-0.125),
    Case("scale_zero", 2, 4, 4, 1000, 64, True, scale=0.0),
    Case("bh70400", 4400, 16, 16, 64, 64, True),
    Case("blocks_256_512", 2, 4, 4, 1000, 64, True, blocks=(256, 512)),
    Case("blocks_8_128", 2, 4, 4, 1000, 64, True, blocks=(8, 128)),
    # the twelfth slice: head-dim class 256 at Gemma 2B's attention (8
    # query heads of 256 over one KV head) on the gemma phase's shape (B 4,
    # T 2048), in fp16 and f32; non-causal, window + sink, a scale that
    # is not positive, and head dims 160 and 250 (padded to 256)
    Case("gemma_2b", 4, 8, 1, 2048, 256, True),
    Case("gemma_2b_fp16", 4, 8, 1, 2048, 256, True, dtype="float16"),
    Case("gemma_2b_f32", 4, 8, 1, 2048, 256, True, dtype="float32"),
    Case("d256_noncausal", 2, 8, 1, 1000, 256, False),
    Case("d256_window_sink", 2, 8, 1, 2048, 256, True, 256, 4),
    Case("d256_scale_neg", 2, 8, 2, 1000, 256, True, 64, 70, scale=-0.0625,
         blocks=(64, 64)),
    Case("d160", 4, 8, 1, 2048, 160, True),
    Case("d250", 4, 8, 1, 2048, 250, True),
    # the thirteenth slice: dk/dv's query heads split over slices that do
    # not divide the group (6 heads over 5 slices at B 1: dkv_splits)
    Case("d256_gqa6", 1, 6, 1, 2048, 256, True),
    # the fourteenth: Gemma 7B's attention widths (16 heads of 256, one KV
    # head each), whose K and V overflow L2 at B 4, so that the forward
    # takes its longest-first order over chunks of 4 b*h rows
    # (attention.fwd_chunk)
    Case("gemma_7b", 4, 16, 16, 2048, 256, True),
    # the seventeenth: head dims above 256 (the sliced kernels) at the
    # wide_head phase's attention, 4 query heads of 512 over one KV head at
    # B 4, T 2048, in bf16, fp16 and f32; head dims 264 and 300 (padded to
    # 304: a last slice of one or two 64-column blocks), 384 non-causal,
    # 512 with window + sink and at a negative scale with GQA 8/2, and 1024
    # (four slices)
    Case("d512_mqa", 4, 4, 1, 2048, 512, True),
    Case("d512_mqa_fp16", 4, 4, 1, 2048, 512, True, dtype="float16"),
    Case("d512_mqa_f32", 4, 4, 1, 2048, 512, True, dtype="float32"),
    Case("d264", 2, 4, 1, 1000, 264, True),
    Case("d300", 2, 4, 2, 1000, 300, True),
    Case("d384_noncausal", 2, 4, 1, 1000, 384, False),
    Case("d512_window_sink", 2, 4, 1, 2048, 512, True, 256, 4),
    Case("d512_scale_neg", 1, 8, 2, 1000, 512, True, 64, 70, scale=-0.0625),
    Case("d1024", 1, 2, 1, 300, 1024, True),
    # the eighteenth: dq and dk/dv take the cluster kernels at every case
    # above, in bf16 and fp16; above the cluster's reach (attention.
    # CLUSTER_LD, 1024) the sliced ones still run (nine slices)
    Case("d2112", 1, 2, 1, 300, 2112, True),
]
# launches the profiler averages a kernel's device time over
DEVICE_REPS = 10
# the encoders' shapes, where all three kernels take the encoders' kernels
# (attention.short_route)
ENCODER_CASES = ("vit_b16", "bert_base", "vit_b16_tp2", "bert_base_tp2")
# the cases where all three kernels and SDPA's forward and backward are
# timed by the profiler: the main shape, the encoders', since the
# sixteenth slice the tp 2 shards of GPT-small and llama, and the f32 main
# shape and Gemma 2B's attention in f32, where dk/dv runs on the tensor
# cores (d512_mqa_f32, above head dim 256, is timed so too)
DEVICE_CASES = ("main", "gpt_small_tp2", "llama_tp2", "main_f32",
                "gemma_2b_f32") + ENCODER_CASES
TIMED_CASES = ("main", "gqa", "window_sink", "d128", "vit_b16", "bert_base",
               "gpt_small_tp2", "llama_tp2", "vit_b16_tp2", "bert_base_tp2",
               "main_fp16", "main_f32", "d32", "d80", "d100", "gemma_2b",
               "gemma_2b_fp16", "gemma_2b_f32", "d160", "d250", "d256_gqa6",
               "gemma_7b", "d512_mqa", "d512_mqa_fp16", "d512_mqa_f32",
               "d2112")


def rule(dtype: str) -> tuple:
    """(per-element factor, whole relative Frobenius, lse) of the tolerance
    for inputs of `dtype`."""
    if dtype == "float32":
        return RTOL_F32, FRO_F32, TOL_LSE_F32
    return RTOL, FRO, TOL_LSE


def live_pairs(t, causal, window, sink, device) -> int:
    import torch

    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=device)
    if causal:
        keep = j <= i
        if window:
            keep = keep & ((i - j < window) | (j < sink))
    return int(keep.sum())


def kernel_case(case, timing: bool):
    import torch
    import torch.nn.functional as F

    from tf_operator_tpu_torch.ops import attention as A

    name, b, h, hkv, t, d, causal, window, sink = case[:9]
    dtype = getattr(torch, case.dtype)
    rtol, fro, tol_lse = rule(case.dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q, do = randn(b, h, t, d), randn(b, h, t, d)
    k, v = randn(b, hkv, t, d), randn(b, hkv, t, d)
    scale = d ** -0.5 if case.scale is None else case.scale
    opts = dict(scale=scale, causal=causal, window=window, sink=sink,
                block_q=case.blocks[0], block_k=case.blocks[1])
    plain_opts = dict(scale=scale, causal=causal, window=window, sink=sink)

    def fwd():
        return A.flash_forward(q, k, v, **opts)

    o, lse = fwd()
    delta = (do.float() * o.float()).sum(-1)

    def dq_kernel():
        return A.flash_backward_dq(q, k, v, do, lse, delta, **opts)

    def dkv_kernel():
        return A.flash_backward_dkv(q, k, v, do, lse, delta, **opts)

    dq = dq_kernel()
    dk, dv = dkv_kernel()
    # each kernel again on the same inputs: the same bits (no atomics, no
    # read of what a launch leaves unset)
    again = (*fwd(), dq_kernel(), *dkv_kernel())
    torch.cuda.synchronize()
    differ = [label for label, a, b in zip(
        ("o", "lse", "dq", "dk", "dv"), (o, lse, dq, dk, dv), again)
        if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"kernel case {name}: a second launch on the "
                           f"same inputs gives other bits in {differ}")

    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))

    def fwd_plain():
        return A.attention_lse(qf, *A.repeat_kv(qf, kf, vf), causal=causal,
                               scale=scale, window=window, sink=sink)

    def dq_plain():
        return A.backward_dq_plain(qf, kf, vf, dof, lse, delta, **plain_opts)

    def dkv_plain():
        return A.backward_dkv_plain(qf, kf, vf, dof, lse, delta,
                                    **plain_opts)

    o_ref, lse_ref = fwd_plain()
    if dtype == torch.float32:
        # f32 dq and dk/dv against the plain version in f64: the exact
        # result, rounded to f32 by the rule (at large logits plain f32's
        # own order of sums leaves the rule against it)
        exact = [x.double() for x in (qf, kf, vf, dof, lse, delta)]
        dq_ref = A.backward_dq_plain(*exact, **plain_opts)
        dk_ref, dv_ref = A.backward_dkv_plain(*exact, **plain_opts)
        del exact
    else:
        dq_ref = dq_plain()
        dk_ref, dv_ref = dkv_plain()

    errs = {}
    for label, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        got = got.float()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"kernel case {name}: {label} has shape "
                               f"{tuple(got.shape)} or non-finite values")
        err = float((got - ref).abs().max())
        errs[label] = err
        if label == "lse":
            print(f"  {name:11s} lse max_abs_err {err:.3e} (tolerance "
                  f"{tol_lse:.0e})", flush=True)
            ok = err <= tol_lse
        else:
            worst, rel = tolerance_ratios(got, ref, rtol)
            print(f"  {name:11s} {label:3s} max_abs_err {err:.3e} "
                  f"worst err/limit {worst:.3f} (<= 1) relative Frobenius "
                  f"{rel:.3e} (<= {fro:.0e})", flush=True)
            ok = worst <= 1.0 and rel <= fro
        if not ok:
            raise RuntimeError(f"kernel case {name}: {label} is outside its "
                               "tolerance")

    pairs = b * h * live_pairs(t, causal, window, sink, dev)
    rows = b * h * t
    elt = q.element_size()
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    work = {
        # (products, bytes: inputs read once + outputs written once)
        "flash_forward": (2, (b * h * t * d * 2 + 2 * b * hkv * t * d) * elt
                          + rows * 4),
        "flash_backward_dq": (3, (3 * b * h * t * d + 2 * b * hkv * t * d)
                              * elt + 2 * rows * 4),
        "flash_backward_dkv": (4, (2 * b * h * t * d + 4 * b * hkv * t * d)
                               * elt + 2 * rows * 4),
    }
    tf32 = dtype == torch.float32  # dq and dk/dv on the tensor cores
    result = {}
    for kname, (products, nbytes) in work.items():
        flops = 2.0 * products * pairs * d
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        simt_ms = None
        if tf32 and kname != "flash_forward":
            # f32 products on the tensor cores in three TF32 passes: the
            # least time is theirs; the f32 pipes' (67 TFLOP/s) beside it
            simt_ms = max(t_ops, t_bytes) * 1e3
            t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS
        result[kname] = {
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_simt_ms": simt_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": max(errs[x] for x in {
                "flash_forward": ("o", "lse"),
                "flash_backward_dq": ("dq",),
                "flash_backward_dkv": ("dk", "dv")}[kname]),
        }
    if not timing:
        return result

    reps = 20
    times = {
        "flash_forward": (cuda_ms(fwd, reps), cuda_ms(fwd_plain, 3)),
        "flash_backward_dq": (cuda_ms(dq_kernel, reps), cuda_ms(dq_plain, 3)),
        "flash_backward_dkv": (cuda_ms(dkv_kernel, reps),
                               cuda_ms(dkv_plain, 3)),
    }
    # yardstick only: one PyTorch call for the same function
    mask = None
    if window:
        i = torch.arange(t, device=dev)[:, None]
        j = torch.arange(t, device=dev)[None, :]
        mask = (j <= i) & ((i - j < window) | (j < sink))
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                   scale=scale)
    if hkv != h:
        sdpa_kw["enable_gqa"] = True
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **sdpa_kw)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
        out.backward(do)

    # SDPA's backward alone (dq, dk and dv in one call) on a retained graph
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                   retain_graph=True)

    lib_fwd = cuda_ms(sdpa_fwd, reps)
    lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd, reps)
    lib_bwd = cuda_ms(sdpa_bwd, reps)
    kern_total = sum(k_ms for k_ms, _ in times.values())
    kern_bwd = (times["flash_backward_dq"][0] +
                times["flash_backward_dkv"][0])
    for kname, (k_ms, p_ms) in times.items():
        r = result[kname]
        # SDPA's forward beside the forward kernel; its whole backward (dq,
        # dk and dv in one call) beside each backward kernel, as the joint
        # yardstick of the two
        r.update(ms=k_ms, plain_ms=p_ms,
                 library_ms=lib_fwd if kname == "flash_forward" else lib_bwd)
        print(f"  {name:11s} {kname:18s} kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"bound/kernel {r['bound_ms'] / k_ms:.3f}", flush=True)
    print(f"  {name:11s} kernels fwd+bwd ms {kern_total:.4f}; sdpa (yardstick)"
          f" fwd ms {lib_fwd:.4f} fwd+bwd ms {lib_fwd_bwd:.4f}", flush=True)
    print(f"  {name:11s} kernels dq + dk/dv ms {kern_bwd:.4f}; sdpa backward "
          f"alone (yardstick, dq+dk+dv in one call) ms {lib_bwd:.4f}",
          flush=True)
    sliced = A.head_class(d) == A.SLICED
    # the memory-efficient backend as the yardstick above head dim 256 and
    # in f32 (every f32 case: one backend for all of them)
    efficient = sliced or dtype == torch.float32
    if efficient:
        # SDPA's default dispatch takes its math path above head dim 256
        # (f32 GEMMs; with enable_gqa always): the yardstick is its
        # memory-efficient backend, K and V expanded to the query heads as
        # views, where it runs; the math path's times stay beside it
        eff = sdpa_efficient(q, k, v, do, sdpa_kw)
        if isinstance(eff, str):
            print(f"  {name:11s} sdpa memory-efficient backend {eff}",
                  flush=True)
        else:
            eff_ms = {"flash_forward": cuda_ms(eff[0], reps),
                      "backward": cuda_ms(eff[1], reps)}
            for kname in result:
                math_ms = result[kname]["library_ms"]
                result[kname].update(
                    library_ms=eff_ms.get(kname, eff_ms["backward"]),
                    library_math_ms=math_ms)
            print(f"  {name:11s} sdpa memory-efficient (K, V expanded) fwd "
                  f"ms {eff_ms['flash_forward']:.4f} backward ms "
                  f"{eff_ms['backward']:.4f}; the math path's {lib_fwd:.4f}"
                  f" / {lib_bwd:.4f} (yardstick)", flush=True)
    if A.head_class(d) in (256, A.SLICED) or name in DEVICE_CASES:
        # the kernels' own time and SDPA's on the device (profiler), under
        # keys of their own (`ms` and `library_ms` stay CUDA events): back
        # to back, a wrapper whose host time outlasts its kernel times the
        # host, and a stall of the host lands in the mean.  At head-dim
        # class 256 the forward, at DEVICE_CASES and above head dim 256 all
        # three and SDPA's whole backward too
        def reps(fn):
            return lambda: [fn() for _ in range(DEVICE_REPS)]

        sdpa_ms = {"flash_forward": device_busy(reps(sdpa_fwd))[0]
                   / DEVICE_REPS}
        calls = {"flash_forward": (fwd, "fwd_")}
        if efficient and (sliced or name in DEVICE_CASES):
            # SDPA's flash backend stops at head dim 256: the kernel its
            # dispatcher ran instead (the longest one of each call), and
            # the memory-efficient backend's, which the kernels line gives
            # beside library_ms (the math path's under library_math_*)
            backend = {"flash_forward": sdpa_kernel(sdpa_fwd),
                       "backward": sdpa_kernel(sdpa_bwd)}
            print(f"  {name:11s} sdpa (yardstick) ran "
                  f"{backend['flash_forward']!r} (forward), "
                  f"{backend['backward']!r} (backward)", flush=True)
            if not isinstance(eff, str):
                math_dev = {"flash_forward": sdpa_ms["flash_forward"],
                            "backward": device_busy(reps(sdpa_bwd))[0]
                            / DEVICE_REPS}
                sdpa_ms = {"flash_forward": device_busy(reps(eff[0]))[0]
                           / DEVICE_REPS,
                           "backward": device_busy(reps(eff[1]))[0]
                           / DEVICE_REPS}
                backend = {"flash_forward": sdpa_kernel(eff[0]),
                           "backward": sdpa_kernel(eff[1])}
                print(f"  {name:11s} sdpa memory-efficient ran "
                      f"{backend['flash_forward']!r} (forward), "
                      f"{backend['backward']!r} (backward); device_ms "
                      f"{sdpa_ms['flash_forward']:.4f} / "
                      f"{sdpa_ms['backward']:.4f} against the math path's "
                      f"{math_dev['flash_forward']:.4f} / "
                      f"{math_dev['backward']:.4f}", flush=True)
                for kname in result:
                    result[kname]["library_math_device_ms"] = math_dev.get(
                        kname, math_dev["backward"])
            for kname in result:
                result[kname]["library_backend"] = backend.get(
                    kname, backend["backward"])
        if (name in DEVICE_CASES or sliced) and "backward" not in sdpa_ms:
            sdpa_ms["backward"] = device_busy(reps(sdpa_bwd))[0] / DEVICE_REPS
        if name in DEVICE_CASES or sliced:
            # dk/dv's own kernel (not the reduce after a split: apart, below)
            calls.update(flash_backward_dq=(dq_kernel, "dq_tf32" if tf32
                                            else "dq_"),
                         flash_backward_dkv=(dkv_kernel, "dkv_tf32" if tf32
                                             else "dkv_"))
        for kname, (fn, frag) in calls.items():
            dev_ms = kernel_device_ms(reps(fn), frag)
            lib_ms = sdpa_ms.get(kname, sdpa_ms.get("backward"))
            bound = result[kname]["bound_ms"]
            result[kname].update(device_ms=dev_ms, library_device_ms=lib_ms)
            print(f"  {name:11s} {kname} device_ms {dev_ms:.4f} (profiler, "
                  f"mean of the launches caught of {DEVICE_REPS}; cuda_ms "
                  f"{times[kname][0]:.4f}) bound_ms {bound:.4f} bound/kernel "
                  f"{bound / dev_ms:.3f}; sdpa "
                  f"{'forward' if kname == 'flash_forward' else 'backward'}"
                  f" device_ms {lib_ms:.4f} (yardstick)", flush=True)
        if tf32 and "flash_backward_dkv" in calls:
            for kname, fn in (("flash_backward_dq", dq_kernel),
                              ("flash_backward_dkv", dkv_kernel)):
                tf32_line(name, kname, result[kname], case_splits(case), fn)
    del sdpa_out
    return result


def sdpa_efficient(q, k, v, do, sdpa_kw):
    """SDPA's forward and whole backward (autograd.grad on a retained
    graph) under its memory-efficient backend, K and V expanded to the
    query heads as views (no enable_gqa, which sends the dispatcher to the
    math path): (forward call, backward call), or the backend's refusal as
    a string.  A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel as backend

    b, h, t, d = q.shape
    group = h // k.shape[1]
    kx, vx = (x[:, :, None].expand(-1, -1, group, -1, -1).reshape(b, h, t, d)
              if group > 1 else x for x in (k, v))
    kw = {key: val for key, val in sdpa_kw.items() if key != "enable_gqa"}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, kx, vx))
    try:
        with backend(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
        torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:200]}"

    def fwd():
        with torch.no_grad(), backend(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, kx, vx, **kw)

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

    return fwd, bwd


def sdpa_kernel(fn) -> str:
    """The name of the device kernel that takes the most time in one call
    of fn (the profiler's): which of SDPA's backends ran."""
    by_name = {}
    for e in profiled_events(fn):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    return max(by_name, key=by_name.get)[:120] if by_name else "none"


def tf32_line(name, kname, r, splits, call):
    """Prints f32 dq or dk/dv (`kname`, its wrapper's `call`) on the tensor
    cores at a case: its device time (the profiler's, its own kernel; the
    reduce of dk/dv's split apart) against both bounds, the three TF32
    passes' on the tensor cores and the f32 pipes', and its launches (all
    of them the tensor-core kernel's) in one call; records the reduce's
    device time and the launches in r."""
    from tf_operator_tpu_torch.ops import attention as A

    before = A.launches()[kname]
    call()
    launched = A.launches()[kname] - before
    dev = r["device_ms"]
    reduce = ""
    if kname == "flash_backward_dkv" and splits > 1:
        r["reduce_device_ms"] = kernel_device_ms(
            lambda: [call() for _ in range(DEVICE_REPS)],
            "dkv_reduce_kernel")
        reduce = (f"; its {splits} splits' reduce device_ms "
                  f"{r['reduce_device_ms']:.4f}")
    r["launches_a_call"] = launched
    kernel = "dq" if kname == "flash_backward_dq" else "dkv"
    print(f"  {name:11s} {kernel}_tf32_kernel device_ms {dev:.4f}: "
          f"three-pass bound {r['bound_ms']:.4f} ms (tensor cores, 3 x TF32 "
          f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s) share "
          f"{r['bound_ms'] / dev:.3f}, f32-pipe bound "
          f"{r['bound_simt_ms']:.4f} ms ({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)"
          f" share {r['bound_simt_ms'] / dev:.3f}; sdpa backward device_ms "
          f"{r['library_device_ms']:.4f} ({r.get('library_backend', 'its '
          'default dispatch')!r}); launches +{launched} a call{reduce}",
          flush=True)
    if launched != 1:
        raise RuntimeError(f"kernel case {name}: f32 {kernel} launched the "
                           f"tensor-core kernel {launched} times a call")


def case_splits(case) -> int:
    """The slices dk/dv's wrapper splits a case's query heads into."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    if A.head_class(case.d) != 256:
        return 1
    return A.dkv_splits(case.b * case.hkv, case.t, case.h // case.hkv,
                        A.sm_count(torch.device("cuda")))


def reduce_case(case) -> dict:
    """`dkv_reduce` on a workspace of a case's shape (its slices, f32
    partials drawn from a seed) against `dkv_reduce_plain`: the same bits
    (both sum the slices in order in f32, then scale and round once); its
    time, the plain version's, its bound (bytes: every partial read once,
    dk and dv written once), and as a yardstick the device time of
    `ws.sum(1)` with the scale and the casts."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    dtype = getattr(torch, case.dtype)
    splits = case_splits(case)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ws = torch.randn(2, splits, case.b, case.hkv, case.t, case.d,
                     generator=gen, device="cuda")
    scale = case.d ** -0.5
    got = A.dkv_reduce(ws, scale, dtype)
    ref = A.dkv_reduce_plain(ws, scale, dtype)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise RuntimeError(f"dkv_reduce at {case.name}'s shape differs from "
                           "its plain version")
    err = max(float((g.float() - r.float()).abs().max())
              for g, r in zip(got, ref))
    nbytes = ws.numel() * 4 + 2 * got[0].numel() * got[0].element_size()

    def call():
        return A.dkv_reduce(ws, scale, dtype)

    def library():
        # yardstick only: ws.sum(1) with the scale and the cast (its sum
        # over the slices is torch's, not in slice order)
        total = ws.sum(1)
        return (total[0] * scale).to(dtype), total[1].to(dtype)

    # CUDA events around back-to-back calls, as every kernel's `ms`; and
    # the kernel's own time (profiler), since its wrapper's host time is
    # longer than the kernel; the library's device time alike.  Each over
    # DEVICE_REPS calls: a profile of one launch can miss its only device
    # event (the mean is over the launches caught)
    res = {"max_abs_err": err,
           "ms": cuda_ms(call, 20),
           "device_ms": kernel_device_ms(
               lambda: [call() for _ in range(DEVICE_REPS)],
               "dkv_reduce_kernel"),
           "plain_ms": cuda_ms(
               lambda: A.dkv_reduce_plain(ws, scale, dtype), 3),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "library_ms": cuda_ms(library, 20),
           "library_device_ms": device_busy(
               lambda: [library() for _ in range(DEVICE_REPS)])[0]
           / DEVICE_REPS}
    print(f"  {case.name:11s} dkv_reduce ({splits} slices, {nbytes:,} bytes)"
          f" equal to its plain version; device_ms {res['device_ms']:.4f}"
          f" (back to back {res['ms']:.4f}) plain_ms "
          f"{res['plain_ms']:.4f} bound_ms {res['bound_ms']:.4f} (bytes) "
          f"bound/kernel {res['bound_ms'] / res['device_ms']:.3f}; ws.sum(1)"
          f" with the scale and the casts (yardstick) device_ms "
          f"{res['library_device_ms']:.4f} (back to back "
          f"{res['library_ms']:.4f})", flush=True)
    return res


def phase_kernels():
    """Every case against its plain versions; returns the main case's
    numbers, under "dkv_reduce" the slices' sum at Gemma 2B's shape, under
    "flash_forward_short", "flash_backward_dq_short" and
    "flash_backward_dkv_short" the encoders' kernels at ViT-B/16's, under
    "flash_forward_pair" the pair forward at d512_mqa's, under
    "flash_backward_dq_cluster" and "flash_backward_dkv_cluster" the
    cluster kernels there, under "flash_backward_dq_tf32",
    "flash_backward_dkv_tf32" and their "_cluster" rows f32 dq and dk/dv on
    the tensor cores at main_f32's and d512_mqa_f32's, and under
    "flash_forward_sliced",
    "flash_backward_dq_sliced" and "flash_backward_dkv_sliced" the sliced
    ones above the pair's and the cluster's reach (d2112)."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    out = {}
    for case in CASES:
        tiles = A.launch_tiles(*case.blocks, case.d,
                               getattr(torch, case.dtype), case.t)
        print(f"kernel case {case.name}: B={case.b} H={case.h} "
              f"Hkv={case.hkv} T={case.t} D={case.d} causal={case.causal} "
              f"window={case.window} sink={case.sink} {case.dtype} scale="
              f"{case.d ** -0.5 if case.scale is None else case.scale} blocks"
              f" {case.blocks} -> tiles (rows, step) fwd {tiles.fwd} dq "
              f"{tiles.dq} dkv {tiles.dkv}, dk/dv in {case_splits(case)} "
              "slice(s)", flush=True)
        before = (A.launches(), A.sliced_launches(), A.cluster_launches(),
                  A.pair_launches())
        res = kernel_case(case, case.name in TIMED_CASES)
        if A.head_class(case.d) == A.SLICED:
            # every launch of the case above head dim 256 was the kernels'
            # of head dims above 256, dq's and dk/dv's on their CLUSTER
            # route (the cluster kernels in bf16 and fp16, the tensor-core
            # kernels' clusters in f32) a cluster's and the forward's on the
            # pair route the pair kernel's (none elsewhere)
            ran = {n: c - before[0][n] for n, c in A.launches().items()}
            sliced = {n: c - before[1][n]
                      for n, c in A.sliced_launches().items()}
            cluster = {n: c - before[2][n]
                       for n, c in A.cluster_launches().items()}
            pair = {n: c - before[3][n]
                    for n, c in A.pair_launches().items()}
            dtype = getattr(torch, case.dtype)
            on_route = {n: A.route(kind, case.d, dtype) == A.CLUSTER
                        for n, kind in (("flash_backward_dq", "dq"),
                                        ("flash_backward_dkv", "dkv"))}
            on_pair = A.pair_route(case.d, dtype)
            if (sliced != ran or not all(ran.values())
                    or cluster != {n: ran[n] * on_route[n] for n in cluster}
                    or pair != {n: ran[n] * on_pair for n in pair}):
                raise RuntimeError(f"kernel case {case.name}: launches {ran}"
                                   f", of the sliced kernels {sliced}, of "
                                   f"the cluster kernels {cluster}, of the "
                                   f"pair forward {pair}")
            print(f"  {case.name:11s} launches {ran}, the cluster kernels' "
                  f"{cluster}, the pair forward's {pair}", flush=True)
        if case.name == "main":
            out.update(res)
        if case.name == "d512_mqa":
            # the pair forward and the cluster dq and dk/dv at the
            # wide_head phase's attention
            out["flash_forward_pair"] = res["flash_forward"]
            for fn in A.CLUSTER_KERNELS:
                out[f"{fn.__name__}_cluster"] = res[fn.__name__]
        if case.name == "d2112":
            # the forward, dq and dk/dv above the pair's and the cluster's
            # reach
            for fn in A.KERNELS:
                out[f"{fn.__name__}_sliced"] = res[fn.__name__]
        if case.name == "vit_b16":
            # the encoders' kernels at ViT-B/16's shape
            for fn in A.KERNELS:
                out[f"{fn.__name__}_short"] = res[fn.__name__]
        if case.name == "gemma_2b":
            out["dkv_reduce"] = reduce_case(case)
        if case.name == "gemma_2b_f32":
            # the reduce into f32 (the same bits as its plain version)
            reduce_case(case)
        if case.name in ("main_f32", "d512_mqa_f32"):
            # f32 dq and dk/dv on the tensor cores at a head-dim class and
            # on their clusters
            key = "_cluster" if A.head_class(case.d) == A.SLICED else ""
            for fn in A.CLUSTER_KERNELS:
                out[f"{fn.__name__}_tf32{key}"] = res[fn.__name__]
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the tenth slice: the block autotuner over the kernels' instantiations

TUNE_SHAPES = {
    # name: (B, H, T, D, causal) of the three workloads' attention
    "gpt_small": (8, 12, 2048, 64, True),
    "vit_b16": (256, 12, 197, 64, False),
    "bert_base": (32, 12, 128, 64, False),
}
TUNE_REPS = 20


def every_instantiation():
    """Each block pair of the tuner's candidates, in bf16 and fp16 at head
    dims 64, 128 and 256 (positive and negative scale: both forward
    routes), and the f32 kernels, against the plain versions at a ragged
    causal shape with a window and a sink (B 1, H 4 over 2 KV heads, T 300,
    window 64, sink 70), at T 200 in bf16 and fp16 at head dim 64 (the
    encoders' kernels, attention.short_route, both routes), and at head dim
    300 in each dtype (the sliced kernels, both routes; dq and dk/dv in
    bf16 and fp16 on the cluster kernels, which head dims 600 and 1000 hold
    at three and four slices, and the forward in bf16 and fp16 on the pair
    kernel, whose reach 600 passes: the sliced forward there, both routes),
    and at 1096 in bf16 and fp16 (dq and dk/dv on the sliced kernels above
    the cluster's reach), and in f32 at head dims 1000 and 2048 (f32 dk/dv
    on the tensor cores at four and eight slices, its reach) and 2056
    (above it, its streamed slices), f32 dq and dk/dv against the plain
    version in f64; fails unless every instantiation ran."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.ops import autotune as AT

    dev = torch.device("cuda")
    b, h, hkv, window, sink = 1, 4, 2, 64, 70
    runs = [(dtype, d, pair, sign, 300) for dtype in ("bfloat16", "float16")
            for d in (64, 128, 256) for pair in AT.DEFAULT_CANDIDATES
            for sign in (1, -1)]
    runs += [("float32", d, (128, 128), sign, 300) for d in (64, 128, 256)
             for sign in (1, -1)]
    runs += [(dtype, 64, (128, 128), sign, 200)
             for dtype in ("bfloat16", "float16") for sign in (1, -1)]
    # the sliced kernels (head dims above 256: one tile each, whatever the
    # blocks), at head dim 300 in two slices
    runs += [(dtype, 300, (128, 128), sign, 300)
             for dtype in ("bfloat16", "float16", "float32")
             for sign in (1, -1)]
    # the cluster kernels at three and four slices, and the sliced dq and
    # dk/dv above the cluster's reach (five slices); the sliced forward in
    # bf16 and fp16 above the pair's reach, both routes
    runs += [(dtype, d, (128, 128), 1, 300)
             for dtype in ("bfloat16", "float16") for d in (600, 1000, 1096)]
    runs += [(dtype, 600, (128, 128), -1, 300)
             for dtype in ("bfloat16", "float16")]
    # f32 dk/dv's cluster at four and eight slices, and above its reach
    runs += [("float32", d, (128, 128), 1, 300) for d in (1000, 2048, 2056)]
    ran, worst = set(), {}
    for dtype_name, d, (bq, bk), sign, t in runs:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(d + bq + bk)
        q, k, v, do = (torch.randn(b, n, t, d, generator=gen, device=dev)
                       .to(dtype) for n in (h, hkv, hkv, h))
        opts = dict(scale=sign * d ** -0.5, causal=True, window=window,
                    sink=sink)
        o, lse = A.flash_forward(q, k, v, block_q=bq, block_k=bk, **opts)
        delta = (do.float() * o.float()).sum(-1)
        dq = A.flash_backward_dq(q, k, v, do, lse, delta, block_q=bq,
                                 block_k=bk, **opts)
        dk, dv = A.flash_backward_dkv(q, k, v, do, lse, delta, block_q=bq,
                                      block_k=bk, **opts)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        o_ref, lse_ref = A.attention_lse(qf, *A.repeat_kv(qf, kf, vf),
                                         **opts)
        # f32 dq and dk/dv against the plain version in f64 (as in
        # kernel_case)
        bwd = [x.double() if dtype == torch.float32 else x
               for x in (qf, kf, vf, dof, lse, delta)]
        refs = {"o": o_ref, "dq": A.backward_dq_plain(*bwd, **opts),
                **dict(zip(("dk", "dv"), A.backward_dkv_plain(*bwd,
                                                              **opts)))}
        rtol, fro, tol_lse = rule(dtype_name)
        got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        what = (f"{dtype_name} D {d} T {t} blocks ({bq}, {bk}) scale "
                f"{opts['scale']:.4g}")
        for key, ref in refs.items():
            ratio, rel = tolerance_ratios(got[key], ref, rtol)
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), ratio)
            if not (ratio <= 1.0 and rel <= fro
                    and torch.isfinite(got[key]).all()):
                raise RuntimeError(f"instantiation check, {what}: {key} "
                                   f"worst err/limit {ratio:.3f}, relative "
                                   f"Frobenius {rel:.3e}")
        if float((lse - lse_ref).abs().max()) > tol_lse:
            raise RuntimeError(f"instantiation check, {what}: lse outside "
                               f"{tol_lse:g}")
        tiles = A.launch_tiles(bq, bk, d, dtype, t)
        for kernel in ("fwd", "dq", "dkv"):
            ran.add((kernel, dtype_name, A.route(kernel, d, dtype),
                     *getattr(tiles, kernel)))
    missing = A.instantiations() - ran
    print(f"autotune: every instantiation ({len(ran)} of "
          f"{len(A.instantiations())}, both forward routes) held against "
          f"its plain version in {len(runs)} runs; worst err/limit "
          + ", ".join(f"{key} {r:.3f}" for key, r in worst.items()),
          flush=True)
    if missing:
        raise RuntimeError(f"instantiations no run reached: {sorted(missing)}")


def phase_autotune(card: str, lm_losses):
    """tune_flash_blocks at the three workloads' shapes (bf16), every
    instantiation against its plain version, the tuner's caches, and the LM
    on the GPT-small winner's blocks through the env."""
    from unittest import mock

    import torch

    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.ops import autotune as AT

    every_instantiation()
    results = {}
    with tempfile.TemporaryDirectory(prefix="autotune-") as tmp, \
            mock.patch.dict(os.environ, {"TPUJOB_AUTOTUNE_CACHE": os.path.join(
                tmp, "tune.json")}):
        AT._CACHE.clear()
        for name, (b, h, t, d, causal) in TUNE_SHAPES.items():
            res = AT.tune_flash_blocks(b, h, t, d, causal=causal,
                                       dtype=torch.bfloat16, reps=TUNE_REPS)
            results[name] = res
            print(f"autotune {name} (B {b}, H {h}, T {t}, D {d}, causal "
                  f"{causal}; fwd+bwd ms, mean of {TUNE_REPS}) [{card}]:",
                  flush=True)
            for row in res["table"]:
                tiles = row.get("tiles", {})
                print(f"  ({row['block_q']:3d}, {row['block_k']:3d}) "
                      + (f"ms {row['ms']:.4f}" if "ms" in row
                         else f"ERROR {row['error']}")
                      + " tiles " + " ".join(f"{key} {tuple(v)}" for key, v
                                             in tiles.items()), flush=True)
            errors = [row for row in res["table"] if "error" in row]
            if errors or "block_q" not in res:
                raise RuntimeError(f"autotune {name}: candidates failed: "
                                   f"{errors}")
            default = next(row["ms"] for row in res["table"]
                           if (row["block_q"], row["block_k"]) == (128, 128))
            print(f"autotune {name}: winner ({res['block_q']}, "
                  f"{res['block_k']}) {res['ms']:.4f} ms against the default "
                  f"(128, 128) {default:.4f} ms ({default / res['ms']:.3f}x)",
                  flush=True)

        b, h, t, d, causal = TUNE_SHAPES["bert_base"]
        tune = dict(causal=causal, dtype=torch.bfloat16, reps=TUNE_REPS)
        A.reset_launches()
        if AT.tune_flash_blocks(b, h, t, d, **tune) is not results[
                "bert_base"] or any(A.launches().values()):
            raise RuntimeError("autotune: a second call was not served from "
                               "the in-process cache without a launch")
        AT._CACHE.clear()
        served = AT.tune_flash_blocks(b, h, t, d, **tune)
        if served != results["bert_base"] or any(A.launches().values()):
            raise RuntimeError("autotune: after _CACHE.clear() the result "
                               "was not served from the file")
        saved = AT._KERNEL_HASH
        AT._CACHE.clear()
        AT._KERNEL_HASH = "0" * 16
        try:
            fresh = AT.tune_flash_blocks(b, h, t, d, **tune)
        finally:
            AT._KERNEL_HASH = saved
        searched = A.launches()
        with open(os.environ["TPUJOB_AUTOTUNE_CACHE"]) as f:
            entries = len(json.load(f))
        if not all(searched.values()) or entries != len(TUNE_SHAPES) + 1:
            raise RuntimeError("autotune: a changed kernel hash did not "
                               f"search again ({searched}, {entries} file "
                               "entries)")
        print(f"autotune: second call served in process, then from the "
              f"file ({entries - 1} entries), no launch; a changed kernel "
              f"hash searched again ({searched['flash_forward']} forward "
              f"launches, winner ({fresh['block_q']}, {fresh['block_k']}))",
              flush=True)

    # the LM on the GPT-small winner's blocks through the env, against the
    # slice phase's run on the default blocks (the same seed and data)
    win = results["gpt_small"]
    steps, layers = 5, 12
    A.reset_launches()
    with mock.patch.dict(os.environ, {
            "TPUJOB_FLASH_BLOCK_Q": str(win["block_q"]),
            "TPUJOB_FLASH_BLOCK_K": str(win["block_k"])}), \
            step_losses_kept() as kept:
        run_lm(["--steps", str(steps)])
    check_launches(layers * steps, "gpt-small on the tuned blocks")
    tuned = [float(x) for x in kept]
    rel = max(abs(a - b) / abs(b) for a, b in zip(tuned, lm_losses))
    print(f"gpt-small on blocks ({win['block_q']}, {win['block_k']}) via "
          f"TPUJOB_FLASH_BLOCK_Q/K: losses {tuned} against the default "
          f"blocks' {lm_losses[:steps]}: worst relative difference "
          f"{rel:.3e} (<= {TOL_PIPE_LOSS:g})", flush=True)
    if len(tuned) != steps or not rel <= TOL_PIPE_LOSS:
        raise RuntimeError("the LM on the tuned blocks left the default "
                           "run's losses")


# ---------------------------------------------------------------------------
# the slice at full width


def write_detail(out_dir, name: str, text: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)


def phase_slice(card: str, out_dir):
    """The main path; returns the kernels' launch counts and the 6-step
    run's losses in full precision."""
    import torch

    from tf_operator_tpu_torch.models.transformer import gpt_small_config
    from tf_operator_tpu_torch.ops import attention as A

    layers, steps = 12, 6
    with tempfile.TemporaryDirectory(prefix="lm-ckpt-") as ckpt:
        base = ["--checkpoint-dir", ckpt, "--checkpoint-every", "3"]
        A.reset_launches()
        t0 = time.perf_counter()
        with step_losses_kept() as kept:
            log = run_lm(["--steps", str(steps)] + base)
        wall = time.perf_counter() - t0
        counts = check_launches(layers * steps, "gpt-small main path")
        first = step_losses(log)
        A.reset_launches()
        log2 = run_lm(["--steps", str(steps + 5)] + base)
        check_launches(layers * 5, "gpt-small resumed run")
    if f"resumed from step {steps}" not in log2:
        raise RuntimeError("the second run did not resume from step "
                           f"{steps}")
    last = step_losses(log2)
    l0, l10 = first.get(0), last.get(10)
    if l0 is None or l10 is None or not (math.isfinite(l0)
                                         and math.isfinite(l10)):
        raise RuntimeError(f"losses missing or not finite: {first} {last}")
    if not l10 < l0:
        raise RuntimeError(f"loss did not fall: step 0 {l0}, step 10 {l10}")
    print(f"gpt-small: loss step 0 {l0} -> step 10 {l10} (after resume); "
          f"6-step run wall {wall:.1f} s incl. init and checkpoints",
          flush=True)

    # the workload's own step time, without checkpoints
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log3 = run_lm(["--steps", "12"])
    peak = torch.cuda.max_memory_allocated()
    m = STEP_TIME.search(log3)
    if m is None:
        raise RuntimeError("the workload printed no step time")
    ms = float(m.group(1))
    mfu = model_flops(gpt_small_config(), 8, 2048) / (ms / 1e3) / \
        PEAK_BF16_FLOPS
    print(f"gpt-small step: {ms} ms/step, {m.group(2)} tokens/s, MFU "
          f"{mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)

    # two steps under the workload's profiler (--profile-dir)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lm-profile-") as prof_dir:
        run_lm(["--steps", "4", "--profile-dir", prof_dir, "--profile-start",
                "2", "--profile-steps", "2"])
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    summary = device_profile(events, 2, ms)
    print(summary, flush=True)
    write_detail(out_dir, "profile_gpt_small.txt", f"{card}\n{summary}\n")
    return counts, [float(x) for x in kept]


def device_events(events) -> list:
    """The device activities (kernels, copies, sets) of a torch.profiler
    Chrome trace."""
    return [e for e in events if "dur" in e and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]


def device_profile(events, steps: int, step_ms: float) -> str:
    """Per-step device time, the device's idle share over the profiled
    window, and the kernels that take the most time, from a torch.profiler
    Chrome trace."""
    dev = device_events(events)
    if not dev:
        raise RuntimeError("the profile holds no device activity")
    busy = sum(e["dur"] for e in dev)
    span = max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)
    by_name = {}
    for e in dev:
        total, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"], n + 1)
    lines = [f"profile ({steps} steps): device busy {busy / steps / 1e3:.3f} "
             f"ms/step over a span of {span / steps / 1e3:.3f} ms/step, idle "
             f"share {1 - busy / span:.4f}; unprofiled step {step_ms} ms"]
    for name, (total, n) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:15]:
        lines.append(f"  {total / steps / 1e3:9.3f} ms/step {n // steps:5d}x "
                     f" {name[:100]}")
    return "\n".join(lines)


def model_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step (forward + backward = 3x forward) of the
    model's products: the dense projections, the tied readout, and causal
    attention (QK^T and PV over the T(T+1)/2 live pairs)."""
    head_dim = cfg.d_model // cfg.num_heads
    kv = cfg.num_kv_heads or cfg.num_heads
    attn_proj = cfg.d_model * head_dim * (2 * cfg.num_heads + 2 * kv)
    mlp = cfg.d_model * cfg.d_ff * (3 if cfg.mlp == "swiglu" else 2)
    matmul_params = cfg.num_layers * (attn_proj + mlp) + \
        cfg.vocab_size * cfg.d_model
    pairs = seq * (seq + 1) // 2 if cfg.causal else seq * seq
    attn = cfg.num_layers * batch * cfg.num_heads * 2 * 2 * pairs * head_dim
    return 3.0 * (2 * batch * seq * matmul_params + attn)


def logits_within(what: str, got, ref, shape, tol: float = TOL_LOGITS) -> None:
    import torch

    err = float((got.float() - ref.float()).abs().max())
    limit = tol * float(ref.float().abs().max())
    print(f"{what}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"(tolerance {limit:.3e})", flush=True)
    if tuple(got.shape) != shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: wrong shape or not finite")
    if not err <= limit:
        raise RuntimeError(f"{what}: differs by {err} > {limit}")


def phase_llama():
    import torch

    from tf_operator_tpu_torch.models.transformer import (
        TransformerLM, llama_style_config)
    from tf_operator_tpu_torch.ops import attention as A

    layers, steps = 4, 2
    A.reset_launches()
    run_lm(["--arch", "llama", "--layers", str(layers), "--steps",
            str(steps)])
    check_launches(layers * steps, "llama (GQA 12/4) run")

    # the model with the kernels against the model on the plain attention
    # path, same weights and tokens, on the card
    dev = torch.device("cuda")
    cfg = llama_style_config(num_layers=2, max_len=512)
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.to(dev)
    plain = TransformerLM(llama_style_config(num_layers=2, max_len=512,
                                             use_flash=False)).to(dev)
    plain.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 512),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        got, ref = model(tokens), plain(tokens)
    logits_within("llama 2-layer logits, kernels vs plain attention", got,
                  ref, (2, 512, cfg.vocab_size))


# the twelfth path: the repo's llama-style block (RoPE, RMSNorm, SwiGLU,
# GQA) at Gemma 2B's widths (arXiv:2403.08295, Table 1: d_model 2048, 18
# layers, 8 query heads of 256 over one KV head); d_ff = d_model * 8 // 3
# as the LM workload sizes its SwiGLU; vocabulary and context the LM's
GEMMA_2B_ATTN = dict(d_model=2048, num_heads=8, num_kv_heads=1,
                     num_layers=18, d_ff=2048 * 8 // 3, max_len=2048,
                     vocab_size=32000)
GEMMA_BATCH, GEMMA_STEPS = 4, 6


def lm_at_widths(card: str, out_dir, label: str, widths: dict, detail: str,
                 check):
    """The llama-style LM at `widths`, full depth, through the LM
    workload's train step, loss, AdamW recipe (its flags' defaults) and
    token stream: GEMMA_STEPS timed steps at B 4, T 2048 and two more
    under the profiler, each kernel launched once a layer a step
    (`check(cfg, steps)` then holds what else the path launched; its
    result is returned), losses finite and falling; step ms, tokens/s,
    MFU, peak memory, the profiled steps' device time by kernel (also
    written to `detail` under out_dir); then the model with the kernels
    against the same model on the plain attention path at 2 layers."""
    import torch

    from tf_operator_tpu_torch.models.transformer import (
        TransformerLM, llama_style_config)
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.train.data import (prefetch_to_device,
                                                  synthetic_tokens)
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step
    from tf_operator_tpu_torch.workloads import lm
    from tf_operator_tpu_torch.workloads.runner import (ProfileCapture,
                                                         StepTimer)

    dev = torch.device("cuda")
    batch, seq, steps = GEMMA_BATCH, widths["max_len"], GEMMA_STEPS
    cfg = llama_style_config(**widths)
    args = lm.parser().parse_args(["--batch", str(batch), "--steps",
                                   str(steps)])
    _, tx = lm.config(args, None, lambda line: None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg)
    state = create_train_state(model, tx, seed=0, device=dev)
    params = sum(p.numel() for p in model.parameters())
    step = make_train_step(lm_loss_fn(model))
    data = prefetch_to_device(
        synthetic_tokens(batch, seq + 1, cfg.vocab_size, 0), dev)
    timer = StepTimer(dev, 0)
    losses = []
    A.reset_launches()
    with tempfile.TemporaryDirectory(prefix="gemma-profile-") as prof_dir:
        prof = ProfileCapture(prof_dir, steps, 2)
        for i in range(steps + 2):
            prof.step(i)
            state, metrics = step(state, next(data))
            losses.append(metrics["loss"])
            timer.step_done(i)
            if i == steps - 1:
                line = timer.line(i, batch * seq, "tokens")
        prof.close()
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    peak = torch.cuda.max_memory_allocated()
    check_launches(cfg.num_layers * (steps + 2), f"{label}, {steps + 2} "
                   f"steps of {cfg.num_layers} layers")
    checked = check(cfg, steps + 2)
    losses = [float(x) for x in losses]
    print(f"{label} ({cfg.num_layers} x {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.d_model // cfg.num_heads} over "
          f"{cfg.num_kv_heads} KV head, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {params:,} params), B {batch}, T {seq}: "
          f"losses {losses}", flush=True)
    # finite, and falling: the last two steps' mean below the first two's
    # (the seeded stream's uniform tokens leave a slow fall over 8 steps)
    if not (all(math.isfinite(x) for x in losses)
            and sum(losses[-2:]) < sum(losses[:2])):
        raise RuntimeError(f"{label}: losses {losses}")
    m = STEP_TIME.search(line or "")
    if m is None:
        raise RuntimeError(f"{label}: no step time")
    ms = float(m.group(1))
    mfu = model_flops(cfg, batch, seq) / (ms / 1e3) / PEAK_BF16_FLOPS
    print(f"{label} step: {ms} ms/step, {m.group(2)} "
          f"tokens/s, MFU {mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s,"
          f" peak memory {peak / 2**30:.2f} GiB [{card}]", flush=True)
    summary = device_profile(events, 2, ms)
    print(summary, flush=True)
    write_detail(out_dir, detail, f"{card}\n{summary}\n")
    del state, model, step, data
    torch.cuda.empty_cache()

    # the model with the kernels against the model on the plain attention
    # path, same weights and tokens, at 2 layers and the path's T
    cut = dict(widths, num_layers=2)
    model = TransformerLM(llama_style_config(**cut))
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.to(dev)
    plain = TransformerLM(llama_style_config(**cut, use_flash=False)).to(dev)
    plain.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    A.reset_launches()
    with torch.no_grad():
        got = model(tokens)
    if A.launches()["flash_forward"] != 2:
        raise RuntimeError(f"{label} logits: launches {A.launches()}")
    with torch.no_grad():
        ref = plain(tokens)
    logits_within(f"{label} 2-layer logits, kernels vs plain attention", got,
                  ref, (2, seq, cfg.vocab_size))
    return checked


def phase_gemma(card: str, out_dir):
    """The LM at Gemma 2B's attention widths (`lm_at_widths`), whose dk/dv
    the sum of its slices follows where `dkv_splits` splits it; returns
    that sum's launches."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    def check(cfg, steps):
        # the sum of dk/dv's slices runs after each dk/dv launch it splits
        splits = A.dkv_splits(GEMMA_BATCH * cfg.num_kv_heads, cfg.max_len,
                              cfg.num_heads // cfg.num_kv_heads,
                              A.sm_count(torch.device("cuda")))
        n = A.dkv_reduce.launches
        print(f"gemma-2b attention widths: dk/dv in {splits} slices, "
              f"dkv_reduce launches {n}", flush=True)
        if n != (cfg.num_layers * steps if splits > 1 else 0):
            raise RuntimeError(f"gemma-2b attention widths: dkv_reduce "
                               f"launched {n} times at {splits} slices")
        return n

    return lm_at_widths(card, out_dir, "gemma-2b attention widths",
                        GEMMA_2B_ATTN, "profile_gemma.txt", check)


# the seventeenth path: Gemma 2B's block (GEMMA_2B_ATTN) with its 8 query
# heads of 256 regrouped into 4 of 512 over the one KV head (no public
# model has these widths; its attention FLOPs equal Gemma 2B's, and the K
# and V projections are twice as wide): head_dim 512, the sliced kernels
WIDE_HEAD_ATTN = dict(GEMMA_2B_ATTN, num_heads=4)


def phase_wide_head(card: str, out_dir):
    """The LM at WIDE_HEAD_ATTN (`lm_at_widths`), every kernel launch the
    kernels' of head dims above 256, every forward launch the pair
    kernel's and every dq and dk/dv launch the cluster kernels'; then the
    LM above the pair's and the cluster's reach (`beyond_cluster_lm`).
    Returns the launches: the pair forward's and the cluster kernels' on
    the wide-head path, and the sliced kernels' beyond the reach."""
    from tf_operator_tpu_torch.ops import attention as A

    def check(cfg, steps):
        check_route_launches("sliced", cfg.num_layers * steps,
                             "wide-head attention widths")
        pair = A.pair_launches()
        print(f"wide-head attention widths: the pair forward's launches "
              f"{pair} (expected {cfg.num_layers * steps})", flush=True)
        if pair != {n: cfg.num_layers * steps for n in pair}:
            raise RuntimeError("wide-head attention widths: a forward "
                               f"launch was not the pair kernel's: {pair}")
        cluster = A.cluster_launches()
        print(f"wide-head attention widths: the cluster kernels' launches "
              f"{cluster} (expected {cfg.num_layers * steps} each)",
              flush=True)
        if cluster != {n: cfg.num_layers * steps for n in cluster}:
            raise RuntimeError("wide-head attention widths: a dq or dk/dv "
                               f"launch was not the cluster kernel's: "
                               f"{cluster}")
        return {"flash_forward_pair": pair["flash_forward"],
                **{f"{n}_cluster": c for n, c in cluster.items()}}

    counts = lm_at_widths(card, out_dir,
                          "wide-head (4 x 512) attention widths",
                          WIDE_HEAD_ATTN, "profile_wide_head.txt", check)
    counts.update(beyond_cluster_lm(card))
    return counts


# the LM with one head of BEYOND_HEAD_DIM over one KV head, above the
# pair forward's and the cluster kernels' reach (attention.PAIR_LD,
# CLUSTER_LD), so that all three take the sliced kernels (nine slices); 2
# layers, B 1, T 1024, 2 steps: no public model has such heads, the path
# holds the kernels there
BEYOND_HEAD_DIM = 2112
BEYOND_ATTN = dict(d_model=BEYOND_HEAD_DIM, num_heads=1, num_kv_heads=1,
                   num_layers=2, d_ff=BEYOND_HEAD_DIM * 8 // 3, max_len=1024,
                   vocab_size=32000)
BEYOND_STEPS = 2


def beyond_cluster_lm(card: str) -> dict:
    """The llama-style LM at BEYOND_ATTN through the LM workload's train
    step, loss and AdamW recipe, BEYOND_STEPS steps at B 1: each kernel
    launched once a layer a step, every one the sliced kernels' (no pair
    forward, no cluster kernel), losses finite.  Returns the sliced
    kernels' launches."""
    import torch

    from tf_operator_tpu_torch.models.transformer import (
        TransformerLM, llama_style_config)
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.train.data import (prefetch_to_device,
                                                  synthetic_tokens)
    from tf_operator_tpu_torch.train.state import create_train_state
    from tf_operator_tpu_torch.train.step import lm_loss_fn, make_train_step
    from tf_operator_tpu_torch.workloads import lm

    dev = torch.device("cuda")
    cfg = llama_style_config(**BEYOND_ATTN)
    args = lm.parser().parse_args(["--batch", "1", "--steps",
                                   str(BEYOND_STEPS)])
    _, tx = lm.config(args, None, lambda line: None)
    model = TransformerLM(cfg)
    state = create_train_state(model, tx, seed=0, device=dev)
    step = make_train_step(lm_loss_fn(model))
    data = prefetch_to_device(
        synthetic_tokens(1, cfg.max_len + 1, cfg.vocab_size, 0), dev)
    A.reset_launches()
    losses = []
    for _ in range(BEYOND_STEPS):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    n = cfg.num_layers * BEYOND_STEPS
    what = (f"beyond the cluster's reach (head dim {BEYOND_HEAD_DIM}, "
            f"{cfg.num_layers} layers, B 1, T {cfg.max_len})")
    check_launches(n, what)
    sliced = check_route_launches("sliced", n, what)
    cluster, pair = A.cluster_launches(), A.pair_launches()
    print(f"{what}: losses {losses}; the cluster kernels' launches {cluster}"
          f", the pair forward's {pair} (expected 0) [{card}]", flush=True)
    if (any(cluster.values()) or any(pair.values())
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"{what}: cluster launches {cluster}, pair "
                           f"launches {pair}, losses {losses}")
    del state, model, step, data
    torch.cuda.empty_cache()
    return {f"{fn.__name__}_sliced": sliced[fn.__name__]
            for fn in A.KERNELS}


# ---------------------------------------------------------------------------
# the second path: flash_attention_lse, ring hops, the distributed step

LSE_CASES = [
    # name, B, H, Hkv, T, D, causal
    ("sp2_causal", 8, 12, 12, 1024, 64, True),
    ("sp2_full", 8, 12, 12, 1024, 64, False),
    ("sp4_causal", 8, 12, 12, 512, 64, True),
    ("sp4_full", 8, 12, 12, 512, 64, False),
    ("gqa_full", 8, 12, 4, 1024, 64, False),
    ("d128_causal", 4, 8, 8, 1024, 128, True),
    # the twelfth slice: Gemma 2B's attention (8 query heads of 256 over one
    # KV head) through the (o, lse) entry
    ("d256_gqa8_causal", 4, 8, 1, 1024, 256, True),
    # the seventeenth slice: the wide_head phase's attention (4 query heads
    # of 512 over one KV head) through the (o, lse) entry: the sliced
    # forward (since the nineteenth the pair forward), and since the
    # eighteenth the cluster dq and dk/dv
    ("d512_gqa4_causal", 4, 4, 1, 1024, 512, True),
]


def held(got, ref) -> bool:
    worst, rel = tolerance_ratios(got, ref)
    return worst <= 1.0 and rel <= FRO


def lse_case(case):
    """flash_attention_lse on the card, forward and backward with
    cotangents on o and lse, against the plain versions in f32 on the same
    bf16 inputs.  o within the tolerance rule and lse within TOL_LSE of f32
    autograd of `attention_lse`; dq/dk/dv per element against the kernels'
    plain versions given the kernel's bf16 O and lse (delta' = rowsum(dO *
    O) - dlse, as the backward forms it) and by Frobenius against f32
    autograd.  The same kernels given delta (the dlse term dropped: the
    planted fault) must fail the rule in dq and dk (dv reads no delta).
    Returns the worst ratios; raises on any failure."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    name, b, h, hkv, t, d, causal = case
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, do = randn(b, h, t, d).bfloat16(), randn(b, h, t, d).bfloat16()
    k, v = randn(b, hkv, t, d).bfloat16(), randn(b, hkv, t, d).bfloat16()
    dlse = randn(b, h, t)
    scale = d ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before, cluster = A.launches(), A.cluster_launches()
    pair = A.pair_launches()
    o, lse = A.flash_attention_lse(*leaves, causal)
    torch.autograd.backward((o, lse), (do, dlse))
    after = A.launches()
    on_route = A.cluster_route(d, q.dtype)
    on_pair = A.pair_route(d, q.dtype)
    if (any(after[n] != before[n] + 1 for n in after)
            or any(c != cluster[n] + on_route
                   for n, c in A.cluster_launches().items())
            or any(c != pair[n] + on_pair
                   for n, c in A.pair_launches().items())):
        raise RuntimeError(f"lse case {name}: launches {before} -> {after}, "
                           f"the cluster kernels' {cluster} -> "
                           f"{A.cluster_launches()}, the pair forward's "
                           f"{pair} -> {A.pair_launches()}")
    got = {"o": o.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}

    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ref_leaves = [x.detach().requires_grad_() for x in (qf, kf, vf)]
    o_ref, lse_ref = A.attention_lse(
        ref_leaves[0], *A.repeat_kv(*ref_leaves), causal=causal, scale=scale)
    torch.autograd.backward((o_ref, lse_ref), (dof, dlse))
    autograd = {"o": o_ref.detach(), "dq": ref_leaves[0].grad,
                "dk": ref_leaves[1].grad, "dv": ref_leaves[2].grad}
    opts = dict(scale=scale, causal=causal, window=None, sink=0)
    lse_k = lse.detach()
    delta = (dof * o.detach().float()).sum(-1)
    plain = {"o": o_ref.detach(),
             "dq": A.backward_dq_plain(qf, kf, vf, dof, lse_k, delta - dlse,
                                       **opts)}
    plain["dk"], plain["dv"] = A.backward_dkv_plain(qf, kf, vf, dof, lse_k,
                                                    delta - dlse, **opts)
    lse_err = float((lse_k - lse_ref.detach()).abs().max())
    if not (torch.isfinite(lse_k).all() and lse_err <= TOL_LSE):
        raise RuntimeError(f"lse case {name}: lse max_abs_err {lse_err}")
    ratios = {}
    for key in ("o", "dq", "dk", "dv"):
        if got[key].shape != plain[key].shape or \
                not torch.isfinite(got[key]).all():
            raise RuntimeError(f"lse case {name}: {key} has the wrong shape "
                               "or non-finite values")
        worst, rel = tolerance_ratios(got[key], plain[key])
        rel_autograd = tolerance_ratios(got[key], autograd[key])[1]
        ratios[key] = worst
        print(f"  {name:11s} {key}: worst err/limit {worst:.3f} (<= 1), "
              f"relative Frobenius {rel:.3e}, vs f32 autograd "
              f"{rel_autograd:.3e} (<= {FRO:.0e})", flush=True)
        if not (worst <= 1.0 and rel <= FRO and rel_autograd <= FRO):
            raise RuntimeError(f"lse case {name}: {key} is outside its "
                               "tolerance")
    # the planted fault: delta where the backward needs delta'
    k_opts = dict(opts, block_q=128, block_k=128)
    fault = {"dq": A.flash_backward_dq(q, k, v, do, lse_k, delta.contiguous(),
                                       **k_opts)}
    fault["dk"], fault["dv"] = A.flash_backward_dkv(
        q, k, v, do, lse_k, delta.contiguous(), **k_opts)
    fault_ratios = {key: tolerance_ratios(fault[key], plain[key])[0]
                    for key in fault}
    print(f"  {name:11s} planted fault (delta for delta'): worst err/limit "
          + ", ".join(f"{key} {r:.1f}" for key, r in fault_ratios.items()),
          flush=True)
    # dv = P^T dO reads no delta; dq and dk must both fail
    if held(fault["dq"], plain["dq"]) or held(fault["dk"], plain["dk"]):
        raise RuntimeError(f"lse case {name}: the planted fault passed the "
                           "tolerance")
    ratios["fault_dq"] = fault_ratios["dq"]
    return ratios


def phase_lse():
    import torch

    for case in LSE_CASES:
        print(f"lse case {case[0]}: B={case[1]} H={case[2]} Hkv={case[3]} "
              f"T={case[4]} D={case[5]} causal={case[6]}", flush=True)
        lse_case(case)
        torch.cuda.empty_cache()


# the f32 path: the public op on f32 tensors at the kernels phase's f32
# cases (no workload computes in f32)
F32_PATH_CASES = ("main_f32", "gemma_2b_f32", "d512_mqa_f32")


def phase_f32() -> dict:
    """`flash_attention` on f32 tensors, forward and backward under
    autograd, at F32_PATH_CASES: the launch counts set to 0 just before
    each call and read just after (each kernel once; every f32 dq and
    dk/dv launch is the tensor-core kernels'); the gradients held by the
    f32 rule against the plain versions of the backward kernels in f64
    given the forward kernel's o and lse (as the kernels phase holds them:
    where a gradient is zero in exact arithmetic, as dq's first row, the
    autograd of the plain attention rounds otherwise), and within FRO_F32
    of the plain attention's under autograd as a whole.  Returns the
    launches of f32 dq and dk/dv on the tensor cores at the head-dim
    classes and on their clusters."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    counts = {f"{fn.__name__}_tf32{key}": 0 for fn in A.CLUSTER_KERNELS
              for key in ("", "_cluster")}
    rtol, fro, _ = rule("float32")
    for case in (c for c in CASES if c.name in F32_PATH_CASES):
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, do = (torch.randn(case.b, case.h, case.t, case.d, generator=gen,
                             device="cuda") for _ in range(2))
        k, v = (torch.randn(case.b, case.hkv, case.t, case.d, generator=gen,
                            device="cuda") for _ in range(2))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        A.reset_launches()
        A.flash_attention(*leaves, causal=case.causal).backward(do)
        torch.cuda.synchronize()
        ran = A.launches()
        if any(n != 1 for n in ran.values()):
            raise RuntimeError(f"f32 {case.name}: launches {ran}")
        key = "_cluster" if A.head_class(case.d) == A.SLICED else ""
        for fn in A.CLUSTER_KERNELS:
            counts[f"{fn.__name__}_tf32{key}"] += ran[fn.__name__]
        opts = dict(scale=case.d ** -0.5, causal=case.causal, window=None,
                    sink=0)
        o, lse = A.flash_forward(q, k, v, **opts)
        delta = (do * o).sum(-1)
        exact = [x.double() for x in (q, k, v, do, lse, delta)]
        plain = (A.backward_dq_plain(*exact, **opts),
                 *A.backward_dkv_plain(*exact, **opts))
        del exact
        refs = [x.detach().requires_grad_() for x in (q, k, v)]
        A.attention(refs[0], *A.repeat_kv(*refs), **opts).backward(do)
        worst = {}
        for label, got, ref, auto in zip(("dq", "dk", "dv"), leaves, plain,
                                          refs):
            ratio, rel = tolerance_ratios(got.grad, ref, rtol)
            rel_auto = tolerance_ratios(got.grad, auto.grad, rtol)[1]
            worst[label] = (ratio, rel, rel_auto)
            if not (ratio <= 1.0 and rel <= fro and rel_auto <= fro
                    and torch.isfinite(got.grad).all()):
                raise RuntimeError(f"f32 {case.name}: {label} worst "
                                   f"err/limit {ratio:.3f}, relative "
                                   f"Frobenius {rel:.3e} ({rel_auto:.3e} "
                                   "against autograd)")
        print(f"f32 {case.name}: flash_attention fwd + bwd on f32 tensors, "
              f"launches {ran}; against the plain versions in f64: "
              + ", ".join(
                  f"{label} worst err/limit {r:.3f} Frobenius {f:.2e} "
                  f"(against the plain attention's autograd {a:.2e})"
                  for label, (r, f, a) in worst.items()), flush=True)
        del q, k, v, do, leaves, refs, o, lse, delta, plain
        torch.cuda.empty_cache()
    return counts


RING_CASES = [
    # name, B, H, T (whole sequence), D, n ranks, causal
    ("n2_causal", 8, 12, 2048, 64, 2, True),
    ("n2_full", 8, 12, 2048, 64, 2, False),
    ("n4_causal", 8, 12, 2048, 64, 4, True),
    ("n4_full", 8, 12, 2048, 64, 4, False),
    ("long_n4_causal", 2, 12, 8192, 64, 4, True),
    # the eighth path: BERT-base under sp (B 32, T 128), non-causal, each
    # rank's block 64 and 32 rows: shorter than one tile
    ("bert_n2_full", 32, 12, 128, 64, 2, False),
    ("bert_n4_full", 32, 12, 128, 64, 4, False),
]


def ring_case(case, card: str):
    """Every rank's hop loop on the card, its blocks handed over from the
    whole sequence in place of the ring shift (the same `ring_hops` the
    collective runs), against attention over the whole sequence."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.parallel.ring_attention import ring_hops

    name, b, h, t, d, n, causal = case
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    tl = t // n

    def ring(fault=False, backward=True):
        """([o, dq, dk, dv], the f32 merge that o is rounded from).  Rank me
        receives rank (me - s)'s blocks at step s; the planted fault leaves
        out the last shift, so the last step sees the blocks of the step
        before."""
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        blocks = [tuple(x[:, :, i * tl:(i + 1) * tl].contiguous()
                        for x in leaves[1:]) for i in range(n)]
        merged = torch.cat([ring_hops(
            leaves[0][:, :, me * tl:(me + 1) * tl].contiguous(), me, n,
            [blocks[(me - min(s, n - 2 if fault else s)) % n]
             for s in range(n)], causal=causal) for me in range(n)], dim=2)
        out = merged.to(q.dtype)  # as ring_attention returns it
        if not backward:
            return [out.detach()], merged.detach()
        out.backward(do)
        return [out.detach()] + [x.grad for x in leaves], merged.detach()

    def full():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = A.flash_attention(*leaves, causal)
        out.backward(do)
        return [out.detach()] + [x.grad for x in leaves]

    def plain(merged):
        """The plain f32 attention and its backward with delta =
        rowsum(dO * O), O the ring's f32 merge: the merge's gradient gives
        each hop the delta' = rowsum(dO_h * o_h) - dlse_h = w_h *
        rowsum(dO * O) (w_h = exp(lse_h - LSE)), so the hops' gradients sum
        to this backward (`_FlashHops` hands the kernels that delta).  The
        bf16 output that O is rounded to would make a row-wide delta
        error."""
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        o_ref, lse = A.attention_lse(qf, kf, vf, causal=causal,
                                     scale=d ** -0.5)
        delta = (dof * merged).sum(-1)
        opts = dict(scale=d ** -0.5, causal=causal, window=None, sink=0)
        return [o_ref, A.backward_dq_plain(qf, kf, vf, dof, lse, delta,
                                           **opts),
                *A.backward_dkv_plain(qf, kf, vf, dof, lse, delta, **opts)]

    A.reset_launches()
    got, merged = ring()
    hops = A.launches()
    want_hops = n * (n + 1) // 2 if causal else n * n
    print(f"  {name:14s} hop launches {hops} (expected {want_hops} each)",
          flush=True)
    if any(c != want_hops for c in hops.values()):
        raise RuntimeError(f"ring case {name}: hop launches {hops}")
    # per element and as a whole against the plain f32 version, as the
    # kernels are held; as a whole against flash_attention
    exact, ref = plain(merged), full()
    del merged
    for label, a, e, r in zip(("o", "dq", "dk", "dv"), got, exact, ref):
        worst, rel = tolerance_ratios(a, e)
        rel_flash = tolerance_ratios(a, r)[1]
        print(f"  {name:14s} {label}: vs plain f32 worst err/limit "
              f"{worst:.3f} (<= 1), relative Frobenius {rel:.3e}; vs "
              f"flash_attention relative Frobenius {rel_flash:.3e} (<= "
              f"{FRO:.0e})", flush=True)
        if not (torch.isfinite(a).all() and worst <= 1.0 and rel <= FRO
                and rel_flash <= FRO):
            raise RuntimeError(f"ring case {name}: {label} is outside its "
                               "tolerance")
    del ref
    if n == 4:
        wrong = ring(fault=True, backward=False)[0][0]
        worst = tolerance_ratios(wrong, exact[0])[0]
        print(f"  {name:14s} planted fault (the last shift left out): o "
              f"worst err/limit {worst:.1f}", flush=True)
        if held(wrong, exact[0]):
            raise RuntimeError(f"ring case {name}: the planted fault passed "
                               "the tolerance")
    del exact
    ring_ms, full_ms = cuda_ms(ring, 5), cuda_ms(full, 5)
    busy_ms, kernels = device_busy(ring)
    print(f"  {name:14s} ring hops of all {n} ranks fwd+bwd (merge "
          f"included) {ring_ms:.4f} ms, of it device busy {busy_ms:.4f} ms "
          f"in {kernels} kernels; flash_attention fwd+bwd over the whole "
          f"sequence {full_ms:.4f} ms [{card}]", flush=True)
    return {"hops": hops, "ring_ms": ring_ms, "full_ms": full_ms}


def profiled_events(fn) -> list:
    """The device activities of one call of fn, after a warm-up call, from
    a torch.profiler Chrome trace (as `device_profile` reads the
    workload's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip-profile-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return device_events(json.load(f)["traceEvents"])


def kernel_device_ms(fn, name: str) -> float:
    """Mean device time of a launch of the kernels whose name holds `name`
    in one call of fn (which may launch them several times), from the
    profiler: for a kernel shorter than its wrapper's host time, where
    CUDA events around back-to-back calls time the host.  The profiler
    drops device events at times, so the mean is over the launches the
    trace caught, and a trace that caught none is taken again, three
    times at most."""
    for _ in range(3):
        durs = [e["dur"] for e in profiled_events(fn) if name in e["name"]]
        if durs:
            return sum(durs) / len(durs) / 1e3
    raise RuntimeError(f"three profiles of one call saw no kernel named "
                       f"{name!r}")


def device_busy(fn):
    """(device ms, device activities) of one call of fn."""
    dev = profiled_events(fn)
    return sum(e["dur"] for e in dev) / 1e3, len(dev)


def phase_ring(card: str):
    import torch

    for case in RING_CASES:
        print(f"ring case {case[0]}: B={case[1]} H={case[2]} T={case[3]} "
              f"D={case[4]} n={case[5]} causal={case[6]}", flush=True)
        ring_case(case, card)
        torch.cuda.empty_cache()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(env_extra=None):
    """A one-rank NCCL process group (the workloads make none for one
    process, and join this one) with the workload env `env_extra` set;
    both undone on exit."""
    import torch
    import torch.distributed as dist

    address = f"127.0.0.1:{free_port()}"
    env = {"TPUJOB_PROCESS_ID": "0", "TPUJOB_NUM_PROCESSES": "1",
           "TPUJOB_COORDINATOR_ADDRESS": address, **(env_extra or {})}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://{address}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def phase_dist(card: str):
    """The workload through the distributed step (shard_batch, the summed
    gradient all-reduce, the all-reduced loss) over a one-rank NCCL group,
    against the plain one-process run at the same seed: plain, group,
    group, plain.  Then, in the group, two profiled steps and the gradient
    all-reduce alone at GPT-small's parameter count."""
    import torch

    from tf_operator_tpu_torch.models.transformer import (TransformerLM,
                                                          gpt_small_config)
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.parallel.shard import Sharding

    steps, layers = 11, 12  # loss lines at steps 0 and 10
    logs = {"plain": [], "dist": []}
    logs["plain"].append(run_lm(["--steps", str(steps)]))
    with one_rank_group():
        for _ in range(2):
            A.reset_launches()
            logs["dist"].append(run_lm(["--steps", str(steps)]))
            check_launches(layers * steps, "distributed step, one rank")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="lm-profile-") as prof_dir:
            run_lm(["--steps", "4", "--profile-dir", prof_dir,
                    "--profile-start", "2", "--profile-steps", "2"])
            with open(os.path.join(prof_dir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        step_ms = float(STEP_TIME.search(logs["dist"][-1]).group(1))
        print(device_profile(events, 2, step_ms), flush=True)
        model = TransformerLM(gpt_small_config()).cuda()
        sharding = Sharding(model, build_mesh(device_type="cuda"))
        grads = [torch.randn_like(p) for p in model.parameters()]

        def reduce():
            for p, g in zip(model.parameters(), grads):
                p.grad = g
            sharding.reduce_grads()

        count = sum(p.numel() for p in model.parameters())
        print(f"dist: gradient all-reduce of {count} f32 in one flat buffer "
              f"(one rank) {cuda_ms(reduce, 10):.3f} ms [{card}]",
              flush=True)
        del model, sharding, grads
    logs["plain"].append(run_lm(["--steps", str(steps)]))
    plain = step_losses(logs["plain"][0])
    for log in logs["plain"][1:] + logs["dist"]:
        other = step_losses(log)
        if not plain or sorted(other) != sorted(plain):
            raise RuntimeError(f"loss lines differ: {plain} {other}")
        for i, loss in plain.items():
            if not (math.isfinite(loss) and
                    abs(other[i] - loss) <= 1e-5 * abs(loss)):
                raise RuntimeError(f"step {i}: loss {other[i]} against the "
                                   f"plain run's {loss}")
    times = {kind: [float(STEP_TIME.search(log).group(1)) for log in runs]
             for kind, runs in logs.items()}
    print(f"dist: losses {plain} equal within 1e-5 relative in all four "
          f"runs; step ms in turns: plain {times['plain'][0]}, group "
          f"{times['dist'][0]}, group {times['dist'][1]}, plain "
          f"{times['plain'][1]} [{card}]", flush=True)


def phase_shard(card: str, out_dir):
    """The fourth path: the LM workload at GPT-small width over a one-rank
    NCCL group with the mesh {"fsdp": 1, "tp": 1}, so its parameters go
    through FSDP2 (one unit per block) and the tensor-parallel layout (the
    column- and row-parallel products, the vocab-sharded embedding and
    cross-entropy), against the plain one-process run: plain, sharded,
    plain, losses equal within 1e-5 relative, each kernel launched 12 x
    steps times in the sharded run, and two of its steps profiled; a
    checkpoint written under the mesh (its whole state, gathered) resumes
    in a plain run with the loss a plain checkpoint gives.  Then the ZeRO plan's optimizer-state
    bytes per rank for GPT-small at dp 8, computed (one card cannot run
    dp 8)."""
    import torch

    from tf_operator_tpu_torch.models.convert import flax_param_map
    from tf_operator_tpu_torch.models.transformer import (TransformerLM,
                                                          gpt_small_config)
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train import zero

    steps, layers = 11, 12
    logs = [run_lm(["--steps", str(steps)])]
    mesh = json.dumps({"fsdp": 1, "tp": 1})
    with one_rank_group({"TPUJOB_MESH_SHAPE": mesh}):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        logs.append(run_lm(["--steps", str(steps)]))
        check_launches(layers * steps, f"sharded step ({mesh}, one rank)")
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="lm-profile-") as prof_dir:
            run_lm(["--steps", "4", "--profile-dir", prof_dir,
                    "--profile-start", "2", "--profile-steps", "2"])
            with open(os.path.join(prof_dir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        summary = device_profile(
            events, 2, float(STEP_TIME.search(logs[1]).group(1)))
        print(summary, flush=True)
        write_detail(out_dir, "profile_shard.txt", f"{card}\n{summary}\n")
    logs.append(run_lm(["--steps", str(steps)]))
    plain = step_losses(logs[0])
    for log in logs[1:]:
        other = step_losses(log)
        if not plain or sorted(other) != sorted(plain):
            raise RuntimeError(f"loss lines differ: {plain} {other}")
        for i, loss in plain.items():
            if not (math.isfinite(loss) and
                    abs(other[i] - loss) <= 1e-5 * abs(loss)):
                raise RuntimeError(f"step {i}: loss {other[i]} against the "
                                   f"plain run's {loss}")
    # the whole state saved under the mesh restores into the plain run:
    # 6 steps with checkpoints, sharded and plain, each resumed to step 11
    # by a plain run
    resumed = {}
    with tempfile.TemporaryDirectory(prefix="shard-ckpt-") as sharded_dir, \
            tempfile.TemporaryDirectory(prefix="plain-ckpt-") as plain_dir:
        every = ["--checkpoint-every", "3"]
        with one_rank_group({"TPUJOB_MESH_SHAPE": mesh}):
            run_lm(["--steps", "6", "--checkpoint-dir", sharded_dir] + every)
        run_lm(["--steps", "6", "--checkpoint-dir", plain_dir] + every)
        for name, ckpt in (("sharded", sharded_dir), ("plain", plain_dir)):
            log = run_lm(["--steps", "11", "--checkpoint-dir", ckpt] + every)
            if "resumed from step 6" not in log:
                raise RuntimeError(f"the {name} checkpoint did not resume "
                                   "from step 6")
            resumed[name] = step_losses(log)[10]
    if not abs(resumed["sharded"] - resumed["plain"]) <= \
            1e-5 * abs(resumed["plain"]):
        raise RuntimeError(f"resumed from the sharded checkpoint: step 10 "
                           f"loss {resumed['sharded']} against "
                           f"{resumed['plain']} from the plain one")
    print(f"shard: a checkpoint saved under {mesh} at step 6 resumes in a "
          f"plain run: step 10 loss {resumed['sharded']} (from the plain "
          f"checkpoint: {resumed['plain']})", flush=True)

    times = [STEP_TIME.search(log) for log in logs]
    print(f"shard: losses {plain} equal within 1e-5 relative in all three "
          f"runs; step ms in turns: plain {times[0].group(1)}, sharded "
          f"{times[1].group(1)}, plain {times[2].group(1)}; sharded "
          f"{times[1].group(2)} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)

    with torch.device("meta"):
        model = TransformerLM(gpt_small_config())
    layout = build_mesh({"dp": 8}, 8)
    plan = zero.plan_for_model(model, layout)
    params = [(e.path, e.shape) for e in flax_param_map(model)]
    dense = zero.opt_state_bytes_per_device(None, params)
    sharded = zero.opt_state_bytes_per_device(plan, params)
    print(f"shard: computed, not measured: GPT-small AdamW moments per rank "
          f"{dense} bytes dense, {sharded} bytes under the ZeRO plan at "
          f"dp 8 ({sum(e.dim is not None for e in plan.entries)} of "
          f"{len(plan.entries)} entries sharded)", flush=True)


# ---------------------------------------------------------------------------
# the eighth path: the transformers under tp and ZeRO with fsdp at size 1

MESH_RUNS = [
    # workload, its flags, steps (loss lines at each, or the LM's at 0 and
    # 10), blocks, items per step, unit, meshes (tag, mesh, ZeRO knob)
    ("vit", [], 3, 12, 256, "images",
     [("tp1", {"tp": 1}, False), ("dp1_fsdp1_zero", {"dp": 1, "fsdp": 1},
                                   True)]),
    ("bert", [], 6, 12, 32, "sequences",
     [("tp1", {"tp": 1}, False), ("dp1_fsdp1_zero", {"dp": 1, "fsdp": 1},
                                   True)]),
    ("lm", [], 11, 12, 8 * 2048, "tokens",
     [("dp1_fsdp1_zero", {"dp": 1, "fsdp": 1}, True)]),
]


@contextlib.contextmanager
def step_losses_kept():
    """A list that every train step made inside the block appends its loss
    to, as the step returns it (no sync inside the run; read it after)."""
    from tf_operator_tpu_torch.train import step as S

    made, losses = S.make_train_step, []

    def make(*args, **kwargs):
        inner = made(*args, **kwargs)

        def step(state, batch):
            state, metrics = inner(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        return step

    S.make_train_step = make
    try:
        yield losses
    finally:
        S.make_train_step = made


def mesh_run(name: str, argv, steps: int, blocks: int):
    """(log, every step's loss in full precision, peak bytes) of one run of
    workload `name`, each kernel's launches counted from zero and held to
    blocks x steps."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    extra = [] if name == "lm" else ["--log-every", "1"]
    with step_losses_kept() as losses:
        log = run_workload(name, argv + ["--steps", str(steps)] + extra)
    check_launches(blocks * steps, f"{name} run")
    return (log, [float(x) for x in losses],
            torch.cuda.max_memory_allocated())


def phase_encoder_mesh(card: str):
    """The eighth path on one card: ViT-B/16 (B 256, 224 px) and BERT-base
    (B 32, T 128) under {"tp": 1} (the tensor-parallel layout on 1-way
    slices, BERT's vocab-sharded lookup) and under {"dp": 1, "fsdp": 1}
    with the ZeRO knob (FSDP2 per block; at dp 1 the workload builds no
    plan and runs dense, as the JAX workload does), and the LM (GPT-small)
    under the latter, each over a one-rank NCCL group beside the plain
    run, in turns (plain, each mesh, plain again): every step's loss, in
    full precision, equal within 1e-5 relative, each kernel launched
    blocks x steps times, step ms,
    items/s and peak memory.  Then, computed, what
    the ZeRO plan shards at {"dp": 2, "fsdp": 4} for each model (one card
    cannot run it).  Returns the LM's two plain runs (log, losses, peak
    bytes), the in-process reference of the pod phase."""
    import torch

    from tf_operator_tpu_torch.models.transformer import (BertEncoder,
                                                          TransformerLM,
                                                          bert_base_config,
                                                          gpt_small_config)
    from tf_operator_tpu_torch.models.vit import ViT, vit_base_config
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.parallel.tp_rules import param_layouts
    from tf_operator_tpu_torch.train import zero

    for name, argv, steps, blocks, items, unit, meshes in MESH_RUNS:
        runs = {"plain": mesh_run(name, argv, steps, blocks)}
        for tag, mesh, knob in meshes:
            env = {"TPUJOB_MESH_SHAPE": json.dumps(mesh)}
            if knob:
                env["TPUJOB_ZERO_SHARD_WEIGHT_UPDATE"] = "1"
            with one_rank_group(env):
                runs[tag] = mesh_run(name, argv, steps, blocks)
            if knob and "dp axis size is 1, running dense" not in \
                    runs[tag][0]:
                raise RuntimeError(f"{name} {tag}: the ZeRO knob at dp 1 "
                                   "did not run dense")
        runs["plain again"] = mesh_run(name, argv, steps, blocks)
        plain = runs["plain"][1]
        for tag, (log, losses, peak) in runs.items():
            if len(losses) != steps or len(plain) != steps:
                raise RuntimeError(f"{name} {tag}: {len(losses)} losses "
                                   f"for {steps} steps")
            for i, (got, want) in enumerate(zip(losses, plain)):
                if not (math.isfinite(want) and
                        abs(got - want) <= 1e-5 * abs(want)):
                    raise RuntimeError(f"{name} {tag}: step {i} loss {got} "
                                       f"against the plain run's {want}")
            m = STEP_TIME.search(log)
            worst = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
            print(f"encoder_mesh {name} {tag}: step {m.group(1)} ms, "
                  f"{m.group(2)} {unit}/s ({items} {unit} a step), peak "
                  f"memory {peak / 2**30:.2f} GiB; losses {losses}, worst "
                  f"relative difference to the plain run {worst:.2e} "
                  f"[{card}]", flush=True)
        print(f"encoder_mesh {name}: losses equal to the plain run's within "
              f"1e-5 relative under {[tag for tag, _, _ in meshes]}",
              flush=True)
        if name == "lm":
            lm_plain = [runs["plain"], runs["plain again"]]

    layout = build_mesh({"dp": 2, "fsdp": 4}, 8)
    with torch.device("meta"):
        models = {"vit-b16": ViT(vit_base_config(max_len=197)),
                  "bert-base": BertEncoder(bert_base_config()),
                  "gpt-small": TransformerLM(gpt_small_config())}
    for label, model in models.items():
        plan = zero.plan_for_model(model, layout)
        layouts = param_layouts(model, layout, plan)
        sharded = sum(e.dim is not None for e in plan.entries)
        heads = sum(lay.zero_split is not None for lay in layouts.values())
        print(f"encoder_mesh: computed, not measured: {label}'s ZeRO plan "
              f"at {layout.shape} shards {sharded} of {len(plan.entries)} "
              f"entries over dp, {heads} of them on a head_dim (the split "
              "[heads x head_dim] view)", flush=True)
    return lm_plain


# ---------------------------------------------------------------------------
# the ninth path: one process per GPU, started by the per-pod launcher

POD_CHILD = re.compile(r"^pod child: (\{.*\})$", re.M)
LOCAL_PIDS = re.compile(r"^pod launcher: local rank pids \[([\d, ]+)\]$",
                        re.M)


def pod_child(argv) -> int:
    """`chip_smoke.py --pod-child ARGS`: a local rank that the pod launcher
    starts, running `workloads.lm.main(ARGS)` through the launcher's child
    path, then printing `pod child: {...}` with every step's loss in full
    precision and each kernel's launches over the run."""
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.workloads import lm
    from tf_operator_tpu_torch.workloads.launch import run_pod

    A.reset_launches()
    with step_losses_kept() as losses:
        rc = run_pod(lm.main, argv)
    print("pod child: " + json.dumps({
        "rc": rc, "losses": [float(x) for x in losses],
        "launches": A.launches()}), flush=True)
    return rc


def launch_pod(argv, **kwargs) -> subprocess.Popen:
    """The pod command through the launcher's entry with an explicit L = 1
    (`workloads.launch --local-ranks 1`), its output in one text pipe."""
    return subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.workloads.launch",
         "--local-ranks", "1", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, **kwargs)


def finished(proc: subprocess.Popen) -> tuple:
    """(exit code, output) of a `launch_pod` process."""
    try:
        out, _ = proc.communicate(timeout=PROCESS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise RuntimeError(f"pod: the launcher ran over {PROCESS_TIMEOUT} s:"
                           f"\n{out[-4000:]}")
    return proc.returncode, out


def phase_pod(card: str, lm_plain):
    """The ninth path on one card: GPT-small through the per-pod launcher's
    spawn path at L = 1 (its entry with an explicit count), the child over
    a one-rank NCCL group, 11 steps: every loss in full precision equal to
    the in-process plain runs' of the encoder_mesh phase, 12 launches a
    step of each kernel in the child, step ms and tokens/s beside the
    in-process runs'.  Then the preemption relay (2 layers, 15 steps):
    SIGTERM to the launcher alone after the first checkpoint exits 143
    with the child gone, the state restored from the newest checkpoint
    equals the saved one bit for bit, and the rerun resumes from it and
    finishes."""
    import signal

    import torch

    from tf_operator_tpu_torch.models.transformer import (TransformerLM,
                                                          gpt_small_config)
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.optim import lm_optimizer
    from tf_operator_tpu_torch.train.state import (create_train_state,
                                                   full_state)

    steps, layers = 11, 12
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, out = finished(launch_pod([os.path.abspath(__file__), "--pod-child",
                                   "--steps", str(steps)]))
    wall = time.perf_counter() - t0
    m = POD_CHILD.search(out)
    if rc != 0 or m is None or "pod launcher: 1 pod(s) x 1 local rank(s), " \
            "world 1" not in out:
        raise RuntimeError(f"pod: the launcher exited {rc}:\n{out[-4000:]}")
    child = json.loads(m.group(1))
    for name, n in child["launches"].items():
        if n != layers * steps:
            raise RuntimeError(f"pod: {name} launched {n} times in the "
                               f"child, expected {layers * steps}")
    for log, losses, _ in lm_plain:
        if child["losses"] != losses:
            raise RuntimeError(f"pod: the child's losses {child['losses']} "
                               f"against the in-process run's {losses}")
    times = [STEP_TIME.search(log) for log in
             (lm_plain[0][0], out, lm_plain[1][0])]
    print(f"pod: GPT-small through the launcher at L 1 (NCCL, world 1), "
          f"{steps} steps: losses {child['losses']} equal in full precision "
          f"to both in-process runs'; launches {child['launches']} "
          f"({layers} a step each); step ms in turns: in-process "
          f"{times[0].group(1)}, launcher {times[1].group(1)}, in-process "
          f"{times[2].group(1)}; tokens/s {times[0].group(2)}, "
          f"{times[1].group(2)}, {times[2].group(2)}; the launcher's wall "
          f"{wall:.1f} s [{card}]", flush=True)

    # the preemption relay: SIGTERM to the launcher alone.  15 steps save
    # at 5, 10 and 15: with the manager's three kept, the rerun never
    # prunes the checkpoint that is checked while it starts
    argv = ["-m", "tf_operator_tpu_torch.workloads.lm", "--layers", "2",
            "--steps", "15", "--checkpoint-every", "5"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pod-preempt-") as ckpt:
        argv += ["--checkpoint-dir", ckpt]
        proc = launch_pod(argv)
        deadline = time.monotonic() + PROCESS_TIMEOUT
        while not os.path.exists(os.path.join(ckpt, "5", "state.pt")):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("pod: the first checkpoint never came: "
                                   f"{finished(proc)[1][-4000:]}")
            time.sleep(0.02)
        first_life = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc, out = finished(proc)
        pids = LOCAL_PIDS.search(out)
        if rc != 143 or "pod launcher: exit 143" not in out or pids is None:
            raise RuntimeError(f"pod: SIGTERM to the launcher exited {rc}, "
                               f"expected 143:\n{out[-4000:]}")
        left = [pid for pid in map(int, pids.group(1).split(","))
                if os.path.exists(f"/proc/{pid}")]
        if left:
            raise RuntimeError(f"pod: local ranks {left} outlived the pod")
        manager = CheckpointManager(ckpt)
        saved_step = manager.latest_step()
        # the rerun's process starts while the saved state is checked here
        t0 = time.perf_counter()
        rerun = launch_pod(argv)
        try:
            saved = torch.load(os.path.join(ckpt, str(saved_step),
                                            "state.pt"),
                               map_location="cpu", weights_only=True)
            template = create_train_state(
                TransformerLM(gpt_small_config(num_layers=2)),
                lm_optimizer(3e-4), seed=1, device=torch.device("cuda"))
            restored = full_state(manager.restore(template))
            pairs = [(restored["model"][n], t)
                     for n, t in saved["model"].items()]
            pairs += [(restored["optimizer"][n][k], t)
                      for n, moments in saved["optimizer"].items()
                      for k, t in moments.items()]
            if restored["step"] != saved_step or not all(
                    torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b))
                    for a, b in pairs):
                raise RuntimeError("pod: the restored state differs from "
                                   "the saved one")
            del template, restored, saved
        except BaseException:
            rerun.kill()
            rerun.communicate()
            raise
        rc, out = finished(rerun)
        second_life = time.perf_counter() - t0
        if rc != 0 or f"resumed from step {saved_step}" not in out or \
                "\ndone\n" not in out:
            raise RuntimeError(f"pod: the rerun exited {rc} or did not "
                               f"resume from step {saved_step}:\n"
                               f"{out[-4000:]}")
    print(f"pod: SIGTERM to the launcher alone exited 143, its local rank "
          f"gone; {len(pairs)} saved tensors of step {saved_step} restored "
          f"bit for bit on the card; the rerun resumed from step "
          f"{saved_step} and finished (GPT-small width, 2 layers, 15 "
          f"steps); walls: to the first checkpoint {first_life:.1f} s, the "
          f"rerun {second_life:.1f} s [{card}]", flush=True)


# ---------------------------------------------------------------------------
# the third path: the classification workloads at full width


def conv_dense_flops(model, image_size: int) -> float:
    """Forward FLOPs of one image through `model`'s convolutions and dense
    layers (2 x multiply-adds), from each layer's weight and output shape
    in a forward pass of one image on the model's device."""
    import torch

    total = []

    def conv_hook(module, inputs, out):
        # out [1, Cout, H, W]; each output element takes Cin * kh * kw MACs
        total.append(2.0 * out.numel() * module.weight[0].numel())

    def dense_hook(module, inputs, out):
        total.append(2.0 * module.weight.numel())

    from tf_operator_tpu_torch.models import resnet as R

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, R.Conv)]
    hooks += [m.register_forward_hook(dense_hook) for m in model.modules()
              if isinstance(m, torch.nn.Linear)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image_size, image_size, 3,
                              device=next(model.parameters()).device))
    finally:
        for hook in hooks:
            hook.remove()
    return sum(total)


def encoder_flops(cfg, batch: int, seq: int, per_sequence: float) -> float:
    """FLOPs of one training step (3 x forward) of a non-causal encoder's
    products: the blocks' projections and MLP per token, attention over
    T^2 pairs, plus `per_sequence` forward FLOPs of each sequence outside
    the blocks (patch embedding, pooler, heads)."""
    head_dim = cfg.d_model // cfg.num_heads
    per_token = 2 * cfg.num_layers * (4 * cfg.d_model ** 2 +
                                      2 * cfg.d_model * cfg.d_ff)
    attn = cfg.num_layers * cfg.num_heads * 2 * 2 * seq * seq * head_dim
    return 3.0 * batch * (seq * per_token + attn + per_sequence)


def run_classification(card: str, out_dir, name: str, argv, steps: int,
                       flops: float, launches_per_step: int = 0):
    """The workload `name` for `steps` steps at `argv`: every step's loss
    finite, its step time line read, MFU against PEAK_BF16_FLOPS from
    `flops` per step, peak memory; the kernels' launches counted from zero
    over the run when `launches_per_step`; then two steps profiled through
    its --profile-dir.  Returns the run's log, every step's loss in full
    precision, and for vit and bert the launches of the encoders' kernels
    over the run (each must be every launch of its wrapper)."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    with step_losses_kept() as kept:
        log = run_workload(name, argv + ["--steps", str(steps),
                                         "--log-every", "1"])
    short = {}
    if launches_per_step:
        check_launches(launches_per_step * steps, f"{name} run")
        short = check_route_launches("short", launches_per_step * steps,
                                     f"{name} run")
    peak = torch.cuda.max_memory_allocated()
    losses = step_losses(log)
    if sorted(losses) != list(range(steps)) or not all(
            math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"{name}: losses missing or not finite: {losses}")
    m = STEP_TIME.search(log)
    if m is None:
        raise RuntimeError(f"{name}: the workload printed no step time")
    ms = float(m.group(1))
    mfu = flops / (ms / 1e3) / PEAK_BF16_FLOPS
    print(f"{name} step: {ms} ms/step, {m.group(2)} {m.group(3)}/s, "
          f"{flops / 1e12:.3f} TFLOP/step, MFU {mfu:.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses} [{card}]", flush=True)

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=f"{name}-profile-") as prof_dir:
        run_workload(name, argv + ["--steps", "4", "--profile-dir", prof_dir,
                                   "--profile-start", "2",
                                   "--profile-steps", "2"])
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    summary = device_profile(events, 2, ms)
    print(summary, flush=True)
    write_detail(out_dir, f"profile_{name}.txt", f"{card}\n{summary}\n")
    return log, [float(x) for x in kept], short


def phase_resnet(card: str, out_dir):
    import torch

    from tf_operator_tpu_torch.models import resnet as R

    batch, size = 256, 224
    probe = R.ResNet50(num_classes=1000)
    probe.reset_parameters(torch.Generator().manual_seed(0))
    flops = 3.0 * batch * conv_dense_flops(probe.cuda(), size)
    del probe
    log, _, _ = run_classification(card, out_dir, "resnet", [], 8, flops)
    if "image source: native" not in log:
        raise RuntimeError("resnet: the images did not come from the native "
                           "loader")

    # bf16 convs against f32 on the card: the same weights, the same batch,
    # train mode (batch statistics), without gradients
    g = torch.Generator().manual_seed(5)
    model = R.ResNet50(num_classes=1000)
    model.reset_parameters(g)
    with torch.no_grad():
        for block in model.blocks:
            block.norms[-1].weight.fill_(0.1)
    f32 = R.ResNet50(num_classes=1000, dtype=torch.float32)
    f32.load_state_dict(model.state_dict())
    model.cuda().train()
    f32.cuda().train()
    images = torch.randn(16, size, size, 3, generator=g).cuda()
    with torch.no_grad():
        got, ref = model(images), f32(images)
    logits_within("resnet-50 logits, bf16 convs vs f32 (B 16, 224x224)",
                  got, ref, (16, 1000))


def phase_encoder(card: str, out_dir, name: str):
    """vit or bert: the workload, then its model on the kernels against the
    same model on the plain attention path; returns the launches of the
    encoders' kernels over the workload's run."""
    import dataclasses

    import torch

    from tf_operator_tpu_torch.models.transformer import (BertEncoder,
                                                          bert_base_config)
    from tf_operator_tpu_torch.models.vit import ViT, vit_base_config

    if name == "vit":
        batch, seq, steps = 256, 197, 5
        cfg = vit_base_config(max_len=seq)
        per_seq = 2.0 * (seq - 1) * 3 * 16 * 16 * cfg.d_model + \
            2.0 * cfg.d_model * 1000

        def build(c):
            return ViT(c, num_classes=1000, patch_size=16, image_size=224)

        def inputs(g):
            return torch.randn(8, 224, 224, 3, generator=g)
        shape = (8, 1000)
    else:
        batch, seq, steps = 32, 128, 10
        cfg = bert_base_config(max_len=seq)
        per_seq = 2.0 * cfg.d_model ** 2 + 2.0 * cfg.d_model * 2

        def build(c):
            return BertEncoder(c, num_labels=2)

        def inputs(g):
            return torch.randint(0, cfg.vocab_size, (8, seq), generator=g)
        shape = (8, 2)
    flops = encoder_flops(cfg, batch, seq, per_seq)
    _, first, short = run_classification(card, out_dir, name, [], steps,
                                         flops,
                                  launches_per_step=cfg.num_layers)

    g = torch.Generator().manual_seed(6)
    model = build(cfg)
    model.reset_parameters(g)
    plain = build(dataclasses.replace(cfg, use_flash=False))
    plain.load_state_dict(model.state_dict())
    model.cuda()
    plain.cuda()
    x = inputs(g).cuda()

    def logits(out):
        return out["logits"] if isinstance(out, dict) else out

    with torch.no_grad():
        got, ref = logits(model(x)), logits(plain(x))
    logits_within(f"{name} {cfg.num_layers}-layer logits, kernels vs plain "
                  f"attention (B 8, T {seq})", got, ref, shape)
    if name == "bert":
        # the workload's run again, one seed and one batch stream: the same
        # losses to the bit (every embedding's table gradient sums in token
        # order)
        del model, plain
        second = mesh_run("bert", [], steps, cfg.num_layers)[1]
        if first != second:
            raise RuntimeError(f"two plain BERT runs part: {first} against "
                               f"{second}")
        print(f"bert: two plain runs give equal losses in full precision "
              f"over {steps} steps: {first} [{card}]", flush=True)
    return short


# ---------------------------------------------------------------------------
# the fifth path: the small workloads


def final_loss(log: str, pattern: str = r"^final loss (\S+)$") -> float:
    m = re.search(pattern, log, re.M)
    if m is None:
        raise RuntimeError(f"no final loss line ({pattern})")
    return float(m.group(1))


def phase_mnist(card: str, out_dir):
    """BASELINE config 1: the MNIST workload, MLP and CNN at the JAX
    defaults (B 64, Adam 1e-3), 200 steps each on the card: final loss
    below 1.0, the step time line, two profiled steps; then each model's
    logits on the card against the same weights in f32 on the CPU."""
    import torch

    from tf_operator_tpu_torch.models.mnist import MnistCNN, MnistMLP
    from tf_operator_tpu_torch.train.data import synthetic_mnist

    print(f"TF32 in force: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    for model in ("mlp", "cnn"):
        log = run_workload("mnist", ["--model", model, "--steps", "200"])
        loss = final_loss(log)
        if not (math.isfinite(loss) and loss < 1.0):
            raise RuntimeError(f"mnist {model}: final loss {loss} is not "
                               "below 1.0")
        m = STEP_TIME.search(log)
        if m is None:
            raise RuntimeError(f"mnist {model}: the workload printed no "
                               "step time")
        ms = float(m.group(1))
        print(f"mnist {model} (B 64, 200 steps): final loss {loss}, {ms} "
              f"ms/step, {m.group(2)} images/s [{card}]", flush=True)
        with tempfile.TemporaryDirectory(prefix="mnist-profile-") as prof:
            run_workload("mnist", ["--model", model, "--steps", "4",
                                   "--profile-dir", prof, "--profile-start",
                                   "2", "--profile-steps", "2"])
            with open(os.path.join(prof, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        summary = device_profile(events, 2, ms)
        print(summary, flush=True)
        write_detail(out_dir, f"profile_mnist_{model}.txt",
                     f"{card}\n{summary}\n")

    x = torch.from_numpy(next(synthetic_mnist(64, seed=0))["x"])
    saved = torch.backends.cudnn.allow_tf32
    try:
        for cls in (MnistMLP, MnistCNN):
            ref_model = cls()
            ref_model.reset_parameters(torch.Generator().manual_seed(0))
            model = cls(device="cuda")
            model.load_state_dict(ref_model.state_dict())
            kw = {} if cls is MnistMLP else {"train": False}
            with torch.no_grad():
                ref = ref_model(x, **kw)
                for tf32, tol in ((False, TOL_MNIST_F32), (True, TOL_LOGITS)):
                    torch.backends.cudnn.allow_tf32 = tf32
                    got = model(x.cuda(), **kw).cpu()
                    logits_within(
                        f"{cls.__name__} logits, card (cudnn.allow_tf32="
                        f"{tf32}) vs f32 on the CPU (B 64)", got, ref,
                        (64, 10), tol)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def phase_preempt(card: str):
    """BASELINE config 5 on the card: the MNIST run checkpoints at step 5
    and exits 143; the state a fresh process would restore equals the saved
    one bit for bit; the rerun resumes at step 5 and finishes."""
    import torch

    from tf_operator_tpu_torch.models.mnist import MnistMLP
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.optim import adam
    from tf_operator_tpu_torch.train.state import (create_train_state,
                                                   full_state)

    with tempfile.TemporaryDirectory(prefix="mnist-preempt-") as ckpt:
        argv = ["--steps", "12", "--checkpoint-dir", ckpt,
                "--preempt-at-step", "5"]
        rc, log = run_module("mnist", argv)
        if rc != 143 or "preempted at step 5, checkpoint saved" not in log:
            raise RuntimeError(f"preempt: the first life exited {rc}, "
                               "expected 143 after its checkpoint")
        saved = torch.load(os.path.join(ckpt, "5", "state.pt"),
                           map_location="cpu", weights_only=True)
        template = create_train_state(MnistMLP(), adam(1e-3), seed=1,
                                      device=torch.device("cuda"))
        restored = full_state(CheckpointManager(ckpt).restore(template))
        pairs = [(restored["model"][n], t) for n, t in saved["model"].items()]
        pairs += [(restored["optimizer"][n][k], t)
                  for n, moments in saved["optimizer"].items()
                  for k, t in moments.items()]
        if restored["step"] != 5 or not all(
                torch.equal(a.cpu(), b) for a, b in pairs):
            raise RuntimeError("preempt: the restored state differs from "
                               "the saved one")
        rc, log = run_module("mnist", argv)
        if rc != 0 or "resumed from checkpoint step 5" not in log:
            raise RuntimeError(f"preempt: the second life exited {rc} or "
                               "did not resume from step 5")
        loss = final_loss(log)
    print(f"preempt: exit 143 at step 5, {len(pairs)} saved tensors restored "
          f"bit for bit on the card, resumed to step 12, final loss {loss} "
          f"[{card}]", flush=True)


class Processes:
    """Workload processes started with their own TF_CONFIG, each writing
    its log to a file; every one is stopped on exit.  Each gets one
    intra-op CPU thread (OMP_NUM_THREADS=1), as each pod gets its own
    cores: six processes share the host's cores here, and a worker's math
    runs on the card."""

    def __init__(self, tmp: str):
        self.tmp, self.procs = tmp, {}

    def start(self, key: str, module: str, argv, tf_config: dict,
              env_extra=None):
        env = dict(os.environ,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                   TF_CONFIG=json.dumps(tf_config), OMP_NUM_THREADS="1")
        for name in ("TPUJOB_FORCE_PLATFORM", "TPUJOB_PROCESS_ID",
                     "TPUJOB_NUM_PROCESSES", "TPUJOB_COORDINATOR_ADDRESS"):
            env.pop(name, None)
        env.update(env_extra or {})
        out = open(os.path.join(self.tmp, f"{key}.log"), "w")
        self.procs[key] = (subprocess.Popen(
            [sys.executable, "-m", f"tf_operator_tpu_torch.workloads.{module}"]
            + list(argv), env=env, stdout=out, stderr=subprocess.STDOUT),
            out)

    def wait(self, keys) -> dict:
        """{key: log} once each of `keys` has exited 0; raises otherwise."""
        deadline = time.time() + PROCESS_TIMEOUT
        logs = {}
        for key in keys:
            proc, out = self.procs[key]
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                rc = None
            out.close()
            with open(out.name) as f:
                logs[key] = f.read()
            if rc != 0:
                raise RuntimeError(f"{key} exited {rc}:\n{logs[key][-3000:]}")
        return logs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for proc, out in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def cluster_spec(**counts) -> dict:
    return {kind: [f"127.0.0.1:{free_port()}" for _ in range(n)]
            for kind, n in counts.items()}


def phase_dist_mnist(card: str):
    """BASELINE config 2: 2 PS + 4 workers as processes with TF_CONFIG (the
    PS on the host, the four workers on the one card), 200 steps on each
    transport; every worker's final loss finite and below 1.5; worker
    steps/s and the pull and push ms per step from their logs."""
    from tf_operator_tpu_torch.train import native_ps, ps

    for transport in ("python", "native"):
        cluster = cluster_spec(ps=2, worker=4)
        argv = ["--steps", "200", "--transport", transport]
        with tempfile.TemporaryDirectory(prefix="dist-mnist-") as tmp, \
                Processes(tmp) as procs:
            t0 = time.perf_counter()
            for kind, n in (("ps", 2), ("worker", 4)):
                for i in range(n):
                    procs.start(f"{kind}{i}", "dist_mnist", argv,
                                {"cluster": cluster,
                                 "task": {"type": kind, "index": i}})
            logs = procs.wait([f"worker{i}" for i in range(4)])
            wall = time.perf_counter() - t0
            client = (native_ps.NativePSClient if transport == "native"
                      else ps.PSClient)(cluster["ps"])
            client.shutdown_servers()
            client.close()
            procs.wait(["ps0", "ps1"])
        rates, pulls, pushes = [], [], []
        for i in range(4):
            log = logs[f"worker{i}"]
            loss = final_loss(
                log, rf"^worker {i} \({transport} transport\) final loss "
                r"(\S+)$")
            if not (math.isfinite(loss) and loss < 1.5):
                raise RuntimeError(f"dist_mnist {transport}: worker {i} "
                                   f"final loss {loss}")
            m = STEP_TIME.search(log)
            io = re.search(rf"^worker {i} pull (\S+) ms \+ push (\S+) ms",
                           log, re.M)
            if m is None or io is None:
                raise RuntimeError(f"dist_mnist: worker {i} printed no "
                                   "timing lines")
            rates.append(1e3 / float(m.group(1)))
            pulls.append(float(io.group(1)))
            pushes.append(float(io.group(2)))
        print(f"dist_mnist {transport} (2 PS + 4 workers, B 64, 200 steps): "
              f"worker steps/s {[round(r, 2) for r in rates]}, pull ms/step "
              f"{pulls}, push ms/step {pushes}, job wall {wall:.1f} s incl. "
              f"process start [{card}]", flush=True)


def phase_estimator(card: str):
    """The estimator's train-and-evaluate: chief + worker + 1 PS +
    evaluator as processes; the chief publishes DONE and the evaluator
    evaluates at least one of its checkpoints."""
    cluster = cluster_spec(chief=1, worker=1, ps=1)
    with tempfile.TemporaryDirectory(prefix="estimator-") as tmp, \
            Processes(tmp) as procs:
        model_dir = os.path.join(tmp, "model")
        argv = ["--steps", "200", "--model-dir", model_dir]
        for kind in ("ps", "evaluator", "worker", "chief"):
            procs.start(kind, "estimator", argv,
                        {"cluster": cluster,
                         "task": {"type": kind, "index": 0}})
        logs = procs.wait(["chief", "worker", "ps", "evaluator"])
        done = os.path.exists(os.path.join(model_dir, "DONE"))
    evals = re.findall(r"^eval step=(\d+) loss=(\S+)$", logs["evaluator"],
                       re.M)
    if not done or "chief: published DONE" not in logs["chief"] or \
            not evals or "evaluator done" not in logs["evaluator"]:
        raise RuntimeError("estimator: no DONE, or the evaluator saw no "
                           "checkpoint")
    print(f"estimator: DONE published; evaluator saw {len(evals)} "
          f"checkpoint(s), last step {evals[-1][0]} loss {evals[-1][1]} "
          f"[{card}]", flush=True)


def phase_multislice(card: str):
    """multislice_check as the controller launches it for 4 workers of a
    2x4 (2-host) slice topology: 4 processes on the one card with the
    injected env (process ids, the coordinator, the MEGASCALE document: 2
    slices, slice = index // 2); they join one NCCL group, gather the
    fabric table over gloo and check it."""
    cluster = cluster_spec(worker=4)
    coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="multislice-") as tmp, \
            Processes(tmp) as procs:
        for i in range(4):
            procs.start(f"worker{i}", "multislice_check", [],
                        {"cluster": cluster,
                         "task": {"type": "worker", "index": i}},
                        {"TPUJOB_PROCESS_ID": str(i),
                         "TPUJOB_NUM_PROCESSES": "4",
                         "TPUJOB_COORDINATOR_ADDRESS": coordinator,
                         "TPUJOB_SLICE_TOPOLOGY": "2x4",
                         "MEGASCALE_COORDINATOR_ADDRESS":
                             cluster["worker"][0],
                         "MEGASCALE_NUM_SLICES": "2",
                         "MEGASCALE_SLICE_ID": str(i // 2)})
        logs = procs.wait([f"worker{i}" for i in range(4)])
    table = "fabric table: [[0, 0], [1, 0], [2, 1], [3, 1]]"
    if not all(table in log and "multislice_check OK" in log
               for log in logs.values()):
        raise RuntimeError("multislice: a process saw another table")
    print(f"multislice: 4 processes on one card, one NCCL group, {table} "
          f"checked by every process [{card}]", flush=True)


def phase_smoke(card: str):
    """workloads.smoke (a bf16 1024 x 1024 matmul) and allreduce_check
    (one process: the JAX workload's early exit) on the card."""
    log = run_workload("smoke", [])
    if "smoke matmul on cuda" not in log:
        raise RuntimeError("smoke: the matmul did not run on the card")
    rc, log2 = run_module("allreduce_check")
    if rc != 0 or "single process; nothing to verify" not in log2:
        raise RuntimeError(f"allreduce_check exited {rc}")
    print(f"smoke: {log.strip().splitlines()[-1]} [{card}]", flush=True)


# ---------------------------------------------------------------------------
# the sixth path: KV-cache decoding and mixture of experts

# 128 new tokens (formerly 256: halved to keep the whole script's time
# once the kernels' coverage cases and the autotune phase were added)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 8, 1024, 128
SAMPLE_LINE = re.compile(r"^sample: (\[.*\])$", re.M)
AUX_LINE = re.compile(r"^step (\d+) moe_aux_loss (\S+)$", re.M)


def decode_steps(model, prompt, steps: int, forced=None):
    """Greedy decoding as `models.generate.generate` runs it (one prefill,
    then T=1 calls on the same cache), each call timed by CUDA events:
    (tokens [B, steps], logits [B, steps, V] f32, prefill ms, T=1 step ms
    list).  With `forced` [B, steps] the cache is fed those tokens in
    place of its own picks (the same history for two caches)."""
    import torch

    cache = model.init_cache(prompt.shape[0])
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    tokens, logits = [], []
    with torch.no_grad():
        marks[0].record()
        out = model(prompt, cache=cache)[:, -1]
        for i in range(steps):
            marks[i + 1].record()
            logits.append(out.float())
            tokens.append(out.argmax(-1))
            if i + 1 < steps:
                feed = tokens[-1] if forced is None else forced[:, i]
                out = model(feed[:, None], cache=cache)[:, -1]
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return (torch.stack(tokens, 1), torch.stack(logits, 1), times[0],
            times[1:])


def decode_case(card: str, name: str, model, prompt, history=None) -> dict:
    """One config's decoding at full width: `generate` as a user calls it
    (no kernel launched: the decode path is the plain one, as the JAX
    package's), its peak memory and wall time; the step loop's prefill ms,
    median ms per token and tokens/s; its tokens equal `generate`'s; and
    its logits held by the model-logits rule against the training forward
    (the kernels) over the generated sequence, its tokens equal to the
    forward's wherever the forward's top-2 margin exceeds the rule.  With
    `history` (another cache's case on the same weights) the step loop is
    fed that case's tokens and held against that case's forward."""
    import torch

    from tf_operator_tpu_torch.models.generate import generate
    from tf_operator_tpu_torch.ops import attention as A

    b, p = prompt.shape
    cache = model.init_cache(b)
    cache_bytes = sum(t.nbytes for layer in cache.layers
                      for t in (layer.cached_key, layer.cached_value,
                                layer.cached_key_scale,
                                layer.cached_value_scale, layer.cached_pos1)
                      if t is not None)
    slots = cache.layers[0].cached_key.shape[2]
    del cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.perf_counter()
    out = generate(model, prompt, DECODE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise RuntimeError(f"{name}: decoding launched kernels {launches}")
    tokens, logits, prefill_ms, step_ms = decode_steps(
        model, prompt, DECODE_NEW,
        forced=None if history is None else history["tokens"])
    if history is None and not torch.equal(tokens, out[:, p:]):
        raise RuntimeError(f"{name}: the step loop's tokens differ from "
                           "generate's")
    step_ms.sort()
    median = step_ms[len(step_ms) // 2]
    rate = b * len(step_ms) / (sum(step_ms) / 1e3)
    print(f"decode {name}: B {b}, prompt {p}, {DECODE_NEW} greedy tokens: "
          f"prefill {prefill_ms:.3f} ms, median {median:.3f} ms per token, "
          f"{rate:.1f} decode tokens/s; generate() wall {wall:.3f} s; cache "
          f"{cache_bytes} bytes ({slots} slots a layer); peak memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches} [{card}]",
          flush=True)
    ref = teacher_forced(model, out, p) if history is None else \
        history["ref"]
    check_decode_logits(f"decode {name}", logits, ref, tokens)
    return {"tokens": tokens, "free": out[:, p:], "ref": ref,
            "cache_bytes": cache_bytes}


def teacher_forced(model, seq, prompt_len: int):
    """The training forward's (the kernels') f32 logits over `seq` at the
    positions that predict its generated tokens: [B, N, V]."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    A.reset_launches()
    with torch.no_grad():
        logits = model(seq)[:, prompt_len - 1:-1].float()
    if not all(A.launches()[k] == 0 for k in ("flash_backward_dq",
                                              "flash_backward_dkv")) or \
            A.launches()["flash_forward"] != model.cfg.num_layers:
        raise RuntimeError(f"teacher-forced forward: launches "
                           f"{A.launches()}")
    return logits


def check_decode_logits(what: str, got, ref, tokens) -> None:
    """The model-logits rule on every step's logits, and each greedy token
    equal to the forward's argmax wherever the forward's top-2 margin
    exceeds the rule."""
    import torch

    limit = TOL_LOGITS * float(ref.abs().max())
    logits_within(f"{what}: step logits vs the training forward", got, ref,
                  tuple(ref.shape))
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > limit
    wrong = int(((tokens != ref.argmax(-1)) & clear).sum())
    print(f"{what}: {int(clear.sum())} of {clear.numel()} steps with a "
          f"top-2 margin above {limit:.3e}; tokens off the forward's there: "
          f"{wrong}", flush=True)
    if wrong:
        raise RuntimeError(f"{what}: {wrong} tokens differ where the "
                           "forward's choice is clear")


def phase_decode(card: str):
    """The sixth path's decoding at GPT-small full width (12 x 768, vocab
    32000, max_len 2048) from seeded weights: B 8, a 1024-token prompt,
    128 greedy tokens with the model-dtype cache, then with the int8
    cache (fed the model-dtype run's tokens: per-step greedy agreement
    at least 0.9, JAX's bar), then llama (4 KV heads, RoPE) with window
    256 + sink 4 (a rolling cache of 260 slots) against the windowed
    kernels; last the workload's --sample-tokens."""
    import dataclasses

    import torch

    from tf_operator_tpu_torch.models.transformer import (
        TransformerLM, gpt_small_config, llama_style_config)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)
    cfg = gpt_small_config()
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(20))
    model.to(dev)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT),
                           generator=gen).to(dev)
    base = decode_case(card, "gpt-small bf16 cache", model, prompt)
    want = 12 * 2 * DECODE_BATCH * 12 * cfg.max_len * 64 * 2
    if base["cache_bytes"] != want:
        raise RuntimeError(f"cache {base['cache_bytes']} bytes, expected "
                           f"{want}")

    quant = TransformerLM(dataclasses.replace(cfg, kv_cache_dtype="int8"))
    quant.load_state_dict(model.state_dict())
    quant.to(dev)
    q = decode_case(card, "gpt-small int8 cache (steps fed the bf16 "
                    "run's tokens)", quant, prompt, history=base)
    agree = float((q["tokens"] == base["tokens"]).float().mean())
    free = float((q["free"] == base["tokens"]).float().mean())
    print(f"decode int8 cache: {q['cache_bytes']} bytes against "
          f"{base['cache_bytes']}; greedy agreement with the bf16 cache "
          f"{agree:.4f} step by step on the same history, {free:.4f} "
          f"free-running (the bar: 0.9 step by step) [{card}]", flush=True)
    if agree < 0.9:
        raise RuntimeError(f"int8 cache agreement {agree} < 0.9")
    del quant, model
    torch.cuda.empty_cache()

    lcfg = llama_style_config(attn_window=256, attn_sink=4)
    llama = TransformerLM(lcfg)
    llama.reset_parameters(torch.Generator().manual_seed(22))
    llama.to(dev)
    decode_case(card, "llama window 256 + sink 4", llama, prompt)
    del llama
    torch.cuda.empty_cache()

    log = run_lm(["--steps", "2", "--sample-tokens", "32"])
    m = SAMPLE_LINE.search(log)
    sample = json.loads(m.group(1)) if m else []
    if len(sample) != 40 or not all(0 <= t < cfg.vocab_size
                                    for t in sample):
        raise RuntimeError(f"the workload's sample line is wrong: {sample}")
    print(f"decode: lm.py --steps 2 --sample-tokens 32 printed a sample of "
          f"{len(sample)} tokens", flush=True)


def phase_moe(card: str, out_dir):
    """The sixth path's mixture of experts: `lm.py --moe-experts 8` at
    GPT-small defaults (top-2, capacity factor 1.25, every second block:
    6 MoE blocks), 11 steps: every kernel launched 12 x steps times, loss
    and load-balancing loss finite, the loss falling, step time, tokens/s,
    peak memory; the same run over a one-rank NCCL group with
    {"dp": 1, "ep": 1} (the logits gathered over the data group, the
    experts' collectives over ep), two of its steps profiled, with the
    plain run's losses within 1e-5 relative; then one MoE layer on the
    card against its CPU f32 run with the card's dispatch."""
    import torch

    from tf_operator_tpu_torch.models.transformer import (TransformerLM,
                                                          gpt_small_config)
    from tf_operator_tpu_torch.ops import attention as A

    steps, layers = 11, 12
    argv = ["--moe-experts", "8", "--steps", str(steps)]
    with torch.device("meta"):
        count = sum(p.numel() for p in TransformerLM(gpt_small_config(
            moe_num_experts=8)).parameters())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    log = run_lm(argv)
    counts = check_launches(layers * steps, "moe LM")
    peak = torch.cuda.max_memory_allocated()
    losses = step_losses(log)
    aux = {int(i): float(v) for i, v in AUX_LINE.findall(log)}
    values = list(losses.values()) + list(aux.values())
    if sorted(losses) != [0, 10] or sorted(aux) != [0, 10] or \
            not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"moe LM: losses {losses}, aux {aux}")
    if not losses[10] < losses[0]:
        raise RuntimeError(f"moe LM: the loss did not fall: {losses}")
    m = STEP_TIME.search(log)
    print(f"moe LM ({count} parameters, 8 experts, top-2, 6 MoE blocks): "
          f"loss {losses[0]} -> {losses[10]}, moe_aux_loss {aux[0]} -> "
          f"{aux[10]}; {m.group(1)} ms/step, {m.group(2)} tokens/s, peak "
          f"memory {peak / 2**30:.2f} GiB; kernel launches {counts} "
          f"[{card}]", flush=True)

    mesh = json.dumps({"dp": 1, "ep": 1})
    with one_rank_group({"TPUJOB_MESH_SHAPE": mesh}), \
            tempfile.TemporaryDirectory(prefix="moe-profile-") as prof_dir:
        torch.cuda.empty_cache()
        log2 = run_lm(argv + ["--profile-dir", prof_dir, "--profile-start",
                              "2", "--profile-steps", "2"])
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    summary = device_profile(events, 2, float(m.group(1)))
    print(summary, flush=True)
    write_detail(out_dir, "profile_moe.txt", f"{card}\n{summary}\n")
    other = step_losses(log2)
    for i, loss in losses.items():
        if not abs(other.get(i, math.inf) - loss) <= 1e-5 * abs(loss):
            raise RuntimeError(f"moe over {mesh}: step {i} loss "
                               f"{other.get(i)} against {loss}")
    m2 = STEP_TIME.search(log2)
    print(f"moe over a one-rank group {mesh}: losses {other} equal the "
          f"plain run's within 1e-5 relative; {m2.group(1)} ms/step with "
          f"steps 2-3 profiled [{card}]", flush=True)
    moe_layer_check(card)


def moe_layer_check(card: str) -> None:
    """One MoE layer at the LM's shapes (B 8 x T 2048 tokens, d 768, f
    3072, 8 experts, top-2, capacity 5120), seeded: the card's bf16 output
    against the CPU f32 function with the card's dispatch (the CPU's own
    gates at those indices), by the model-logits rule; the tokens the CPU
    would route otherwise are counted, not folded into the error."""
    import torch

    from tf_operator_tpu_torch.parallel.moe import (MoEMLP, Routing,
                                                    capacity_for,
                                                    expert_ffn, route)

    gen = torch.Generator().manual_seed(23)
    n, d, f, e, k, cf = 8 * 2048, 768, 3072, 8, 2, 1.25
    layer = MoEMLP(d, f, e, k, cf)
    layer.reset_parameters(gen)
    x = torch.randn(n, d, generator=gen).to(torch.bfloat16)
    cap = capacity_for(n, k, cf, e)
    card_layer = MoEMLP(d, f, e, k, cf).cuda()
    card_layer.load_state_dict(layer.state_dict())
    xc = x.cuda()
    with torch.no_grad():
        r = route(card_layer.router(xc.float()), k, cap)
        got = expert_ffn(xc, r, card_layer.wi, card_layer.wo,
                         torch.bfloat16, 0, cap)
        whole = card_layer(xc.view(8, 2048, d)).view(n, d)
        layer_ms = cuda_ms(lambda: card_layer(xc.view(8, 2048, d)), 10)
        probs = torch.softmax(layer.router(x.float()), -1)
        mine = route(layer.router(x.float()), k, cap)
        choice = r.choice.cpu()
        fixed = Routing(choice, probs.gather(-1, choice.T).T, r.pos.cpu(),
                        r.keep.cpu(), mine.aux)
        ref = expert_ffn(x.float(), fixed, layer.wi, layer.wo,
                         torch.float32, 0, cap)
    if not torch.equal(got, whole):
        raise RuntimeError("the MoE layer's forward is not route + "
                           "expert_ffn")
    moved = int(((mine.choice != choice) | (mine.keep != r.keep.cpu()))
                .any(0).sum())
    logits_within("moe layer, the card's dispatch, bf16 card vs f32 CPU",
                  got.cpu(), ref, (n, d))
    print(f"moe layer: {int(r.keep.sum())} of {n * k} assignments kept at "
          f"capacity {cap}; {moved} of {n} tokens routed otherwise by the "
          f"CPU f32 router; layer forward {layer_ms:.3f} ms [{card}]",
          flush=True)


def pipeline_launches(what: str, schedule: str, microbatches: int,
                      layers: int, got: dict) -> dict:
    """The kernels' launches `got` over one step, held against the count
    the schedule implies: each rank runs its stage once per microbatch
    (bubble steps skip it), so GPipe and the interleaved schedule launch
    each kernel M x layers times, and 1F1B, which runs every stage again
    in its backward, twice that of the forward kernel."""
    n = microbatches * layers
    want = {"flash_forward": 2 * n if schedule == "1f1b" else n,
            "flash_backward_dq": n, "flash_backward_dkv": n}
    print(f"{what}: kernel launches {got} (the schedule implies {want})",
          flush=True)
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")
    return got


def pipeline_grads(models) -> dict:
    """{the one-rank module's parameter name: gradient} from every rank's
    module of an in-process pipeline (V = 1): rank r's block j is global
    block r * layers_per_stage + j; the embedding and head are rank 0's."""
    out = {}
    for model in models:
        for name, p in model.named_parameters():
            if name.startswith("blocks."):
                _, j, rest = name.split(".", 2)
                j = model.rank * model.layers_per_stage + int(j)
                name = f"blocks.{j}.{rest}"
            elif model.rank:
                continue
            out[name] = p.grad.detach().clone()
    return out


def grad_ratio(got: dict, ref: dict, tol: float) -> tuple:
    """(worst leaf's relative Frobenius error over `tol`, the leaf, the
    whole gradient's relative Frobenius error); the key biases, whose
    gradient is zero in exact arithmetic, only in the whole."""
    import torch

    worst, where = 0.0, None
    for name, g in ref.items():
        if name.endswith("attn.key.bias"):
            continue
        rel = float((got[name] - g).norm() / g.norm().clamp_min(1e-30))
        if rel / tol > worst:
            worst, where = rel / tol, name
    diff = torch.cat([(got[n] - g).reshape(-1) for n, g in ref.items()])
    whole = torch.cat([g.reshape(-1) for g in ref.values()])
    return worst, where, float(diff.norm() / whole.norm())


def hold_pipeline(what: str, loss, ref_loss, grads=None, ref_grads=None,
                  tol: float = TOL_PIPE_GRAD):
    """Loss within TOL_PIPE_LOSS relative of the reference's; gradients, if
    given, by the `grad_ratio` rule at `tol`."""
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    line = f"{what}: loss {float(loss)} vs {float(ref_loss)} (rel {rel:.2e})"
    if not (math.isfinite(float(loss)) and rel <= TOL_PIPE_LOSS):
        raise RuntimeError(f"{line} > {TOL_PIPE_LOSS}")
    if grads is not None:
        worst, where, whole = grad_ratio(grads, ref_grads, tol)
        line += (f"; gradients: worst leaf {worst:.3g} of the {tol:g} rule "
                 f"({where}), whole {whole:.2e}")
        if not (worst <= 1.0 and whole <= FRO):
            raise RuntimeError(f"{line}: outside the rule")
    print(line, flush=True)


def timed_loss(models, fn, tokens, update=None, reps: int = 3) -> dict:
    """One forward and backward through `fn` (and `update()` after it),
    after a warm-up call whose gradients are dropped, `reps` times: the
    first call's loss, launches (counted from zero), peak memory and the
    memory held before it (parameters and what the caller keeps), and the
    calls' mean ms.  The gradients left are the last call's."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    fn(tokens).backward()
    torch.cuda.synchronize()
    out = {"held": torch.cuda.memory_allocated()}
    t0 = time.perf_counter()
    for i in range(reps):
        zero_grads(models)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            A.reset_launches()
        loss = fn(tokens)
        loss.backward()
        if update is not None:
            update()
        if i == 0:
            torch.cuda.synchronize()
            out.update(loss=loss.detach(), launches=A.launches(),
                       peak=torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def zero_grads(models) -> None:
    for model in models:
        model.zero_grad(set_to_none=True)


def planted_state(kept=dict, dx=dict):
    """A 1F1B `CycleState` whose kept inputs and input gradients live in
    the given dict types (a planted fault's)."""
    from tf_operator_tpu_torch.parallel import pipeline as pipeline_mod

    class State(pipeline_mod.CycleState):
        def __init__(self, *args):
            super().__init__(*args)
            self.kept, self.dx = kept(), dx()

    return State


class PreviousInput(dict):
    """Kept inputs that hand microbatch b's backward the input of b - 1 (a
    backward index off by one; microbatch 0 keeps its own)."""

    def __getitem__(self, slot):
        return super().__getitem__(slot - 1 if slot - 1 in self else slot)


def phase_pipeline(card: str):
    """The seventh path: the pipeline-parallel LM (`models/pipeline_lm.py`
    over `parallel/pipeline.py`) at GPT-small width (12 x 768, 12 heads,
    d_ff 3072, vocab 32000, T 2048, B 8, bf16 compute, f32 params), as the
    JAX package's pp dryrun arms drive it.  (a) Over a one-rank NCCL group
    with TPUJOB_MESH_SHAPE={"pp": 1}, at M 4 and 8: GPipe, 1F1B and 1F1B's
    primal under autograd, 1F1B held against the primal and the primal
    against GPipe (`TOL_PIPE_*`), one profiled step of GPipe and 1F1B;
    a GPipe training step (SGD 1e-3) at M 4, the interleaved schedule at
    V 2, M 1; step ms, tokens/s and peak memory of each.  (b) Every rank
    of P 2 (M 4) and P 4 (M 8) in this process (the hops as hand-overs;
    times serialise the ranks), GPipe against the one-rank GPipe and 1F1B
    against the one-rank primal at the same M.  (c) Two faults planted in
    1F1B at P 4 must leave the rule.  Every run's launches are held to the
    schedule's count."""
    from unittest import mock

    import torch

    from tf_operator_tpu_torch.models import pipeline_lm as PL
    from tf_operator_tpu_torch.models.transformer import gpt_small_config
    from tf_operator_tpu_torch.parallel import pipeline as pipeline_mod
    from tf_operator_tpu_torch.parallel.mesh import build_mesh, mesh_from_env

    cfg = gpt_small_config()
    layers, batch, seq = cfg.num_layers, 8, cfg.max_len
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(40)).cuda()

    def build(mesh, m, virtual=1, rank=None):
        with torch.device("cuda"):
            model = PL.PipelinedTransformerLM(
                cfg, mesh, num_microbatches=m, virtual_stages=virtual,
                pp_rank=rank)
        model.reset_parameters(
            torch.Generator(device="cuda").manual_seed(41))
        return model

    def loss_fn(models, name):
        """The loss through schedule `name` ("gpipe", "1f1b" or
        "1f1b_primal") over the modules (one: its process-group method;
        several: every rank in this process)."""
        if len(models) == 1:
            return getattr(models[0], f"loss_{name}")
        all_ranks = getattr(PL, f"loss_{name}_all_ranks")
        return lambda t: all_ranks(models, t)

    def run(models, name, update=None):
        return timed_loss(models, loss_fn(models, name), tokens, update)

    def sgd(models):
        def update():
            with torch.no_grad():
                for model in models:
                    for p in model.parameters():
                        if p.grad is not None:
                            p -= 1e-3 * p.grad
        return update

    def report(what, r, steps="per forward + backward"):
        """Print a run's loss, ms, tokens/s and memory; returns it."""
        above = (r["peak"] - r["held"]) / 2**30
        print(f"{what}: loss {float(r['loss'])}, {r['ms']:.3f} ms {steps}, "
              f"{batch * seq / r['ms'] * 1e3:.1f} tokens/s, peak memory "
              f"{r['peak'] / 2**30:.2f} GiB ({above:.2f} above the "
              f"{r['held'] / 2**30:.2f} held before it) [{card}]",
              flush=True)
        return r

    def profile(what, models, name, step_ms):
        fn = loss_fn(models, name)

        def step():
            zero_grads(models)
            fn(tokens).backward()

        text = device_profile(profiled_events(step), 1, step_ms)
        print(f"{what}: " + "\n".join(text.splitlines()[:6]), flush=True)

    with one_rank_group({"TPUJOB_MESH_SHAPE": json.dumps({"pp": 1})}):
        mesh = mesh_from_env(device_type="cuda")
        mesh.group("pp")  # the axis's group, laid from the TPUJob env
        model = build(mesh, 4)
        ref, one = {}, {}
        for m in (4, 8):
            model.num_microbatches = m
            for name in ("gpipe", "1f1b", "1f1b_primal"):
                what = f"pp 1 (NCCL) {name}, M {m}"
                r = one[name, m] = report(what, run([model], name))
                pipeline_launches(what, "1f1b" if name == "1f1b" else
                                  "gpipe", m, layers, r["launches"])
                ref[name, m] = (r["loss"], pipeline_grads([model]))
                if name != "1f1b_primal":
                    profile(f"{what}, one step profiled", [model], name,
                            r["ms"])
            for got, want, tol in (("1f1b", "1f1b_primal", TOL_PIPE_GRAD),
                                   ("1f1b_primal", "gpipe", TOL_PIPE_HEAD),
                                   ("1f1b", "gpipe", TOL_PIPE_HEAD)):
                hold_pipeline(f"pp 1, M {m}: {got} against {want}",
                              ref[got, m][0], ref[want, m][0],
                              ref[got, m][1], ref[want, m][1], tol)
        model.num_microbatches = 4
        r = report("pp 1 (NCCL) GPipe training step (SGD 1e-3), M 4",
                   run([model], "gpipe", sgd([model])), "per step")
        after = model.loss_gpipe(tokens).detach()
        print(f"pp 1 GPipe steps: loss {float(r['loss'])} -> {float(after)} "
              f"after 3 steps", flush=True)
        if not (math.isfinite(float(r["loss"]))
                and math.isfinite(float(after))):
            raise RuntimeError(f"the GPipe step: loss {float(r['loss'])} "
                               f"-> {float(after)}")
        del model
        torch.cuda.empty_cache()
        model_v = build(mesh, 1, virtual=2)
        what = "pp 1 (NCCL) interleaved V 2, M 1"
        r = report(what, run([model_v], "gpipe"))
        pipeline_launches(what, "gpipe", 1, layers, r["launches"])
        profile(f"{what}, one step profiled", [model_v], "gpipe", r["ms"])
        hold_pipeline(f"{what} against GPipe M 4", r["loss"],
                      ref["gpipe", 4][0])
        del model_v
        torch.cuda.empty_cache()

    for size, m in ((2, 4), (4, 8)):
        layout = build_mesh({"pp": size}, world_size=size)
        models = [build(layout, m, rank=r) for r in range(size)]
        losses = {}
        for name in ("gpipe", "1f1b"):
            what = f"P {size} in process (the ranks serialised), {name}, M {m}"
            r = report(what, run(models, name))
            pipeline_launches(what, name, m, layers, r["launches"])
            against = "gpipe" if name == "gpipe" else "1f1b_primal"
            hold_pipeline(f"{what} against the one-rank {against}",
                          r["loss"], ref[against, m][0],
                          pipeline_grads(models), ref[against, m][1])
            losses[name] = r["loss"]
        hold_pipeline(f"P {size} in process: 1F1B against GPipe",
                      losses["1f1b"], losses["gpipe"])
        if size == 4:
            def overwrite(kept, slots, f, valid, inp):
                kept[f % slots] = inp

            faults = {
                "1F1B's invalid forwards overwrite their slot": mock.patch
                .object(pipeline_mod, "_save_input", overwrite),
                "1F1B's backward re-runs the previous microbatch's input":
                mock.patch.object(pipeline_mod, "CycleState",
                                  planted_state(kept=PreviousInput)),
            }
            for fault, patch in faults.items():
                zero_grads(models)
                with patch:
                    PL.loss_1f1b_all_ranks(models, tokens).backward()
                worst, where, whole = grad_ratio(
                    pipeline_grads(models), ref["1f1b_primal", m][1],
                    TOL_PIPE_GRAD)
                print(f"planted fault ({fault}, P 4, M 8): worst leaf "
                      f"{worst:.3g} of the {TOL_PIPE_GRAD:g} rule "
                      f"({where}), whole {whole:.2e}", flush=True)
                if worst <= 1.0 and whole <= FRO:
                    raise RuntimeError(f"the planted fault ({fault}) passed "
                                       "the gradient rule")
        del models
        torch.cuda.empty_cache()
    for m in (4, 8):
        gp, fb = one["gpipe", m], one["1f1b", m]
        print(f"pipeline: peak memory at M {m}, one rank: GPipe "
              f"{gp['peak'] / 2**30:.2f} GiB, 1F1B {fb['peak'] / 2**30:.2f} "
              f"GiB ({(gp['peak'] - gp['held']) / 2**30:.2f} and "
              f"{(fb['peak'] - fb['held']) / 2**30:.2f} above what each held "
              f"before the step) [{card}]", flush=True)


# ---------------------------------------------------------------------------
# the eleventh path: the train step's collective inventory and its rules

# (workload, what its defaults are, each kernel's launches a step)
HLO_RUNS = (("lm", "GPT-small, B 8, T 2048", 12),
            ("vit", "ViT-B/16, B 256", 12),
            ("bert", "BERT-base, B 32, T 128", 12),
            ("resnet", "ResNet-50 in bf16, B 256, SGD momentum", 0))
HLO_CLI_LINE = re.compile(r"^(lm|resnet|bert|vit): \d+ collective\(s\) over "
                          r"1 rank\(s\); (\w+) peak (\d+) B", re.M)


def phase_hlo(card: str):
    """The eleventh path: `analysis/hlo.capture_workload` at full width
    (each workload's own `build` at its defaults) over a one-rank NCCL
    group with the ZeRO knob (dense at dp 1: the JAX workload builds no
    plan there): one recorded step each of GPT-small, ViT-B/16, BERT-base
    and ResNet-50.  Prints each signature, the peak (`max_memory_allocated`
    over the recorded step), the resident bytes and the admission lower
    bound, and the kernels' launches in the recorded step.  Holds: no
    finding under the card's whole memory; peak >=
    `admission_peak_lower_bound` (its "never a false positive"); a budget
    of half the peak fires hlo-memory-infeasible once and nothing else;
    each kernel launched 12 times in the transformer steps (none in
    ResNet's); the gradient all-reduce over a group of 1; a deleted
    capture leaves nothing allocated once cuBLAS's workspaces are cleared.
    Then the CLI,
    `python -m tf_operator_tpu_torch.analysis --hlo all --devices 1`, as a
    user runs it: its rank on the card over NCCL, no finding under the
    card's memory, every capture's peak measured on cuda."""
    import gc

    import torch

    from tf_operator_tpu_torch.analysis import hlo
    from tf_operator_tpu_torch.ops import attention as A
    from tf_operator_tpu_torch.workloads.runner import WorkloadContext

    total = torch.cuda.get_device_properties(0).total_memory
    gib = 2 ** 30
    with one_rank_group({"TPUJOB_ZERO_SHARD_WEIGHT_UPDATE": "1"}):
        zero = WorkloadContext.from_env().zero_shard_weight_update
        if not zero:
            raise RuntimeError("hlo: the ZeRO knob did not reach the "
                               "workload context")
        for name, what, launches in HLO_RUNS:
            gc.collect()
            torch.cuda.empty_cache()
            torch._C._cuda_clearCublasWorkspaces()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            cap = hlo.capture_workload(
                name, 1, zero=zero, device_memory_budget_bytes=total,
                full_width=True)
            seconds = time.perf_counter() - t0
            mem, moments = cap.memory, cap.moments_per_param
            bound = hlo.admission_peak_lower_bound(
                cap.n_params, moments_per_param=moments)
            print(f"hlo {name} ({what}): signature "
                  f"{json.dumps(hlo.workload_signature(cap), sort_keys=True)}",
                  flush=True)
            print(f"hlo {name}: peak {mem.peak_bytes / gib:.3f} GiB, resident "
                  f"{mem.resident_bytes / gib:.3f} GiB, admission lower bound "
                  f"{bound / gib:.3f} GiB ({cap.n_params} params x "
                  f"{8 + 4 * moments} B); peak / bound "
                  f"{mem.peak_bytes / bound:.3f}; kernel launches in the "
                  f"recorded step {cap.program.kernel_launches}; "
                  f"{seconds:.1f} s [{card}]", flush=True)
            problems = []
            if mem.device != "cuda":
                problems.append(f"measured on {mem.device}")
            findings = hlo.check_capture(cap)
            if findings:
                problems.append("findings under the card's "
                                f"{total} B: {[f.render() for f in findings]}")
            if not mem.peak_bytes >= mem.resident_bytes >= bound:
                problems.append(f"peak {mem.peak_bytes} >= resident "
                                f"{mem.resident_bytes} >= lower bound {bound}"
                                " does not hold")
            cap.device_memory_budget_bytes = mem.peak_bytes // 2
            half = [f.rule for f in hlo.check_capture(cap)]
            if half != [hlo.RULE_HLO_MEMORY_INFEASIBLE]:
                problems.append(f"half the peak fired {half}")
            want = {fn.__name__: launches for fn in A.KERNELS}
            if cap.program.kernel_launches != want:
                problems.append(f"launches {cap.program.kernel_launches}, "
                                f"expected {want}")
            grads = [op for op in cap.program.by_kind("all-reduce")
                     if op.group_size == 1
                     and op.op_name.startswith(
                         "tf_operator_tpu_torch/parallel/shard.py:")]
            if not grads:
                problems.append("no gradient all-reduce over a group of 1 "
                                f"in {cap.program.collectives}")
            if cap.plan is not None:
                problems.append("a ZeRO plan at dp 1")
            if problems:
                raise RuntimeError(f"hlo {name}: " + "; ".join(problems))
            print(f"hlo {name}: no finding under {total / gib:.2f} GiB, peak "
                  f">= resident >= the admission lower bound, half the peak "
                  f"fires {half} alone, the gradient all-reduce "
                  f"{grads[0].result_shapes} over a group of 1 from "
                  f"{grads[0].op_name}", flush=True)
            # a deleted capture gives back every byte it took (ROADMAP C.4:
            # the dispatch counter's module tracker held its parameters and
            # gradients until the process ended), once cuBLAS has let go of
            # the workspaces it keeps for each handle and stream (65 MiB
            # after the process's first matmuls)
            param_bytes = cap.params_bytes_per_device
            del cap
            gc.collect()
            torch._C._cuda_clearCublasWorkspaces()
            left = torch.cuda.memory_allocated() - before
            print(f"hlo {name}: {left} B still allocated after the capture is"
                  f" deleted and cuBLAS's workspaces cleared (its parameters: "
                  f"{param_bytes} B)", flush=True)
            if left > 0:
                raise RuntimeError(f"hlo {name}: a deleted capture keeps "
                                   f"{left} B allocated")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    cli = subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.analysis", "--hlo",
         "all", "--devices", "1"], cwd=here, env=dict(env, PYTHONPATH=here),
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    print(cli.stdout, end="", flush=True)
    lines = HLO_CLI_LINE.findall(cli.stdout)
    if (cli.returncode != 0
            or "0 HLO finding(s) over 4 recorded train step(s)"
            not in cli.stdout
            or sorted(n for n, _, _ in lines) != sorted(hlo.TRAIN_WORKLOADS)
            or any(device != "cuda" for _, device, _ in lines)):
        raise RuntimeError(f"hlo: the CLI exited {cli.returncode} "
                           f"(captures {lines}):\n{cli.stdout}\n"
                           f"{cli.stderr[-4000:]}")
    print(f"hlo cli: --hlo all --devices 1 exit 0 in {seconds:.1f} s, every "
          f"capture on cuda, peaks {[int(peak) for _, _, peak in lines]} B "
          f"[{card}]", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--pod-child"]:
        return pod_child(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=None,
                        help="also write the compiler report and the "
                             "profile summary under this directory")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the reference side of every comparison runs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import attention as A

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.target().name})", flush=True)
    if _build.build_log is not None:
        write_detail(args.out_dir, "build.txt", _build.build_log)
        report = ptxas_report(_build.build_log)
        for name, regs, stores, loads, _ in report:
            print(f"  {name}: {regs} registers at launch, {stores} bytes "
                  f"spill stores, {loads} bytes spill loads", flush=True)
        spilled = [r[0] for r in report if r[2] or r[3]]
        if not report or spilled:
            raise RuntimeError(f"ptxas reports spills in {spilled} (or no "
                               "kernel at all); no instantiation may spill")
        built = {r[4] for r in report}
        if built != A.instantiations():
            raise RuntimeError(
                "the built instantiations are not attention.INSTANTIATED's:"
                f" built only {sorted(built - A.instantiations())}, listed "
                f"only {sorted(A.instantiations() - built)}")
        print(f"build: {len(report)} kernels, the {len(built)} "
              "instantiations attention.INSTANTIATED lists", flush=True)
    # the cluster kernels (in f32 the tensor-core kernels' clusters): each
    # one's shared memory against a block's 227 KB, and the clusters the
    # card holds at once
    for kernel in ("dq", "dkv"):
        for dtype, dims, name in (
                (torch.bfloat16, (512, 768, 1024), "cluster"),
                (torch.float16, (512, 768, 1024), "cluster"),
                (torch.float32, (512, 1024, 2048), "tf32")):
            for d in dims:
                smem, clusters = A.cluster_info(kernel, dtype, d)
                print(f"  {kernel}_{name}_kernel<{str(dtype)[6:]}, "
                      f"{A.n_slices(d)} slices>: {smem:,} bytes of shared "
                      f"memory of a block's 232,448; "
                      f"cudaOccupancyMaxActiveClusters {clusters} (clusters"
                      f" of {A.n_slices(d)} blocks at one block an SM)",
                      flush=True)

    def timed(phase, *phase_args):
        t0 = time.perf_counter()
        out = phase(*phase_args)
        what = [a for a in phase_args[2:] if isinstance(a, str)]
        print(f"{' '.join([phase.__name__, *what])}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    kernels = timed(phase_kernels)
    counts, lm_losses = timed(phase_slice, card, args.out_dir)
    timed(phase_autotune, card, lm_losses)
    timed(phase_llama)
    counts = dict(counts,
                  dkv_reduce=timed(phase_gemma, card, args.out_dir))
    # the pair forward and the cluster kernels: their launches on the
    # wide-head LM's path; the sliced kernels above the pair's and the
    # cluster's reach
    counts.update(timed(phase_wide_head, card, args.out_dir))
    # f32 dq and dk/dv on the tensor cores: their launches on the f32 path
    counts.update(timed(phase_f32))
    timed(phase_lse)
    timed(phase_ring, card)
    timed(phase_dist, card)
    timed(phase_resnet, card, args.out_dir)
    # the encoders' kernels: their launches on ViT-B/16's path
    short = timed(phase_encoder, card, args.out_dir, "vit")
    counts.update({f"{name}_short": n for name, n in short.items()})
    timed(phase_encoder, card, args.out_dir, "bert")
    timed(phase_shard, card, args.out_dir)
    lm_plain = timed(phase_encoder_mesh, card)
    timed(phase_pod, card, lm_plain)
    timed(phase_mnist, card, args.out_dir)
    timed(phase_preempt, card)
    timed(phase_dist_mnist, card)
    timed(phase_estimator, card)
    timed(phase_multislice, card)
    timed(phase_smoke, card)
    timed(phase_decode, card)
    timed(phase_moe, card, args.out_dir)
    timed(phase_pipeline, card)
    timed(phase_hlo, card)

    print(f"every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"],
         "device_ms": kernels[name].get("device_ms"),
         "library_device_ms": kernels[name].get("library_device_ms"),
         "library_backend": kernels[name].get("library_backend"),
         "library_math_ms": kernels[name].get("library_math_ms"),
         "library_math_device_ms": kernels[name].get(
             "library_math_device_ms")}
        for name in [fn.__name__ for fn in A.KERNELS] + ["dkv_reduce"]
        + [f"{fn.__name__}_{route}" for route in ROUTES
           for fn in A.KERNELS]
        + [f"{fn.__name__}_cluster" for fn in A.CLUSTER_KERNELS]
        + [f"{fn.__name__}_pair" for fn in A.PAIR_KERNELS]
        + [f"{fn.__name__}_tf32{key}" for fn in A.CLUSTER_KERNELS
           for key in ("", "_cluster")]]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
