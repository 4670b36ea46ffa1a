#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mem_tpu_torch) on one H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ and checks each against its
plain PyTorch version on the card; it fails when ptxas reports a spill in the
wgmma kernels (K3f and the rows and columns kernels of K3b at head dims 64
and 32, which K5b / K5d / K5e launch on head-major operands and K2f / K5a
and K2b / K5c for bf16 at N <= 256; the GEMM body of K6f and K6b; X1's and X2's one-hot
contractions) or serializes their wgmma pipelines. It drives the seven
ported paths and the experiment tools, each with the launch counts set
to 0 just before it and read just after:

- the served classification path: the HTTP server of mem_tpu_torch.cli.serve,
  ViT-B/16 ft_vit at full width with weights drawn from a seed; it checks
  that the path launched K1 and K2f and holds the card's logits against
  the CPU's;
- the pretraining path: mem_tpu_torch.cli.run_mem_pretraining.main with the
  configs/ncaltech.conf recipe (ViT-B/16 pt_vit at full width, a seeded
  VAE tokenizer at the conf's size) on a synthetic N-Caltech-like dataset,
  two epochs, checkpoints and an auto-resumed third epoch; it checks that
  the path launched K1, K2f and K2b;
- the VAE-training path: mem_tpu_torch.cli.train_vae.main at the conf's
  full width (224^2, 8192 tokens, hidden 384, bf16, B=32) on the same
  synthetic set, two epochs with evaluations, reconstruction panels and
  checkpoints, an auto-resumed third epoch; it checks that the path
  launched K1; then run_mem_pretraining for one epoch on the tokenizer it
  wrote, with --dump_recon_dir (K1, K2f, K2b);
- the MAE path: mem_tpu_torch.cli.run_mem_pretraining.main with --MAE 1 at
  the conf's full width (ViT-B/16 encoder, 512-wide 8-block 16-head decoder,
  bf16, B=64) on the same synthetic set, two epochs with checkpoints and an
  auto-resumed third; it checks exactly K1 once a step and K2f and K2b 20
  times (12 encoder blocks on the 99 visible tokens, 8 decoder blocks at
  head dim 32: K3's Hopper bodies at D = 32) and nothing else; then
  run_class_finetuning.main --MAE 1 --finetune on its checkpoint
  (vit_base_patch16, global pool) for an epoch with the raw and EMA
  evaluation (K1 once, K2f 12 times a micro-batch, K2b 12 times a train
  micro-batch), and serve --MAE 1 on that checkpoint over HTTP (K1 once and
  K2f 12 times a batch; card logits against the CPU's);
- the segmentation path: mem_tpu_torch.cli.test_seg.main (EvBEiT ViT-B/16 at
  512^2 + UPerNet at full width, a seeded .pth) over a synthetic DSEC-like
  data_root of 16 pairs, single-scale and with --aug_test, and the HTTP
  server with --surface seg; it checks that the path launched K3f and K4
  (and neither K2f nor K1), and holds the card's logits against the CPU's;
- the segmentation training path: mem_tpu_torch.cli.train_seg.main at full
  width (B=16, bf16) on a synthetic DSEC-like train split, the backbone
  initialised from a seeded pretraining-schema .pth through the surgery, a
  few iterations with evaluations and checkpoints, an auto-resumed second
  call, then test_seg on the final checkpoint; it checks that the path
  launched K3b 12 times a train step, K3f and K4, and no K1, K2f or K2b;
  then a short train_seg run and test_seg on its checkpoint with the
  reference's toggle FLAT_ATTN_LONG = False, which sends the 1025 tokens to
  the head-major kernels: K5b 12 times a forward, K5e 12 times a train step,
  no K3f, K3b or K5d;
- the classification finetune path: mem_tpu_torch.cli.run_class_finetuning.main
  (ViT-B/16 ft_vit at full width, bf16, mixup and cutmix on, EMA, update_freq
  2) from a seeded pretraining-schema .pth through the surgery, with the
  model toggles FUSED_MLP = True and FLAT_ATTN = False: two epochs with
  evaluations and checkpoints, an auto-resumed third epoch, --eval on the
  result; then one short run at the default toggles. The launch counts are
  checked exactly: K6f, K6b, K5a and K5c 12 times a micro-batch, K1 once,
  and no K2f or K2b in the toggled run; K2f and K2b and no K5 or K6 in the
  default one. Then one epoch at --input_H / --input_W 320 (N = 401, not
  head-blocked-eligible) from seeded weights with FLAT_ATTN = False:
  with the reference's ENABLED = True, K5b 12 times a micro-batch and K5d 12
  times a train micro-batch; with ENABLED = False the einsum path, no K5;
- the experiment tools: mem_tpu_torch.tools.exp_voxelize.main(["all"]) (the
  one-hot contraction kernels X1a, X1b, X1c at the reference's seg and cls
  shapes and chunks, K1 beside them), mem_tpu_torch.tools.exp_attn_bwd.main
  (X3, the paired attention backward, beside K2b at (128, 197, 768)) and
  mem_tpu_torch.tools.exp_voxelize2.main(["all"]) (X2a, the int8 dense
  contraction, and X2b / X2c, the row-band contraction with the reference's
  (band, chunk) skip in bf16 and int8, at every (TH, chunk) of the
  reference's main, main2 and main3, the packed-key sort, K4 and K1 beside
  them); each must exit 0 and launch exactly what its loops call.

K1 and K4 share one histogram body (csrc/voxelize_hist.cuh): both are held
bit for bit against their plain versions in planes and raster mode, at the
model shapes, N % 4 != 0, a cell past 65,535 events, an empty sample and
stray values, and from a fresh thread; K4's plan at the DSEC shape must be
one wave. voxelize_fused is timed whole, and its raster tail against the
chain of planes, wrap and stack that it replaces.

The K5 kernels of the shapes that are not head-blocked-eligible (K5b, K5d,
K5e) share K3f's and K3b's bodies: each is also held bit for bit against the
K3 kernel on transposed operands, and a seg forward with FLAT_ATTN = False
against the CPU's logits. X1a, X1b, X1c, X2a, X2b and X2c are held bit for
bit against their plain versions (X2 at every chunk and (TH, chunk) of the
reference's sweeps, on y-sorted and unsorted events; X1 at every chunk of
its sweep; both also on a hot cell past 70,000 events, at shapes that
straddle their tiles, and across two launches); X3 inside K2b's gates
against its plain version, with a planted fault that must fail them, bit for
bit against K2b's Hopper path (the body it varies) and across two launches,
and from a fresh thread.

The dataset tools and the optimizer switch (run_tools_slice, on a generator
of its own): seeded ATIS .bin recordings in N-Caltech101's layout with a
split file and N-Cars .dat files go through the port's process_dataset at
--cores 2 (every .npy bit-equal to the numpy decoder of its raw file; the
native and the numpy decoders' host rates on the same buffers), then
run_class_finetuning --opt lookahead_adamp trains on the processed tree
(6 steps, exact K1 / K2f / K2b launches, Lookahead's state in the
checkpoint); every --opt name, lookahead_adamp and bf16 moments run 7 steps
on full-width ft_vit weights on the card and on the CPU from one gradient
sequence (each tensor's displacement within 1e-5, bf16 moments 1e-3, AdamP
decisions equal, a planted skipped update that the gate must catch), and
run_mem_pretraining --bf16_moments 1 --pretrained 1 --init_ckpt <seeded
timm .pth> takes two steps with exact launches.

The measuring tools (run_tools_slice): tools/bench_serve.py for 3 s against
the served slice's server (no error, at least one request); every trace tool
(trace_pretrain, also with bf16_moments=1; trace_finetune with fused_mlp=1
and with flat=0; trace_mae, trace_vae, trace_seg; trace_infer mode=cls, also
with int8=1) through its main at steps=2 and the smallest batch of the
chip_smoke timings it took over, each breakdown with device ms > 0, finite
losses and the launch counters' counts exact (trace_pretrain K1 once, K2f and
K2b 12 times a step; trace_seg K4 once, K3f and K3b 12 times; trace_infer K1
once and K2f 12 times a batch; trace_mae K1 once, K2f and K2b 20 times;
trace_finetune K1 once, K2f and K2b 12 times, with K6f and K6b 12 times under
fused_mlp=1, or K5a and K5c 12 times under flat=0);
bf16 moments under 0.6 of the f32 state, the int8 forward's int8 GEMMs in
its families and none in the bf16 one's; bench_pretrain_step,
bench_host_loader and bench_host_feed at a few batches. After the multi-GPU
slice (run_tools_big_slice, the card to themselves) the trace tools at the
larger batches and other toggles of those timings take one step each under
the same gates: trace_pretrain B=128, trace_finetune B=64 under the default
toggles and B=128 under the default toggles, fused_mlp=1 and flat=0,
trace_mae B=512, trace_vae B=192, trace_seg
B=16 with and without FLAT_ATTN_LONG. Each slice prints its seconds on a
``<name>_slice`` line, and the line ``slices`` sums them.

The IMNET real-image path (run_imnet_slice, on a generator of its own):
ImageNet-like synthetic JPEGs (2 synsets, sides 256-500 px, 64 train and
16 val); preprocess_image_cls (the finetune's --aa
rand-m9-mstd0.5-inc1 and RandomErasing) card vs CPU on one batch, one set of
host draws and one erasing noise tensor, per sample and batch_ops, with a
planted fault (the erasing box one row off on the card) that must fail the
gate, then the card's own fill from the step's CUDA generator (N(0, 1)
moments inside the boxes, the pixels outside unchanged; a planted const
fill must fail the moments); one two-view pretraining step of pt_vit at full width (depth 2, B=2,
the conf's tokenizer) card vs CPU in f32 and bf16 with a planted fault (the
views swapped on the card), a depth-12 bf16 step with exact launches (K2f
and K2b 12 times, no K1) on this thread and a fresh one; then
run_mem_pretraining, run_class_finetuning (default --aa, --reprob 0.25,
mixup on, EMA) and train_vae with --data_set IMNET at the conf's widths,
each one epoch with exact launches, a finite loss and a checkpoint; three
bf16 IMNET pretraining steps at B=128 with finite losses.

W8A8 int8 serving, the sinks and the pipeline script (run_int8_slice, on a
generator of its own): the quantized values and scales of
ops/quant.py and the torch._int_mm accumulators (int8_mm) card against CPU
bit for bit at ViT-B's shapes (rows 1,576 and 12,608), dense_w8a8 in f32
within one ulp, per-input-channel weight scales as a planted fault that must
fail that gate and the f32 logits gate, a 16-row product refused; the
full-width ft_vit (B=8) and segmentor (B=2) int8 forwards card against CPU
(36 int8 products and 12 K2f / K3f launches a forward), against bf16 on the
card, and from a fresh thread; serve --int8 1 on both surfaces, test_seg
--int8 1 and run_class_finetuning --int8 1 --eval with exact launches;
the int8 forwards' device records (cls at B=8 and 64, seg at B=8) hold int8
GEMMs and the bf16 forwards' none;
and, in processes of its own beside those checks,
run-pipeline-torch.sh on a tiny depth-12 conf on the card (VAE ->
pretraining -> finetune, pruned to final / best / latest), whose conf's
profile_dir and log_dir make the pretraining stage trace its third step (K1
once, K2f and K2b 12 times by kernel name) and write TensorBoard files.

The trajectory check (run_trajectory_card, on a generator of its own, while
the pipeline script's processes run): parity_bf16_drift.py's method with the
port alone (mem_tpu_torch/tools/trajectory.py drift_arms), 192 steps of
full-width pt_vit cut to depth 4 (B=32, the conf's f32 tokenizer, 64
class-structured samples) as an f32 oracle on the plain attention path, an
f32 arm and a bf16 arm through K1, K2f and K2b, and an f32 arm from a
redrawn init: the bf16 arm's largest windowed loss gap from the oracle must
be within the redrawn arm's and its final window within 5 %, the f32 arm's
gap below the redrawn arm's, the launches exact, and a planted fault on the
bf16 path (K2b's bias held from its first launch, whose first step is
exact) must fail the check.

The resilience slice (run_resilience_slice, on a generator of its own,
last): resume_card runs full-width pt_vit (bf16, the
conf's f32 tokenizer, B=64, 3 epochs of 2 steps) as CLI processes under
scripts/run_resilient.sh through mem_tpu_torch/tools/resume.py, straight and
recycled at every epoch boundary (--rss_restart_gb): every step's loss and
the final weights and AdamW state must be bit-equal, a planted resume that
drops the optimizer state must fail that, and a SIGTERM one second into a
fresh CLI process (during its setup) must end in exit 0 and a checkpoint;
beside it, soak_card runs mem_tpu_torch/tools/soak.py cut to 1.5 minutes and
64 files a class (SIGTERMs, RSS recycles, auto-resumes) held to the soak's
own gates. The K1 / K2f / K2b rows carry both phases' launches as
``resilience_launches``.

Multi-GPU training (run_parallel_slice, in processes of its own, started
on a thread before the measuring tools and waited for after the int8 slice,
its lines printed after the wait; it reads no time, since it shares the card
with the tools, IMNET and int8 slices;
mem_tpu_torch/tools/mp_worker.py's chip modes, tools/mp_chip.py): a
world-size-1 NCCL group runs three full-width pretraining steps (pt_vit
ViT-B/16, vocab 8192, bf16, the conf's f32 tokenizer, B=64) under DP,
ZeRO-1, FSDP and TP (a one-rank "model" group) against the same steps
without a group (DP and ZeRO-1 bit-equal, FSDP and TP within 1e-6 relative
L2), with peak memory and launches, and then, bit-equal to the
same steps without a group, the optimizers whose update reads a statistic of
the whole tensor under FSDP and TP (the first four blocks) and the MAE
(B=128) at TP; then two processes on the one card over Gloo (NCCL refuses
two ranks on one device) run the DP step (f32, 2 x 32 against 64), the TP
step at tp = 2 (bf16, B=16, K2f / K2b at 6 heads, FUSED_MLP's K6f / K6b at
hidden 1,536), the full-width seg step under DP (f32, six blocks, 2 x 2
against 4, SyncBN; K3f, K3b, K4) and the MAE at tp = 2 (bf16, B=16), each
against one process within its gate, each with a planted fault (a per-rank
loss mean, fc2's bias added on every rank, an unsynced BatchNorm) that must
miss it, and Adafactor and AdamP at tp = 2 and Adafactor under FSDP (f32,
B=16, two steps), each tensor's displacement against one
process's, with the statistic taken over the rank's shard alone as the
fault that must miss the gate. The kernel table's rows on these paths carry
their launches as ``parallel_launches``.

Between them it holds one VAE, one pretraining, one MAE, one segmentation
and one finetune train step on the card (f32 and bf16) against the same step
on the CPU (the VAE, pretraining and MAE steps on the CPU's images, tokens
and shuffle noise; the MAE's gates must see a decoder that skips its
unshuffle and a K2b with its last key dropped), and
it times kernels (each beside its plain version,
its bound and, where there is one, a PyTorch library call) and requests;
the forwards' and train steps' timings and profiles are the measuring
tools' (mem_tpu_torch/tools/trace_*.py, bench_*.py). One line per phase; the line before the last is
the kernel table as JSON; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

It exits non-zero, before printing any result, when no CUDA device is
available or mem_tpu_torch cannot be imported, and on any failed check.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import functools
import io
import itertools
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

try:
    from mem_tpu_torch.tools import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_INT8_OPS,
                                     attention_bwd_bound, attention_fwd_bound, bound, hist_bound,
                                     time_ms)
    from mem_tpu_torch.tools.step_timers import (body_device_ms, call_device_profile,
                                                 kernel_device_ms)
except ImportError as e:   # not run from the root of a checkout
    sys.exit(f"chip_smoke: run it from the root of a mem_tpu checkout ({e})")

N_REQUESTS = 24          # served through HTTP, 8 clients at a time
K2_BF16_TOL = 2e-2       # bf16 output: p and o each rounded to bf16 -> a few ulps at |o| <= 2
K2_F32_TOL = 1e-5        # f32: the same math, sums in another order
LOGITS_BF16_REL = 5e-2   # card bf16 vs CPU f32, relative L2: 12 blocks of bf16 rounding
LOGITS_F32_REL = 1e-3    # card f32 vs CPU f32, relative L2: summation order only
IMAGES_TOL = 1e-4        # preprocessed images card vs CPU (f32 resize sums reordered)
# K2b: dq/dk/dv max abs error relative to the plain version's max abs. bf16:
# both round the outputs to bf16 (2^-8 relative) and ds to bf16 before the
# dq/dk products, from f32 sums taken in another order -> a few bf16 ulps.
K2B_BF16_TOL = 2e-2
K2B_F32_TOL = 1e-5       # f32: the same math, sums in another order
K2B_DB_REL = 1e-5        # db relative L2: f32 ds summed over the batch in batch order
WGMMA_HEAD_DIMS = (64, 32)   # the head dims K3's Hopper bodies take (bf16)


def _bf16_wgmma(torch, shape, dt):
    """Whether K3's Hopper bodies take operands of dtype ``dt`` and shape
    (B, N, H, D) or (B, H, N, D): D is the last in both."""
    return dt == torch.bfloat16 and shape[3] in WGMMA_HEAD_DIMS
# one train step, card vs CPU on the same host batch, draws and weights:
TRAIN_IMG_TOL = 2.5 / 255     # RandAugment truncates to uint8: a sum taken in another
TRAIN_IMG_FRAC = 1e-3         # order can flip one level (x <= 1.2 jitter) at a few pixels
VAE_TOKENS_AGREE = 0.99  # f32 tokenizer, TF32 off: only near-ties of the 8192 logits may flip
VAE_MIN_DISTINCT = 16    # a tokenizer that gives every patch one token makes the agreement vacuous
STEP_F32_LOSS_REL = 1e-4   # f32 card vs f32 CPU: summation order only
# per-parameter relative L2 of the gradients, the same, both steps on the CPU's
# images and tokens: on an H100 3.7e-6 on each of two batches, where the
# card's own inputs (a few pixels, RandAugment's uint8 truncation) read
# 1.9e-3 and, on another batch, 2.7e-2 (suspect S1); with the last key
# dropped 4.4e-2. The MAE step (unclipped, one noise array): 4.5e-7; the
# last key dropped 1.1e-2, the decoder's unshuffle skipped 0.25
STEP_F32_GRAD_REL = 1e-4
STEP_BF16_LOSS_REL = 2e-2  # bf16 card vs f32 CPU: two blocks of bf16 rounding
# bf16 card vs f32 CPU, per-parameter relative L2 of the gradients, both
# steps (pretraining, finetune): two blocks of bf16 rounding. Readings on an
# H100 against the CPU, two batches each: 6.0e-3 / 6.2e-3 (pretraining),
# 9.5e-3 / 8.8e-3 (finetune), 6.6e-3 (MAE); with the last key dropped from
# the attention backward's scores, 4.4e-2 / 4.9e-2 and 4.3e-2 / 4.8e-2 (the
# MAE's ragged tail tile dropped 0.54, its unshuffle skipped 0.25)
STEP_BF16_GRAD_REL = 2e-2
LOSS_FALL = 0.3          # nats the loss must fall over 15 steps on one repeated batch
N_TRAIN_FILES, N_VAL_FILES = 128, 64
# the segmentation slice
SEG_EVENTS = 180_000     # slice_max_evs of the DSEC recipe
SEG_PAIRS = 16           # (events, label) pairs of the synthetic data_root: 2 batches of 8
SEG_IMAGES_FRAC = 1e-5   # card vs CPU eval images: a hot-pixel threshold (f32 sums in
                         # another order) may flip a pixel; everything else is exact
SEG_F32_REL = 1e-3       # card f32 vs CPU f32 logits, relative L2: summation order only
SEG_BF16_REL = 5e-2      # card bf16 vs CPU f32: 12 blocks + the heads' convs in bf16
SEG_PRED_AGREE = 0.999   # labels served / saved vs a direct forward on the same card
SEG_MIOU_TOL = 1e-4      # test_seg's mIoU vs the same pipeline called directly
# the segmentation training slice
SEG_TRAIN_PAIRS = 16     # pairs of the synthetic train split: one batch of train_seg's default 16
SEG_TRAIN_IMG_TOL = 1.0  # card vs CPU train images, 0..255: the resize jitter's f32 sums taken
SEG_TRAIN_IMG_FRAC = 1e-3  # in another order can flip a uint8 level (or a hot pixel) here and there
SEG_STEP_BN_REL = 1e-3   # updated BatchNorm buffers card vs CPU in f32, relative L2: a batch
                         # mean is a cancelling sum, so 1e-6 of the activations shows larger
SEG_DAMPED_EPS = 0.1     # the epsilon the PSP BatchNorms get in the step's second comparison
SEG_STEP_DEPTH = 6       # blocks of the card-vs-CPU seg step: every kernel and gate of the
                         # path at half the CPU reference's time of the full depth
SEG_STEP_BN_DAMPED_REL = 1e-5  # the same buffers with the PSP BatchNorms damped: 8.1e-7 to
                               # 1.2e-6 on six seeds on an H100 (tools/seg_bn_seeds.py), where
                               # the undamped ones read 5.0e-6 to 8.0e-4
SEG_STEP_F32_GRAD_REL = 5e-3   # ... whose gradients are held to this, not to the pretraining
                               # step's 1e-3: every BatchNorm's fast variance E[x^2] - E[x]^2
                               # cancels in f32, and the stride-4 and stride-8 necks (fpn1_bn,
                               # lateral_0, lateral_1) showed 1.3e-3 to 1.9e-3 over four runs
                               # on an H100 against the CPU
SEG_GRAD_FLOOR = 1e-8    # a gradient below this share of the global norm is rounding noise
                         # (a bias ahead of a conv + BatchNorm has none): held to the floor
SEG_LOSS_FALL = 0.1      # nats the seg loss must fall over 15 steps on one repeated batch
# the finetune slice. K6f / K6b: max abs error relative to the plain version's
# max abs (out, h, dx) and relative L2 (the f32 weight and bias gradients).
# bf16: h, g, dh and the outputs are each rounded to bf16 (2^-8 relative) from
# f32 sums taken in another order, so an element can land one bf16 step away
# (6e-2 at |out| ~ 14: 4e-3 of the max); a row-summed gradient averages such
# flips out (first readings on an H100: <= 7e-5).
K6_BF16_TOL = 2e-2
K6_F32_TOL = 1e-5        # f32: the same math, sums in another order
K6B_SUM_BF16_REL = 2e-3  # dW1, dW2, db1, db2 relative L2 in bf16
K6B_SUM_F32_REL = 1e-5   # ... and in f32
# the planted K6f and K6b faults of the bf16 finetune step drop this many
# hidden columns (one 64-wide box of the GEMM body): one column of dW1, dW2,
# db1 moves those gradients by ~1 / sqrt(3072) = 1.8e-2 rel L2, which the
# bf16 gate (2e-2, over a sound step's ~1e-2) cannot tell from rounding
K6_FAULT_COLUMNS = 64
FT_STEP_F32_GRAD_REL = 3e-3  # per-parameter gradient relative L2 of one finetune step, card f32
                             # vs CPU f32; not the pretraining step's 1e-3: q_bias's gradient is
                             # a sum over all tokens of dq = ds k, whose terms cancel (a softmax
                             # row's ds sums to zero), and read 1.2e-3 on an H100 against the CPU
FT_TOGGLE_GRAD_REL = 1e-3   # one f32 step with the toggles on against off, on the card:
                            # another order of sums, and erf by a polynomial (1.5e-7 abs)
FT_EMA_REL = 1e-6        # the EMA weights against decay * start + (1 - decay) * updated, f32
FT_MICRO = 32            # micro-batch of the finetune CLI runs (batch 64, update_freq 2)
# the head-major kernels of shapes that are not head-blocked-eligible (K5b,
# K5d, K5e): output, dq, dk, dv as max abs error relative to the plain
# version's max abs, as K3b's (K3f's output is held to 2e-2 absolute at
# |o| <= 2: the same bound); db as K2B_DB_REL. bf16: p, ds and the outputs
# rounded to bf16 from f32 sums taken in another order -> a few bf16 ulps.
K5L_BF16_TOL = 2e-2
K5L_F32_TOL = 1e-5       # f32: the same math, sums in another order
FT_N401_SIZE = 320       # --input_H / --input_W of the finetune run at N = 20 x 20 + 1 = 401
# the VAE-training slice: one make_vae_train_step of the conf's VAE on one
# host batch, the card's f32 and bf16 steps against the CPU's f32 step on the
# same images and Gumbel noise
VAE_STEP_B = 4
VAE_STEP_F32_LOSS_REL = 1e-4   # f32 card vs f32 CPU: summation order only
# per-parameter relative L2 of the (clipped) gradients, card f32 vs CPU f32:
# the encoder's biases sum ~50k upstream terms that cancel (a seeded VAE's
# encoder gets its gradient only through 8192-way soft codes); reading on an
# H100 2.1e-3 (decoder.1.net.0.weight), median 4.1e-4; with the last
# deconvolution's kernel flipped 0.76
VAE_STEP_F32_GRAD_REL = 1e-2
VAE_STEP_BF16_LOSS_REL = 2e-2  # bf16 card vs f32 CPU
# bf16 card vs f32 CPU, per parameter: every activation (the images included)
# rounded to bf16 moves these gradients the way a few changed pixels do
# (one card f32 step on its own images read 1.7e-2); reading 0.123
# (decoder.1.net.0.weight), median 4.3e-2; flipped kernel 0.76
VAE_STEP_BF16_GRAD_REL = 0.25
VAE_DECODE_F32_REL = 1e-4      # decode_indices card f32 vs CPU f32, relative L2
VAE_DECODE_BF16_REL = 2e-2     # ... card bf16 vs CPU f32
VAE_CLI_B = 32           # train_vae's batch in the CLI run: 4 steps an epoch of 128 files
X1A_RANDOM_REL = 1e-6    # X1a on random f32 weights, relative L2: the bf16-rounded weights'
                         # f32 sums taken in another order (exact on dyadic weights)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(tag, **fields):
    print(f"{tag} {json.dumps(fields)}", flush=True)


def synthetic_events(rng, n):
    """N-Caltech101-like stream: x < 240, y < 180, sorted t, p = +-1; most
    events on a blob (the object), the rest spread over the sensor."""
    w, h = int(rng.integers(160, 241)), int(rng.integers(120, 181))
    n_obj = int(0.7 * n)
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    xo = np.clip(rng.normal(cx, w / 8, n_obj), 0, w - 1)
    yo = np.clip(rng.normal(cy, h / 8, n_obj), 0, h - 1)
    ev = np.zeros((n, 4), np.float64)
    ev[:, 0] = np.floor(np.concatenate([xo, rng.uniform(0, w, n - n_obj)]))
    ev[:, 1] = np.floor(np.concatenate([yo, rng.uniform(0, h, n - n_obj)]))
    perm = rng.permutation(n)
    ev[:, :2] = ev[perm, :2]
    ev[:, 2] = np.sort(rng.integers(0, 300_000, n))
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    return ev


@contextlib.contextmanager
def http_server(serve, args, quiet=False):
    """``serve.build_server(args)`` answering HTTP on a thread of its own.
    Yields (post, read_stats, build_s): post(events) sends one /predict
    request and returns (status, content type, body bytes, ms); read_stats()
    reads /stats. On exit the batcher, the server and every thread they
    started are stopped. ``quiet`` drops what the build prints."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
        httpd, state, threads = serve.build_server(args)
    build_s = time.perf_counter() - t0
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(ev):
        buf = io.BytesIO()
        np.save(buf, ev)
        t = time.perf_counter()
        req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            body, code, ctype = r.read(), r.status, r.headers["Content-Type"]
        return code, ctype, body, (time.perf_counter() - t) * 1e3

    def read_stats():
        return json.loads(urllib.request.urlopen(url + "/stats", timeout=10).read())

    post.url = url

    try:
        yield post, read_stats, build_s
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        httpd.shutdown()
        httpd.server_close()
        for t in threads:
            t.join(timeout=10)
        http_thread.join(timeout=10)


def in_turns(torch, plain, kernel, runs=20):
    """(kernel ms, plain ms), each the mean of two medians taken in turns:
    plain, kernel, kernel, plain."""
    tp = [time_ms(plain, runs=runs)]
    tk = [time_ms(kernel, runs=runs), time_ms(kernel, runs=runs)]
    tp.append(time_ms(plain, runs=runs))
    return statistics.mean(tk), statistics.mean(tp)


def bincount_ms(torch, col, ys, H, W, want):
    """The one library call that computes K1's and K4's counts: a
    torch.bincount over the linear index (sample, y, column of [pos | neg]),
    the invalid events weighted 0 (the index and weights are built before the
    timing). Returns (ms, or None where its counts differ from ``want``, the
    plain version's; whether they are equal)."""
    B = col.shape[0]
    ok = (col >= 0) & (col < 2 * W) & (ys >= 0) & (ys < H)
    lin = (torch.where(ok, ys.long() * (2 * W) + col.long(), 0)
           + torch.arange(B, device=col.device)[:, None] * (H * 2 * W)).reshape(-1)
    wts = ok.reshape(-1).float()

    def call():
        return torch.bincount(lin, weights=wts, minlength=B * H * 2 * W)

    equal = bool(torch.equal(call().view(B, H, 2 * W).to(torch.int32), want))
    return (time_ms(call) if equal else None), equal


def raster_bound(B, N, H, W):
    """The raster mode: col and ys read (int32), the (B, H, W, 3) uint8 image
    written; one add per event."""
    return bound(2 * B * N * 4 + B * H * W * 3, B * N, PEAK_F32_FLOPS)


def time_raster(torch, gpu, tag, events, n_valid, H, W, y_sorted=False):
    """voxelize_fused as its caller runs it (no time surface, no voxel grid:
    the kernel writes the raster): CUDA-event ms of the call, device ms of
    every kernel it launches and the kernels a call. Then the tail that the
    raster mode replaced, on the packed events of the same call (K1, or K4
    on a wide canvas): the kernel's raster against its int32 planes wrapped,
    cast and stacked (raster_from_planes, the chain before the raster mode),
    in turns (chain, raster, raster, chain), each bit-equal to the call."""
    from mem_tpu_torch.ops import voxelize as V
    from mem_tpu_torch.ops import voxelize_hist as vh

    B, N = n_valid.shape[0], events.shape[1]
    with torch.inference_mode():
        def call():
            return V.voxelize_fused(events, n_valid, H, W, y_sorted=y_sorted)

        want = call()
        whole = (time_ms(call, runs=20), *call_device_profile(call)[:2])
        # voxelize_fused's packing without augmentations
        xs, ys, ps = events[..., 0].int(), events[..., 1].int(), events[..., 3]
        ok = ((torch.arange(N, device=events.device)[None] < n_valid[:, None])
              & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
        col, ysp = vh.pack_cols(xs.clamp(0, W - 1), ys.clamp(0, H - 1),
                                (ok & (ps == 1)).float(), (ok & (ps == -1)).float(), H, W)
        col, ysp = col.contiguous(), ysp.contiguous()
        if H * 2 * W >= vh.WIDE_CANVAS_CELLS:
            hist = lambda **kw: vh.hist_planes_cols_sorted(  # noqa: E731
                col, ysp, H, W, presorted=y_sorted, **kw)
        else:
            hist = lambda **kw: vh.hist_planes_cols(col, ysp, H, W, **kw)  # noqa: E731
        legs = {"raster": lambda: hist(raster=True),
                "chain": lambda: vh.raster_from_planes(hist())}
        res = {"chain": [], "raster": []}
        for leg in ("chain", "raster", "raster", "chain"):
            check(torch.equal(legs[leg](), want),
                  f"time_raster {tag}: the {leg} tail differs from voxelize_fused's raster")
            res[leg].append((time_ms(legs[leg], runs=20),
                             *call_device_profile(legs[leg])[:2]))
    mean = lambda leg, i: statistics.mean(r[i] for r in res[leg])  # noqa: E731
    say("time_raster", gpu=gpu, case=tag, shape=[B, N, H, W], y_sorted=y_sorted,
        fused_ms=whole[0], fused_device_ms=whole[1], fused_kernels=whole[2],
        tail_raster_ms=mean("raster", 0), tail_raster_device_ms=mean("raster", 1),
        tail_raster_kernels=mean("raster", 2), tail_chain_ms=mean("chain", 0),
        tail_chain_device_ms=mean("chain", 1), tail_chain_kernels=mean("chain", 2),
        legs=res, raster_bound_ms=raster_bound(B, N, H, W)[0])


def check_ptxas(log):
    """ptxas's report, from the build log ``log``, on the wgmma kernels: those
    of K3f (which K2f, K5a and K5b launch too) at head dims 64 and 32, of
    K3b's rows and columns kernels (K2b, K5c, K5d, K5e too) at both head dims,
    flat and head-major, and X3's (its rows kernel's kPair
    instantiation, and the columns kernel its translation unit compiles
    beside it), K6's GEMM body
    (F1, F2 of K6f; B1, B2, B3+B4 of K6b; F2, B2 and B3+B4 at tile widths
    128 and 256), X1's contraction (X1a and X1b, which X1c launches, at
    the plan's two tile widths) and X2's (int8 and bf16 at the plan's two
    tile widths): registers (at entry, setmaxnreg gives the
    consumers 240), shared memory and spills; it fails on a spill or on any
    warning that ptxas serialized a wgmma pipeline."""
    fwd = ptxas_report(log, "attention_long_fwd_wgmma_kernel")
    bwd = [r for frag in ("attention_long_bwd_rows_wgmma_kernel",
                          "attention_long_bwd_cols_wgmma_kernel")
           for r in ptxas_report(log, frag)]
    k6 = ptxas_report(log, "mlp_gemm_")
    x1 = ptxas_report(log, "x1_wgmma_kernel")
    from mem_tpu_torch.tools.exp_voxelize2 import X2_TILE_NS

    x2 = ptxas_report(log, "x2_wgmma_kernel")
    n_x2 = 2 * len(X2_TILE_NS)   # int8 and bf16 at each tile width
    for tag, rows, unit, want, users in (
            ("ptxas_k3f", fwd, "attention_long_fwd", 4, "K3f K2f K5a K5b"),
            ("ptxas_k3b", bwd, "attention_long_bwd", 10, "K3b K2b K5c K5d K5e X3"),
            ("ptxas_k6", k6, "mlp_gemm_", 8, "K6f K6b"),
            ("ptxas_x1", x1, "x1_wgmma_kernel", 4, "X1a X1b X1c"),
            ("ptxas_x2", x2, "x2_wgmma_kernel", n_x2, "X2a X2b X2c")):
        serial = [ln.strip() for ln in log.splitlines() if "serialized" in ln and unit in ln]
        say(tag, launched_by=users, kernels=rows, serialized=serial)
        check(len(rows) == want and all(" 0 bytes spill stores" in r["spills"] for r in rows)
              and not serial, f"{tag}: the wgmma kernels' ptxas report: {rows}, {serial}")


def ptxas_report(log, fragment):
    """ptxas's lines (spills; registers and shared memory) for each kernel
    whose mangled name holds ``fragment``, from a build log."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1]} if fragment in ln else None
            if cur:
                out.append(cur)
        elif cur is not None and "spill" in ln:
            cur["spills"] = ln.strip()
        elif cur is not None and "registers" in ln:
            cur["registers"] = ln.strip().replace("ptxas info    : ", "")
    return out


def sdpa_operands(torch, q, k, v, bias):
    """(B, H, N, D) views' contiguous copies and the bias as a mask in the
    operands' dtype, for one scaled_dot_product_attention call."""
    B, N, C = q.shape
    H = bias.shape[0]
    heads = lambda t: t.view(B, N, H, C // H).transpose(1, 2).contiguous()  # noqa: E731
    return heads(q), heads(k), heads(v), bias.to(q.dtype)[None].contiguous()


def run(torch):
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli.common import build_classifier, build_preproc
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.kernels import build, launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import voxelize_hist as vh
    from mem_tpu_torch.ops.attention import (cuda_kernel_path, fused_attention_flat,
                                             fused_attention_flat_reference)
    from mem_tpu_torch.tools import bench_serve
    from mem_tpu_torch.utils import env

    # full-precision f32 products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slices, clock = {}, [time.perf_counter()]

    def lap(name, own_line=False):
        """The seconds since the last lap, kept under ``name`` and printed on
        a ``<name>_slice`` line unless the slice prints its own."""
        now = time.perf_counter()
        slices[name] = round(now - clock[0], 2)
        clock[0] = now
        if not own_line:
            say(f"{name}_slice", seconds=slices[name])

    # -- phase 0: probe + build ----------------------------------------------
    info = env.probe()
    gpu = info["nvidia_smi"] or f"{info['device_name']}, power limit not read"
    print(gpu, flush=True)
    say("probe", **info)
    t0 = time.perf_counter()
    build.library()
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)
    check_ptxas(build.build_log())

    # -- phase 1: K1 against its plain version -------------------------------
    g = torch.Generator().manual_seed(0)
    k1_err = check_k1(torch, dev, g)

    # -- phase 2: K2 forward against its plain version -----------------------
    # the serving shape first (bf16 at head dim 64 or 32 and N <= 256: the
    # Hopper kernel), the ragged lengths, the longest it takes, then the
    # scalar kernel (f32, other head dims); every case launched twice: the
    # outputs must be bit-identical
    k2_err = None
    for (B, N, H, D), dt in (((8, 197, 12, 64), torch.bfloat16),
                             ((2, 37, 3, 64), torch.bfloat16),
                             ((2, 129, 2, 64), torch.bfloat16),
                             ((1, 256, 2, 64), torch.bfloat16),
                             ((2, 50, 4, 32), torch.bfloat16),
                             ((2, 37, 3, 32), torch.bfloat16),
                             ((1, 256, 2, 32), torch.bfloat16),
                             # the MAE's encoder (its 99 visible tokens) and
                             # decoder (head dim 32), and the decoder at the
                             # timed batch
                             ((8, 99, 12, 64), torch.bfloat16),
                             ((8, 197, 16, 32), torch.bfloat16),
                             ((128, 197, 16, 32), torch.bfloat16),
                             ((2, 50, 4, 16), torch.bfloat16),
                             ((8, 197, 12, 64), torch.float32),
                             ((8, 197, 16, 32), torch.float32)):
        tol = K2_BF16_TOL if dt == torch.bfloat16 else K2_F32_TOL
        q, k, v = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(3))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        got = fused_attention_flat(q, k, v, bias, D ** -0.5)
        again = fused_attention_flat(q, k, v, bias, D ** -0.5)
        want = fused_attention_flat_reference(q, k, v, bias, D ** -0.5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same, path = bool(torch.equal(got, again)), cuda_kernel_path(q, k, v, bias)
        say("k2_check", dtype=str(dt), shape=[B, N, H, D], max_abs_err=err, tol=tol,
            identical_across_launches=same, kernel=path)
        check(err <= tol, f"K2 {dt} {B, N, H, D} max abs err {err} > {tol}")
        check(same, f"K2 {dt} {B, N, H, D}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, (B, N, H, D), dt) else "scalar"),
              f"K2 {dt} {B, N, H, D} took the {path} kernel")
        if k2_err is None:
            k2_err = err

    lap("kernels_k1_k2")

    # -- phase 3: the served slice at full width ------------------------------
    rng = np.random.default_rng(0)
    payloads = [synthetic_events(rng, int(rng.integers(20_000, 60_001)))
                for _ in range(N_REQUESTS)]
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "ft_vit_b16_seed0.pth")
    flags = ["--checkpoint", ckpt, "--nb_classes", "101", "--dataset", "ncaltech101",
             "--model", "ft_vit", "--dtype", "bfloat16", "--batch_size", "8",
             "--max_wait_ms", "5", "--topk", "5", "--port", "0", "--device", "cuda"]
    args = serve.get_args(flags)
    ref = build_classifier(args, 101, torch.float32, torch.device("cpu"))
    ref.init_weights(torch.Generator().manual_seed(0))
    torch.save({"model": ref.state_dict(), "epoch": 0}, ckpt)
    say("model", name="ft_vit", embed_dim=args.transformer_emb,
        depth=args.transformer_depth, heads=args.transformer_heads,
        img=[args.input_H, args.input_W], patch=16, classes=101, params=sum(p.numel() for p in ref.parameters()), checkpoint_mb=round(
            os.path.getsize(ckpt) / 2**20, 1))

    with http_server(serve, args) as (post, read_stats, build_s):
        def ask(ev):
            code, _, body, ms = post(ev)
            return code, json.loads(body), ms

        reset_launch_counts()                 # just before the main path
        with ThreadPoolExecutor(8) as pool:
            burst = list(pool.map(ask, payloads))
        seq = [ask(payloads[i]) for i in range(8)]
        repeat = ask(payloads[0])
        counts = launch_counts()              # just after it
        stats = read_stats()
        # tools/bench_serve.py against this server (tools_slice reads it)
        t_bs, buf = time.perf_counter(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_serve.main([f"url={post.url}", "conc=8", "secs=3", "n_events=30000"])
        serve_bench = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                       round(time.perf_counter() - t_bs, 2))
    say("bench_serve", **serve_bench[0])
    check(serve_bench[0]["errors"] == 0 and serve_bench[0]["requests"] >= 1,
          f"bench_serve: {serve_bench[0]}")

    for code, body, _ in burst + seq + [repeat]:
        check(code == 200, f"HTTP {code}")
        tk = body["topk"]
        probs = [p for _, p in tk]
        check(len(tk) == 5 and all(0 <= c < 101 for c, _ in tk), f"bad topk {tk}")
        check(probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1 + 1e-5,
              f"bad probabilities {probs}")
        check(all(np.isfinite(probs)), "non-finite probabilities")
    check(repeat[1]["topk"] == seq[0][1]["topk"], "same payload, different top-k")
    served = len(burst) + len(seq) + 1
    say("serve", requests=served, over_cap=sum(len(p) > 30_000 for p in payloads),
        build_server_s=round(build_s, 3), launches=counts, stats=stats,
        deterministic=True)
    check(stats["served"] >= served, f"/stats served {stats['served']} < {served}")
    for name in ("hist_planes_cols", "fused_attention_flat"):
        check(counts.get(name, 0) > 0, f"the served path launched no {name} kernel")

    # card logits (bf16 and f32) against the plain versions on the CPU in f32
    pp = build_preproc(args, is_train=False)
    batch = serve.make_assemble(args, pp)([(p, False) for p in payloads[:8]], 8)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    cpu_model = build_classifier(args, 101, torch.float32, torch.device("cpu"))
    cpu_model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        cpu_images = preprocess_batch(serve.to_device(batch, "cpu"), pp, is_train=False)
        cpu_logits = cpu_model.eval()(cpu_images)
    rel, img_err = {}, 0.0
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model = build_classifier(args, 101, dt, dev)
        model.load_state_dict(sd, strict=True)
        model.eval()
        with torch.inference_mode():
            images = preprocess_batch(serve.to_device(batch, dev), pp, is_train=False)
            logits = model(images).cpu()
        check(bool(torch.isfinite(logits).all()) and logits.shape == (8, 101),
              f"card logits {tuple(logits.shape)} not finite")
        rel[name] = (torch.linalg.norm(logits - cpu_logits)
                     / torch.linalg.norm(cpu_logits)).item()
        img_err = max(img_err, (images.cpu() - cpu_images).abs().max().item())
    say("logits_check", rel_l2_bf16=rel["bfloat16"], bound_bf16=LOGITS_BF16_REL,
        rel_l2_f32=rel["float32"], bound_f32=LOGITS_F32_REL, images_max_abs=img_err,
        logits_abs_mean=cpu_logits.abs().mean().item())
    check(img_err <= IMAGES_TOL, f"card images differ from CPU by {img_err}")
    check(rel["bfloat16"] <= LOGITS_BF16_REL, f"bf16 logits rel L2 {rel['bfloat16']}")
    check(rel["float32"] <= LOGITS_F32_REL, f"f32 logits rel L2 {rel['float32']}")

    # -- phase 4: timings (CUDA-event medians of 30 runs after 5 warm-up) ----
    timing = {}
    for B in (8, 64):
        evs = [synthetic_events(rng, 30_000) for _ in range(B)]
        xs = torch.tensor(np.stack([e[:, 0] for e in evs]), dtype=torch.int32, device=dev)
        ys = torch.tensor(np.stack([e[:, 1] for e in evs]), dtype=torch.int32, device=dev)
        pos = torch.tensor(np.stack([e[:, 3] > 0 for e in evs]), device=dev).float()
        col, ysf = vh.pack_cols(xs, ys, pos, 1.0 - pos, 256, 256)
        col, ysf = col.contiguous(), ysf.contiguous()
        t_k1, t_k1p = in_turns(torch, lambda: vh.hist_planes_cols_reference(col, ysf, 256, 256),
                               lambda: vh.hist_planes_cols(col, ysf, 256, 256))
        t_k1l, k1l_equal = bincount_ms(torch, col, ysf, 256, 256,
                                       vh.hist_planes_cols_reference(col, ysf, 256, 256))
        # the profiler's device time of every kernel the call launches (no
        # fill ahead of the kernel: the kernel writes each cell); the raster
        # mode (voxelize_fused's tail) at this shape
        plan = vh.hist_plan(B, 30_000, 256, 256, vh.sm_count(0))
        k1 = lambda: vh.hist_planes_cols(col, ysf, 256, 256)  # noqa: E731
        _, k1_kernels, k1_names = call_device_profile(k1)
        check(all("hist_band_kernel" in k for k in k1_names),
              f"K1 launched {k1_names}, not its kernel alone")
        d_k1, d_k1r = (kernel_device_ms(f, ("hist_band_kernel",), per_launch=True)
                       for f in (k1, lambda: vh.hist_planes_cols(col, ysf, 256, 256,
                                                                 raster=True)))
        say("time_k1", gpu=gpu, batch=B, events=30_000, canvas=[256, 256], kernel_ms=t_k1,
            kernel_device_ms=d_k1, kernels_a_call=k1_kernels, plain_ms=t_k1p,
            bincount_ms=t_k1l, bincount_equals_plain=k1l_equal,
            plan=dict(rows=plan.rows, blocks=plan.blocks, counter_bytes=plan.counter_bytes),
            raster_device_ms=d_k1r,
            bound_ms=hist_bound(B, 30_000, 256, 256)[0],
            raster_bound_ms=raster_bound(B, 30_000, 256, 256)[0],
            kernel_gev_s=B * 30_000 / t_k1 / 1e6)
        evb = torch.tensor(np.stack(evs), dtype=torch.float32, device=dev)
        time_raster(torch, gpu, f"serving B={B}", evb,
                    torch.full((B,), 30_000, dtype=torch.int32, device=dev), 256, 256)

        q, k, v = (torch.randn(B, 197, 768, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn(12, 197, 197, device=dev)
        t_k2 = time_ms(lambda: fused_attention_flat(q, k, v, bias, 0.125))
        t_k2d = kernel_device_ms(lambda: fused_attention_flat(q, k, v, bias, 0.125),
                                 ("attention_long_fwd_wgmma",), per_launch=True)
        t_k2p = time_ms(lambda: fused_attention_flat_reference(q, k, v, bias, 0.125))
        qh, kh, vhd, mask = sdpa_operands(torch, q, k, v, bias)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vhd, attn_mask=mask, scale=0.125)
        t_k2l, t_k2ld = time_ms(sdpa), kernel_device_ms(sdpa, ("",))
        flop = 4 * B * 12 * 197 * 197 * 64
        say("time_k2", gpu=gpu, batch=B, shape=[197, 12, 64], dtype="bfloat16",
            kernel_ms=t_k2, kernel_device_ms=t_k2d, plain_ms=t_k2p, sdpa_ms=t_k2l,
            sdpa_device_ms=t_k2ld,
            bound_ms=attention_fwd_bound(B, 197, 12, 64)[0],
            kernel_tflop_s=flop / t_k2 / 1e9)
        timing[B] = (t_k1, t_k1p, t_k2, t_k2p, t_k2l, t_k1l)

    lat = sorted(ms for _, _, ms in burst)
    say("time_http", gpu=gpu, batch_size=8, clients=8, requests=len(burst),
        p50_ms=statistics.median(lat), p90_ms=lat[int(0.9 * (len(lat) - 1))],
        sequential_p50_ms=statistics.median(ms for _, _, ms in seq))
    tmp.cleanup()
    lap("served")

    # -- the segmentation slice's kernels against their plain versions --------
    k4_err = check_k4(torch, dev, g)
    k3f_err = check_k3f(torch, dev, g)
    k3b_err = check_k3b(torch, dev, g)
    # -- the rest of fused_attention: K5b, K5d, K5e ---------------------------
    k5b_err, k5d_err, k5e_err = (check_k5b(torch, dev, g), check_k5d(torch, dev, g),
                                 check_k5e(torch, dev, g))
    lap("kernels_k3_k4_k5")

    # -- phases 5-8: the pretraining slice ------------------------------------
    k2b_err = check_k2b(torch, dev, g)
    train_tmp = tempfile.TemporaryDirectory()
    try:
        data_root, vae_path = write_training_inputs(torch, train_tmp.name, rng)
        base = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
                "--discrete_vae_weight_path", vae_path, "--num_workers", "4"]
        check_train_step(torch, dev, base + ["--output_dir", os.path.join(train_tmp.name, "x")])
        train_counts = run_training_cli(torch, base + [
            "--output_dir", os.path.join(train_tmp.name, "pt_out")])
        check_loss_fall(torch, dev, base + ["--output_dir", os.path.join(train_tmp.name, "x")])
        t_k2b, t_k2bp, t_k2bl = time_training(torch, dev, gpu)
        lap("pretraining")
        # -- the VAE-training slice: train_vae -> run_mem_pretraining --------
        run_vae_slice(torch, dev, gpu, data_root, train_tmp.name, base)
        lap("vae")
        # -- the MAE slice: pretraining -> finetune -> serve, --MAE 1 ---------
        run_mae_slice(torch, dev, gpu, data_root, train_tmp.name)
        lap("mae")
        # -- the classification finetune slice (on the same synthetic dataset) --
        ft = run_finetune_slice(torch, dev, gpu, g, data_root, train_tmp.name)
        lap("finetune")
        # -- chained dispatch: the graph chains against the eager loop --------
        run_chain_slice(torch, dev, gpu, data_root, vae_path, train_tmp.name)
        lap("chain")
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLI latched SIGTERM
        train_tmp.cleanup()

    # -- the segmentation slice -------------------------------------------------
    seg = run_seg_slice(torch, dev, gpu, rng)
    lap("seg")

    # -- the segmentation training slice ----------------------------------------
    seg_train = run_seg_train_slice(torch, dev, gpu, rng)
    k5_ms = time_k5_long(torch, dev, gpu)
    lap("seg_train")

    # -- the experiment kernels X1a, X1b, X1c, X3, X2a, X2b and X2c -------------
    x1_err, x3_err = check_x1(torch, dev, g), check_x3(torch, dev, g)
    x2_err = check_x2(torch, dev, g)
    exp_counts = run_experiment_tools(torch)
    x_ms = time_experiments(torch, dev, gpu)
    lap("experiments")

    # -- the dataset tools and the optimizer switch (their own generator: they
    #    change no other phase's inputs) ------------------------------------
    tools_tmp = tempfile.TemporaryDirectory()
    try:
        run_dataset_tools_slice(torch, dev, gpu, tools_tmp.name)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLIs latched SIGTERM
        tools_tmp.cleanup()
    lap("dataset_tools", own_line=True)

    # -- multi-GPU training, in processes of its own, beside the tools, IMNET
    #    and int8 slices (its gates only: it reads no time; its lines are
    #    kept and printed after the join) --------------------------------------
    torch.cuda.empty_cache()   # the children need the card's memory, not this cache
    par_tmp, par_box, par_lines = tempfile.TemporaryDirectory(), {}, []

    def parallel():
        try:
            par_box["par"] = run_parallel_slice(torch, gpu, par_tmp.name, par_lines)
        except BaseException as e:   # raised again on the main thread
            par_box["error"] = e

    par_thread = threading.Thread(target=parallel, name="parallel_slice")
    par_thread.start()
    try:
        # -- the measuring tools at a cut size (their own seeds and data) -------
        tools_tmp = tempfile.TemporaryDirectory()
        try:
            run_tools_slice(torch, gpu, tools_tmp.name, serve_bench)
        finally:
            tools_tmp.cleanup()
        lap("tools", own_line=True)

        # -- the IMNET real-image slice (its own generator) --------------------
        imnet_tmp = tempfile.TemporaryDirectory()
        try:
            run_imnet_slice(torch, dev, gpu, imnet_tmp.name)
        finally:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLIs latched SIGTERM
            imnet_tmp.cleanup()
        lap("imnet", own_line=True)

        # -- W8A8 int8 serving, the sinks and the pipeline script (its own
        #    generator); the trajectory check (its own generator) runs while
        #    the pipeline script's processes do ---------------------------------
        int8_tmp, traj_tmp, traj = (tempfile.TemporaryDirectory(),
                                    tempfile.TemporaryDirectory(), {})
        try:
            run_int8_slice(torch, dev, gpu, int8_tmp.name, lambda: traj.update(
                run_trajectory_card(torch, dev, gpu, traj_tmp.name)))
        finally:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLIs latched SIGTERM
            int8_tmp.cleanup()
            traj_tmp.cleanup()
        lap("int8_trajectory", own_line=True)
    finally:
        par_thread.join()
        par_tmp.cleanup()
        for line in par_lines:
            print(line, flush=True)
    if "error" in par_box:
        raise par_box["error"]
    par = par_box["par"]
    lap("parallel_wait")

    # -- the trace tools at the larger batches, the card to themselves --------
    run_tools_big_slice(gpu)
    lap("tools_big", own_line=True)

    # -- the resilience slice: the pretraining CLI recycled, preempted and
    #    resumed (its own generator; soak_card in processes of its own) ------
    res_tmp = tempfile.TemporaryDirectory()
    try:
        resilience = run_resilience_slice(torch, gpu, res_tmp.name)
    finally:
        res_tmp.cleanup()
    lap("resilience", own_line=True)

    say("slices", seconds=slices, total=round(sum(slices.values()), 2))

    def row(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        out = {"name": name, "route": "cuda", "source": f"mem_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches,
               "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
        if name in par:   # the parallel paths' launches (their ranks' main paths)
            out["parallel_launches"] = par[name]
        if name in traj:  # the trajectory phase's arms
            out["trajectory_launches"] = traj[name]
        if name in resilience:  # resume_card's gated arms, soak_card's trainers
            out["resilience_launches"] = resilience[name]
        return out

    # launches: K1, K2f, K2b from the pretraining CLI's run, K3f and K4 from
    # test_seg's single-scale run, K3b from train_seg's first run, K6f, K6b,
    # K5a and K5c from the toggled finetune CLI's first run, K5b and K5e from
    # train_seg's run with FLAT_ATTN_LONG = False, K5d from the N = 401
    # finetune run, X1a, X1b, X1c, X3, X2a, X2b and X2c from the experiment
    # tools' runs;
    # times at the shapes the bounds name
    ops, vox, attn = "mem_tpu/ops/", "scripts/exp_voxelize.py", "scripts/exp_attn_bwd.py"
    vox2 = "scripts/exp_voxelize2.py"
    print(json.dumps({"kernels": [
        row("hist_planes_cols", "voxelize_hist.cu", ops + "voxelize_pallas.py:64",
            train_counts["hist_planes_cols"], k1_err, timing[8][0], timing[8][1],
            hist_bound(8, 30_000, 256, 256), timing[8][5]),
        row("fused_attention_flat", "attention_long_fwd.cu", ops + "attention.py:105",
            train_counts["fused_attention_flat"], k2_err, timing[8][2], timing[8][3],
            attention_fwd_bound(8, 197, 12, 64), timing[8][4]),
        row("fused_attention_flat_bwd", "attention_long_bwd.cu", ops + "attention.py:128",
            train_counts["fused_attention_flat_bwd"], k2b_err, t_k2b, t_k2bp,
            attention_bwd_bound(64, 197, 12, 64), t_k2bl),
        row("fused_attention_flat_long", "attention_long_fwd.cu", ops + "attention.py:255",
            seg["counts"]["fused_attention_flat_long"], k3f_err, seg["k3f_ms"],
            seg["k3f_plain_ms"], attention_fwd_bound(8, 1025, 12, 64), seg["k3f_sdpa_ms"]),
        row("hist_planes_cols_sorted", "voxelize_hist_sorted.cu",
            ops + "voxelize_pallas.py:81", seg["counts"]["hist_planes_cols_sorted"], k4_err,
            seg["k4_ms"], seg["k4_plain_ms"], hist_bound(8, SEG_EVENTS, 440, 640),
            seg["k4_bincount_ms"]),
        row("fused_attention_flat_long_bwd", "attention_long_bwd.cu", ops + "attention.py:276",
            seg_train["counts"]["fused_attention_flat_long_bwd"], k3b_err,
            seg_train["k3b_ms"], seg_train["k3b_plain_ms"],
            attention_bwd_bound(16, 1025, 12, 64), seg_train["k3b_sdpa_ms"]),
        row("mlp_fused", "mlp_fwd.cu", ops + "mlp.py:54", ft["counts"]["mlp_fused"],
            ft["k6f_err"], *ft["k6f_ms"], mlp_fwd_bound(FT_ROWS, 768, 3072), None),
        row("mlp_fused_bwd", "mlp_bwd.cu", ops + "mlp.py:118", ft["counts"]["mlp_fused_bwd"],
            ft["k6b_err"], *ft["k6b_ms"], mlp_bwd_bound(FT_ROWS, 768, 3072), None),
        row("fused_attention", "attention_long_fwd_bhnd.cu", ops + "attention.py:54",
            ft["counts"]["fused_attention"], ft["k5a_err"], *ft["k5a_ms"][:2],
            attention_fwd_bound(FT_B, 197, 12, 64), ft["k5a_ms"][2]),
        row("fused_attention_bwd", "attention_long_bwd_bhnd.cu", ops + "attention.py:70",
            ft["counts"]["fused_attention_bwd"], ft["k5c_err"], *ft["k5c_ms"][:2],
            attention_bwd_bound(FT_B, 197, 12, 64), ft["k5c_ms"][2]),
        row("fused_attention_long", "attention_long_fwd_bhnd.cu", ops + "attention.py:413",
            seg_train["counts_long_off"]["fused_attention_long"], k5b_err, *k5_ms["K5b"][:2],
            attention_fwd_bound(8, 1025, 12, 64), k5_ms["K5b"][2]),
        row("fused_attention_bwd_whole", "attention_long_bwd_bhnd.cu", ops + "attention.py:425",
            ft["counts_n401"]["fused_attention_bwd_whole"], k5d_err, *k5_ms["K5d"][:2],
            attention_bwd_bound(FT_MICRO, 401, 12, 64), k5_ms["K5d"][2]),
        row("fused_attention_bwd_long", "attention_long_bwd_bhnd.cu", ops + "attention.py:515",
            seg_train["counts_long_off"]["fused_attention_bwd_long"], k5e_err,
            *k5_ms["K5e"][:2], attention_bwd_bound(16, 1025, 12, 64), k5_ms["K5e"][2]),
        *(row(name, "exp_voxelize.cu", f"{vox}:{line}", exp_counts["exp_voxelize"][name],
              x1_err[name], *x_ms[name])
          for name, line in (("exp_voxelize_base", 25), ("exp_voxelize_fused_onehot", 47),
                             ("exp_voxelize_fused_loop", 66))),
        row("fused_attention_flat_bwd_pair", "attention_bwd_pair.cu", f"{attn}:38",
            exp_counts["exp_attn_bwd"]["fused_attention_flat_bwd_pair"], x3_err,
            *x_ms["fused_attention_flat_bwd_pair"]),
        *(row(name, "exp_voxelize2.cu", f"{vox2}:{line}", exp_counts["exp_voxelize2"][name],
              x2_err[name], *x_ms[name])
          for name, line in (("exp_voxelize2_fused_i8", 49), ("exp_voxelize2_tiled", 24),
                             ("exp_voxelize2_tiled_i8", 204))),
    ]}), flush=True)


def last_key_dropped(bwd):
    """``bwd``, an attention backward wrapper, with a planted fault: the last
    key masked out of the scores it recomputes (what a kernel that mishandles
    the ragged tail tile would give). A step gate must see it."""
    def faulty(q, k, v, bias, do, scale):
        bias = bias.clone()
        bias[:, :, -1] = float("-inf")
        return bwd(q, k, v, bias, do, scale)
    return faulty


def path_spy(bwd, path_of, paths, device):
    """``bwd``, an attention backward wrapper, that first appends to
    ``paths`` the kernel path ``path_of`` names for its operands (on the
    card): a step's record of which kernels its backward launches took."""
    def spied(q, k, v, bias, do, scale):
        if device.type == "cuda":
            paths.append(path_of(q, k, v, bias))
        return bwd(q, k, v, bias, do, scale)
    return spied


def grad_rel(torch, got, ref):
    """Per-parameter relative L2 of the gradients ``got`` against ``ref``
    (name -> tensor): the largest, its parameter, the median and the five
    largest."""
    rel = {n: rel_l2(torch, g, ref[n]) for n, g in got.items()}
    worst = sorted(rel, key=rel.get, reverse=True)
    return dict(max=rel[worst[0]], worst=worst[0], median=statistics.median(rel.values()),
                worst5=[(n, rel[n]) for n in worst[:5]])


def rel_max_abs(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def rel_l2(torch, a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def check_k2b(torch, dev, g):
    """Phase 5: K2b against its plain version at the training shapes (the
    pretraining batch 64 and 8; bf16 at head dim 64: the Hopper kernels), two
    ragged ones, the longest N the Hopper kernels take, the MAE's encoder
    (N = 99) and decoder (head dim 32, B = 8 and 128: the Hopper kernels at
    D = 32; a ragged and the longest N there too), f32 and head dim 16 (the
    scalar kernel); every output bit-identical across two launches; autograd
    through fused_attention_flat on the card reaches K2b. Then a planted fault
    inside the D = 32 rows kernel (dq's last k16 step of every key tile
    skipped; a library built with MEM_ATTN_PLANT_FAULT) must fail the gate at the
    decoder's shape on the path it claims, and K2f / K2b run from a fresh
    thread at both head dims. Returns K2b's max abs error at the first
    training shape."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops.attention import (cuda_bwd_kernel_path, fused_attention_flat,
                                             fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference)

    first = None
    for (B, N, H, D), dt in (((8, 197, 12, 64), torch.bfloat16),
                             ((64, 197, 12, 64), torch.bfloat16),
                             ((2, 37, 3, 64), torch.bfloat16),
                             ((2, 129, 2, 64), torch.bfloat16),
                             ((1, 256, 2, 64), torch.bfloat16),
                             # the MAE: the encoder's 99 visible tokens; the
                             # decoder at head dim 32 (its padded ds
                             # workspace: 323 MB at B=128)
                             ((8, 99, 12, 64), torch.bfloat16),
                             ((8, 197, 16, 32), torch.bfloat16),
                             ((128, 197, 16, 32), torch.bfloat16),
                             ((2, 37, 3, 32), torch.bfloat16),
                             ((1, 256, 2, 32), torch.bfloat16),
                             ((2, 50, 4, 16), torch.bfloat16),
                             ((2, 197, 4, 64), torch.float32),
                             ((2, 99, 4, 32), torch.float32)):
        tol = K2B_BF16_TOL if dt == torch.bfloat16 else K2B_F32_TOL
        q, k, v, do = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(4))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        got = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
        again = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
        want = fused_attention_flat_bwd_reference(q, k, v, bias, do, D ** -0.5)
        torch.cuda.synchronize()
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        db = rel_l2(torch, got[3], want[3])
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        path = cuda_bwd_kernel_path(q, k, v, bias)
        say("k2b_check", dtype=str(dt), shape=[B, N, H, D], rel_max_abs=errs, tol=tol,
            db_rel_l2=db, db_tol=K2B_DB_REL, identical_across_launches=same, kernel=path)
        check(max(errs.values()) <= tol and db <= K2B_DB_REL,
              f"K2b {dt} {B, N, H, D}: {errs}, db {db}")
        check(same, f"K2b {dt} {B, N, H, D}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, (B, N, H, D), dt) else "scalar"),
              f"K2b {dt} {B, N, H, D} took the {path} kernels")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        del q, k, v, do, bias, got, again, want

    q, k, v = (torch.randn(2, 197, 768, generator=g).to(torch.bfloat16).to(dev)
               .requires_grad_() for _ in range(3))
    bias = torch.randn(12, 197, 197, generator=g).to(dev).requires_grad_()
    do = torch.randn(2, 197, 768, generator=g).to(torch.bfloat16).to(dev)
    before = launch_counts().get("fused_attention_flat_bwd", 0)
    fused_attention_flat(q, k, v, bias, 0.125).backward(do)
    torch.cuda.synchronize()
    launched = launch_counts().get("fused_attention_flat_bwd", 0) - before
    want = fused_attention_flat_bwd_reference(q.detach(), k.detach(), v.detach(),
                                              bias.detach(), do, 0.125)
    errs = [rel_max_abs(t.grad, w) for t, w in zip((q, k, v), want)]
    say("k2b_autograd", launches=launched, rel_max_abs=errs,
        db_rel_l2=rel_l2(torch, bias.grad, want[3]))
    check(launched == 1, f"autograd through fused_attention_flat launched K2b {launched} times")
    check(max(errs) <= K2B_BF16_TOL, f"autograd grads differ from the plain backward: {errs}")

    k2b_d32_fault(torch, dev, g)

    # K2f and K2b from a fresh thread, on which PyTorch has made no CUDA
    # context current yet (as autograd's device thread when the attention's
    # backward is its first work): the library binds the device itself
    # (build.library), and the results are the main thread's bits
    q, k, v = (t.detach() for t in (q, k, v))
    bias = bias.detach()
    fresh = {}

    def launch():
        try:
            fresh["out"] = (fused_attention_flat(q, k, v, bias, 0.125),
                            *fused_attention_flat_bwd(q, k, v, bias, do, 0.125))
            torch.cuda.synchronize()
        except Exception as e:   # reported below, on the main thread
            fresh["error"] = repr(e)

    t = threading.Thread(target=launch, daemon=True)
    t.start()
    t.join(timeout=300)
    check(not t.is_alive(), "K2f / K2b from a fresh thread did not finish in 300 s")
    main = (fused_attention_flat(q, k, v, bias, 0.125),
            *fused_attention_flat_bwd(q, k, v, bias, do, 0.125))
    torch.cuda.synchronize()
    same = "out" in fresh and all(torch.equal(a, b) for a, b in zip(fresh["out"], main))
    say("k2_fresh_thread", error=fresh.get("error"), equals_main_thread=same)
    check(same, f"K2f / K2b from a fresh thread: {fresh.get('error', 'other bits')}")
    # the same at the decoder's head dim 32 (the D = 32 instantiation)
    q, k, v, do = (torch.randn(2, 197, 512, generator=g).to(torch.bfloat16).to(dev)
                   for _ in range(4))
    bias = torch.randn(16, 197, 197, generator=g).to(dev)
    check(cuda_bwd_kernel_path(q, k, v, bias) == "wgmma", "K2b at D = 32 is not on wgmma")
    fresh_thread_check(torch, "k2_fresh_thread_d32", lambda: (
        fused_attention_flat(q, k, v, bias, 32 ** -0.5),
        *fused_attention_flat_bwd(q, k, v, bias, do, 32 ** -0.5)))
    return first


def k2b_d32_fault(torch, dev, g):
    """The planted D = 32 fault: the kernels built again with
    -DMEM_ATTN_PLANT_FAULT (a library of its own hash), whose D = 32 rows
    kernel skips dq's last k16 step of every 64-key tile (a quarter of each
    dq sum), stand in for the library while K2b runs once through its
    wrapper. At the decoder's (8, 197, 16, 32) in bf16 the launch must take
    the wgmma path, be counted under K2b's name, and fail the gate K2b is
    held to; dk, dv and db (the columns kernel and the bias sum) are the
    clean library's bits. With the library back the launch is back to the
    clean bits."""
    from mem_tpu_torch.kernels import build, launch_counts
    from mem_tpu_torch.ops.attention import (cuda_bwd_kernel_path, fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference)

    B, N, H, D = 8, 197, 16, 32
    q, k, v, do = (torch.randn(B, N, H * D, generator=g).to(torch.bfloat16).to(dev)
                   for _ in range(4))
    bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
    clean_lib = build.library(dev)
    faulty_lib = build.bind(build.build(("-DMEM_ATTN_PLANT_FAULT",)))
    clean = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
    torch.cuda.synchronize()
    before = launch_counts().get("fused_attention_flat_bwd", 0)
    with build._lock:
        build._lib, build._thread.device = faulty_lib, None   # binds the device on first use
    try:
        faulty = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
        torch.cuda.synchronize()
    finally:
        with build._lock:
            build._lib, build._thread.device = clean_lib, None
    launched = launch_counts().get("fused_attention_flat_bwd", 0) - before
    again = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
    want = fused_attention_flat_bwd_reference(q, k, v, bias, do, D ** -0.5)
    torch.cuda.synchronize()
    errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), faulty, want)}
    path = cuda_bwd_kernel_path(q, k, v, bias)
    rest_same = all(torch.equal(a, b) for a, b in zip(faulty[1:], clean[1:]))
    back = all(torch.equal(a, b) for a, b in zip(again, clean))
    say("k2b_d32_fault", fault="dq_last_k16_step_skipped", shape=[B, N, H, D], kernel=path,
        launches=launched, rel_max_abs=errs, tol=K2B_BF16_TOL, dk_dv_db_clean=rest_same,
        clean_after=back)
    check(path == "wgmma" and launched == 1, f"the D = 32 fault ran on {path}, {launched} launches")
    check(errs["dq"] > K2B_BF16_TOL, f"the K2b gate does not see the D = 32 fault: {errs}")
    check(rest_same and back, "the D = 32 fault touched more than dq, or stayed on")


def stray_events(torch, g, B, N, H, W):
    """Packed (col, ys) int32 on the CPU, uniform over the canvas and a
    margin past it: negatives, the sentinels 2W / H and values past them;
    the first 500 columns of every sample are the invalid sentinel."""
    col = torch.randint(-2, 2 * W + 3, (B, N), generator=g, dtype=torch.int32)
    ys = torch.randint(-2, H + 3, (B, N), generator=g, dtype=torch.int32)
    col[:, :500] = 2 * W
    return col, ys


def check_hist_modes(torch, vh, tag, name, fn, col, ys, H, W, want):
    """One K1 / K4 case: the planes bit-equal to ``want``, the plain planes,
    and to themselves across two launches; the raster mode, mod 256 and
    clamped, bit-equal to voxelize_raster_reference. Returns the max abs
    error."""
    got, again = fn(col, ys, H, W), fn(col, ys, H, W)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if want.numel() else 0
    fields = dict(equals_plain=bool(torch.equal(got, want)),
                  identical_across_launches=bool(torch.equal(got, again)))
    for wrap in (True, False):
        r = fn(col, ys, H, W, raster=True, wrap_uint8=wrap)
        fields[f"raster_{'wrap' if wrap else 'clamp'}_equal"] = bool(torch.equal(
            r, vh.voxelize_raster_reference(col, ys, H, W, wrap)))
    say(tag, case=name, shape=[*col.shape, H, W], max_abs_err=err,
        events=int(want.sum().item()), max_count=int(want.max().item()) if want.numel() else 0,
        **fields)
    check(fields["equals_plain"] and fields["identical_across_launches"],
          f"{tag} {name}: the planes differ from the plain version or across launches")
    check(fields["raster_wrap_equal"] and fields["raster_clamp_equal"],
          f"{tag} {name}: the raster differs from voxelize_raster_reference")
    return err


def fresh_thread_check(torch, tag, launch):
    """``launch()`` from a fresh thread, on which PyTorch has made no CUDA
    context current yet: the library binds the device itself
    (build.library), and the results are the main thread's bits."""
    fresh = {}

    def run():
        try:
            fresh["out"] = launch()
            torch.cuda.synchronize()
        except Exception as e:   # reported below, on the main thread
            fresh["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=300)
    check(not t.is_alive(), f"{tag}: the fresh thread did not finish in 300 s")
    main = launch()
    torch.cuda.synchronize()
    same = "out" in fresh and all(torch.equal(a, b) for a, b in zip(fresh["out"], main))
    say(tag, error=fresh.get("error"), equals_main_thread=same)
    check(same, f"{tag}: {fresh.get('error', 'other bits')}")


def check_k1(torch, dev, g):
    """K1 against its plain version, bit for bit, in planes and raster mode:
    the N-Caltech101 canvas at B = 8 and 64, the (3, 12,345) case (N % 4 != 0: a sample starts off a 16-byte
    boundary), 440x640 with one cell past 65,535 events (32-bit counters)
    and an empty sample, extreme stray values; then from a fresh thread.
    Returns the max abs error."""
    from mem_tpu_torch.ops import voxelize_hist as vh

    err = 0
    for name, (B, N, H, W) in (("cls_b8", (8, 30_000, 256, 256)),
                               ("cls_b64", (64, 30_000, 256, 256)),
                               ("odd_n", (3, 12_345, 180, 240))):
        col, ys = stray_events(torch, g, B, N, H, W)
        if B == 64:
            col[5], ys[5] = 2 * W, H          # an empty sample
        col, ys = col.to(dev), ys.to(dev)
        err = max(err, check_hist_modes(
            torch, vh, "k1_check", name, vh.hist_planes_cols, col, ys, H, W,
            vh.hist_planes_cols_reference(col, ys, H, W)))
    # one hot cell: 70,000 events of sample 0 on (123, 456); sample 1 empty
    B, N, H, W = 3, 100_000, 440, 640
    col, ys = stray_events(torch, g, B, N, H, W)
    col[0, :70_000], ys[0, :70_000] = 456, 123
    col[1], ys[1] = 2 * W, H
    col, ys = col.to(dev), ys.to(dev)
    want = vh.hist_planes_cols_reference(col, ys, H, W)
    check(int(want[0, 123, 456]) > 65_535 and int(want[1].abs().sum()) == 0,
          "the hot-cell case lost its hot cell or its empty sample")
    err = max(err, check_hist_modes(torch, vh, "k1_check", "hot_cell_empty_sample",
                                    vh.hist_planes_cols, col, ys, H, W, want))
    # extremes: INT_MIN / INT_MAX, -1, the sentinels and one past them
    B, N, H, W = 4, 5_001, 180, 240
    pick = torch.randint(0, 8, (2, B, N), generator=g)
    vals = lambda hi, i: torch.tensor([-2**31, -1, hi, hi + 1, 2**31 - 1], dtype=torch.int32)[  # noqa: E731
        pick[i].clamp(max=4)]
    col = torch.where(pick[0] < 5, vals(2 * W, 0), torch.randint(0, 2 * W, (B, N), generator=g,
                                                                 dtype=torch.int32))
    ys = torch.where(pick[1] < 5, vals(H, 1), torch.randint(0, H, (B, N), generator=g,
                                                            dtype=torch.int32))
    col, ys = col.to(dev), ys.to(dev)
    err = max(err, check_hist_modes(torch, vh, "k1_check", "stray_extremes",
                                    vh.hist_planes_cols, col, ys, H, W,
                                    vh.hist_planes_cols_reference(col, ys, H, W)))
    col, ys = (t.to(dev) for t in stray_events(torch, g, 8, 30_000, 256, 256))
    fresh_thread_check(torch, "k1_fresh_thread", lambda: (
        vh.hist_planes_cols(col, ys, 256, 256),
        vh.hist_planes_cols(col, ys, 256, 256, raster=True)))
    return err


def sorted_events(torch, g, B, N, H, W, presort, n_valid=None):
    """Packed (col, ys) int32 on the CPU: rows clustered towards the top,
    an invalid tail per sample (2W / H sentinels), optionally sorted by row
    with the invalid events last."""
    ys = (torch.randint(0, H, (B, N), generator=g).float()
          * torch.rand(B, N, generator=g)).to(torch.int32)
    col = torch.randint(0, 2 * W, (B, N), generator=g, dtype=torch.int32)
    for b, nv in enumerate(n_valid or ()):
        ys[b, nv:] = H
        col[b, nv:] = 2 * W
    if presort:
        key = torch.sort(ys * 4096 + col, dim=1).values
        ys, col = key // 4096, key % 4096
    return col.contiguous(), ys.contiguous()


def check_k4(torch, dev, g):
    """K4 against its plain version and against K1, bit for bit: the DSEC
    shape presorted (one sample with no valid event, one with a single one)
    and unsorted, the same unsorted list passed as presorted (a broken
    promise costs time, never counts), a --voxel 6 canvas at 256^2 (1536
    bin-folded rows) and stray negative / past-the-sentinel values; the
    raster mode (mod 256 and clamped) against voxelize_raster_reference at
    the DSEC shape; the plan at the DSEC shape (one wave, one round); then
    from a fresh thread. Returns the max abs error at the DSEC shape."""
    from mem_tpu_torch.ops import voxelize_hist as vh

    first = None
    for name, (B, N, H, W), presort, nv in (
            ("dsec_presorted", (8, SEG_EVENTS, 440, 640), True,
             [SEG_EVENTS, 150_000, 3, 0, SEG_EVENTS, 90_000, SEG_EVENTS, 1]),
            ("dsec_unsorted", (8, SEG_EVENTS, 440, 640), False, None),
            ("voxel6_256", (8, 30_000, 1536, 256), False, None),
            ("one_sample", (1, SEG_EVENTS, 440, 640), True, None)):
        col, ys = (t.to(dev) for t in sorted_events(torch, g, B, N, H, W, presort, nv))
        got = vh.hist_planes_cols_sorted(col, ys, H, W, presorted=presort)
        torch.cuda.synchronize()
        want = vh.hist_planes_cols_sorted_reference(col, ys, H, W, presorted=presort)
        k1 = vh.hist_planes_cols(col, ys, H, W)
        err = int((got - want).abs().max().item())
        plan = vh.hist_plan(B, N, H, W, vh.sm_count(0), skip=presort)
        fields = dict(shape=[B, N, H, W], presorted=presort, equals_plain=torch.equal(got, want),
                      equals_k1=torch.equal(got, k1), max_abs_err=err,
                      events=int(want.sum().item()), plan=plan._asdict())
        if nv is not None:
            fields["empty_sample_sum"] = int(got[3].sum().item())
            check(fields["empty_sample_sum"] == 0, "K4: a sample with no event is not zeros")
        if name == "dsec_unsorted":
            fields["unsorted_as_presorted_equal"] = torch.equal(
                vh.hist_planes_cols_sorted(col, ys, H, W, presorted=True), want)
            check(fields["unsorted_as_presorted_equal"], "K4 differs on unsorted input "
                  "passed as presorted")
        say("k4_check", case=name, **fields)
        check(fields["equals_plain"] and fields["equals_k1"],
              f"K4 differs from its plain version or from K1 at {name}")
        if name.startswith("dsec"):
            check_hist_modes(torch, vh, "k4_check", name + "_modes",
                             lambda c, y, h, w, **kw: vh.hist_planes_cols_sorted(
                                 c, y, h, w, presorted=presort, **kw),
                             col, ys, H, W, want)
        if first is None:
            first = err
            sorted_dsec = col, ys
    col = torch.randint(-2, 2 * 640 + 3, (4, 50_000), generator=g, dtype=torch.int32).to(dev)
    ys = torch.randint(-2, 443, (4, 50_000), generator=g, dtype=torch.int32).to(dev)
    stray = all(torch.equal(vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=p),
                            vh.hist_planes_cols_reference(col, ys, 440, 640))
                for p in (False, True))
    say("k4_check", case="stray_values", equals_plain=stray)
    check(stray, "K4 differs from the plain version on negative / sentinel values")
    # the plan at the DSEC shape: at most one block (1024 threads, launch
    # bounds of one block an SM) on each of the card's SMs, one item each
    plan = vh.hist_plan(8, SEG_EVENTS, 440, 640, vh.sm_count(0), skip=True)
    say("k4_plan", shape=[8, SEG_EVENTS, 440, 640], blocks=plan.blocks, sms=plan.sms,
        threads=vh.THREADS, waves=plan.waves, rounds=plan.rounds, rows=plan.rows,
        smem=plan.smem)
    check(plan.waves == 1 and plan.rounds == 1 and plan.blocks <= plan.sms,
          f"K4's plan at the DSEC shape is not one wave: {plan}")
    col, ys = sorted_dsec
    fresh_thread_check(torch, "k4_fresh_thread", lambda: (
        vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=True),
        vh.hist_planes_cols_sorted(col, ys, 440, 640),
        vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=True, raster=True)))
    return first


def check_k3f(torch, dev, g):
    """K3f against its plain version: the seg backbone's shape in bf16 at B =
    8 and train_seg's 16 (the wgmma kernel), one key past a tile (65), an N
    that is no multiple of the 64-key tile (577), a short one, a bias that
    ramps along the keys (the running max grows at every tile, so the
    rescale runs), head dim 32 (the D = 32 instantiation, no model path at
    this N), f32 (the scalar kernel) and head dim 128. Every case
    launched twice: the outputs must be bit-identical. Returns the max abs
    error at the backbone's shape."""
    from mem_tpu_torch.ops.attention import (cuda_long_kernel_path, fused_attention_flat_long,
                                             fused_attention_flat_long_reference)

    first = None
    for (B, N, H, D), dt, ramp in (((8, 1025, 12, 64), torch.bfloat16, False),
                                   ((16, 1025, 12, 64), torch.bfloat16, False),
                                   ((2, 1025, 12, 64), torch.bfloat16, True),
                                   ((2, 577, 12, 64), torch.bfloat16, False),
                                   ((1, 65, 12, 64), torch.bfloat16, False),
                                   ((1, 40, 2, 64), torch.bfloat16, False),
                                   ((2, 300, 2, 128), torch.bfloat16, False),
                                   ((2, 300, 4, 32), torch.bfloat16, True),
                                   ((2, 1025, 12, 64), torch.float32, False),
                                   ((2, 577, 3, 32), torch.float32, False)):
        tol = K2_BF16_TOL if dt == torch.bfloat16 else K2_F32_TOL
        q, k, v = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(3))
        bias = 0.5 * torch.randn(H, N, N, generator=g)
        if ramp:   # 2 per 64-key tile
            bias += (2.0 / 64) * torch.arange(N, dtype=torch.float32)
        bias = bias.to(dev)
        got = fused_attention_flat_long(q, k, v, bias, D ** -0.5)
        again = fused_attention_flat_long(q, k, v, bias, D ** -0.5)
        torch.cuda.synchronize()
        want = fused_attention_flat_long_reference(q, k, v, bias, D ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        same = bool(torch.equal(got, again))
        path = cuda_long_kernel_path(q, k, v, bias)
        say("k3f_check", dtype=str(dt), shape=[B, N, H, D], ramped_bias=ramp, max_abs_err=err,
            tol=tol, identical_across_launches=same, kernel=path)
        check(err <= tol, f"K3f {dt} {B, N, H, D} max abs err {err} > {tol}")
        check(same, f"K3f {dt} {B, N, H, D}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, (B, N, H, D), dt) else "scalar"),
              f"K3f {dt} {B, N, H, D} took the {path} kernel")
        if first is None:
            first = err
        del q, k, v, bias, got, again, want
    torch.cuda.empty_cache()
    return first


def check_k3b(torch, dev, g):
    """K3b against its plain version: the seg backbone's sequence in bf16
    (the wgmma kernels) and f32 (the scalar kernels), sequences that
    are no multiple of the 64-wide tile (577, 300, 65), head dim 32 (the
    D = 32 instantiation) and 128 (the scalar kernels), the
    batches train_seg and the timed steps give it (16, 8) and B = 1 and 3;
    every output bit-identical across two launches; autograd through
    fused_attention_flat_long on the card reaches K3b. Returns K3b's max abs
    error at train_seg's shape, (16, 1025, 12, 64) in bf16."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops.attention import (cuda_long_bwd_kernel_path,
                                             fused_attention_flat_long,
                                             fused_attention_flat_long_bwd,
                                             fused_attention_flat_long_bwd_reference)

    first = None
    for (B, N, H, D), dt in (((16, 1025, 12, 64), torch.bfloat16),
                             ((8, 1025, 12, 64), torch.bfloat16),
                             ((3, 1025, 12, 64), torch.bfloat16),
                             ((1, 577, 12, 64), torch.bfloat16),
                             ((3, 300, 2, 64), torch.bfloat16),
                             ((1, 65, 3, 64), torch.bfloat16),
                             ((3, 300, 2, 128), torch.bfloat16),
                             ((1, 577, 3, 32), torch.bfloat16),
                             ((2, 300, 4, 32), torch.bfloat16),
                             ((1, 1025, 12, 64), torch.float32),
                             ((3, 300, 2, 32), torch.float32),
                             ((3, 65, 2, 128), torch.float32)):
        tol = K2B_BF16_TOL if dt == torch.bfloat16 else K2B_F32_TOL
        q, k, v, do = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(4))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        got = fused_attention_flat_long_bwd(q, k, v, bias, do, D ** -0.5)
        again = fused_attention_flat_long_bwd(q, k, v, bias, do, D ** -0.5)
        torch.cuda.synchronize()
        want = fused_attention_flat_long_bwd_reference(q, k, v, bias, do, D ** -0.5)
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        db = rel_l2(torch, got[3], want[3])
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        path = cuda_long_bwd_kernel_path(q, k, v, bias)
        say("k3b_check", dtype=str(dt), shape=[B, N, H, D], rel_max_abs=errs, tol=tol,
            db_rel_l2=db, db_tol=K2B_DB_REL, identical_across_launches=same, kernel=path)
        check(max(errs.values()) <= tol and db <= K2B_DB_REL,
              f"K3b {dt} {B, N, H, D}: {errs}, db {db}")
        check(same, f"K3b {dt} {B, N, H, D}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, (B, N, H, D), dt) else "scalar"),
              f"K3b {dt} {B, N, H, D} took the {path} kernels")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        del q, k, v, do, bias, got, again, want
    torch.cuda.empty_cache()

    q, k, v = (torch.randn(2, 1025, 768, generator=g).to(torch.bfloat16).to(dev)
               .requires_grad_() for _ in range(3))
    bias = torch.randn(12, 1025, 1025, generator=g).to(dev).requires_grad_()
    do = torch.randn(2, 1025, 768, generator=g).to(torch.bfloat16).to(dev)
    before = launch_counts().get("fused_attention_flat_long_bwd", 0)
    fused_attention_flat_long(q, k, v, bias, 0.125).backward(do)
    torch.cuda.synchronize()
    launched = launch_counts().get("fused_attention_flat_long_bwd", 0) - before
    want = fused_attention_flat_long_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                   bias.detach(), do, 0.125)
    errs = [rel_max_abs(t.grad, w) for t, w in zip((q, k, v), want)]
    say("k3b_autograd", launches=launched, rel_max_abs=errs,
        db_rel_l2=rel_l2(torch, bias.grad, want[3]))
    check(launched == 1,
          f"autograd through fused_attention_flat_long launched K3b {launched} times")
    check(max(errs) <= K2B_BF16_TOL, f"autograd grads differ from the plain backward: {errs}")
    torch.cuda.empty_cache()
    return first


def synthetic_dsec_events(rng, n):
    """A DSEC-like window as the dsec loader reads it: (n, 4) f32 rows
    [x, y, t, p], x < 640, y < 480 (rows at y >= 440 are cropped by the
    loader), p in {0, 1}, sorted t; 60 % of the events on three blobs (so
    that the raster is not uniform noise), the rest spread over the sensor."""
    ev = np.zeros((n, 4), np.float32)
    n_blob = int(0.2 * n)
    xs, ys = [rng.uniform(0, 640, n - 3 * n_blob)], [rng.uniform(0, 480, n - 3 * n_blob)]
    for _ in range(3):
        cx, cy, sd = rng.uniform(80, 560), rng.uniform(60, 400), rng.uniform(25, 60)
        xs.append(rng.normal(cx, sd, n_blob))
        ys.append(rng.normal(cy, 0.7 * sd, n_blob))
    perm = rng.permutation(n)
    ev[:, 0] = np.floor(np.clip(np.concatenate(xs), 0, 639))[perm]
    ev[:, 1] = np.floor(np.clip(np.concatenate(ys), 0, 479))[perm]
    ev[:, 2] = np.sort(rng.integers(0, 50_000, n))
    ev[:, 3] = rng.integers(0, 2, n)
    return ev


def write_seg_pairs(data_root, split, n, rng):
    """``n`` synthetic DSEC-like pairs under imgs/<split> and anns/<split>:
    190k-230k events and a 440x640 label PNG of 11 classes in 40-pixel blocks
    with an ignore band."""
    from PIL import Image

    for sub in ("imgs", "anns"):
        os.makedirs(os.path.join(data_root, sub, split, "seq0"))
    for i in range(n):
        ev = synthetic_dsec_events(rng, int(rng.integers(190_000, 230_001)))
        np.save(os.path.join(data_root, "imgs", split, "seq0", f"{i:06d}.npy"), ev)
        lab = np.repeat(np.repeat(rng.integers(0, 11, (11, 16)), 40, 0), 40, 1).astype(np.uint8)
        lab[:10] = 255
        Image.fromarray(lab).save(os.path.join(data_root, "anns", split, "seq0", f"{i:06d}.png"))


def write_seg_inputs(torch, root, rng):
    """A synthetic DSEC-like data_root (imgs/val + anns/val, SEG_PAIRS pairs)
    and a seeded full-width segmentor .pth."""
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.utils.checkpoint import save_checkpoint

    data_root = os.path.join(root, "dsec")
    write_seg_pairs(data_root, "val", SEG_PAIRS, rng)
    model = build_segmentor(11, 512, 768, 12, 12, torch.float32, torch.device("cpu"))
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(os.path.join(root, "seg_ckpt"), "final",
                           {"model": model.state_dict(), "epoch": 0})
    say("seg_inputs", pairs=SEG_PAIRS, model="EvBEiT ViT-B/16 + UPerNet", embed_dim=768,
        depth=12, heads=12, seg_input_size=512, tokens=1025, classes=11,
        params=sum(p.numel() for p in model.parameters()),
        checkpoint_mb=round(os.path.getsize(ckpt) / 2**20, 1))
    return data_root, ckpt


def run_seg_slice(torch, dev, gpu, rng):
    """The segmentation slice at full width: routing, card against CPU, the
    test_seg CLI (single-scale and --aug_test), the seg server over HTTP and
    the kernel timings. Returns the launch counts of
    test_seg's single-scale run and the K3f / K4 times."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli import test_seg as T
    from mem_tpu_torch.data.device_pipeline import events_f32
    from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                                 scan_seg_pairs, seg_preprocess_batch)
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.models.segmentation import build_segmentor, confusion_matrix, seg_metrics
    from mem_tpu_torch.ops import voxelize_hist as vh
    from mem_tpu_torch.ops.attention import (fused_attention_flat_long,
                                             fused_attention_flat_long_reference)
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    cpu = torch.device("cpu")
    tmp = tempfile.TemporaryDirectory()
    try:
        data_root, ckpt = write_seg_inputs(torch, tmp.name, rng)
        sd = load_checkpoint(ckpt)["model"]

        def segmentor(dtype, device):
            m = build_segmentor(11, 512, 768, 12, 12, dtype, device)
            m.load_state_dict(sd, strict=True)
            return m.eval()

        models = {"bfloat16": segmentor(torch.bfloat16, dev),
                  "float32": segmentor(torch.float32, dev)}
        # the first four exceed the cap after the y crop (a window is cut), the
        # last four stay under it: what a request's sample holds then does
        # not depend on its place in the batch
        payloads = [synthetic_dsec_events(rng, n).astype(np.float64)
                    for n in (230_000, 215_000, 225_000, 240_000) + (170_000,) * 4]
        assemble = serve.make_seg_assemble(SEG_EVENTS, True)
        tensors = lambda b, d: {n: torch.from_numpy(v).to(d) for n, v in b.items()}  # noqa: E731

        # -- routing: which kernels a seg forward launches ----------------------
        batch2 = assemble([(p, False) for p in payloads[:2]], 2)
        with torch.inference_mode():
            reset_launch_counts()
            images = seg_preprocess_batch(tensors(batch2, dev), False, y_sorted=True)[0]
            pre_counts = launch_counts()
            reset_launch_counts()
            feats = models["bfloat16"].backbone(images)
            torch.cuda.synchronize()
            bb_counts = launch_counts()
        say("seg_routing", preprocess=pre_counts, backbone=bb_counts,
            features=[list(f.shape) for f in feats], image_nonzero=int((images > 0).sum()))
        check(pre_counts == {"hist_planes_cols_sorted": 1},
              f"seg_preprocess_batch launched {pre_counts}, not K4 once")
        check(bb_counts == {"fused_attention_flat_long": 12},
              f"the EvBEiT forward launched {bb_counts}, not K3f 12 times")
        check(int((images > 0).sum()) > 50_000, "the synthetic raster is (nearly) empty")

        # -- card against CPU: B=2 on both sides ---------------------------------
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu_images = seg_preprocess_batch(tensors(batch2, cpu), False, y_sorted=True)[0]
            cpu_logits = segmentor(torch.float32, cpu)(cpu_images)[0]
        cpu_s = time.perf_counter() - t0
        frac = ((images.cpu() - cpu_images).abs() > 0).float().mean().item()
        rel, agree = {}, {}
        for name, model in models.items():
            with torch.inference_mode():
                logits = model(cpu_images.to(dev))[0].cpu()
            check(bool(torch.isfinite(logits).all()) and logits.shape == (2, 440, 640, 11),
                  f"card seg logits {tuple(logits.shape)} not finite")
            rel[name] = rel_l2(torch, logits, cpu_logits)
            agree[name] = (logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean().item()
        say("seg_logits_check", batch_card=2, batch_cpu=2, cpu_seconds=round(cpu_s, 1),
            rel_l2_f32=rel["float32"], bound_f32=SEG_F32_REL, rel_l2_bf16=rel["bfloat16"],
            bound_bf16=SEG_BF16_REL, argmax_agree=agree, images_frac_differing=frac,
            images_bound=SEG_IMAGES_FRAC, logits_abs_mean=cpu_logits.abs().mean().item(),
            classes_predicted=int(cpu_logits.argmax(-1).unique().numel()))
        check(frac <= SEG_IMAGES_FRAC, f"card seg images differ from the CPU's at {frac}")
        check(rel["float32"] <= SEG_F32_REL, f"seg f32 logits rel L2 {rel['float32']}")
        check(rel["bfloat16"] <= SEG_BF16_REL, f"seg bf16 logits rel L2 {rel['bfloat16']}")

        # -- FLAT_ATTN = False: the same forwards through K5b, head-major ---------
        rel_bhnd, bhnd_counts = {}, {}
        with toggles(flat_attn=False), torch.inference_mode():
            for name, model in models.items():
                reset_launch_counts()
                logits = model(cpu_images.to(dev))[0]
                torch.cuda.synchronize()
                bhnd_counts[name] = launch_counts()
                rel_bhnd[name] = rel_l2(torch, logits.cpu(), cpu_logits)
        say("seg_logits_check_flat_attn_off", batch_card=2, batch_cpu=2,
            toggles=dict(FLAT_ATTN=False), rel_l2_f32=rel_bhnd["float32"], bound_f32=SEG_F32_REL,
            rel_l2_bf16=rel_bhnd["bfloat16"], bound_bf16=SEG_BF16_REL, launches=bhnd_counts)
        check(all(c == {"fused_attention_long": 12} for c in bhnd_counts.values()),
              f"the EvBEiT forward with FLAT_ATTN = False launched {bhnd_counts}, not K5b x12")
        check(rel_bhnd["float32"] <= SEG_F32_REL,
              f"seg f32 logits with FLAT_ATTN = False: rel L2 {rel_bhnd['float32']}")
        check(rel_bhnd["bfloat16"] <= SEG_BF16_REL,
              f"seg bf16 logits with FLAT_ATTN = False: rel L2 {rel_bhnd['bfloat16']}")
        del cpu_logits, cpu_images, logits, feats, images
        models.pop("float32")
        torch.cuda.empty_cache()

        # -- the test_seg CLI: single-scale, then --aug_test ---------------------
        flags = ["--data_root", data_root, "--checkpoint", ckpt, "--device", "cuda"]
        save_dir = os.path.join(tmp.name, "preds")
        t0 = time.perf_counter()
        reset_launch_counts()                 # just before the main path
        stats = T.main(flags + ["--save_dir", save_dir])
        counts = launch_counts()              # just after it
        t1 = time.perf_counter()
        reset_launch_counts()
        stats_tta = T.main(flags + ["--aug_test", "1"])
        counts_tta = launch_counts()
        t2 = time.perf_counter()
        # the same pipeline called directly
        it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/val", "anns/val"),
                              SegPipelineConfig(batch_size=8, is_train=False,
                                                max_evs=SEG_EVENTS))
        cm, preds = np.zeros((11, 11)), []
        with torch.inference_mode():
            for b in it.eval_batches():
                b.pop("n_real")
                images, labels = seg_preprocess_batch(T.to_device(b, dev), False, y_sorted=True)
                pred = models["bfloat16"](images)[0].float().argmax(-1)
                cm += confusion_matrix(pred, labels, 11).cpu().numpy()
                preds.append(pred.cpu().numpy())
        direct = seg_metrics(cm)
        from PIL import Image

        saved = np.stack([np.asarray(Image.open(os.path.join(save_dir, f)))
                          for f in sorted(os.listdir(save_dir))])
        saved_agree = float((saved == np.concatenate(preds)).mean())
        say("test_seg_cli", pairs=SEG_PAIRS, batch=8, forwards=[2, 12],
            mIoU=[stats["mIoU"], stats_tta["mIoU"]], aAcc=[stats["aAcc"], stats_tta["aAcc"]],
            direct_mIoU=direct["mIoU"], saved_pngs=len(saved), saved_agree=saved_agree,
            launches=counts, launches_aug_test=counts_tta,
            seconds=[round(t1 - t0, 2), round(t2 - t1, 2)])
        check(counts == {"fused_attention_flat_long": 24, "hist_planes_cols_sorted": 2},
              f"test_seg (2 forwards) launched {counts}")
        check(counts_tta == {"fused_attention_flat_long": 144, "hist_planes_cols_sorted": 2},
              f"test_seg --aug_test (12 forwards) launched {counts_tta}")
        check(abs(stats["mIoU"] - direct["mIoU"]) <= SEG_MIOU_TOL,
              f"test_seg mIoU {stats['mIoU']} vs direct {direct['mIoU']}")
        check(saved.shape == (SEG_PAIRS, 440, 640) and saved.max() < 11
              and saved_agree >= SEG_PRED_AGREE, f"saved predictions agree on {saved_agree}")
        check(all(np.isfinite(s["mIoU"]) and 0 <= s["mIoU"] <= 1 for s in (stats, stats_tta)),
              "mIoU out of range")

        # -- serve --surface seg over HTTP ----------------------------------------
        args = serve.get_args(["--checkpoint", ckpt, "--surface", "seg", "--nb_classes", "11",
                               "--slice_max_evs", str(SEG_EVENTS), "--batch_size", "8",
                               "--max_wait_ms", "5", "--port", "0", "--device", "cuda"])
        with http_server(serve, args) as (post, read_stats, build_s):
            def ask(ev):
                code, ctype, png, ms = post(ev)
                return code, ctype, np.asarray(Image.open(io.BytesIO(png))), ms

            reset_launch_counts()
            seq = [ask(p) for p in payloads[:4]]
            with ThreadPoolExecutor(4) as pool:
                burst = list(pool.map(ask, payloads[4:]))
            serve_counts = launch_counts()
            stats_http = read_stats()
        agrees = []
        for (code, ctype, png, _), ev in zip(seq + burst, payloads):
            check(code == 200 and ctype == "image/png", f"HTTP {code} {ctype}")
            check(png.shape == (440, 640) and png.dtype == np.uint8 and png.max() < 11,
                  f"served label map {png.shape} {png.dtype} max {png.max()}")
            with torch.inference_mode():
                images = seg_preprocess_batch(tensors(assemble([(ev, False)], 8), dev), False,
                                              y_sorted=True)[0]
                want = models["bfloat16"](images)[0].float().argmax(-1)[0].cpu().numpy()
            agrees.append(float((png == want).mean()))
        lat = sorted(ms for *_, ms in seq + burst)
        say("serve_seg", gpu=gpu, requests=len(lat), build_server_s=round(build_s, 2),
            launches=serve_counts, stats=stats_http, agree_with_direct=agrees,
            sequential_p50_ms=statistics.median(ms for *_, ms in seq),
            burst4_p50_ms=statistics.median(ms for *_, ms in burst), p50_ms=statistics.median(lat),
            classes_served=int(len(np.unique(np.stack([r[2] for r in seq + burst])))))
        # a sequential request is dispatched alone: the batch is the payload
        # wrap-padded, the direct call's own input, so the labels are equal
        check(all(a == 1.0 for a in agrees[:4]), f"served labels != direct argmax: {agrees}")
        check(min(agrees) >= SEG_PRED_AGREE, f"served labels agree on {agrees}")
        check(serve_counts.get("fused_attention_flat_long", 0) == 12 * stats_http["batches"]
              and serve_counts.get("hist_planes_cols_sorted", 0) == stats_http["batches"]
              and set(serve_counts) == {"fused_attention_flat_long", "hist_planes_cols_sorted"},
              f"the seg server launched {serve_counts} over {stats_http['batches']} batches")

        # -- kernel timings (the forward's: tools/trace_infer.py mode=seg) ---------
        batch8 = tensors(assemble([(p, False) for p in payloads], 8), dev)

        # K4 against K1 and the plain version at the DSEC shape, on the batch's own events
        ev = batch8["events"]
        pos = (ev[..., 3] == 1).float()
        col, ys = vh.pack_cols(ev[..., 0].int(), ev[..., 1].int(), pos, 1.0 - pos, 440, 640)
        idx = torch.arange(SEG_EVENTS, device=dev)[None]
        pad = idx >= batch8["n_valid"][:, None]
        col = torch.where(pad, torch.full_like(col, 1280), col).contiguous()
        ys = torch.where(pad, torch.full_like(ys, 440), ys).contiguous()
        t_k4, t_k4p = in_turns(
            torch, lambda: vh.hist_planes_cols_sorted_reference(col, ys, 440, 640, True),
            lambda: vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=True))
        # unsorted events: K4 counts them as they come (no sort); the route
        # before it sorted them first
        t_k4u = time_ms(lambda: vh.hist_planes_cols_sorted(col, ys, 440, 640))
        t_k4s = time_ms(lambda: vh.hist_planes_cols_sorted(
            *vh.sort_events_by_row(col, ys, 440), 440, 640, presorted=True))
        t_k1 = time_ms(lambda: vh.hist_planes_cols(col, ys, 440, 640))
        t_k4l, k4l_equal = bincount_ms(
            torch, col, ys, 440, 640,
            vh.hist_planes_cols_sorted_reference(col, ys, 440, 640, True))
        # both kernels are short enough for the events above to time the
        # launch as much as the kernel: the profiler's device time beside
        # them, of every kernel a call launches (K4: the bounds pass and the
        # band kernel; neither fills its output)
        k4 = lambda: vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=True)  # noqa: E731
        k1 = lambda: vh.hist_planes_cols(col, ys, 440, 640)  # noqa: E731
        _, k4_kernels, k4_names = call_device_profile(k4)
        _, k1_kernels, k1_names = call_device_profile(k1)
        check(all("hist_band_kernel" in k or "chunk_bounds_kernel" in k
                  for k in k4_names + k1_names),
              f"K4 launched {k4_names}, K1 {k1_names}, not their kernels alone")
        k4_pair = ("hist_band_kernel", "chunk_bounds_kernel")
        d_k4, d_k4r = (body_device_ms(f, k4_pair, n=20) for f in (
            k4, lambda: vh.hist_planes_cols_sorted(col, ys, 440, 640, presorted=True, raster=True)))
        d_k4_band, d_k4u, d_k1 = (kernel_device_ms(f, ("hist_band_kernel",), per_launch=True)
                                  for f in (
            k4, lambda: vh.hist_planes_cols_sorted(col, ys, 440, 640), k1))
        say("time_k4", gpu=gpu, batch=8, events=SEG_EVENTS, canvas=[440, 640], kernel_ms=t_k4,
            kernel_device_ms=d_k4, band_kernel_device_ms=d_k4_band, kernels_a_call=k4_kernels,
            k1_kernels_a_call=k1_kernels,
            unsorted_ms=t_k4u, unsorted_device_ms=d_k4u, sort_then_presorted_ms=t_k4s,
            k1_same_shape_ms=t_k1, k1_same_shape_device_ms=d_k1, plain_ms=t_k4p,
            bincount_ms=t_k4l, bincount_equals_plain=k4l_equal,
            raster_device_ms=d_k4r,
            bound_ms=hist_bound(8, SEG_EVENTS, 440, 640)[0],
            raster_bound_ms=raster_bound(8, SEG_EVENTS, 440, 640)[0],
            kernel_gev_s=8 * SEG_EVENTS / t_k4 / 1e6)
        time_raster(torch, gpu, "seg B=8", events_f32(batch8), batch8["n_valid"], 440, 640,
                    y_sorted=True)

        # K3f at the seg forward's B = 8 and train_seg's B = 16
        k3f = {}
        for B in (8, 16):
            q, k, v = (torch.randn(B, 1025, 768, device=dev, dtype=torch.bfloat16)
                       for _ in range(3))
            bias = torch.randn(12, 1025, 1025, device=dev)
            t_k, t_p = in_turns(
                torch, lambda: fused_attention_flat_long_reference(q, k, v, bias, 0.125),
                lambda: fused_attention_flat_long(q, k, v, bias, 0.125), runs=10)
            qh, kh, vhd, mask = sdpa_operands(torch, q, k, v, bias)
            t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vhd, attn_mask=mask, scale=0.125))
            # the events above include the wrapper's host time before each
            # launch; the profiler's device time of the kernel alone beside it
            d_k = kernel_device_ms(lambda: fused_attention_flat_long(q, k, v, bias, 0.125),
                                   ("attention_long_fwd",), per_launch=True)
            bnd = attention_fwd_bound(B, 1025, 12, 64)
            say("time_k3f", gpu=gpu, batch=B, shape=[1025, 12, 64], dtype="bfloat16",
                kernel_ms=t_k, kernel_device_ms=d_k, plain_ms=t_p, sdpa_ms=t_l,
                bound_ms=bnd[0], bound_by=bnd[1],
                kernel_tflop_s=4 * B * 12 * 1025 * 1025 * 64 / t_k / 1e9)
            k3f[B] = (t_k, t_p, t_l)
            del q, k, v, bias, qh, kh, vhd, mask
        t_k3, t_k3p, t_k3l = k3f[8]
    finally:
        tmp.cleanup()
    return dict(counts=counts, k3f_ms=t_k3, k3f_plain_ms=t_k3p, k3f_sdpa_ms=t_k3l,
                k4_ms=t_k4, k4_plain_ms=t_k4p, k4_bincount_ms=t_k4l)


def seg_host_batch(data_root, B, batch_ops=True):
    """The first training batch of the synthetic train split at batch size
    B, with its RandAugment draws, as numpy."""
    from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                                 draw_seg_train_aug, scan_seg_pairs)

    it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/train", "anns/train"),
                          SegPipelineConfig(batch_size=B, is_train=True, max_evs=SEG_EVENTS))
    batch = next(iter(it.batches()))
    batch.update(draw_seg_train_aug(batch["aug_seed"], batch_ops))
    return batch


def make_seg_step(torch, sd, device, dtype, lr_fn, drop=0.1, depth=12, chain=False):
    """A full-width segmentor on ``device`` from the state_dict ``sd`` (its
    first ``depth`` blocks, the last four tapped) and its train step (the
    CLI's optimizer: layer decay 0.65, betas 0.9 / 0.999), or its chain."""
    from mem_tpu_torch.cli.train_seg import SEG_BETAS
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_seg_steps

    model = build_segmentor(11, 512, 768, depth, 12, dtype, device, drop_path_rate=drop,
                            dropout_ratio=drop)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not (k.startswith("backbone.blocks.")
                                   and int(k.split(".")[2]) >= depth)}, strict=True)
    opt = create_optimizer(model, 5e-4, 0.05, layer_decay=0.65, num_layers=depth,
                           betas=SEG_BETAS)
    step, _ = make_seg_steps(model, opt, lr_fn, 0.05, 11, True, True, y_sorted=True,
                             chain=chain)
    return model, step


def check_seg_train_step(torch, dev, data_root, sd):
    """One make_seg_steps train step of the full-width segmentor (its first
    SEG_STEP_DEPTH blocks, B=2, drop-path and dropout 0: the CPU's and the card's generators draw
    other bits) on one host batch and its draws: the train images (resize
    jitter, RandAugment, flips) card vs CPU, then the step on the card in f32
    (TF32 off) and bf16 against the CPU in f32 from the same weights.

    As the recipe has the model: loss, updated BatchNorm buffers and launch
    counts. Its gradients are not compared: at B=2 the pool-scale-1 branch of
    the PSP module normalises 2 values per channel, and where the two windows'
    pooled features nearly agree (var << eps = 1e-5) the channel is a gain of
    up to rsqrt(eps) = 316 on the f32 rounding of its fast variance, which
    every gradient below the decode head inherits (PERF.md has the readings).
    The gradients are compared on the same step with the four PSP BatchNorms'
    eps at SEG_DAMPED_EPS on both devices, which bounds that gain by 3.2, and
    held to SEG_STEP_F32_GRAD_REL, and that step's BatchNorm buffers to
    SEG_STEP_BN_DAMPED_REL (the undamped buffers' psp_bottleneck mean carries
    the same gain). That the gate can see a wrong K3b is shown
    in the same run: the damped card step is repeated with a fault planted in
    K3b's operands (the last key masked out; the last query row's do zeroed:
    what a mishandled tail tile at N = 1025 would give) and must fail it.
    Every card step is repeated with FLAT_ATTN_LONG = False (K5b forward, K5e
    backward) against the same CPU steps, faults included, under the same
    gates and with exact launch counts."""
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import attention as A

    cpu = torch.device("cpu")
    host = seg_host_batch(data_root, 2)
    images = {}
    for d in (cpu, dev):
        img, lab = seg_preprocess_batch(to_device(host, d), True, True, True, y_sorted=True)
        images[d.type] = (img.cpu(), lab.cpu())
    diff = (images["cuda"][0] - images["cpu"][0]).abs()
    frac = (diff > 0).float().mean().item()
    labels_equal = bool(torch.equal(images["cuda"][1], images["cpu"][1]))
    say("seg_train_images_check", shape=list(diff.shape), max_abs=diff.max().item(),
        frac_differing=frac, tol=SEG_TRAIN_IMG_TOL, frac_tol=SEG_TRAIN_IMG_FRAC,
        labels_equal=labels_equal, resize_jitter=host["resize_jitter"].tolist(),
        flips=host["flip"].tolist(), ra_batch_ops=host["ra_batch_ops"].tolist())
    check(frac <= SEG_TRAIN_IMG_FRAC, f"card seg train images differ from the CPU's at {frac}")
    check(labels_equal, "card seg train labels differ from the CPU's")

    real = {True: A.fused_attention_flat_long_bwd, False: A.fused_attention_bwd}

    def faulty(fault, flat):
        """K3b (flat) or K5e (head-major) with a planted fault."""
        def bwd(q, k, v, bias, do, scale):
            if fault == "last_key_dropped":
                bias = bias.clone()
                bias[:, :, -1] = float("-inf")
            else:
                do = do.clone()
                do.select(1 if flat else 2, -1).zero_()   # the last query row
            return real[flat](q, k, v, bias, do, scale)
        return bwd

    def install(fault, flat):
        A.fused_attention_flat_long_bwd = faulty(fault, True) if fault and flat else real[True]
        A.fused_attention_bwd = faulty(fault, False) if fault and not flat else real[False]

    lr_fn = lambda it: 5e-4  # noqa: E731
    out, counts = {}, {}
    rows = [("cpu_f32", cpu, torch.float32, None, None),
            ("card_f32", dev, torch.float32, None, None),
            ("card_bf16", dev, torch.bfloat16, None, None),
            ("cpu_f32_damped", cpu, torch.float32, SEG_DAMPED_EPS, None),
            ("card_f32_damped", dev, torch.float32, SEG_DAMPED_EPS, None),
            ("last_key_dropped", dev, torch.float32, SEG_DAMPED_EPS, "last_key_dropped"),
            ("last_row_dropped", dev, torch.float32, SEG_DAMPED_EPS, "last_row_dropped")]
    # the same card steps with FLAT_ATTN_LONG = False (K5b / K5e), against the
    # same CPU steps: the plain versions of K3 and K5 are one function
    rows += [(n + "_long_off", d, dt, eps, fault) for n, d, dt, eps, fault in rows
             if d.type == "cuda"]
    for name, d, dt, eps, fault in rows:
        flat = not name.endswith("_long_off")
        with toggles(flat_attn_long=flat):
            model, step = make_seg_step(torch, sd, d, dt, lr_fn, drop=0.0,
                                        depth=SEG_STEP_DEPTH)
            if eps is not None:
                for si in range(len(model.decode_head.pool_scales)):
                    getattr(model.decode_head, f"psp_{si}").bn.eps = eps
            t0 = time.perf_counter()
            reset_launch_counts()
            try:
                install(fault, flat)
                m = step(to_device(host, d), 0)
            finally:
                install(None, flat)
        metrics = {k: v.item() for k, v in m.items()}
        counts[name] = launch_counts()
        out[name] = (metrics,
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()},
                     {n: b.detach().float().cpu() for n, b in model.named_buffers()
                      if "running_" in n}, round(time.perf_counter() - t0, 1))
        del model, step
        torch.cuda.empty_cache()

    def gradients(card, ref="cpu_f32_damped"):
        """Per-parameter relative L2 card vs CPU; the parameters whose CPU
        gradient is below the floor are held to the floor instead."""
        ref_g, got_g = out[ref][1], out[card][1]
        floor = SEG_GRAD_FLOOR * out[ref][0]["grad_norm"]
        noise = sorted(n for n, g in ref_g.items() if torch.linalg.norm(g).item() < floor)
        rel = {n: rel_l2(torch, g, ref_g[n]) for n, g in got_g.items() if n not in noise}
        noise_max = max([torch.linalg.norm(got_g[n]).item() for n in noise] + [0.0])
        worst5 = [(n, rel[n], torch.linalg.norm(ref_g[n]).item())
                  for n in sorted(rel, key=rel.get, reverse=True)[:5]]
        return dict(rel_l2_max=worst5[0][1], rel_l2_median=statistics.median(rel.values()),
                    worst5=worst5, compared=len(rel), below_floor=noise, floor=floor,
                    below_floor_card_norm_max=noise_max)

    ref_m, _, ref_b, _ = out["cpu_f32"]
    loss_rel = {n + t: abs(out[n + t][0]["loss"] - out[r][0]["loss"]) / abs(out[r][0]["loss"])
                for n, r in (("card_f32", "cpu_f32"), ("card_bf16", "cpu_f32"),
                             ("card_f32_damped", "cpu_f32_damped")) for t in ("", "_long_off")}
    grads = {t: gradients("card_f32_damped" + t) for t in ("", "_long_off")}
    faults = {n + t: gradients(n + t) for n in ("last_key_dropped", "last_row_dropped")
              for t in ("", "_long_off")}
    bn_rel = {(n, t): rel_l2(torch, b, ref_b[n]) for t in ("", "_long_off")
              for n, b in out["card_f32" + t][2].items()}
    worst_bn = max(bn_rel, key=bn_rel.get)
    # the same buffers with the PSP BatchNorms damped, where the pool-scale-1
    # branch's gain on f32 rounding is at most 3.2
    bn_damped = {(n, t): rel_l2(torch, b, out["cpu_f32_damped"][2][n]) for t in ("", "_long_off")
                 for n, b in out["card_f32_damped" + t][2].items()}
    worst_damped = max(bn_damped, key=bn_damped.get)
    say("seg_train_step_check", model="EvBEiT ViT-B/16 + UPerNet + FCN", embed_dim=768,
        depth=SEG_STEP_DEPTH, heads=12, tokens=1025, batch=2,
        metrics={n: v[0] for n, v in out.items()}, seconds={n: v[3] for n, v in out.items()},
        loss_rel=loss_rel, gradients_damped=grads, damped_eps=SEG_DAMPED_EPS,
        planted_faults={n: dict(rel_l2_max=f["rel_l2_max"], rel_l2_median=f["rel_l2_median"],
                                worst=f["worst5"][0][0]) for n, f in faults.items()},
        bn_buffers=len(bn_rel), bn_rel_l2_max=bn_rel[worst_bn], bn_worst=worst_bn,
        bn_damped_rel_l2_max=bn_damped[worst_damped], bn_damped_worst=worst_damped,
        launches=counts,
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad_damped=SEG_STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL, bn=SEG_STEP_BN_REL,
                    bn_damped=SEG_STEP_BN_DAMPED_REL))
    check(all(np.isfinite(v) for v in ref_m.values()), "CPU seg step metrics not finite")
    for name, c in counts.items():
        want = {} if name.startswith("cpu") else {
            "hist_planes_cols_sorted": 1, "fused_attention_long": SEG_STEP_DEPTH,
            "fused_attention_bwd_long": SEG_STEP_DEPTH} if name.endswith("_long_off") else {
            "hist_planes_cols_sorted": 1, "fused_attention_flat_long": SEG_STEP_DEPTH,
            "fused_attention_flat_long_bwd": SEG_STEP_DEPTH}
        check(c == want, f"the {name} seg step launched {c}")
    for t in ("", "_long_off"):
        check(loss_rel["card_f32" + t] <= STEP_F32_LOSS_REL
              and loss_rel["card_f32_damped" + t] <= STEP_F32_LOSS_REL,
              f"f32 seg step loss rel {loss_rel}")
        check(grads[t]["rel_l2_max"] <= SEG_STEP_F32_GRAD_REL,
              f"f32 grad{t} with the PSP BatchNorms damped: {grads[t]['worst5'][0]}")
        check(grads[t]["below_floor_card_norm_max"] <= 10 * grads[t]["floor"]
              and len(grads[t]["below_floor"]) <= 8,
              f"gradients below the floor on the CPU: {grads[t]['below_floor']}, on the card "
              f"up to {grads[t]['below_floor_card_norm_max']}")
        check(loss_rel["card_bf16" + t] <= STEP_BF16_LOSS_REL,
              f"bf16 seg step loss rel {loss_rel}")
    for n, f in faults.items():
        check(f["rel_l2_max"] > SEG_STEP_F32_GRAD_REL,
              f"the gradient gate does not see the backward with {n}: worst {f['worst5'][0]}")
    check(bn_rel[worst_bn] <= SEG_STEP_BN_REL, f"BN buffer {worst_bn} rel L2 {bn_rel[worst_bn]}")
    check(bn_damped[worst_damped] <= SEG_STEP_BN_DAMPED_REL,
          f"damped BN buffer {worst_damped} rel L2 {bn_damped[worst_damped]}")


def run_train_seg_cli(torch, data_root, pretrained, out_dir):
    """train_seg at full width on the card (B=16, bf16, every default of the
    recipe but the iteration counts): 4 iterations with an evaluation and a
    checkpoint every 2, then a second call that auto-resumes at iteration 4
    and runs 2 more, then test_seg on the final checkpoint. Returns the launch
    counts of the first run."""
    from mem_tpu_torch.cli import test_seg as T
    from mem_tpu_torch.cli import train_seg as S
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    common = ["--data_root", data_root, "--pretrained", pretrained, "--output_dir", out_dir,
              "--eval_interval", "2", "--save_interval", "2", "--device", "cuda"]
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    hist = S.main(common + ["--max_iters", "4"])
    counts = launch_counts()              # just after it
    t1 = time.perf_counter()
    written = sorted(os.listdir(out_dir))
    reset_launch_counts()
    resumed = S.main(common + ["--max_iters", "6"])
    counts_resumed = launch_counts()
    t2 = time.perf_counter()
    final = os.path.join(out_dir, "checkpoint-final.pth")
    payload = load_checkpoint(final)
    reset_launch_counts()
    stats = T.main(["--data_root", data_root, "--checkpoint", final, "--device", "cuda"])
    counts_test = launch_counts()
    say("train_seg_cli", model="EvBEiT ViT-B/16 + UPerNet + FCN", embed_dim=768, depth=12,
        heads=12, seg_input_size=512, tokens=1025, batch=16, dtype="bfloat16",
        train_steps=4, eval_forwards=3, history=hist, checkpoints=written, launches=counts,
        resumed_history=resumed, launches_resumed=counts_resumed,
        final_epoch=int(payload["epoch"]), final_has_optimizer="optimizer" in payload,
        test_seg_mIoU=stats["mIoU"], launches_test_seg=counts_test,
        seconds=[round(t1 - t0, 2), round(t2 - t1, 2), round(time.perf_counter() - t2, 2)])
    # 4 train steps; evaluations after iterations 1 and 3 and the final one,
    # one batch of 16 each
    check(counts == {"fused_attention_flat_long_bwd": 48, "fused_attention_flat_long": 84,
                     "hist_planes_cols_sorted": 7}, f"train_seg launched {counts}")
    check(counts_resumed == {"fused_attention_flat_long_bwd": 24,
                             "fused_attention_flat_long": 48, "hist_planes_cols_sorted": 4},
          f"the resumed train_seg launched {counts_resumed}")
    check([h[0] for h in hist] == [0] and [h[0] for h in resumed] == [4],
          f"train_seg read back iterations {hist} and, resumed, {resumed}")
    check(all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in hist + resumed),
          f"train_seg losses {hist} {resumed}")
    check({"checkpoint-1.pth", "checkpoint-3.pth", "checkpoint-final.pth"} <= set(written),
          f"checkpoints {written}")
    check(os.path.exists(os.path.join(out_dir, "checkpoint-5.pth")), "no checkpoint-5.pth")
    check(int(payload["epoch"]) == 6 and "optimizer" not in payload,
          "checkpoint-final.pth is not the 6-iteration run's, without its optimizer")
    check(np.isfinite(stats["mIoU"]) and 0 <= stats["mIoU"] <= 1
          and counts_test == {"fused_attention_flat_long": 24, "hist_planes_cols_sorted": 2},
          f"test_seg on the trained checkpoint: mIoU {stats['mIoU']}, launches {counts_test}")
    return counts


def time_seg_training(torch, dev, gpu):
    """K3b beside its plain version (in turns), its bound and the backward of
    one SDPA call, at B=16 (train_seg's default) and B=8. Returns K3b's, its
    plain version's and the SDPA backward's ms at B=16."""
    from mem_tpu_torch.ops.attention import (fused_attention_flat_long_bwd,
                                             fused_attention_flat_long_bwd_reference)

    k3b = {}
    for B in (8, 16):
        q, k, v, do = (torch.randn(B, 1025, 768, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        bias = torch.randn(12, 1025, 1025, device=dev)
        t_k, t_p = in_turns(
            torch, lambda: fused_attention_flat_long_bwd_reference(q, k, v, bias, do, 0.125),
            lambda: fused_attention_flat_long_bwd(q, k, v, bias, do, 0.125), runs=8)
        parts = {f: kernel_device_ms(
            lambda: fused_attention_flat_long_bwd(q, k, v, bias, do, 0.125), (f,), n=5,
            per_launch=True)
            for f in ("rows_wgmma", "cols_wgmma", "bias_sum")}
        # the yardstick: the backward of one scaled_dot_product_attention call
        # with the bias as its mask (dq, dk, dv and the mask's gradient)
        qh, kh, vhd, mask = (t.requires_grad_() for t in sdpa_operands(torch, q, k, v, bias))
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vhd, attn_mask=mask,
                                                               scale=0.125)
        doh = torch.randn_like(out)
        t_lib = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vhd, mask), doh,
                                                    retain_graph=True), runs=10)
        bnd = attention_bwd_bound(B, 1025, 12, 64)
        say("time_k3b", gpu=gpu, batch=B, shape=[1025, 12, 64], dtype="bfloat16", kernel_ms=t_k,
            plain_ms=t_p, sdpa_backward_ms=t_lib, bound_ms=bnd[0], bound_by=bnd[1],
            kernel_device_ms_by_part=parts,
            kernel_device_ms=sum(parts.values()) if None not in parts.values() else None,
            workspace_mb=round(B * 12 * 1025 * 1025 * 4 / 1e6, 1),
            kernel_tflop_s=10 * B * 12 * 1025 * 1025 * 64 / t_k / 1e9)
        k3b[B] = (t_k, t_p, t_lib)
        del q, k, v, do, bias, qh, kh, vhd, mask, out, doh
        torch.cuda.empty_cache()
    return k3b[16]


def repeated_batch_losses(step, batch, steps):
    """The losses of ``steps`` calls of ``step`` on one repeated batch."""
    metrics = [step(batch, i) for i in range(steps)]
    return [m["loss"].item() for m in metrics]


def check_seg_loss_fall(torch, dev, data_root, sd):
    """The full-width seg train step (depth 12, bf16, drop-path and dropout
    0.1) at B=8, under the default toggles and with FLAT_ATTN_LONG = False:
    15 steps on one repeated batch at the recipe's peak lr; the loss must
    fall by SEG_LOSS_FALL (the train step's timing and profile are
    tools/trace_seg.py's)."""
    from mem_tpu_torch.data.prefetch import to_device

    batch = to_device(seg_host_batch(data_root, 8), dev)
    for tag, long_on in (("default", True), ("flat_attn_long_off", False)):
        with toggles(flat_attn_long=long_on):
            model, step = make_seg_step(torch, sd, dev, torch.bfloat16, lambda it: 5e-4)
            losses = repeated_batch_losses(step, batch, 15)
        say("seg_loss_fall", batch=8, toggles=tag, steps=15, losses=losses,
            min_fall=SEG_LOSS_FALL)
        check(all(np.isfinite(losses)), f"seg B=8 {tag}: non-finite losses {losses}")
        check(losses[-1] <= losses[0] - SEG_LOSS_FALL,
              f"the seg loss ({tag}) fell from {losses[0]} to {losses[-1]}, less than "
              f"{SEG_LOSS_FALL}")
        del model, step
        torch.cuda.empty_cache()


def run_seg_train_slice(torch, dev, gpu, rng):
    """The segmentation training slice at full width: one train step card
    against CPU (also with FLAT_ATTN_LONG = False), the train_seg CLI with a
    resume and test_seg on its checkpoint, the same with FLAT_ATTN_LONG =
    False, the loss-fall gate and K3b's timings. Returns
    train_seg's launch counts under both toggles and K3b's times at B=16."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.models.segmentation import build_segmentor

    tmp = tempfile.TemporaryDirectory()
    try:
        data_root = os.path.join(tmp.name, "dsec")
        write_seg_pairs(data_root, "train", SEG_TRAIN_PAIRS, rng)
        write_seg_pairs(data_root, "val", SEG_PAIRS, rng)
        # a pretraining-schema checkpoint (pt_vit at 224^2: one shared 14x14
        # rel-pos table, mask_token, lm_head), weights drawn from a seed
        pt = R.build_model(R.get_args(["--config", "configs/ncaltech.conf"]), torch.float32,
                           torch.device("cpu"))
        pt.init_weights(torch.Generator().manual_seed(1))
        pretrained = os.path.join(tmp.name, "pt_vit_b16_seed1.pth")
        torch.save({"model": pt.state_dict(), "epoch": 0}, pretrained)
        seg = build_segmentor(11, 512, 768, 12, 12, torch.float32, torch.device("cpu"))
        seg.init_weights(torch.Generator().manual_seed(0))
        sd = seg.state_dict()
        say("seg_train_inputs", train_pairs=SEG_TRAIN_PAIRS, val_pairs=SEG_PAIRS,
            pretrained_keys=len(pt.state_dict()),
            pretrained_mb=round(os.path.getsize(pretrained) / 2**20, 1))
        del pt, seg
        check_seg_train_step(torch, dev, data_root, sd)
        counts = run_train_seg_cli(torch, data_root, pretrained,
                                   os.path.join(tmp.name, "seg_out"))
        counts_long_off = run_train_seg_cli_long_off(torch, data_root, pretrained,
                                                     os.path.join(tmp.name, "seg_out_long_off"))
        check_seg_loss_fall(torch, dev, data_root, sd)
        t_k3b, t_k3bp, t_k3bl = time_seg_training(torch, dev, gpu)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLI latched SIGTERM
        tmp.cleanup()
    return dict(counts=counts, counts_long_off=counts_long_off, k3b_ms=t_k3b,
                k3b_plain_ms=t_k3bp, k3b_sdpa_ms=t_k3bl)


def write_training_inputs(torch, root, rng):
    """A synthetic N-Caltech-like dataset (ncaltech101/{train,val}/<cls>/*.npy,
    20k-60k events each) and a seeded VAE tokenizer .pth at the conf's size."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    data_root = os.path.join(root, "ncaltech101")
    for split, n in (("train", N_TRAIN_FILES), ("val", N_VAL_FILES)):
        for i in range(n):
            d = os.path.join(data_root, split, f"class_{i % 8}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"image_{i:04d}.npy"),
                    synthetic_events(rng, int(rng.integers(20_000, 60_001))))
    hp = dict(input_H=224, input_W=224, num_tokens=8192, emb_dim=32, num_layers=4,
              num_resnet_blocks=3, hidden_dim=384, channels=3, loss="mse")
    vae = DiscreteVAE((224, 224), num_tokens=8192, codebook_dim=32, num_layers=4,
                      num_resnet_blocks=3, hidden_dim=384)
    vae.init_weights(torch.Generator().manual_seed(0))
    vae_path = os.path.join(root, "vae_seed0.pth")
    torch.save({"model": vae.state_dict(), "hparams": hp}, vae_path)
    say("training_inputs", train_files=N_TRAIN_FILES, val_files=N_VAL_FILES,
        vae=hp, vae_mb=round(os.path.getsize(vae_path) / 2**20, 1))
    return data_root, vae_path


def host_train_batch(args, B, index=0):
    """Training batch ``index`` of epoch 0 of the synthetic set at batch
    size B, with its augmentation draws (and, but under --MAE 1, its
    masks), as numpy."""
    from mem_tpu_torch.cli.common import build_pipeline, build_preproc
    from mem_tpu_torch.data.device_pipeline import draw_train_aug

    pp = build_preproc(args, True, color_jitter=args.color_jitter)
    patch = 2 ** args.num_layers
    _, it = build_pipeline(args, "train", True, B, masking=None if args.MAE else args.masking,
                           window_size=(args.input_H // patch, args.input_W // patch),
                           seed=args.seed, num_workers=args.num_workers)
    batch = next(itertools.islice(it.epoch(0), index, None))
    batch.update(draw_train_aug(batch["aug_seed"], pp, pp.canvas_h, pp.canvas_w))
    return pp, batch


class _FixedTokens:
    """A tokenizer stand-in that hands every step the same codes."""

    def __init__(self, ids):
        self.ids = ids

    def get_codebook_indices(self, images):
        return self.ids.to(images.device)


def make_step(torch, R, args, device, dtype, vae, pp, lr_sched, moment_dtype=None,
              chain=False):
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_pretrain_train_step

    model = R.build_model(args, dtype, device)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    opt = create_optimizer(model, args.lr, args.weight_decay, moment_dtype=moment_dtype)
    wd = np.full(len(lr_sched), args.weight_decay)
    step = make_pretrain_train_step(model, vae, opt, pp, lr_sched, wd, args.clip_grad,
                                    args.seed, chain=chain)
    return model, step, opt


def check_train_step(torch, dev, flags):
    """Phase 6: one make_pretrain_train_step of pt_vit at full width and depth
    2, B=8, drop_path 0, on one host batch and its draws: the preprocessed
    images (RandAugment and ColorJitter on) and the VAE tokens card vs CPU,
    then the step on the card in f32 (TF32 off) and bf16 against the CPU in
    f32 from the same seeded weights: the loss, and every parameter's
    gradient by relative L2 (bf16 to a looser bound). Each card step records
    the kernel path of every K2b launch: the scalar kernel in f32, K3b's
    Hopper kernels in bf16. The card's steps take the CPU's images and
    tokens (one input for both sides of each gate; the images and tokens are
    held card vs CPU first). That each gradient gate can see a wrong K2b is
    shown in the same run: the f32 and the bf16 card steps are repeated with
    a fault planted in K2b's operands (the last key masked out of its
    scores), and each must fail its gate. On the next batch of the epoch the
    f32 step is taken again on the card's own inputs (reported) and on the
    CPU's (gated): suspect S1."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.ops import attention as A

    cpu = torch.device("cpu")
    args = R.get_args(flags + ["--transformer_depth", "2", "--drop_path", "0",
                               "--batch_size", "8", "--dtype", "float32"])
    pp, host = host_train_batch(args, 8)
    images = {}
    for d in (cpu, dev):
        images[d.type] = preprocess_batch(to_device(host, d), pp, is_train=True).cpu()
    diff = (images["cuda"] - images["cpu"]).abs()
    vae_cpu, vae_card = R.load_vae(args, cpu), R.load_vae(args, dev)
    with torch.no_grad():
        tok_cpu = vae_cpu.get_codebook_indices(images["cpu"])
        tok_card = vae_card.get_codebook_indices(images["cpu"].to(dev)).cpu()
    agree = (tok_cpu == tok_card).float().mean().item()
    say("train_images_check", shape=list(images["cpu"].shape), max_abs=diff.max().item(),
        frac_differing=(diff > 1e-6).float().mean().item(), tol=TRAIN_IMG_TOL,
        frac_tol=TRAIN_IMG_FRAC, rand_aug_batch_ops=pp.rand_aug_batch_ops,
        color_jitter=pp.color_jitter)
    say("vae_tokens_check", tokens=tok_cpu.numel(), agree=agree, bound=VAE_TOKENS_AGREE,
        distinct=int(tok_cpu.unique().numel()), min_distinct=VAE_MIN_DISTINCT)
    check(diff.max().item() <= TRAIN_IMG_TOL and
          (diff > 1e-6).float().mean().item() <= TRAIN_IMG_FRAC,
          "card train images differ from the CPU's")
    check(agree >= VAE_TOKENS_AGREE, f"VAE tokens agree on {agree} < {VAE_TOKENS_AGREE}")
    check(tok_cpu.unique().numel() >= VAE_MIN_DISTINCT,
          f"the seeded VAE gave {tok_cpu.unique().numel()} distinct tokens")

    # the card's steps take the CPU's images and tokens: one input for both
    # sides of the gate (suspect S1: a few changed pixels or labels move the
    # gradients by more than the gate)
    lr = np.array([args.lr])
    out, paths = {}, {}
    real = A.fused_attention_flat_bwd
    fixed = _FixedTokens(tok_cpu)
    for name, d, dt, vae, fault in (("cpu_f32", cpu, torch.float32, vae_cpu, False),
                                    ("card_f32", dev, torch.float32, fixed, False),
                                    ("card_bf16", dev, torch.bfloat16, fixed, False),
                                    ("last_key_dropped", dev, torch.float32, fixed, True),
                                    ("last_key_dropped_bf16", dev, torch.bfloat16, fixed,
                                     True)):
        model, step, _ = make_step(torch, R, args, d, dt, vae, pp, lr)
        paths[name] = []
        try:
            A.fused_attention_flat_bwd = path_spy(
                last_key_dropped(real) if fault else real, A.cuda_bwd_kernel_path,
                paths[name], d)
            with fed_images(images["cpu"]) if d.type == "cuda" else contextlib.nullcontext():
                m = step(to_device(host, d), 0)
        finally:
            A.fused_attention_flat_bwd = real
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        del model, step
    ref_m = out["cpu_f32"][0]
    loss_rel = {n: abs(out[n][0]["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
                for n in ("card_f32", "card_bf16")}
    grads = {n: grad_rel(torch, out[n][1], out["cpu_f32"][1]) for n in out if n != "cpu_f32"}
    say("train_step_check", model="pt_vit", embed_dim=args.transformer_emb, depth=2,
        heads=args.transformer_heads, batch=8, metrics={n: v[0] for n, v in out.items()},
        loss_rel=loss_rel, grad_rel_l2_vs_cpu_f32=grads, k2b_paths=paths,
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad=STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL, bf16_grad=STEP_BF16_GRAD_REL))
    check(all(np.isfinite(v) for v in ref_m.values()), "CPU step metrics not finite")
    check(all(paths[n] == ["wgmma" if "bf16" in n else "scalar"] * 2 for n in out
              if n != "cpu_f32"), f"the card steps' K2b launches took {paths}")
    check(loss_rel["card_f32"] <= STEP_F32_LOSS_REL, f"f32 step loss rel {loss_rel}")
    check(grads["card_f32"]["max"] <= STEP_F32_GRAD_REL, f"f32 grads: {grads['card_f32']}")
    check(loss_rel["card_bf16"] <= STEP_BF16_LOSS_REL, f"bf16 step loss rel {loss_rel}")
    check(grads["card_bf16"]["max"] <= STEP_BF16_GRAD_REL, f"bf16 grads: {grads['card_bf16']}")
    for n, bnd in (("last_key_dropped", STEP_F32_GRAD_REL),
                   ("last_key_dropped_bf16", STEP_BF16_GRAD_REL)):
        check(grads[n]["max"] > bnd, f"the gradient gate does not see K2b with its last key "
                                     f"dropped ({n}): {grads[n]}")

    # suspect S1: on the next batch of the same epoch, the card's f32 step on
    # its own images and tokens (reported) and on the CPU's (gated), against
    # the CPU's step
    pp2, host2 = host_train_batch(args, 8, index=1)
    cpu_images = preprocess_batch(to_device(host2, cpu), pp2, is_train=True)
    with torch.no_grad():
        cpu_tokens = vae_cpu.get_codebook_indices(cpu_images)
    s1 = {}
    for name, d, vae, fed in (("cpu_f32", cpu, vae_cpu, False),
                              ("card_f32", dev, vae_card, False),
                              ("card_f32_cpu_inputs", dev, _FixedTokens(cpu_tokens), True)):
        model, step, _ = make_step(torch, R, args, d, torch.float32, vae, pp2, lr)
        with fed_images(cpu_images) if fed else contextlib.nullcontext():
            m = step(to_device(host2, d), 0)
        s1[name] = ({k: v.item() for k, v in m.items()},
                    {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        del model, step
    s1_grads = {n: grad_rel(torch, s1[n][1], s1["cpu_f32"][1])
                for n in ("card_f32", "card_f32_cpu_inputs")}
    say("s1_check", batch_index=1, metrics={n: v[0] for n, v in s1.items()},
        grad_rel_l2_vs_cpu_f32=s1_grads, bound_on_one_input=STEP_F32_GRAD_REL)
    check(s1_grads["card_f32_cpu_inputs"]["max"] <= STEP_F32_GRAD_REL,
          f"f32 grads on the second batch: {s1_grads['card_f32_cpu_inputs']}")
    torch.cuda.empty_cache()


def run_training_cli(torch, flags):
    """Phase 7: the pretraining CLI at full width on the card, 2 epochs with a
    checkpoint each, then an auto-resumed third epoch. Returns the launch
    counts of the first run."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    out_dir = flags[flags.index("--output_dir") + 1]
    common = flags + ["--batch_size", "64", "--save_ckpt_freq", "1", "--warmup_steps", "2",
                      "--device", "cuda"]
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    hist = R.main(common + ["--epochs", "2"])
    counts = launch_counts()              # just after it
    t1 = time.perf_counter()
    written = sorted(os.listdir(out_dir))
    resumed = R.main(common + ["--epochs", "3"])
    t2 = time.perf_counter()
    say("train_cli", model="pt_vit", embed_dim=768, depth=12, heads=12, batch=64,
        steps=len(hist), losses=[h[1] for h in hist], mlm_acc=[h[2] for h in hist],
        grad_norm=[h[3] for h in hist], checkpoints=written, launches=counts,
        resumed_steps=[h[0] for h in resumed], resumed_losses=[h[1] for h in resumed],
        seconds=[round(t1 - t0, 2), round(t2 - t1, 2)])
    check(len(hist) == 4 and all(np.isfinite(h[1]) for h in hist + resumed),
          f"training losses {hist} {resumed}")
    check({"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-final.pth"} <= set(written),
          f"checkpoints {written}")
    check([h[0] for h in resumed] == [4, 5], f"auto-resume ran steps {resumed}")
    check(os.path.exists(os.path.join(out_dir, "checkpoint-2.pth")), "no checkpoint-2.pth")
    for name in ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"):
        check(counts.get(name, 0) > 0, f"the training path launched no {name} kernel")
    return counts


def time_training(torch, dev, gpu):
    """Phase 8: K2b against its plain version at the training shape (B=64)
    and the serving batch (B=8), in turns: plain, kernel, kernel, plain; its
    device time (its rows, columns and bias-sum kernels) and the backward of
    one SDPA call beside it. Returns the mean ms of K2b, of its plain version
    and of the library yardstick at B=64."""
    from mem_tpu_torch.ops.attention import (fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference)

    for B in (8, 64):
        q, k, v, do = (torch.randn(B, 197, 768, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        bias = torch.randn(12, 197, 197, device=dev)
        plain = lambda: fused_attention_flat_bwd_reference(q, k, v, bias, do, 0.125)  # noqa: E731
        kernel = lambda: fused_attention_flat_bwd(q, k, v, bias, do, 0.125)  # noqa: E731
        tp = [time_ms(plain, runs=20)]
        tk = [time_ms(kernel, runs=20), time_ms(kernel, runs=20)]
        tp.append(time_ms(plain, runs=20))
        t_dev = body_device_ms(kernel, ("attention_long_bwd_rows_wgmma",
                                        "attention_long_bwd_cols_wgmma",
                                        "attention_long_bwd_bias_sum"))
        # the yardstick: the backward of one scaled_dot_product_attention call
        # with the bias as its mask (dq, dk, dv and the mask's gradient)
        qh, kh, vhd, mask = (t.requires_grad_() for t in sdpa_operands(torch, q, k, v, bias))
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vhd, attn_mask=mask,
                                                               scale=0.125)
        doh = torch.randn_like(out)
        lib_bwd = lambda: torch.autograd.grad(out, (qh, kh, vhd, mask), doh,  # noqa: E731
                                              retain_graph=True)
        t_lib, t_lib_dev = time_ms(lib_bwd, runs=20), kernel_device_ms(lib_bwd, ("",))
        flop = 5 * 2 * B * 12 * 197 * 197 * 64
        say("time_k2b", gpu=gpu, batch=B, shape=[197, 12, 64], dtype="bfloat16", kernel_ms=tk,
            kernel_device_ms=t_dev, plain_ms=tp, sdpa_backward_ms=t_lib,
            sdpa_backward_device_ms=t_lib_dev,
            bound_ms=attention_bwd_bound(B, 197, 12, 64)[0],
            kernel_tflop_s=flop / statistics.mean(tk) / 1e9)
        del q, k, v, do, bias, qh, kh, vhd, mask, out, doh

    return statistics.mean(tk), statistics.mean(tp), t_lib


def check_loss_fall(torch, dev, flags):
    """The full-width pt_vit train step (depth 12, bf16, the conf's recipe)
    at B=64: 15 steps on one repeated batch with no lr warm-up; the loss must
    fall by LOSS_FALL (the step's timing and profile are
    tools/trace_pretrain.py's)."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.train.schedules import cosine_scheduler

    args = R.get_args(flags + ["--device", "cuda"])
    lr = cosine_scheduler(args.lr, args.min_lr, 1, 15, warmup_steps=0)
    pp, host = host_train_batch(args, 64)
    model, step, _ = make_step(torch, R, args, dev, torch.bfloat16, R.load_vae(args, dev), pp, lr)
    losses = repeated_batch_losses(step, to_device(host, dev), 15)
    say("loss_fall", batch=64, steps=15, losses=losses, min_fall=LOSS_FALL)
    check(all(np.isfinite(losses)), f"B=64: non-finite losses {losses}")
    check(losses[-1] <= losses[0] - LOSS_FALL,
          f"the loss fell from {losses[0]} to {losses[-1]}, less than {LOSS_FALL}")
    del model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the VAE-training slice: train_vae -> run_mem_pretraining
# ---------------------------------------------------------------------------

def vae_host_batch(args, B, n=1, color_jitter=0.0):
    """A training batch of the synthetic set at batch size B for train_vae
    (no masks, ColorJitter off as the reference's VAE pipeline; the MAE
    passes its ``color_jitter``), with its augmentation draws, as numpy: the
    first batch of epoch 0 at B, or for B above the train split the first
    ``n`` batches of 64 (epochs 0, 1, ...) stacked."""
    from mem_tpu_torch.cli.common import build_pipeline, build_preproc
    from mem_tpu_torch.data.device_pipeline import draw_train_aug

    pp = build_preproc(args, True, color_jitter=color_jitter)
    _, it = build_pipeline(args, "train", True, B if n == 1 else 64, seed=args.seed,
                           num_workers=args.num_workers)
    parts = list(itertools.islice((b for e in range(n) for b in it.epoch(e)), n))
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    batch.update(draw_train_aug(batch["aug_seed"], pp, pp.canvas_h, pp.canvas_w))
    return pp, batch


@contextlib.contextmanager
def fed_images(images):
    """Within the block, the train steps of ``mem_tpu_torch.train.steps``
    preprocess nothing: they take ``images`` (moved to the batch's device)
    as what the preprocessing gave, so that steps on two devices see one
    input."""
    from mem_tpu_torch.train import steps as S

    real = S.preprocess_batch
    S.preprocess_batch = lambda batch, pp, is_train: images.to(batch["n_valid"].device)
    try:
        yield
    finally:
        S.preprocess_batch = real


def deconv_flipped(vae):
    """``vae`` with a planted fault: its last ConvTranspose2d applies its
    kernel flipped in both spatial axes (what a kernel-layout slip in a
    hand-written deconvolution would give). The step gates must see it."""
    import torch.nn.functional as F

    conv = vae.decoder[-2][0]
    conv.forward = lambda x: F.conv_transpose2d(
        x, conv.weight.to(x.dtype).flip(2, 3), conv.bias.to(x.dtype), conv.stride, conv.padding)
    return vae


def check_vae_step(torch, dev, flags):
    """Phase V1: one make_vae_train_step of the conf's VAE (224^2, 8192
    tokens, codebook 32, 4 layers, 3 ResBlocks, hidden 384) at B=4 on one
    host batch and its draws, with one injected Gumbel-noise array: the
    preprocessed images card vs CPU; then the step on the CPU in f32 and on
    the card in f32 (TF32 off) and bf16, all three on the CPU's images, from
    the same seeded weights: the loss, and every parameter's gradient by
    relative L2 against the CPU's (gradients, not weights: after Adam's
    first step a weight moves by about +-lr). The f32 and bf16 card steps
    are repeated with the last deconvolution's kernel flipped, and each must
    fail its gradient gate. decode_indices of the CPU's codes card vs CPU,
    and one card f32 step on its own preprocessing (the path with K1: one
    launch)."""
    from mem_tpu_torch.cli import train_vae as T
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.models.discrete_vae import gumbel_like
    from mem_tpu_torch.train.steps import make_vae_train_step

    cpu, B = torch.device("cpu"), VAE_STEP_B
    args = T.get_args(flags + ["--batch_size", str(B)])
    pp, host = vae_host_batch(args, B)
    images = {d.type: preprocess_batch(to_device(host, d), pp, is_train=True).cpu()
              for d in (cpu, dev)}
    diff = (images["cuda"] - images["cpu"]).abs()
    say("vae_images_check", shape=list(images["cpu"].shape), max_abs=diff.max().item(),
        frac_differing=(diff > 1e-6).float().mean().item(), tol=TRAIN_IMG_TOL,
        frac_tol=TRAIN_IMG_FRAC, normalize_events=args.normalize_events)
    check(diff.max().item() <= TRAIN_IMG_TOL and
          (diff > 1e-6).float().mean().item() <= TRAIN_IMG_FRAC,
          "card VAE train images differ from the CPU's")
    side = args.input_H >> args.num_layers
    noise = gumbel_like((B, side, side, args.num_tokens), cpu, torch.Generator().manual_seed(1))

    def run(d, dt, fault=False, own_images=False):
        vae = T.build_vae(args, dt, d)
        vae.init_weights(torch.Generator().manual_seed(args.seed))
        if fault:
            deconv_flipped(vae)
        opt = torch.optim.Adam(vae.parameters(), lr=args.learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        step = make_vae_train_step(vae, opt, pp, args.clip, args.seed, inject_noise=True)
        batch = to_device(host, d)
        if own_images:
            reset_launch_counts()
            m = step(batch, noise.to(d), args.learning_rate, args.starting_temp)
            counts = launch_counts()
        else:
            with fed_images(images["cpu"]):
                m = step(batch, noise.to(d), args.learning_rate, args.starting_temp)
            counts = None
        out = ({k: v.item() for k, v in m.items()},
               {n: p.grad.detach().float().cpu() for n, p in vae.named_parameters()}, counts)
        del vae, opt, step
        return out

    out = {"cpu_f32": run(cpu, torch.float32),
           "card_f32": run(dev, torch.float32),
           "card_bf16": run(dev, torch.bfloat16),
           "deconv_flipped": run(dev, torch.float32, fault=True),
           "deconv_flipped_bf16": run(dev, torch.bfloat16, fault=True),
           "card_f32_own_images": run(dev, torch.float32, own_images=True)}
    ref = out["cpu_f32"][0]
    loss_rel = {n: abs(out[n][0]["loss"] - ref["loss"]) / abs(ref["loss"]) for n in out}
    grads = {n: grad_rel(torch, out[n][1], out["cpu_f32"][1]) for n in out if n != "cpu_f32"}
    k1 = out["card_f32_own_images"][2]

    # decode_indices of the CPU's codes, card (f32 and bf16) against the CPU
    decoded = {}
    for name, d, dt in (("cpu_f32", cpu, torch.float32), ("card_f32", dev, torch.float32),
                        ("card_bf16", dev, torch.bfloat16)):
        vae = T.build_vae(args, dt, d)
        vae.init_weights(torch.Generator().manual_seed(args.seed))
        with torch.no_grad():
            if name == "cpu_f32":
                ids = vae.get_codebook_indices(images["cpu"])
            decoded[name] = vae.decode_indices(ids.to(d)).float().cpu()
        del vae
    dec_rel = {n: rel_l2(torch, decoded[n], decoded["cpu_f32"]) for n in ("card_f32", "card_bf16")}
    say("vae_step_check", model="event_vae", input=[args.input_H, args.input_W],
        num_tokens=args.num_tokens, codebook=args.emb_dim, layers=args.num_layers,
        resblocks=args.num_resnet_blocks, hidden=args.hidden_dim, batch=B, clip=args.clip,
        metrics={n: v[0] for n, v in out.items()}, loss_rel=loss_rel,
        grad_rel_l2_vs_cpu_f32=grads, decode_rel_l2_vs_cpu_f32=dec_rel,
        distinct_codes=int(ids.unique().numel()), k1_launches_own_images=k1,
        bounds=dict(f32_loss=VAE_STEP_F32_LOSS_REL, f32_grad=VAE_STEP_F32_GRAD_REL,
                    bf16_loss=VAE_STEP_BF16_LOSS_REL, bf16_grad=VAE_STEP_BF16_GRAD_REL,
                    f32_decode=VAE_DECODE_F32_REL, bf16_decode=VAE_DECODE_BF16_REL))
    check(all(np.isfinite(v) for r in out.values() for v in r[0].values()),
          "VAE step metrics not finite")
    check(loss_rel["card_f32"] <= VAE_STEP_F32_LOSS_REL, f"VAE f32 step loss rel {loss_rel}")
    check(grads["card_f32"]["max"] <= VAE_STEP_F32_GRAD_REL, f"VAE f32 grads {grads['card_f32']}")
    check(loss_rel["card_bf16"] <= VAE_STEP_BF16_LOSS_REL, f"VAE bf16 step loss rel {loss_rel}")
    check(grads["card_bf16"]["max"] <= VAE_STEP_BF16_GRAD_REL,
          f"VAE bf16 grads {grads['card_bf16']}")
    for n, bnd in (("deconv_flipped", VAE_STEP_F32_GRAD_REL),
                   ("deconv_flipped_bf16", VAE_STEP_BF16_GRAD_REL)):
        check(grads[n]["max"] > bnd, f"the VAE gradient gate does not see the flipped "
                                     f"deconvolution ({n}): {grads[n]}")
    check(dec_rel["card_f32"] <= VAE_DECODE_F32_REL, f"decode_indices f32 rel {dec_rel}")
    check(dec_rel["card_bf16"] <= VAE_DECODE_BF16_REL, f"decode_indices bf16 rel {dec_rel}")
    check(k1 == {"hist_planes_cols": 1}, f"the VAE step launched {k1}, not K1 once")
    torch.cuda.empty_cache()


def run_train_vae_cli(torch, flags, out_dir, recon_dir):
    """Phase V2: train_vae at full width on the card (bf16, B=32: 4 steps an
    epoch), 2 epochs with an eval, a recon panel and a checkpoint each, then
    an auto-resumed third epoch. Returns the path of checkpoint-final.pth."""
    from mem_tpu_torch.cli import train_vae as T
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    common = flags + ["--batch_size", str(VAE_CLI_B), "--eval_freq", "1",
                      "--save_ckpt_freq", "1", "--dump_recon_dir", recon_dir,
                      "--output_dir", out_dir, "--device", "cuda"]
    log = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    with contextlib.redirect_stdout(log):
        hist = T.main(common + ["--epochs", "2"])
    counts = launch_counts()              # just after it
    t1 = time.perf_counter()
    written = sorted(os.listdir(out_dir))
    with contextlib.redirect_stdout(log):
        resumed = T.main(common + ["--epochs", "3"])
    t2 = time.perf_counter()
    text = log.getvalue()
    usage = [ln for ln in text.splitlines() if "codebook usage" in ln]
    used = [re.search(r"codebook usage (\d+)/(\d+)", ln) for ln in usage]
    recons = sorted(os.listdir(recon_dir)) if os.path.isdir(recon_dir) else []
    steps = len(hist) // 2
    say("train_vae_cli", model="event_vae", dtype="bfloat16", batch=VAE_CLI_B,
        steps=len(hist), losses=[h[1] for h in hist], grad_norm=[h[2] for h in hist],
        resumed_steps=[h[0] for h in resumed], resumed_losses=[h[1] for h in resumed],
        evals=usage, codebook_usage=[m.group(0) if m else None for m in used],
        checkpoints=written, recon_panels=recons, launches=counts,
        samples_per_sec=[ln for ln in text.splitlines() if "samples/sec" in ln],
        seconds=[round(t1 - t0, 2), round(t2 - t1, 2)])
    check(steps > 0 and all(np.isfinite(h[1]) for h in hist + resumed),
          f"train_vae losses {hist} {resumed}")
    check({"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-final.pth"} <= set(written),
          f"train_vae checkpoints {written}")
    check([h[0] for h in resumed] == list(range(2 * steps, 3 * steps)),
          f"train_vae's auto-resume ran steps {[h[0] for h in resumed]}")
    check(os.path.exists(os.path.join(out_dir, "checkpoint-2.pth")), "no checkpoint-2.pth")
    check(len(usage) == 3 and all(m and int(m.group(2)) == 8192 for m in used),
          f"train_vae printed no codebook usage of the 8192 tokens: {usage}")
    check({"recon_ep0.png", "recon_ep1.png", "recon_ep2.png"} <= set(recons),
          f"train_vae wrote {recons}")
    check(counts.get("hist_planes_cols", 0) > 0, "train_vae launched no hist_planes_cols")
    return os.path.join(out_dir, "checkpoint-final.pth")


def run_vae_chain(torch, pt_flags, vae_path, out_dir, dump_dir):
    """Phase V3: run_mem_pretraining at full width for one epoch on the
    tokenizer train_vae wrote, with --dump_recon_dir: it loads the .pth as
    it is and writes the eval's reconstruction and mask panels."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    args = R.get_args(pt_flags + ["--discrete_vae_weight_path", vae_path,
                                  "--output_dir", out_dir, "--device", "cuda"])
    vae = R.load_vae(args, dev)
    pp, host = host_train_batch(args, 64)
    with torch.no_grad():
        ids = vae.get_codebook_indices(preprocess_batch(to_device(host, dev), pp, True))
    del vae
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    hist = R.main(pt_flags + ["--discrete_vae_weight_path", vae_path, "--output_dir", out_dir,
                              "--batch_size", "64", "--epochs", "1", "--save_ckpt_freq", "1",
                              "--warmup_steps", "2", "--device", "cuda",
                              "--dump_recon_dir", dump_dir])
    counts = launch_counts()              # just after it
    panels = sorted(os.listdir(dump_dir)) if os.path.isdir(dump_dir) else []
    say("vae_chain", vae=vae_path.rsplit(os.sep, 2)[-2:], steps=len(hist),
        losses=[h[1] for h in hist], distinct_tokens_batch64=int(ids.unique().numel()),
        tokens_batch64=ids.numel(), panels=panels, launches=counts,
        seconds=round(time.perf_counter() - t0, 2))
    check(len(hist) > 0 and all(np.isfinite(h[1]) for h in hist), f"chain losses {hist}")
    check({"recon_ep0.png", "mask_ep0.png"} <= set(panels), f"the chain wrote {panels}")
    for name in ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"):
        check(counts.get(name, 0) > 0, f"the chained pretraining launched no {name} kernel")


def run_vae_slice(torch, dev, gpu, data_root, tmp_root, pt_flags):
    """The VAE-training slice on the synthetic N-Caltech set: V1-V3 (the
    step's timing and profile are tools/trace_vae.py's)."""
    flags = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
             "--num_workers", "4"]
    check_vae_step(torch, dev, flags)
    vae_path = run_train_vae_cli(torch, flags, os.path.join(tmp_root, "vae_out"),
                                 os.path.join(tmp_root, "vae_recon"))
    run_vae_chain(torch, pt_flags, vae_path, os.path.join(tmp_root, "pt_chain"),
                  os.path.join(tmp_root, "pt_dump"))


# ---------------------------------------------------------------------------
# the MAE slice: run_mem_pretraining --MAE 1 -> run_class_finetuning --MAE 1
# -> serve --MAE 1
# ---------------------------------------------------------------------------

MAE_STEP_B = 8           # the card-vs-CPU MAE step
MAE_CLI_B = 64           # run_mem_pretraining --MAE 1: 2 steps an epoch of 128 files
MAE_K2_SHAPES = (("encoder", 99, 12, 64), ("decoder", 197, 16, 32))   # (N, H, D) at B=128


def mae_flags(data_root, out_dir):
    """The conf's recipe with --MAE 1: the ViT-B/16 encoder of
    configs/ncaltech.conf and the parser's 512-wide, 8-block, 16-head
    decoder (the reference's mae_vit_base_patch16_dec512d8b)."""
    return ["--config", "configs/ncaltech.conf", "--data_path", data_root, "--MAE", "1",
            "--output_dir", out_dir, "--num_workers", "4"]


def tail_tile_dropped(bwd, tile=64):
    """``bwd``, an attention backward wrapper, with a planted fault: the keys
    of the last ``tile``-key tile masked out of the scores it recomputes
    (what a kernel that drops its ragged tail tile would give: 35 of the
    encoder's 99 keys, 5 of the decoder's 197)."""
    def faulty(q, k, v, bias, do, scale):
        n = bias.shape[-1]
        bias = bias.clone()
        bias[:, :, (n - 1) // tile * tile:] = float("-inf")
        return bwd(q, k, v, bias, do, scale)
    return faulty


def unshuffle_skipped(torch, model):
    """``model`` (an MAE) with a planted fault: its decoder takes the kept
    tokens and the mask tokens in shuffled order, the ``ids_restore``
    unshuffle skipped (the mask itself stays right). Every decoder position
    then sees another patch's token, which no pooling averages away."""
    real = model.random_masking

    def faulty(x, noise):
        kept, mask, restore = real(x, noise)
        return kept, mask, torch.arange(restore.shape[1], device=x.device).expand_as(restore)

    model.random_masking = faulty
    return model


def make_mae_step(torch, args, device, dtype, pp, lr_sched, fault=False):
    """The CLI's MAE on ``device`` from the seeded init, and its train step."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_mae_train_step

    model = R.build_model(args, dtype, device)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if fault:
        unshuffle_skipped(torch, model)
    opt = create_optimizer(model, args.lr, args.weight_decay)
    wd = np.full(len(lr_sched), args.weight_decay)
    return model, make_mae_train_step(model, opt, pp, lr_sched, wd, args.clip_grad, args.seed)


def check_mae_step(torch, dev, flags):
    """Phase M1: one make_mae_train_step at full width (encoder 768 / 12
    heads, decoder 512 / 16 heads; each 2 blocks deep) at B=8 on one host
    batch and its draws, with one injected noise array: the preprocessed
    images card vs CPU; then the step on the CPU in f32 and on the card in
    f32 (TF32 off) and bf16, all on the CPU's images, from the same seeded
    weights: the loss and every parameter's gradient by relative L2 against
    the CPU's. Each card step records the kernel path of every K2b launch
    (scalar in f32, K3b's Hopper kernels in bf16: the encoder's at head dim
    64, the decoder's at 32). The gradients are compared unclipped
    (--clip_grad 0): the MAE's summed loss puts the global norm in the
    thousands, far above the recipe's clip of 30, and the clip factor, a
    ratio of two f32 norms of ~10^8 terms, would scale every gradient by
    its own rounding. Planted faults: the f32 and bf16 card steps repeated
    with the decoder's unshuffle skipped, the f32 step with the last key
    masked out of K2b's scores (the scalar kernels at both head dims), the
    bf16 step with K2b's ragged tail tile dropped; each must fail its gate
    (one key of 99 or 197 moves a bf16 step's gradients by ~1e-2, inside
    rounding, F4). Then one card f32 step on its own preprocessing: K1
    once, K2f and K2b once a block."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import attention as A

    cpu, B = torch.device("cpu"), MAE_STEP_B
    args = R.get_args(flags + ["--transformer_depth", "2", "--mae_decoder_depth", "2",
                               "--batch_size", str(B), "--dtype", "float32",
                               "--clip_grad", "0"])
    pp, host = host_train_batch(args, B)
    images = {d.type: preprocess_batch(to_device(host, d), pp, is_train=True).cpu()
              for d in (cpu, dev)}
    diff = (images["cuda"] - images["cpu"]).abs()
    say("mae_images_check", shape=list(images["cpu"].shape), max_abs=diff.max().item(),
        frac_differing=(diff > 1e-6).float().mean().item(), tol=TRAIN_IMG_TOL,
        frac_tol=TRAIN_IMG_FRAC)
    check(diff.max().item() <= TRAIN_IMG_TOL and
          (diff > 1e-6).float().mean().item() <= TRAIN_IMG_FRAC,
          "card MAE train images differ from the CPU's")
    L = (args.input_H // 2 ** args.num_layers) ** 2
    noise = torch.rand((B, L), generator=torch.Generator().manual_seed(1))
    lr = np.array([args.lr])
    real = A.fused_attention_flat_bwd

    def run(d, dt, fault=None, own_images=False):
        model, step = make_mae_step(torch, args, d, dt, pp, lr, fault == "unshuffle_skipped")
        paths = []
        try:
            bwd = {"last_key_dropped": last_key_dropped,
                   "tail_tile_dropped": tail_tile_dropped}.get(fault, lambda f: f)(real)
            A.fused_attention_flat_bwd = path_spy(bwd, A.cuda_bwd_kernel_path, paths, d)
            reset_launch_counts()
            with (fed_images(images["cpu"]) if d.type == "cuda" and not own_images
                  else contextlib.nullcontext()):
                m = step(to_device(host, d), 0, noise=noise.to(d))
            counts = launch_counts()
        finally:
            A.fused_attention_flat_bwd = real
        out = ({k: v.item() for k, v in m.items()},
               {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()},
               paths, counts)
        del model, step
        return out

    out = {"cpu_f32": run(cpu, torch.float32),
           "card_f32": run(dev, torch.float32),
           "card_bf16": run(dev, torch.bfloat16),
           "unshuffle_skipped": run(dev, torch.float32, "unshuffle_skipped"),
           "unshuffle_skipped_bf16": run(dev, torch.bfloat16, "unshuffle_skipped"),
           "last_key_dropped": run(dev, torch.float32, "last_key_dropped"),
           "tail_tile_dropped_bf16": run(dev, torch.bfloat16, "tail_tile_dropped"),
           "card_f32_own_images": run(dev, torch.float32, own_images=True)}
    ref = out["cpu_f32"][0]
    loss_rel = {n: abs(out[n][0]["loss"] - ref["loss"]) / abs(ref["loss"]) for n in out}
    grads = {n: grad_rel(torch, out[n][1], out["cpu_f32"][1]) for n in out if n != "cpu_f32"}
    say("mae_step_check", model="mae_vit", embed_dim=args.transformer_emb,
        heads=args.transformer_heads, decoder=[args.mae_decoder_emb, args.mae_decoder_heads],
        depth=[2, 2], batch=B, metrics={n: v[0] for n, v in out.items()}, loss_rel=loss_rel,
        grad_rel_l2_vs_cpu_f32=grads, k2b_paths={n: v[2] for n, v in out.items()},
        launches_own_images=out["card_f32_own_images"][3],
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad=STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL, bf16_grad=STEP_BF16_GRAD_REL))
    check(all(np.isfinite(v) for r in out.values() for v in r[0].values()),
          "MAE step metrics not finite")
    # the backward runs the decoder's two blocks, then the encoder's
    for n in ("card_f32", "unshuffle_skipped", "last_key_dropped", "card_f32_own_images"):
        check(out[n][2] == ["scalar"] * 4, f"{n}'s K2b launches took {out[n][2]}")
    for n in ("card_bf16", "unshuffle_skipped_bf16", "tail_tile_dropped_bf16"):
        check(out[n][2] == ["wgmma"] * 4, f"{n}'s K2b launches took {out[n][2]}")
    check(loss_rel["card_f32"] <= STEP_F32_LOSS_REL, f"MAE f32 step loss rel {loss_rel}")
    check(grads["card_f32"]["max"] <= STEP_F32_GRAD_REL, f"MAE f32 grads {grads['card_f32']}")
    check(loss_rel["card_bf16"] <= STEP_BF16_LOSS_REL, f"MAE bf16 step loss rel {loss_rel}")
    check(grads["card_bf16"]["max"] <= STEP_BF16_GRAD_REL,
          f"MAE bf16 grads {grads['card_bf16']}")
    for n, bnd in (("unshuffle_skipped", STEP_F32_GRAD_REL),
                   ("unshuffle_skipped_bf16", STEP_BF16_GRAD_REL),
                   ("last_key_dropped", STEP_F32_GRAD_REL),
                   ("tail_tile_dropped_bf16", STEP_BF16_GRAD_REL)):
        check(grads[n]["max"] > bnd, f"the MAE gradient gate does not see {n}: {grads[n]}")
    check(out["card_f32_own_images"][3] == {"hist_planes_cols": 1, "fused_attention_flat": 4,
                                            "fused_attention_flat_bwd": 4},
          f"the MAE step launched {out['card_f32_own_images'][3]}")
    torch.cuda.empty_cache()


def run_mae_pretraining_cli(torch, flags):
    """Phase M2: run_mem_pretraining --MAE 1 at full width on the card (bf16,
    B=64: 2 steps an epoch), 2 epochs with a checkpoint each, then an
    auto-resumed third. Launch counts exact: K1 once a step, K2f and K2b 20
    times (12 encoder and 8 decoder blocks), nothing else. Returns the path
    of checkpoint-final.pth."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    out_dir = flags[flags.index("--output_dir") + 1]
    common = flags + ["--batch_size", str(MAE_CLI_B), "--save_ckpt_freq", "1",
                      "--warmup_steps", "2", "--device", "cuda"]
    log = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    with contextlib.redirect_stdout(log):
        hist = R.main(common + ["--epochs", "2"])
    counts = launch_counts()              # just after it
    t1 = time.perf_counter()
    written = sorted(os.listdir(out_dir))
    reset_launch_counts()
    with contextlib.redirect_stdout(log):
        resumed = R.main(common + ["--epochs", "3"])
    counts_resumed = launch_counts()
    t2 = time.perf_counter()
    text = log.getvalue()
    steps = len(hist)
    say("mae_pretrain_cli", model="mae_vit_base_patch16_dec512d8b", dtype="bfloat16",
        batch=MAE_CLI_B, steps=steps, losses=[h[1] for h in hist],
        grad_norm=[h[3] for h in hist], checkpoints=written, launches=counts,
        resumed_steps=[h[0] for h in resumed], resumed_losses=[h[1] for h in resumed],
        launches_resumed=counts_resumed,
        samples_per_sec=[ln for ln in text.splitlines() if "samples/sec" in ln],
        seconds=[round(t1 - t0, 2), round(t2 - t1, 2)])
    check(steps == 4 and all(np.isfinite(h[1]) and h[2] is None for h in hist + resumed),
          f"MAE pretraining history {hist} {resumed}")
    check("mlm_acc" not in text, "the MAE run logged an mlm_acc")
    check({"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-final.pth"} <= set(written),
          f"MAE checkpoints {written}")
    check([h[0] for h in resumed] == [4, 5], f"the MAE auto-resume ran steps {resumed}")
    check(counts == {"hist_planes_cols": 4, "fused_attention_flat": 80,
                     "fused_attention_flat_bwd": 80},
          f"the MAE pretraining run launched {counts}")
    check(counts_resumed == {"hist_planes_cols": 2, "fused_attention_flat": 40,
                             "fused_attention_flat_bwd": 40},
          f"the resumed MAE pretraining run launched {counts_resumed}")
    return os.path.join(out_dir, "checkpoint-final.pth")


def run_mae_finetune_cli(torch, data_root, pretrained, out_dir):
    """Phase M3: run_class_finetuning --MAE 1 --finetune on the MAE
    checkpoint at full width (vit_base_patch16, global pool, bf16, batch 64
    = 2 x 32, mixup and cutmix on, EMA), one epoch with the raw and the EMA
    evaluation. Launches exact: K1 once a micro-batch, K2f 12 times a
    micro-batch forward, K2b 12 times a train micro-batch. Returns the path
    of its checkpoint."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    flags = ["--config", "configs/ncaltech.conf", "--data_path", data_root, "--MAE", "1",
             "--finetune", pretrained, "--output_dir", out_dir, "--nb_classes", "101",
             "--batch_size", str(2 * FT_MICRO), "--update_freq", "2", "--mixup_prob", "1.0",
             "--save_ckpt_freq", "1", "--warmup_steps", "2", "--num_workers", "4",
             "--epochs", "1", "--device", "cuda"]
    log = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    with contextlib.redirect_stdout(log):
        r = F.main(flags)
    counts = launch_counts()              # just after it
    text = log.getvalue()
    written = sorted(os.listdir(out_dir))
    say("mae_finetune_cli", model="vit_base_patch16", global_pool=True, classes=101,
        batch=2 * FT_MICRO, update_freq=2, dtype="bfloat16", history=r["history"],
        evals=r["evals"], checkpoints=written, launches=counts,
        lines=[ln for ln in text.splitlines() if "MAE" in ln or "acc1" in ln],
        seconds=round(time.perf_counter() - t0, 2))
    check("MAE finetuning" in text and "Load MAE PT checkpoint from" in text,
          "run_class_finetuning --MAE 1 did not print 'MAE finetuning' and load the checkpoint")
    # 128 files / (2 x 32) = 2 optimizer steps = 4 micro-batches; the raw and
    # the EMA evaluation: 64 files / 32 = 2 batches each
    train, evals = 4, 4
    check(counts == {"hist_planes_cols": train + evals,
                     "fused_attention_flat": 12 * (train + evals),
                     "fused_attention_flat_bwd": 12 * train},
          f"the MAE finetune run launched {counts}")
    check(len(r["history"]) > 0 and all(np.isfinite(h[1]) and np.isfinite(h[2])
                                        for h in r["history"]),
          f"MAE finetune history {r['history']}")
    check(len(r["evals"]) == 1 and r["evals"][0][2] is not None
          and all(np.isfinite(st["loss"]) for st in r["evals"][0][1:]),
          f"MAE finetune evaluations {r['evals']}")
    check("checkpoint-0.pth" in written, f"MAE finetune checkpoints {written}")
    return os.path.join(out_dir, "checkpoint-0.pth")


def run_mae_serve(torch, dev, ckpt, rng):
    """Phase M4: serve --MAE 1 over HTTP on the finetune checkpoint (bf16,
    batch 8): requests in a burst, then one request sent alone twice (the
    same top-k); K1 once and K2f 12 times a batch; then the card's logits (bf16 and f32) on 8 of the payloads against
    the CPU's f32 logits, from the same weights."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli.common import build_classifier, build_preproc
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    payloads = [synthetic_events(rng, int(rng.integers(20_000, 40_001))) for _ in range(16)]
    args = serve.get_args(["--checkpoint", ckpt, "--MAE", "1", "--nb_classes", "101",
                           "--dataset", "ncaltech101", "--dtype", "bfloat16", "--batch_size",
                           "8", "--max_wait_ms", "5", "--topk", "5", "--port", "0",
                           "--device", "cuda"])
    with http_server(serve, args, quiet=True) as (post, read_stats, _):
        def ask(ev):
            code, _, body, _ = post(ev)
            return code, json.loads(body)

        reset_launch_counts()                 # just before the main path
        with ThreadPoolExecutor(8) as pool:
            burst = list(pool.map(ask, payloads))
        # a request sent alone is its own batch, wrap-padded: the same input
        # twice (in a burst, a stream over the cap gets the window of its
        # place in the batch)
        seq, repeat = ask(payloads[0]), ask(payloads[0])
        counts = launch_counts()              # just after it
        stats = read_stats()
    for code, body in burst + [seq, repeat]:
        check(code == 200, f"MAE serve: HTTP {code}")
        tk = body["topk"]
        check(len(tk) == 5 and all(0 <= c < 101 and np.isfinite(p) for c, p in tk),
              f"MAE serve: bad topk {tk}")
    check(repeat[1]["topk"] == seq[1]["topk"],
          f"MAE serve: same payload, other top-k: {seq[1]['topk']} vs {repeat[1]['topk']}")
    batches = stats["batches"]
    check(counts == {"hist_planes_cols": batches, "fused_attention_flat": 12 * batches},
          f"the MAE server launched {counts} over {batches} batches")

    pp = build_preproc(args, is_train=False)
    batch = serve.make_assemble(args, pp)([(p, False) for p in payloads[:8]], 8)
    sd = load_checkpoint(ckpt)["model"]
    logits = {}
    for name, d, dt in (("cpu_f32", torch.device("cpu"), torch.float32),
                        ("card_f32", dev, torch.float32), ("card_bf16", dev, torch.bfloat16)):
        model = build_classifier(args, 101, dt, d)
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            images = preprocess_batch(serve.to_device(batch, d), pp, is_train=False)
            logits[name] = model.eval()(images).float().cpu()
        del model
    ref = logits["cpu_f32"]
    rel = {n: rel_l2(torch, logits[n], ref) for n in ("card_f32", "card_bf16")}
    say("mae_serve", requests=len(burst) + 2, batches=batches, launches=counts, stats=stats,
        logits_rel_l2=rel, logits_abs_mean=ref.abs().mean().item(),
        logits_std_over_classes=ref.std(dim=1).mean().item(),
        bounds=dict(f32=LOGITS_F32_REL, bf16=LOGITS_BF16_REL))
    check(all(torch.isfinite(v).all() for v in logits.values()), "MAE logits not finite")
    check(rel["card_f32"] <= LOGITS_F32_REL, f"MAE serve f32 logits rel L2 {rel}")
    check(rel["card_bf16"] <= LOGITS_BF16_REL, f"MAE serve bf16 logits rel L2 {rel}")


def time_mae(torch, dev, gpu):
    """Phase M5: K2f and K2b at the encoder's (128, 99, 768) H 12 D 64 and
    the decoder's (128, 197, 512) H 16 D 32, in turns with their plain
    versions (plain, kernel, kernel, plain), beside one SDPA call (its
    backward for K2b); the device time per call of each, both read alike:
    each kernel's mean per launch over 20 calls, summed (kernel_device_ms
    per_launch; K2b's rows, columns and bias-sum kernels apart too, and
    every kernel's recorded launches); the bounds, with what one K2b launch allocates and
    its workspaces: on the Hopper bodies the padded (B, H, N, ws_stride) f32
    ds workspace and the row statistics, on the scalar bodies each kernel's
    shared memory per block and the (B, H, N, N) ds / p workspaces (the MAE
    train step's timing and profile are tools/trace_mae.py's). Returns the K2
    times by shape."""
    from mem_tpu_torch.kernels import build
    from mem_tpu_torch.ops.attention import (MAX_SMEM_BYTES, cuda_bwd_kernel_path,
                                             cuda_kernel_path, fused_attention_flat,
                                             fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference,
                                             fused_attention_flat_reference)

    B = 128
    k2 = {}
    for part, N, H, D in MAE_K2_SHAPES:
        q, k, v, do = (torch.randn(B, N, H * D, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        bias = torch.zeros(H, N, N, device=dev)
        s = D ** -0.5
        wg = cuda_kernel_path(q, k, v, bias) == "wgmma"
        fwd_frag = ("attention_long_fwd_wgmma",) if wg else ("attention_fwd_flat_kernel",)
        bwd_frag = (("attention_long_bwd_rows_wgmma", "attention_long_bwd_cols_wgmma",
                     "attention_long_bwd_bias_sum") if wg else
                    ("attention_bwd_flat_kernel", "attention_bwd_bias_sum"))
        check(cuda_bwd_kernel_path(q, k, v, bias) == ("wgmma" if wg else "scalar"),
              f"K2f and K2b take other bodies at {part}")
        # what one K2b launch allocates on top of its operands (outputs and
        # workspaces) and, on the scalar bodies, the shared memory of a block
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fused_attention_flat_bwd(q, k, v, bias, do, s)
        torch.cuda.synchronize()
        mem = dict(k2b_alloc_bytes=torch.cuda.max_memory_allocated() - base,
                   k2b_output_bytes=3 * B * N * H * D * 2 + H * N * N * 4)
        lib = build.library(dev)
        if wg:
            mem.update(k2b_ds_workspace_bytes=B * H * N * lib.mem_attention_long_bwd_ws_stride(N, 1)
                       * 4, k2b_stats_bytes=B * H * -(-N // 64) * 3 * 64 * 4)
        else:
            mem.update(k2f_smem_bytes=lib.mem_attention_fwd_flat_smem(N, D, 1),
                       k2b_smem_bytes=lib.mem_attention_bwd_flat_smem(N, D, 1),
                       smem_limit_bytes=MAX_SMEM_BYTES,
                       k2b_workspace_bytes=B * H * N * N * (4 + 2))   # ds f32 + p bf16
        qh, kh, vhd, mask = (t.requires_grad_() for t in sdpa_operands(torch, q, k, v, bias))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vhd, attn_mask=mask,
                                                                    scale=s)
        doh = torch.randn_like(sdpa_out)
        row = {}
        for name, kern, plain, frags, lib, bnd in (
                ("K2f", lambda: fused_attention_flat(q, k, v, bias, s),
                 lambda: fused_attention_flat_reference(q, k, v, bias, s), fwd_frag,
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qh, kh, vhd, attn_mask=mask, scale=s),
                 attention_fwd_bound(B, N, H, D)),
                ("K2b", lambda: fused_attention_flat_bwd(q, k, v, bias, do, s),
                 lambda: fused_attention_flat_bwd_reference(q, k, v, bias, do, s), bwd_frag,
                 lambda: torch.autograd.grad(sdpa_out, (qh, kh, vhd, mask), doh,
                                             retain_graph=True),
                 attention_bwd_bound(B, N, H, D))):
            tp = [time_ms(plain, runs=20)]
            tk = [time_ms(kern, runs=20), time_ms(kern, runs=20)]
            tp.append(time_ms(plain, runs=20))
            with torch.no_grad() if name == "K2f" else contextlib.nullcontext():
                lib_rec = {}
                t_lib = time_ms(lib, runs=20)
                t_lib_dev = kernel_device_ms(lib, ("",), per_launch=True, records=lib_rec)
            rec = {}
            dev_ms = kernel_device_ms(kern, frags, per_launch=True, records=rec)
            parts = {f: sum(us for key, (_, us) in rec.items() if f in key) / 1e3 for f in frags}
            row[name] = dict(kernel_ms=tk, kernel_device_ms=dev_ms, device_ms_by_kernel=parts,
                             launches_recorded={key[:60]: c for key, (c, _) in rec.items()},
                             sdpa_launches_recorded={key[:60]: c
                                                     for key, (c, _) in lib_rec.items()},
                             plain_ms=tp, sdpa_ms=t_lib, sdpa_device_ms=t_lib_dev,
                             bound_ms=bnd[0], bound_by=bnd[1])
        say("time_mae_k2", gpu=gpu, part=part, shape=[B, N, H, D], dtype="bfloat16",
            body="wgmma" if wg else "scalar", memory=mem, **row)
        k2[part] = row
        del q, k, v, do, bias, qh, kh, vhd, mask, sdpa_out, doh
        torch.cuda.empty_cache()

    return k2


def run_mae_slice(torch, dev, gpu, data_root, tmp_root):
    """The MAE slice on the synthetic N-Caltech set: M1-M5."""
    rng = np.random.default_rng(18)
    pt_flags = mae_flags(data_root, os.path.join(tmp_root, "mae_out"))
    check_mae_step(torch, dev, pt_flags)
    ckpt = run_mae_pretraining_cli(torch, pt_flags)
    ft_ckpt = run_mae_finetune_cli(torch, data_root, ckpt, os.path.join(tmp_root, "mae_ft"))
    run_mae_serve(torch, dev, ft_ckpt, rng)
    return time_mae(torch, dev, gpu)


# ---------------------------------------------------------------------------
# the classification finetune slice: K6f, K6b, K5a, K5c
# ---------------------------------------------------------------------------

FT_B = 128               # the finetune micro-batch the kernels are timed at ...
FT_ROWS = FT_B * 197     # ... 25,216 rows of 768 through the MLP


def mlp_fwd_bound(R, C, Hd, save_h=True, itemsize=2):
    """K6f: x, both weights and biases read, out (and h) written; two
    products of 2 R C Hd operations."""
    nbytes = (2 * R * C + 2 * C * Hd + Hd + C + (R * Hd if save_h else 0)) * itemsize
    return bound(nbytes, 4 * R * C * Hd, PEAK_BF16_FLOPS)


def mlp_bwd_bound(R, C, Hd, itemsize=2):
    """K6b: do, h, x and both weights read, dx and the f32 dW1, dW2, db1, db2
    written; four products of 2 R C Hd operations."""
    nbytes = (3 * R * C + R * Hd + 2 * C * Hd) * itemsize + (2 * C * Hd + Hd + C) * 4
    return bound(nbytes, 8 * R * C * Hd, PEAK_BF16_FLOPS)


def mlp_operands(torch, g, R, C, Hd, dt, dev):
    x, do = (torch.randn(R, C, generator=g).to(dt).to(dev) for _ in range(2))
    w1 = (0.05 * torch.randn(C, Hd, generator=g)).to(dt).to(dev)
    w2 = (0.05 * torch.randn(Hd, C, generator=g)).to(dt).to(dev)
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(dt).to(dev) for n in (Hd, C))
    return x, w1, b1, w2, b2, do


# (rows, C, hidden): the timed micro-batch, the CLI runs' micro-batch, B = 8,
# ragged row counts around the 32-row tile, the narrow tensor-core widths, and
# widths only the scalar kernels take
K6_SHAPES = ((FT_ROWS, 768, 3072), (FT_MICRO * 197, 768, 3072), (1576, 768, 3072),
             (1, 768, 3072), (31, 768, 3072), (513, 768, 3072), (513, 128, 256),
             (600, 384, 1536), (513, 96, 200))


K6_F32_SHAPES = ((513, 768, 3072), (31, 128, 256), (77, 96, 200))


def k6_cases(torch):
    """((rows, C, hidden), dtype): bf16 at every K6_SHAPES entry (the Hopper
    GEMM where the widths allow) and f32 at three (the scalar kernels)."""
    return [(s, torch.bfloat16) for s in K6_SHAPES] + [(s, torch.float32)
                                                       for s in K6_F32_SHAPES]


def check_k6f(torch, dev, g):
    """K6f against its plain version at every k6_cases entry: out and the h
    residual, ``save_h`` both ways (the two must give the same out bit for
    bit, and no h without it), bit-identical across two launches, on the
    kernels ``kernel_route`` names (the Hopper GEMM for bf16 at the model's
    widths). Returns the max abs error of out at FT_ROWS."""
    from mem_tpu_torch.ops import mlp as M

    first = None
    for (R, C, Hd), dt in k6_cases(torch):
        tol = K6_BF16_TOL if dt == torch.bfloat16 else K6_F32_TOL
        x, w1, b1, w2, b2, _ = mlp_operands(torch, g, R, C, Hd, dt, dev)
        out, h = M.mlp_fwd_2d(x, w1, b1, w2, b2, True)
        out_no_h, none = M.mlp_fwd_2d(x, w1, b1, w2, b2, False)
        again, h_again = M.mlp_fwd_2d(x, w1, b1, w2, b2, True)
        torch.cuda.synchronize()
        want, want_h = M.mlp_fused_reference(x, w1, b1, w2, b2, True)
        e_out, e_h = rel_max_abs(out, want), rel_max_abs(h, want_h)
        same_out = bool(torch.equal(out, out_no_h)) and none is None
        same = bool(torch.equal(out, again) and torch.equal(h, h_again))
        path = M.cuda_kernel_path(x, Hd)
        say("k6f_check", dtype=str(dt), shape=[R, C, Hd], rel_max_abs_out=e_out,
            rel_max_abs_h=e_h, tol=tol, save_h_false_equal=same_out,
            identical_across_launches=same, kernel=path)
        check(e_out <= tol and e_h <= tol, f"K6f {dt} {R, C, Hd}: out {e_out}, h {e_h} > {tol}")
        check(same_out, f"K6f {dt} {R, C, Hd}: save_h=False changes the output")
        check(same, f"K6f {dt} {R, C, Hd}: two launches on the same operands differ")
        check(path == M.kernel_route(dt, C, Hd), f"K6f {dt} {R, C, Hd} took the {path} kernels")
        if first is None:
            first = (out.float() - want.float()).abs().max().item()
        del x, w1, b1, w2, b2, out, h, out_no_h, want, want_h
    torch.cuda.empty_cache()
    return first


def check_k6b(torch, dev, g):
    """K6b against its plain version at every k6_cases entry, both on the
    plain forward's h: dx, and the f32 dW1, dW2, db1, db2; every output
    bit-identical across two launches; autograd through mlp_fused on the card
    launches K6f and K6b once each and leaves f32 weight gradients. Returns
    the max abs error of dx at FT_ROWS."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops import mlp as M

    first = None
    for (R, C, Hd), dt in k6_cases(torch):
        bf16 = dt == torch.bfloat16
        tol = K6_BF16_TOL if bf16 else K6_F32_TOL
        sum_tol = K6B_SUM_BF16_REL if bf16 else K6B_SUM_F32_REL
        x, w1, b1, w2, b2, do = mlp_operands(torch, g, R, C, Hd, dt, dev)
        _, h = M.mlp_fused_reference(x, w1, b1, w2, b2, True)
        got = M.mlp_bwd_2d(do, h, x, w1, w2)
        again = M.mlp_bwd_2d(do, h, x, w1, w2)
        torch.cuda.synchronize()
        ref = M.mlp_fused_bwd_reference(do, h, x, w1, w2)
        e_dx = rel_max_abs(got[0], ref[0])
        sums = {n: rel_l2(torch, a, b) for n, a, b in zip(("dw1", "dw2", "db1", "db2"),
                                                          got[1:], ref[1:])}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        path = M.cuda_kernel_path(x, Hd)
        say("k6b_check", dtype=str(dt), shape=[R, C, Hd], rel_max_abs_dx=e_dx, tol=tol,
            rel_l2=sums, sum_tol=sum_tol, identical_across_launches=same, kernel=path,
            wgrad_chunks=M.wgrad_chunk_plan(R))
        check(e_dx <= tol and max(sums.values()) <= sum_tol,
              f"K6b {dt} {R, C, Hd}: dx {e_dx}, {sums}")
        check(same, f"K6b {dt} {R, C, Hd}: two launches on the same operands differ")
        check(path == M.kernel_route(dt, C, Hd), f"K6b {dt} {R, C, Hd} took the {path} kernels")
        if first is None:
            first = (got[0].float() - ref[0].float()).abs().max().item()
        del x, w1, b1, w2, b2, do, h, got, again, ref
    torch.cuda.empty_cache()

    x, w1, b1, w2, b2, do = mlp_operands(torch, g, 2 * 197, 768, 3072, torch.float32, dev)
    xb = x.bfloat16().reshape(2, 197, 768).requires_grad_()
    params = [t.requires_grad_() for t in (w1, b1, w2, b2)]
    before = launch_counts()
    M.mlp_fused(xb, *params).backward(do.bfloat16().reshape(2, 197, 768))
    torch.cuda.synchronize()
    after = launch_counts()
    launched = {n: after.get(n, 0) - before.get(n, 0) for n in ("mlp_fused", "mlp_fused_bwd")}
    c = [t.detach().bfloat16() for t in (w1, b1, w2, b2)]
    x2 = xb.detach().reshape(-1, 768)
    _, h = M.mlp_fused_reference(x2, *c)
    ref = M.mlp_fused_bwd_reference(do.bfloat16(), h, x2, c[0], c[2])
    errs = {"dx": rel_max_abs(xb.grad.reshape(-1, 768), ref[0]),
            "dw1": rel_l2(torch, w1.grad, ref[1]), "db1": rel_l2(torch, b1.grad, ref[3]),
            "dw2": rel_l2(torch, w2.grad, ref[2]), "db2": rel_l2(torch, b2.grad, ref[4])}
    say("k6_autograd", launches=launched, errors=errs,
        grad_dtypes=[str(t.grad.dtype) for t in params])
    check(launched == {"mlp_fused": 1, "mlp_fused_bwd": 1}, f"mlp_fused launched {launched}")
    check(errs["dx"] <= K6_BF16_TOL and max(v for n, v in errs.items() if n != "dx")
          <= K6B_SUM_BF16_REL, f"autograd through mlp_fused: {errs}")
    check(all(t.grad.dtype == torch.float32 for t in params), "weight gradients are not f32")

    # K6f and K6b from a fresh thread, on which PyTorch has made no CUDA
    # context current yet (as autograd's device thread when the MLP's
    # backward is its first work): the library binds the device itself
    # (build.library), and the results are the main thread's bits
    do2 = do.bfloat16()
    fresh = {}

    def launch():
        try:
            out, h = M.mlp_fwd_2d(x2, *c, True)
            fresh["out"] = (out, h, *M.mlp_bwd_2d(do2, h, x2, c[0], c[2]))
            torch.cuda.synchronize()
        except Exception as e:   # reported below, on the main thread
            fresh["error"] = repr(e)

    t = threading.Thread(target=launch, daemon=True)
    t.start()
    t.join(timeout=300)
    check(not t.is_alive(), "K6f / K6b from a fresh thread did not finish in 300 s")
    out, h = M.mlp_fwd_2d(x2, *c, True)
    main = (out, h, *M.mlp_bwd_2d(do2, h, x2, c[0], c[2]))
    torch.cuda.synchronize()
    same = "out" in fresh and all(torch.equal(a, b) for a, b in zip(fresh["out"], main))
    say("k6_fresh_thread", error=fresh.get("error"), equals_main_thread=same,
        kernel=M.cuda_kernel_path(x2, 3072))
    check(same, f"K6f / K6b from a fresh thread: {fresh.get('error', 'other bits')}")
    return first


# (B, H, N, D), bf16: the timed micro-batch, 64, the CLI runs' micro-batch, a
# ragged batch, the largest tensor-core N, a short N at both head dims; then f32
K5_SHAPES = ((FT_B, 12, 197, 64), (64, 12, 197, 64), (FT_MICRO, 12, 197, 64), (3, 12, 197, 64),
             (1, 12, 256, 64), (3, 4, 65, 64), (3, 4, 65, 32))
K5_F32_SHAPES = ((3, 12, 197, 64), (1, 3, 65, 32))


def k5_operands(torch, g, shape, dt, dev):
    B, H, N, D = shape
    q, k, v, do = (torch.randn(B, H, N, D, generator=g).to(dt).to(dev) for _ in range(4))
    bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
    flat = lambda t: t.transpose(1, 2).reshape(B, N, H * D).contiguous()  # noqa: E731
    return q, k, v, do, bias, D ** -0.5, flat


def k5_cases(torch):
    return [(s, torch.bfloat16) for s in K5_SHAPES] + [(s, torch.float32)
                                                       for s in K5_F32_SHAPES]


def check_k5a(torch, dev, g):
    """K5a against its plain version on (B, H, N, D) and against K2f on the
    transposed operands, with which it shares its kernel body: bit for bit.
    N = 197, 65, 256; D = 64, 32; B = 1, 3, 32, 64, 128; bf16 (the Hopper
    kernel at both head dims) and f32 (scalar); every output bit-identical across two
    launches. Returns the max abs error at (FT_B, 12, 197, 64)."""
    from mem_tpu_torch.ops import attention as A

    first = None
    for shape, dt in k5_cases(torch):
        tol = K2_BF16_TOL if dt == torch.bfloat16 else K2_F32_TOL
        q, k, v, _, bias, scale, flat = k5_operands(torch, g, shape, dt, dev)
        o = A.fused_attention(q, k, v, bias, scale)
        again = A.fused_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        o_flat = A.fused_attention_flat(flat(q), flat(k), flat(v), bias, scale)
        err = (o.float() - A.fused_attention_reference(q, k, v, bias, scale).float()
               ).abs().max().item()
        equal, same = bool(torch.equal(flat(o), o_flat)), bool(torch.equal(o, again))
        path = A.cuda_bhnd_kernel_path(q, k, v, bias)
        say("k5a_check", dtype=str(dt), shape=list(shape), max_abs_err=err, tol=tol,
            equals_k2f_on_transposed=equal, identical_across_launches=same, kernel=path)
        check(err <= tol, f"K5a {dt} {shape} max abs err {err} > {tol}")
        check(equal, f"K5a {dt} {shape} differs from K2f on the transposed operands")
        check(same, f"K5a {dt} {shape}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, shape, dt) else "scalar"),
              f"K5a {dt} {shape} took the {path} kernel")
        if first is None:
            first = err
        del q, k, v, bias, o, o_flat
    torch.cuda.empty_cache()
    return first


def check_k5c(torch, dev, g):
    """K5c against its plain version on (B, H, N, D) and against K2b on the
    transposed operands (the same kernel body: bit for bit), at check_k5a's
    shapes; every output bit-identical across two launches. Returns the max
    abs error at (FT_B, 12, 197, 64)."""
    from mem_tpu_torch.ops import attention as A

    first = None
    for shape, dt in k5_cases(torch):
        tol = K2B_BF16_TOL if dt == torch.bfloat16 else K2B_F32_TOL
        q, k, v, do, bias, scale, flat = k5_operands(torch, g, shape, dt, dev)
        got = A.fused_attention_bwd(q, k, v, bias, do, scale)
        again = A.fused_attention_bwd(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        k2b = A.fused_attention_flat_bwd(flat(q), flat(k), flat(v), bias, flat(do), scale)
        want = A.fused_attention_bwd_reference(q, k, v, bias, do, scale)
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        db = rel_l2(torch, got[3], want[3])
        equal = all(torch.equal(flat(a), b) for a, b in zip(got[:3], k2b[:3])) \
            and bool(torch.equal(got[3], k2b[3]))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        path = A.cuda_bhnd_bwd_kernel_path(q, k, v, bias)
        say("k5c_check", dtype=str(dt), shape=list(shape), rel_max_abs=errs, tol=tol,
            db_rel_l2=db, db_tol=K2B_DB_REL, equals_k2b_on_transposed=equal,
            identical_across_launches=same, kernel=path)
        check(max(errs.values()) <= tol and db <= K2B_DB_REL,
              f"K5c {dt} {shape}: {errs}, db {db}")
        check(equal, f"K5c {dt} {shape} differs from K2b on the transposed operands")
        check(same, f"K5c {dt} {shape}: two launches on the same operands differ")
        check(path == ("wgmma" if _bf16_wgmma(torch, shape, dt) else "scalar"),
              f"K5c {dt} {shape} took the {path} kernels")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        del q, k, v, do, bias, got, again, k2b, want
    torch.cuda.empty_cache()
    return first


def toggles(flat_attn: bool = True, fused_mlp: bool = False, flat_attn_long: bool = True,
            enabled: bool = False):
    """The port's module toggles -- FLAT_ATTN, FUSED_MLP and FLAT_ATTN_LONG
    of mem_tpu_torch.models.vit and ENABLED of mem_tpu_torch.ops.attention,
    the reference's names and defaults -- set for a block and put back
    after, through the trace tools' ``step_timers.toggles``."""
    from mem_tpu_torch.tools.step_timers import toggles as tool_toggles

    return tool_toggles({"flat": flat_attn, "fused_mlp": fused_mlp, "flat_long": flat_attn_long,
                         "fa": enabled})


def finetune_flags(data_root, pretrained, out_dir):
    """The conf's recipe at a batch one card takes, mixup and cutmix on; the
    conf's class_dropout = 0.1 would keep the MLPs off the fused kernel
    (vit.py:269), so the runs take the parser's own --drop 0."""
    return ["--config", "configs/ncaltech.conf", "--data_path", data_root, "--finetune",
            pretrained, "--output_dir", out_dir, "--nb_classes", "101", "--drop", "0",
            "--batch_size", str(2 * FT_MICRO), "--update_freq", "2", "--mixup_prob", "1.0",
            "--save_ckpt_freq", "1", "--warmup_steps", "2", "--num_workers", "4"]


def finetune_host_batches(args, B, n):
    """(the train preprocessing config, the mixup settings, the first ``n``
    training micro-batches of B samples with their augmentation and mixup
    draws, as numpy)."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli.common import build_pipeline, build_preproc
    from mem_tpu_torch.train.mixup import make_mixup

    pp = build_preproc(args, True, color_jitter=args.color_jitter)
    _, it = build_pipeline(args, "train", True, B, seed=args.seed, num_workers=args.num_workers)
    mix = make_mixup(args.nb_classes, args.mixup, args.cutmix, args.mixup_prob,
                     args.mixup_switch_prob, args.smoothing, mode=args.mixup_mode,
                     cutmix_minmax=args.cutmix_minmax)
    batches = []
    for batch in F._with_draws(it.epoch(0), pp, mix, args.seed):
        batches.append(batch)
        if len(batches) == n:
            break
    return pp, mix, batches


def make_finetune_step(torch, args, sd, device, dtype, pp, mix, lr_sched, update_freq=1,
                       ema=False, chain=False):
    """A full-width ft_vit on ``device`` from the state_dict ``sd`` and its
    train step (or its chain) with the CLI's optimizer."""
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_finetune_train_step

    model = build_classifier(args, args.nb_classes, dtype, device)
    model.load_state_dict(sd, strict=True)
    opt = create_optimizer(model, args.lr, args.weight_decay, layer_decay=args.layer_decay,
                           num_layers=args.transformer_depth)
    ema_w = [p.detach().clone() for p in model.parameters()] if ema else None
    wd = np.full(len(lr_sched), args.weight_decay)
    step = make_finetune_train_step(
        model, opt, pp, args.nb_classes, lr_sched, wd, mixup=mix, smoothing=args.smoothing,
        update_freq=update_freq, ema=ema_w, ema_decay=args.model_ema_decay if ema else None,
        clip_grad=args.clip_grad, seed=args.seed, chain=chain)
    return model, step, ema_w


def check_finetune_step(torch, dev, flags):
    """One make_finetune_train_step of ft_vit at full width and depth 2 (B=8,
    update_freq 2, mixup and cutmix from the host's draws, EMA, drop-path 0:
    the CPU's and the card's generators draw other bits) on the same host
    micro-batches, draws and seeded weights: on the card in f32 (TF32 off) and
    bf16 with both toggles on against the CPU in f32 (plain versions): loss
    and per-parameter gradient relative L2; the EMA weights against their
    definition from the step's own start and end weights (Adam's first update
    is lr * sign(g) wherever |g| >> eps, so a gradient near zero moves a
    weight by +-lr on either device and end weights are not comparable across
    devices); then the f32 card step with the toggles on against off. The
    head starts at --init_scale 1 instead of the recipe's 0.001, with which
    every loss would be ln(101) whatever the trunk does. Each card step
    records the kernel path of every K5c launch (scalar in f32, K3b's Hopper
    kernels in bf16) and of every K6f and K6b launch (scalar in f32, the
    Hopper GEMM in bf16). That the gradient gates can see a wrong K6f, K6b or
    K5c is shown in the same run: the toggled f32 card step is repeated with
    the last hidden column of K6b's dW1, dW2 and db1 zeroed, the bf16 step
    with the last K6_FAULT_COLUMNS of them zeroed and, again, with as many
    hidden columns of K6f's g zeroed in its second product, and the f32 and
    the bf16 steps with the last key masked out of K5c's scores; each must
    fail its gate."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import attention as A
    from mem_tpu_torch.ops import mlp as M

    cpu = torch.device("cpu")
    args = F.get_args(flags + ["--transformer_depth", "2", "--drop_path", "0",
                               "--dtype", "float32", "--init_scale", "1.0"])
    pp, mix, host = finetune_host_batches(args, 8, 2)
    ref_model = build_classifier(args, args.nb_classes, torch.float32, cpu)
    ref_model.init_weights(torch.Generator().manual_seed(3))
    sd = ref_model.state_dict()
    del ref_model
    lr = np.array([args.lr])
    real_fwd, real_bwd = M.mlp_fwd_2d, M.mlp_bwd_2d

    def k6_spy(fault, cols, seen):
        """K6f and K6b wrappers that record the kernel path of each launch
        and plant ``fault``: "K6f" zeroes the last ``cols`` hidden columns of
        g in the second product (what an F2 that skips its last k steps would
        give); "K6b" zeroes the last ``cols`` hidden columns of dW1, dW2 and
        db1 (what a weight-gradient tile that is never written would give)."""
        def fwd(x, w1, b1, w2, b2, save_h=True):
            seen.append(("K6f", M.cuda_kernel_path(x, w1.shape[1])))
            if fault == "K6f":
                w2 = w2.clone()
                w2[-cols:] = 0
            return real_fwd(x, w1, b1, w2, b2, save_h)

        def bwd(do, h, x, w1, w2):
            seen.append(("K6b", M.cuda_kernel_path(x, w1.shape[1])))
            dx, dw1, dw2, db1, db2 = real_bwd(do, h, x, w1, w2)
            if fault == "K6b":
                dw1, dw2, db1 = dw1.clone(), dw2.clone(), db1.clone()
                dw1[:, -cols:] = 0
                dw2[-cols:] = 0
                db1[-cols:] = 0
            return dx, dw1, dw2, db1, db2
        return fwd, bwd

    real_attn_bwd = A.fused_attention_bwd
    out, counts, paths, k6_paths = {}, {}, {}, {}
    f32, bf16 = torch.float32, torch.bfloat16
    for name, d, dt, on, fault, cols in (
            ("cpu_f32", cpu, f32, True, None, 0),
            ("card_f32", dev, f32, True, None, 0),
            ("card_bf16", dev, bf16, True, None, 0),
            ("card_f32_default", dev, f32, False, None, 0),
            ("last_column_dropped", dev, f32, True, "K6b", 1),
            ("dw_columns_dropped_bf16", dev, bf16, True, "K6b", K6_FAULT_COLUMNS),
            ("g_columns_dropped_bf16", dev, bf16, True, "K6f", K6_FAULT_COLUMNS),
            ("last_key_dropped", dev, f32, True, "K5c", 0),
            ("last_key_dropped_bf16", dev, bf16, True, "K5c", 0)):
        with toggles(flat_attn=not on, fused_mlp=on):
            model, step, ema = make_finetune_step(torch, args, sd, d, dt, pp, mix, lr,
                                                  update_freq=2, ema=True)
            paths[name], k6_paths[name] = [], []
            reset_launch_counts()
            try:
                if d.type == "cuda":
                    M.mlp_fwd_2d, M.mlp_bwd_2d = k6_spy(fault, cols, k6_paths[name])
                A.fused_attention_bwd = path_spy(
                    last_key_dropped(real_attn_bwd) if fault == "K5c" else real_attn_bwd,
                    A.cuda_bhnd_bwd_kernel_path, paths[name], d)
                m = step([to_device(b, d) for b in host], 0)
            finally:
                M.mlp_fwd_2d, M.mlp_bwd_2d = real_fwd, real_bwd
                A.fused_attention_bwd = real_attn_bwd
            counts[name] = launch_counts()
        decay = args.model_ema_decay
        ema_rel = max(rel_l2(torch, e.cpu(), decay * sd[n] + (1 - decay) * p.detach().cpu())
                      for e, (n, p) in zip(ema, model.named_parameters()))
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()},
                     ema_rel)
        del model, step, ema
    torch.cuda.empty_cache()

    ref_m = out["cpu_f32"][0]
    loss_rel = {n: abs(out[n][0]["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
                for n in ("card_f32", "card_bf16", "card_f32_default")}
    grads = {n: grad_rel(torch, out[n][1], out["cpu_f32"][1]) for n in out if n != "cpu_f32"
             and n != "card_f32_default"}
    g_toggle = grad_rel(torch, out["card_f32"][1], out["card_f32_default"][1])
    ema_rel = {n: v[2] for n, v in out.items()}
    say("finetune_step_check", model="ft_vit", embed_dim=768, depth=2, heads=12, batch=8,
        update_freq=2, mixup=dict(use=host[0]["mix_use"].tolist()[:2],
                                  cutmix=host[0]["mix_use_cutmix"].tolist()[:2],
                                  lam=host[0]["mix_lam"].tolist()[:2]),
        metrics={n: v[0] for n, v in out.items()}, loss_rel=loss_rel,
        grad_rel_l2_vs_cpu_f32=grads, grad_rel_l2_toggles_on_vs_off=g_toggle,
        ema_rel_l2_to_definition=ema_rel, launches=counts, k5c_paths=paths,
        k6_paths={n: sorted(set(p)) for n, p in k6_paths.items()},
        k6_fault_columns=K6_FAULT_COLUMNS,
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad=FT_STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL, bf16_grad=STEP_BF16_GRAD_REL,
                    toggles=FT_TOGGLE_GRAD_REL, ema=FT_EMA_REL))
    check(all(np.isfinite(v) for v in ref_m.values()), "CPU finetune step metrics not finite")
    on = {"hist_planes_cols": 2, "mlp_fused": 4, "mlp_fused_bwd": 4, "fused_attention": 4,
          "fused_attention_bwd": 4}
    off = {"hist_planes_cols": 2, "fused_attention_flat": 4, "fused_attention_flat_bwd": 4}
    for name, c in counts.items():
        want = {} if name.startswith("cpu") else off if name.endswith("default") else on
        check(c == want, f"the {name} finetune step launched {c}")
    check(loss_rel["card_f32"] <= STEP_F32_LOSS_REL
          and loss_rel["card_f32_default"] <= STEP_F32_LOSS_REL,
          f"f32 finetune step loss rel {loss_rel}")
    check(all(p == (["wgmma" if "bf16" in n else "scalar"] * 4 if n != "card_f32_default"
                    else []) for n, p in paths.items() if n != "cpu_f32"),
          f"the card steps' K5c launches took {paths}")
    for n, p in k6_paths.items():
        want = [] if n in ("cpu_f32", "card_f32_default") else (
            [(k, "wgmma" if "bf16" in n else "scalar") for k in ("K6f", "K6b") * 4])
        check(sorted(p) == sorted(want), f"the {n} step's K6 launches took {p}")
    check(grads["card_f32"]["max"] <= FT_STEP_F32_GRAD_REL,
          f"f32 grad card vs CPU: {grads['card_f32']}")
    check(grads["card_bf16"]["max"] <= STEP_BF16_GRAD_REL,
          f"bf16 grad card vs CPU: {grads['card_bf16']}")
    check(g_toggle["max"] <= FT_TOGGLE_GRAD_REL, f"f32 grad toggles on vs off: {g_toggle}")
    check(max(v for n, v in ema_rel.items() if "bf16" not in n) <= FT_EMA_REL,
          f"EMA weights against their definition: {ema_rel}")
    check(loss_rel["card_bf16"] <= STEP_BF16_LOSS_REL, f"bf16 finetune step loss rel {loss_rel}")
    for n, bnd, kernel in (("last_column_dropped", FT_STEP_F32_GRAD_REL, "K6b"),
                           ("dw_columns_dropped_bf16", STEP_BF16_GRAD_REL, "K6b"),
                           ("g_columns_dropped_bf16", STEP_BF16_GRAD_REL, "K6f"),
                           ("last_key_dropped", FT_STEP_F32_GRAD_REL, "K5c"),
                           ("last_key_dropped_bf16", STEP_BF16_GRAD_REL, "K5c")):
        check(grads[n]["max"] > bnd,
              f"the gradient gate does not see the planted {kernel} fault ({n}): {grads[n]}")


def run_finetune_cli(torch, flags):
    """run_class_finetuning at full width on the card. With the toggles on
    (K6f/K6b, K5a/K5c): 2 epochs of 2 optimizer steps (update_freq 2, so 8
    micro-batches of FT_MICRO) with the raw and the EMA evaluation and a
    checkpoint after each, an auto-resumed third epoch, --eval on the result.
    With the default toggles: one epoch. Launch counts are exact. Returns the
    counts of the first toggled run."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    out_dir = flags[flags.index("--output_dir") + 1]
    common = flags + ["--device", "cuda"]
    stamps = [time.perf_counter()]
    with toggles(flat_attn=False, fused_mlp=True):
        reset_launch_counts()                 # just before the main path
        first = F.main(common + ["--epochs", "2"])
        counts = launch_counts()              # just after it
        stamps.append(time.perf_counter())
        written = sorted(os.listdir(out_dir))
        reset_launch_counts()
        resumed = F.main(common + ["--epochs", "3"])
        counts_resumed = launch_counts()
        stamps.append(time.perf_counter())
        reset_launch_counts()
        evaluated = F.main(common + ["--epochs", "3", "--eval", "--eval_dump",
                                     os.path.join(out_dir, "pred", "val.jsonl")])
        counts_eval = launch_counts()
        stamps.append(time.perf_counter())
    payload = load_checkpoint(os.path.join(out_dir, "checkpoint-2.pth"))
    reset_launch_counts()
    default = F.main([out_dir + "_default" if f == out_dir else f for f in common]
                     + ["--epochs", "1", "--model_ema", "0"])
    counts_default = launch_counts()
    stamps.append(time.perf_counter())
    with open(os.path.join(out_dir, "pred", "val.jsonl")) as f:
        dumped = sum(1 for _ in f)
    say("finetune_cli", model="ft_vit", embed_dim=768, depth=12, heads=12, img=[224, 224],
        classes=101, batch=2 * FT_MICRO, update_freq=2, dtype="bfloat16",
        toggles=dict(FUSED_MLP=True, FLAT_ATTN=False), history=first["history"],
        evals=first["evals"], checkpoints=written, launches=counts,
        resumed_history=resumed["history"], launches_resumed=counts_resumed,
        eval_stats=evaluated["evals"], eval_dump_rows=dumped, launches_eval=counts_eval,
        default_history=default["history"], launches_default=counts_default,
        seconds=[round(b - a, 2) for a, b in zip(stamps, stamps[1:])])
    # an epoch: 128 files / (2 x 32) = 2 optimizer steps = 4 micro-batches; an
    # evaluation: 64 files / 32 = 2 batches, with the raw and the EMA weights
    train, evals = 8, 8
    check(counts == {"hist_planes_cols": train + evals, "mlp_fused": 12 * (train + evals),
                     "mlp_fused_bwd": 12 * train, "fused_attention": 12 * (train + evals),
                     "fused_attention_bwd": 12 * train},
          f"the toggled finetune run launched {counts}")
    check(counts_resumed == {"hist_planes_cols": 8, "mlp_fused": 96, "mlp_fused_bwd": 48,
                             "fused_attention": 96, "fused_attention_bwd": 48},
          f"the resumed finetune run launched {counts_resumed}")
    check(counts_eval == {"hist_planes_cols": 2, "mlp_fused": 24, "fused_attention": 24},
          f"--eval launched {counts_eval}")
    check(counts_default == {"hist_planes_cols": 6, "fused_attention_flat": 72,
                             "fused_attention_flat_bwd": 48},
          f"the default-toggle finetune run launched {counts_default}")
    check([h[0] for h in first["history"]] == [0, 1, 2, 3]
          and [h[0] for h in resumed["history"]] == [4, 5],
          f"finetune read back steps {first['history']} and, resumed, {resumed['history']}")
    check(all(np.isfinite(h[1]) and np.isfinite(h[2]) for r in (first, resumed, default)
              for h in r["history"]), "non-finite finetune losses")
    check({"checkpoint-0.pth", "checkpoint-1.pth"} <= set(written), f"checkpoints {written}")
    check(int(payload["epoch"]) == 2 and "ema" in payload and "optimizer" in payload,
          "checkpoint-2.pth is not the resumed run's")
    for _, stats, ema_stats in first["evals"] + resumed["evals"] + evaluated["evals"]:
        for st in (stats, ema_stats):
            check(st is None or (np.isfinite(st["loss"]) and 0 <= st["acc1"] <= st["acc5"] <= 100),
                  f"finetune eval stats {st}")
    check(len(first["evals"]) == 2 and first["evals"][0][2] is not None
          and evaluated["evals"][0][0] == 2 and dumped == N_VAL_FILES,
          f"finetune evaluations {first['evals']}, --eval {evaluated['evals']}, dump {dumped}")
    return counts


def time_finetune(torch, dev, gpu, g):
    """K6f, K6b, K5a and K5c beside their plain versions (in turns), their
    bounds and, for K5, one SDPA call on (B, H, N, D), at the finetune
    micro-batch FT_B; the F.linear -> F.gelu -> F.linear chain and its
    autograd backward as information (no single library call computes K6).
    The finetune step's timing and profile are tools/trace_finetune.py's."""
    import torch.nn.functional as Fn

    from mem_tpu_torch.ops import attention as A
    from mem_tpu_torch.ops import mlp as M

    bf = torch.bfloat16
    x, w1, b1, w2, b2, do = mlp_operands(torch, g, FT_ROWS, 768, 3072, bf, dev)
    _, h = M.mlp_fused_reference(x, w1, b1, w2, b2)
    k6f = in_turns(torch, lambda: M.mlp_fused_reference(x, w1, b1, w2, b2),
                   lambda: M.mlp_fwd_2d(x, w1, b1, w2, b2, True), runs=8)
    t_no_h = time_ms(lambda: M.mlp_fwd_2d(x, w1, b1, w2, b2, False), runs=8)
    k6b = in_turns(torch, lambda: M.mlp_fused_bwd_reference(do, h, x, w1, w2),
                   lambda: M.mlp_bwd_2d(do, h, x, w1, w2), runs=8)
    # device ms per launch of each kernel of the Hopper path: K6f's two
    # products, K6b's three and its two sum passes
    fwd_parts = {f: kernel_device_ms(lambda: M.mlp_fwd_2d(x, w1, b1, w2, b2, True), (f,),
                                     n=5, per_launch=True)
                 for f in ("mlp_gemm_f1", "mlp_gemm_f2")}
    bwd_parts = {f: kernel_device_ms(lambda: M.mlp_bwd_2d(do, h, x, w1, w2), (f,), n=5,
                                     per_launch=True)
                 for f in ("mlp_gemm_b1", "mlp_gemm_b2", "mlp_gemm_wgrad", "mlp_colsum",
                           "mlp_wgrad_sum")}
    dev_sum = lambda parts: None if None in parts.values() else sum(parts.values())  # noqa: E731
    w1t, w2t = w1.t().contiguous().requires_grad_(), w2.t().contiguous().requires_grad_()
    xg = x.clone().requires_grad_()
    chain = lambda: Fn.linear(Fn.gelu(Fn.linear(xg, w1t, b1)), w2t, b2)  # noqa: E731
    t_chain = time_ms(chain, runs=8)
    y = chain()
    chain_b = lambda: torch.autograd.grad(y, (xg, w1t, w2t), do,  # noqa: E731
                                          retain_graph=True)
    t_chain_b = time_ms(chain_b, runs=8)
    chain_dev = kernel_device_ms(chain, ("",)), kernel_device_ms(chain_b, ("",))
    flop = 4 * FT_ROWS * 768 * 3072
    path = M.cuda_kernel_path(x, 3072)
    for name, (t_k, t_p), bnd, parts, extra in (
            ("time_k6f", k6f, mlp_fwd_bound(FT_ROWS, 768, 3072), fwd_parts,
             dict(kernel_ms_save_h_false=t_no_h,
                  bound_ms_save_h_false=mlp_fwd_bound(FT_ROWS, 768, 3072, False)[0],
                  linear_gelu_linear_ms=t_chain, linear_gelu_linear_device_ms=chain_dev[0],
                  products=2)),
            ("time_k6b", k6b, mlp_bwd_bound(FT_ROWS, 768, 3072), bwd_parts,
             dict(linear_gelu_linear_backward_ms=t_chain_b,
                  linear_gelu_linear_backward_device_ms=chain_dev[1],
                  wgrad_chunks=M.wgrad_chunk_plan(FT_ROWS),
                  workspace_mb=round(2 * FT_ROWS * 3072 * 2 / 1e6, 1), products=4))):
        t_dev = dev_sum(parts)
        say(name, gpu=gpu, rows=FT_ROWS, shape=[768, 3072], dtype="bfloat16", kernel=path,
            kernel_ms=t_k, kernel_device_ms=t_dev, kernel_device_ms_by_launch=parts,
            plain_ms=t_p, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
            kernel_tflop_s=extra["products"] * flop / 2 / t_k / 1e9,
            kernel_device_tflop_s=None if not t_dev else extra["products"] * flop / 2 / t_dev / 1e9,
            **extra)
    del x, w1, b1, w2, b2, do, h, w1t, w2t, xg, y
    torch.cuda.empty_cache()

    q, k, v, do = (torch.randn(FT_B, 12, 197, 64, device=dev, dtype=bf) for _ in range(4))
    bias = torch.randn(12, 197, 197, device=dev)
    k5a = in_turns(torch, lambda: A.fused_attention_reference(q, k, v, bias, 0.125),
                   lambda: A.fused_attention(q, k, v, bias, 0.125), runs=10)
    k5c = in_turns(torch, lambda: A.fused_attention_bwd_reference(q, k, v, bias, do, 0.125),
                   lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125), runs=10)
    k5_dev = (kernel_device_ms(lambda: A.fused_attention(q, k, v, bias, 0.125),
                               ("attention_long_fwd_wgmma",), per_launch=True),
              body_device_ms(lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125),
                             ("attention_long_bwd_rows_wgmma", "attention_long_bwd_cols_wgmma",
                              "attention_long_bwd_bias_sum")))
    flat = lambda t: t.transpose(1, 2).reshape(FT_B, 197, 768).contiguous()  # noqa: E731
    fq, fk, fv, fdo = flat(q), flat(k), flat(v), flat(do)
    t_k2f = time_ms(lambda: A.fused_attention_flat(fq, fk, fv, bias, 0.125), runs=10)
    t_k2b = time_ms(lambda: A.fused_attention_flat_bwd(fq, fk, fv, bias, fdo, 0.125),
                    runs=10)
    mask = bias.to(bf)[None].contiguous().requires_grad_()
    qh, kh, vh = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa = lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,  # noqa: E731
                                                   scale=0.125)
    t_lib_f = time_ms(sdpa, runs=10)
    out = sdpa()
    lib_bwd = lambda: torch.autograd.grad(out, (qh, kh, vh, mask), do,  # noqa: E731
                                          retain_graph=True)
    t_lib_b = time_ms(lib_bwd, runs=10)
    lib_dev = kernel_device_ms(sdpa, ("",)), kernel_device_ms(lib_bwd, ("",))
    for name, (t_k, t_p), t_dev, t_lib, t_lib_dev, t_k2, bnd, n_prod in (
            ("time_k5a", k5a, k5_dev[0], t_lib_f, lib_dev[0], t_k2f,
             attention_fwd_bound(FT_B, 197, 12, 64), 2),
            ("time_k5c", k5c, k5_dev[1], t_lib_b, lib_dev[1], t_k2b,
             attention_bwd_bound(FT_B, 197, 12, 64), 5)):
        say(name, gpu=gpu, batch=FT_B, shape=[12, 197, 64], dtype="bfloat16", kernel_ms=t_k,
            kernel_device_ms=t_dev, plain_ms=t_p, sdpa_ms=t_lib, sdpa_device_ms=t_lib_dev,
            flat_kernel_ms=t_k2,
            bound_ms=bnd[0], bound_by=bnd[1],
            kernel_tflop_s=n_prod * 2 * FT_B * 12 * 197 * 197 * 64 / t_k / 1e9)
    del q, k, v, do, bias, fq, fk, fv, fdo, mask, qh, kh, vh, out
    torch.cuda.empty_cache()

    return dict(k6f_ms=k6f, k6b_ms=k6b, k5a_ms=(*k5a, t_lib_f), k5c_ms=(*k5c, t_lib_b))


def run_finetune_slice(torch, dev, gpu, g, data_root, tmp_root):
    """The classification finetune slice at full width: K6 and K5 against
    their plain versions, one finetune step card against CPU, the CLI with the
    toggles on (with a resume and --eval) and off, the CLI at N = 401 (K5b and
    K5d; the einsum path), and the kernel timings. Returns the toggled runs' launch
    counts, the kernels' errors and their times."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    k6f_err, k6b_err = check_k6f(torch, dev, g), check_k6b(torch, dev, g)
    k5a_err, k5c_err = check_k5a(torch, dev, g), check_k5c(torch, dev, g)
    # a pretraining-schema checkpoint (pt_vit at 224^2: one shared 14x14
    # rel-pos table, mask_token, lm_head), weights drawn from a seed
    pt = R.build_model(R.get_args(["--config", "configs/ncaltech.conf"]), torch.float32,
                       torch.device("cpu"))
    pt.init_weights(torch.Generator().manual_seed(1))
    pretrained = os.path.join(tmp_root, "pt_vit_b16_seed1.pth")
    torch.save({"model": pt.state_dict(), "epoch": 0}, pretrained)
    del pt
    flags = finetune_flags(data_root, pretrained, os.path.join(tmp_root, "ft_out"))
    check_finetune_step(torch, dev, flags)
    counts = run_finetune_cli(torch, flags)
    counts_n401 = run_finetune_n401(torch, data_root, tmp_root)
    times = time_finetune(torch, dev, gpu, g)
    return dict(counts=counts, counts_n401=counts_n401, k6f_err=k6f_err, k6b_err=k6b_err,
                k5a_err=k5a_err, k5c_err=k5c_err, **times)


# ---------------------------------------------------------------------------
# the chained dispatch slice: --steps_per_dispatch K as one CUDA graph
# ---------------------------------------------------------------------------

CHAIN_K = 8              # the CLIs' default --steps_per_dispatch
CHAIN_B = 64             # the full-width pretraining chain's batch
CHAIN_SMALL_K = 3        # the depth-4 chains: chunks of 3 and 3, then a tail of 2
CHAIN_DEPTH = 4
CHAIN_SMALL_B = 4        # their batch (the seg chain's: 2)
CHAIN_READ_STEPS = 8     # optimizer steps in each K=1 / K=8 reading
# the bf16 chains, graph form against the stock form (chain_gaps: the
# largest metric gap relative to the metric's largest value in the run; the
# L2 gap of all tensors relative to their whole movement). The two forms
# differ by the rounding of the schedule and the bias corrections (f32
# against f64, ~1e-7 of an update); bf16 products carry it into the
# gradients and Adam into every later update. Measured on an H100 80GB HBM3
# at 700 W (PERF.md): metric gaps up to 1.9e-2 (pretraining), total tensor
# gaps up to 9.3e-3 (the MAE); the frozen lr moved the MAE's tensors by
# 9.9e-2 of their movement, the frozen batch op by 0.22. One tensor's gap is
# not gated: a bias with a ~0 gradient (the MAE's qkv key bias) moves by
# noise alone (0.60 of its movement). The metric bound is a sanity bound.
CHAIN_TOL = {"metric": 1e-1, "state_total": 3e-2}


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` within the block."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def chain_blocks(batches, ks):
    """Host batches stacked into one (k, ...) block per chunk length of
    ``ks``, taken in turn (and around again when they run out)."""
    out, i = [], 0
    for k in ks:
        bl = [batches[(i + j) % len(batches)] for j in range(k)]
        out.append({key: np.stack([b[key] for b in bl]) for key in bl[0]})
        i += k
    return out


def split_batch(batch, n):
    """A host batch cut into ``n`` batches along its first axis."""
    b = len(batch["aug_seed"]) // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()} for i in range(n)]


class ChainRun:
    """One chain driven over host (k, ...) blocks as a CLI drives it: each
    block copied to the card by data/prefetch.py's ``device_prefetch`` with
    the chain's own keywords (a graph chain's blocks land in its input
    slots; the eager form keeps the batch ops on the host), chunk
    ``thread_at`` called from a fresh thread: each chunk's metrics and
    launch counts and the peak memory."""

    def __init__(self, torch, chain, blocks, it0s, scheds=None, thread_at=None):
        from mem_tpu_torch.data.prefetch import device_prefetch
        from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
        from mem_tpu_torch.train.chain import prefetch_args

        self.metrics, self.counts = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fed = device_prefetch(iter(blocks), "cuda", **prefetch_args(chain))
        for c, (blk, it0) in enumerate(zip(fed, it0s)):
            kw = {} if scheds is None else {"sched": scheds[c]}
            reset_launch_counts()
            if c == thread_at:
                box = {}

                def call():
                    try:
                        box["m"] = chain(blk, it0, **kw)
                        torch.cuda.synchronize()
                    except BaseException as e:   # raised again on this thread
                        box["error"] = e

                th = threading.Thread(target=call, name="chain_replay")
                th.start()
                th.join()
                if "error" in box:
                    raise box["error"]
                m = box["m"]
            else:
                m = chain(blk, it0, **kw)
            torch.cuda.synchronize()
            self.counts.append(launch_counts())
            self.metrics.append({k: v.detach().float().cpu() for k, v in m.items()})
        self.peak_gb = torch.cuda.max_memory_allocated() / 2**30


def chain_state(model, extra=None):
    """Copies of the model's parameters and buffers and of the ``extra``
    tensors (the EMA)."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i, t in enumerate(extra or []):
        out[f"extra.{i}"] = t.detach().clone()
    return out


def stock_form():
    """Chains made inside the block take the eager form whatever their
    optimizer: the step-at-a-time update with host floats, the batch ops
    read on the host (the reference the graph chains are held against)."""
    from mem_tpu_torch.train import chain as C

    return patched(C, "eager_reason", lambda *a, **k: "the stock form of the check")


def chain_gaps(torch, graph, stock, state_g, state_s, state_0):
    """How far a graph run lies from the stock run. ``metric``: the largest
    |graph - stock| of a metric over every chunk and step, relative to the
    largest |stock| of that metric in the run (an accuracy near 0 early on
    does not blow it up), and its name. Over the float parameters, buffers and extra
    tensors, against how far the stock run moved each from ``state_0``:
    ``state``, the largest L2 gap of one tensor relative to its own movement
    (a tensor neither run moved: 0), and its name; ``state_total``, the L2
    gap of all of them relative to their whole movement (a tensor that
    barely moves, a bias whose gradient is ~0, cannot dominate it);
    ``state_abs``, the largest absolute difference."""
    metric, metric_worst = 0.0, None
    for k in stock.metrics[0]:
        g = torch.cat([m[k].reshape(-1) for m in graph.metrics]).double()
        st = torch.cat([m[k].reshape(-1) for m in stock.metrics]).double()
        gap = ((g - st).abs().max() / (st.abs().max() + 1e-6)).item()
        if gap > metric:
            metric, metric_worst = gap, k
    state, worst, state_abs, gap2, moved2 = 0.0, None, 0.0, 0.0, 0.0
    for name, vs in state_s.items():
        if not vs.is_floating_point():
            continue
        diff = state_g[name].double() - vs.double()
        d = diff.norm().item()
        moved = (vs.double() - state_0[name].double()).norm().item()
        gap2, moved2 = gap2 + d * d, moved2 + moved * moved
        if not d:
            continue
        rel = d / moved if moved else float("inf")
        if rel > state:
            state, worst = rel, name
        state_abs = max(state_abs, diff.abs().max().item())
    total = (gap2 ** 0.5 / moved2 ** 0.5) if moved2 else (float("inf") if gap2 else 0.0)
    return dict(metric=metric, metric_worst=metric_worst, state=state, state_worst=worst,
                state_total=total, state_abs=state_abs)


def check_chain_pair(torch, tag, make, blocks, it0s, kernels, tol, scheds=None, thread_at=None,
                     fault=None):
    """``make()`` -> (model, chain, extra tensors), twice from one seed: one
    chain in the stock form (:func:`stock_form`) and one in the graph form,
    driven over the same host blocks. Without ``fault``, checks that the
    graph run lies within ``tol`` (bounds on some of the gaps of
    :func:`chain_gaps`) of the stock one and that each chunk launched each
    of ``kernels`` k times its per-step count in both forms (the replays
    counted through their capture); returns the facts. With ``fault`` (a
    context manager around the graph chain's making and run) returns
    whether the gate held, which it must not."""
    with stock_form():
        model_s, chain_s, extra_s = make()
    check(chain_s.form == "eager", f"{tag}: the stock run is {chain_s.describe(0)}")
    state_0 = chain_state(model_s, extra_s)
    stock = ChainRun(torch, chain_s, blocks, it0s, scheds)
    state_s = chain_state(model_s, extra_s)
    del model_s, chain_s, extra_s
    torch.cuda.empty_cache()
    with (fault() if fault else contextlib.nullcontext()):
        model_g, chain_g, extra_g = make()
        check(chain_g.form == "graph", f"{tag}: {chain_g.describe(0)}")
        graph = ChainRun(torch, chain_g, blocks, it0s, scheds, thread_at)
    state_g = chain_state(model_g, extra_g)
    gaps = chain_gaps(torch, graph, stock, state_g, state_s, state_0)
    ks = [int(next(iter(b.values())).shape[0]) for b in blocks]
    out = dict(chunks=ks, gaps=gaps, tol=tol, tensors=len(state_s),
               graphs=len(chain_g.graphs), peak_gb_graph=round(graph.peak_gb, 2),
               peak_gb_stock=round(stock.peak_gb, 2))
    del model_g, chain_g, extra_g, state_g, state_s, state_0
    torch.cuda.empty_cache()
    held = all(gaps[key] <= bound for key, bound in tol.items())
    if fault:
        say("chain_fault", run=tag, gate_held=held, **out)
        return held
    per_step = {n: stock.counts[0].get(n, 0) / ks[0] for n in kernels}
    for c, k in enumerate(ks):
        for n in kernels:
            want = per_step[n] * k
            check(per_step[n] >= 1 and stock.counts[c].get(n, 0) == want
                  and graph.counts[c].get(n, 0) == want,
                  f"{tag} chunk {c} (k={k}): {n} launched {graph.counts[c].get(n, 0)} times "
                  f"in the graph, {stock.counts[c].get(n, 0)} in the stock form, not {want}")
    say("chain_check", run=tag, per_step_launches=per_step,
        losses=[m["loss"].tolist() for m in graph.metrics], **out)
    check(held, f"{tag}: the graph chain lies {gaps} from the stock form, beyond {tol}")
    return out


def pretrain_chain_maker(torch, dev, args, vae, pp):
    """make() for check_chain_pair: the CLI's model at ``args``'s widths
    (pt_vit, or the MAE under --MAE 1) in bf16, its optimizer, schedules
    that change every step, and its chain."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.schedules import cosine_scheduler
    from mem_tpu_torch.train.steps import make_mae_train_step, make_pretrain_train_step

    lr = cosine_scheduler(args.lr, args.min_lr, 1, 64, warmup_steps=8,
                          start_warmup_value=args.warmup_lr)
    wd = cosine_scheduler(args.weight_decay, 0.2, 1, 64)

    def make():
        model = R.build_model(args, torch.bfloat16, dev)
        model.init_weights(torch.Generator().manual_seed(args.seed))
        opt = create_optimizer(model, args.lr, args.weight_decay)
        if args.MAE:
            chain = make_mae_train_step(model, opt, pp, lr, wd, args.clip_grad, args.seed,
                                        chain=True)
        else:
            chain = make_pretrain_train_step(model, vae, opt, pp, lr, wd, args.clip_grad,
                                             args.seed, chain=True)
        return model, chain, None
    return make


def read_chain_speed(torch, gpu, tag, step, chain, batch, block, batch_size):
    """Wall ms a step and the card's busy share at K=1 (``step`` on
    ``batch``) and at K = the block's length (``chain`` on ``block``), over
    CHAIN_READ_STEPS optimizer steps after a warm-up (two steps; the chain's
    first chunk and its capture) by tools/step_timers.trace_steps: the timed
    window's median call, and the profiled window's kernel time, kernels a
    step, the gap a step between them (wall - device) and the device ms a
    step of each kernel family."""
    from mem_tpu_torch.tools.step_timers import family, trace_steps

    k = int(next(iter(block.values())).shape[0])
    out = {}
    for K in (1, k):
        if K == 1:
            for i in range(2):
                step(batch, i)
            calls = [lambda i=i: step(batch, 2 + i) for i in range(CHAIN_READ_STEPS)]
        else:
            for c in range(2):
                chain(block, c * k)
            calls = [lambda c=c: chain(block, (2 + c) * k) for c in range(CHAIN_READ_STEPS // k)]
        res = trace_steps(calls, "cuda")
        wall = res["wall_ms"] / K
        device = sum(us for _, _, us in res["records"]) / 1e3 / CHAIN_READ_STEPS
        kernels = sum(n for _, n, _ in res["records"]) / CHAIN_READ_STEPS
        fams = collections.Counter()
        for name, _, us in res["records"]:
            fams[family(name)] += us / 1e3 / CHAIN_READ_STEPS
        out[f"K{K}"] = dict(wall_ms_step=wall, device_ms_step=device, busy=device / wall,
                            kernels_step=kernels, gap_ms_step=wall - device,
                            gap_us_per_kernel=1e3 * (wall - device) / max(kernels, 1),
                            families_ms_step=dict(fams.most_common(8)),
                            peak_gb=res["peak_bytes"] / 2**30)
    say("chain_reading", gpu=gpu, run=tag, batch=batch_size, steps=CHAIN_READ_STEPS, **out)
    check(all(v["device_ms_step"] > 0 for v in out.values()),
          f"{tag}: a reading recorded no device time: {out}")
    return out


def read_batch_ops(torch, dev, gpu, pp, host):
    """RandAugment with batch ops (``--rand_aug_batch_ops 1``, two rounds)
    on the pretraining recipe's uint8 canvases (``host``'s batch): the
    device ms of the host branch, the mean over the 14 ops (the
    step-at-a-time run and the eager chain), of the device choice of the
    graph form (rand_augment.select_op, any op), and of the plain device
    choice (every op on the batch, one kept), by torch.profiler over three
    calls each."""
    from mem_tpu_torch.data import device_pipeline as DP
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.ops import rand_augment as ra

    got = {}

    def grab(u8, ops, bins, signs, batch_ops=None, **kw):
        got.update(u8=u8, ops=ops, bins=bins, signs=signs, kw=kw)
        return ra.rand_augment_batch(u8, ops, bins, signs, batch_ops, **kw)

    with patched(DP, "rand_augment_batch", grab):
        DP.preprocess_batch(to_device(host, dev), pp, is_train=True)
    u8, ops, bins, signs = got["u8"], got["ops"], got["bins"], got["signs"]
    rounds = ops.shape[1]

    def every_op(op):   # the plain device choice: each op on the batch, one kept
        img = u8.float()
        table = ra.magnitude_table(u8.shape[1], u8.shape[2], device=dev)
        for r in range(rounds):
            mag = ra.signed_magnitudes(table, ops[:, r], bins[:, r], signs[:, r])
            out = img
            for j in range(ra.NUM_OPS):
                out = torch.where(op[r] == j, ra.apply_op(img, j, mag), out)
            img = out
        return torch.clamp(img, 0, 255).to(torch.uint8)

    fixed = [torch.full_like(ops, j) for j in range(ra.NUM_OPS)]
    host_ms = kernel_device_ms(lambda: [
        ra.rand_augment_batch(u8, fixed[j], bins, signs, np.full(rounds, j))
        for j in range(ra.NUM_OPS)], ("",), n=3) / ra.NUM_OPS
    op_t = torch.full((rounds,), ra.NUM_OPS - 1, dtype=torch.int32, device=dev)
    select_ms = kernel_device_ms(lambda: ra.rand_augment_batch(u8, ops, bins, signs, op_t),
                                 ("",), n=3)
    every_ms = kernel_device_ms(lambda: every_op(op_t), ("",), n=3)
    out = dict(batch=int(u8.shape[0]), canvas=list(u8.shape[1:3]), rounds=rounds,
               host_branch_mean_ms=host_ms, select_op_device_ms=select_ms,
               every_op_device_ms=every_ms)
    say("chain_batch_ops_reading", gpu=gpu, **out)
    check(select_ms > 0 and every_ms > 0, f"batch-op reading recorded nothing: {out}")
    return out


# the small optimizer chains (a f32 model with layer-decay and no-decay
# groups): the device path rounds lr * scale, 1 - lr * wd and the bias
# corrections in f32 where the stock update works in f64, ~1e-7 of an
# update a step (on the CPU 1.2e-7 absolute after six steps,
# tests/test_torch_chain.py); a decay on a no-decay group moves a LayerNorm
# weight by wd = 5 % of its movement a step, a dropped scale by 25 % or more
CHAIN_OPT_TOL = {"metric": 1e-4, "state": 1e-3}


def check_chain_optimizers(torch, dev, sgd_capture):
    """Each --opt the graph form takes, on a chain of a small f32 model with
    layer-decay scales and no-decay groups (K=3, chunks 3, 3 and 2, lr and
    wd changing every step): the graph chain against its stock form within
    CHAIN_OPT_TOL; two planted faults in the graph form's schedule (the
    decay on the no-decay groups, the layer-decay scale dropped) must fail
    that gate; SGD, which the chain runs eagerly, must fail to capture when
    forced into a graph (the reason the chain gives for it: ``sgd_capture``
    waits for :func:`forced_capture`'s process)."""
    from mem_tpu_torch.train import chain as C
    from mem_tpu_torch.train import optim as O

    g = torch.Generator().manual_seed(3)
    xs = torch.randn(8, 16, 4, 256, generator=g).numpy()
    blocks = [{"x": xs[i:i + k]} for i, k in ((0, 3), (3, 3), (6, 2))]

    class Layered(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pos_embed = torch.nn.Parameter(0.02 * torch.randn(1, 4, 256))
            self.blocks = torch.nn.ModuleList(
                torch.nn.Sequential(torch.nn.LayerNorm(256), torch.nn.Linear(256, 256))
                for _ in range(2))
            self.head = torch.nn.Linear(256, 256)

        def forward(self, x):
            x = x + self.pos_embed
            for b in self.blocks:
                x = x + torch.relu(b(x))
            return self.head(x)

    def make(name, moment_dtype=None):
        def build():
            torch.manual_seed(0)
            model = Layered().to(dev)
            opt = O.create_optimizer(model, 1e-3, 0.05, opt=name, moment_dtype=moment_dtype,
                                     layer_decay=0.75, num_layers=2)

            def body(batch, gen, sched):
                x = batch["x"]
                loss = (model(x) - x).square().mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                O.set_schedule(opt, sched["lr"], sched["wd"])
                opt.step()
                return {"loss": loss.detach()}

            chain = C.Chain(body, device=dev, seed=0, optimizer=opt,
                            sched_fn=lambda it: {"lr": 1e-3 * (1 + 0.1 * it),
                                                 "wd": 0.05 * (1 - 0.02 * it)})
            return model, chain, None
        return build

    def decay_on_no_decay_groups():
        real = O.DeviceSchedule.__init__

        def init(self, optimizer, device):
            real(self, optimizer, device)
            for i, grp in enumerate(optimizer.param_groups):
                if not grp["decays"]:
                    self.wd[i] = torch.zeros((), device=device)
        return patched(O.DeviceSchedule, "__init__", init)

    def lr_scale_dropped():
        real = O.DeviceSchedule.__init__

        def init(self, optimizer, device):
            real(self, optimizer, device)
            for grp in optimizer.param_groups:
                grp["lr_scale"] = 1.0
        return patched(O.DeviceSchedule, "__init__", init)

    out = {}
    for name, md in (("adamw", None), ("adamw", torch.bfloat16), ("adam", None),
                     ("nadam", None), ("rmsprop", None), ("adadelta", None)):
        tag = f"{name}{'_bf16_moments' if md else ''}"
        out[tag] = check_chain_pair(torch, f"opt_{tag}", make(name, md), blocks, [0, 3, 6], (),
                                    CHAIN_OPT_TOL)
    held = {f"{name}_{f.__name__}": check_chain_pair(
        torch, f"opt_{name}_{f.__name__}", make(name), blocks, [0, 3, 6], (), CHAIN_OPT_TOL,
        fault=f) for name in ("adamw", "adam") for f in (decay_on_no_decay_groups,
                                                           lr_scale_dropped)}
    check(not any(held.values()), f"a planted schedule fault passed the gate: {held}")
    out["faults"] = held
    # a failed capture leaves the default CUDA generator mid-capture for the
    # rest of its process: the forced captures run in a process of their own
    for name, (reason, error) in sgd_capture().items():
        out[name] = {"reason": reason, "forced_capture_error": error}
        say("chain_optimizer_refused", opt=name, reason=reason, forced_capture_error=error)
        check(reason is not None and "SGD" in reason, f"{name}: the chain would capture it")
        check(error is not None, f"{name}: a forced capture went through")
    return out


def forced_capture(case):
    """Start ``forced_case(case)`` in a process of its own (a failed capture
    leaves the default CUDA generator mid-capture for the rest of its
    process); the returned function waits for it and gives {name: (the
    chain's eager reason, the capture's error or None)}."""
    code = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as S; "
            f"print(S.forced_case(torch, torch.device('cuda'), {case!r}))")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)   # a failed check before the wait leaves no process behind

    def result():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            stop()
        check(proc.returncode == 0, f"the forced capture {case}: {err[-2000:]}")
        return json.loads(out.strip().splitlines()[-1])
    return result


def forced_case(torch, dev, case):
    """A small MLP chain forced to capture what a graph cannot hold: ``sgd``
    (torch.optim.SGD, made in the graph form by setting aside the chain's
    reason for the eager one), or ``unregistered_generator`` (AdamW, its
    body drawing dropout from the chain's generator, which the fault keeps
    from being registered with the graph). Returns {case: (the chain's eager
    reason, the capture's error or None)} as JSON."""
    from mem_tpu_torch.train import chain as C
    from mem_tpu_torch.train.optim import create_optimizer, set_schedule

    xs = torch.randn(8, 16, 256, generator=torch.Generator().manual_seed(3)).to(dev)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(256, 512), torch.nn.ReLU(),
                                torch.nn.Linear(512, 256)).to(dev)
    opt = create_optimizer(model, 1e-3, 0.05, opt="sgd" if case == "sgd" else "adamw")

    def body(batch, gen, sched):
        x = batch["x"] * (torch.rand(batch["x"].shape, generator=gen, device=dev) < 0.9)
        loss = (model(x) - batch["x"]).square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        set_schedule(opt, sched["lr"], sched["wd"])
        opt.step()
        return {"loss": loss.detach()}

    reason, error = C.eager_reason(dev, opt), None
    forced = (patched(C, "eager_reason", lambda *a, **k: None) if case == "sgd" else
              patched(torch.cuda.CUDAGraph, "register_generator_state", lambda self, g: None))
    with forced:
        chain = C.Chain(body, device=dev, seed=0, optimizer=opt,
                        sched_fn=lambda it: {"lr": 1e-3, "wd": 0.05})
        try:
            for i in range(3):
                chain({"x": xs[3 * i:3 * i + 2]}, 2 * i)
            torch.cuda.synchronize()
        except Exception as e:   # the capture's own error
            error = repr(e)[:200]
    return json.dumps({case: (reason, error)})


def run_chain_slice(torch, dev, gpu, data_root, vae_path, tmp_root):
    """Chained dispatch on the card (train/chain.py): the graph form of each
    training chain against its stock form (the step-at-a-time update and
    batch ops) within CHAIN_TOL, with exact launches and peak memory;
    pretraining at full width (B=64, K=8, a tail chunk, one replay from a
    fresh thread), the MAE, the finetune with EMA, seg training and the VAE
    at depth 4 (K=3, a tail chunk); three planted faults on the MAE chain
    that must fail the gate; then the K=1 and K=8 readings of the
    pretraining recipe at B=128 and train_seg's at B=8, and the batch ops'
    device ms."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.cli import train_vae as V
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.data import device_pipeline as DP
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                                 draw_seg_train_aug, scan_seg_pairs)
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.train import chain as C
    from mem_tpu_torch.train.schedules import VaeAnnealState, poly_lr_schedule
    from mem_tpu_torch.train.steps import make_vae_train_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
            "--discrete_vae_weight_path", vae_path, "--num_workers", "4", "--device", "cuda"]

    def on_card(blocks):
        return [to_device(b, dev, host_keys=()) for b in blocks]

    parts, clock = {}, [t0]

    def part(name):   # the seconds of each part of the slice
        now = time.perf_counter()
        parts[name], clock[0] = round(now - clock[0], 1), now

    # the forced captures run beside the first checks, each in a process of its own
    sgd_capture, unregistered = forced_capture("sgd"), forced_capture("unregistered_generator")
    facts = {"optimizers": check_chain_optimizers(torch, dev, sgd_capture)}
    part("optimizers")
    # -- full width: pretraining ViT-B/16 at B=64, chunks of 8, 8, 8, 8 and 3
    # (the warm-up, a capture on each set of input slots, a replay from a
    # fresh thread, the tail)
    args = R.get_args(base + ["--batch_size", str(CHAIN_B)])
    host = [host_train_batch(args, CHAIN_B, i) for i in range(2)]
    pp, host = host[0][0], [h for _, h in host]
    vae = R.load_vae(args, dev)
    ks = [CHAIN_K] * 4 + [3]
    it0s = [int(x) for x in np.cumsum([0] + ks[:-1])]
    facts["pretrain"] = check_chain_pair(
        torch, "pretrain_b64_k8", pretrain_chain_maker(torch, dev, args, vae, pp),
        chain_blocks(host, ks), it0s,
        ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"), CHAIN_TOL,
        thread_at=3)
    part("pretrain")

    # -- depth 4 at full width, K=3 (chunks 3, 3 and 2)
    ks, it0s = [CHAIN_SMALL_K, CHAIN_SMALL_K, 2], [0, 3, 6]
    depth = ["--transformer_depth", str(CHAIN_DEPTH)]
    margs = R.get_args(mae_flags(data_root, os.path.join(tmp_root, "x")) + depth + [
        "--mae_decoder_depth", str(CHAIN_DEPTH), "--device", "cuda"])
    mpp, mhost = vae_host_batch(margs, 4 * CHAIN_SMALL_B, color_jitter=margs.color_jitter)
    mhost = split_batch(mhost, 4)
    for b in mhost:   # each batch its own draws, batch ops included
        b.update(DP.draw_train_aug(b["aug_seed"], mpp, mpp.canvas_h, mpp.canvas_w))
    make_mae = pretrain_chain_maker(torch, dev, margs, None, mpp)
    mae_kernels = ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd")
    facts["mae"] = check_chain_pair(torch, "mae_d4_k3", make_mae, chain_blocks(mhost, ks), it0s,
                                    mae_kernels, CHAIN_TOL)

    # the planted faults, on the MAE chain: each must fail the gate
    def frozen_lr_wd():
        real, first = C.Chain._feed, {}

        def feed(self, g, block, sched):   # later replays keep the first one's values
            real(self, g, block, first.setdefault(id(g), sched))
        return patched(C.Chain, "_feed", feed)

    def frozen_batch_op():
        real, first = DP.rand_augment_batch, mhost[0]["ra_batch_ops"]

        def frozen(u8, ops, bins, signs, batch_ops=None, **kw):   # a host read, once
            return real(u8, ops, bins, signs, None if batch_ops is None else first, **kw)
        return patched(DP, "rand_augment_batch", frozen)

    # six chunks: after the warm-up each of the two k = 3 graphs (one per set
    # of input slots) replays twice
    fks, fit0s = [CHAIN_SMALL_K] * 5 + [2], [0, 3, 6, 9, 12, 15]
    fblocks = chain_blocks(mhost, fks)
    held = {f.__name__: check_chain_pair(torch, f"mae_d4_k3_{f.__name__}", make_mae, fblocks,
                                         fit0s, mae_kernels, CHAIN_TOL, fault=f)
            for f in (frozen_lr_wd, frozen_batch_op)}
    # an unregistered generator: this torch refuses the capture (a process of
    # its own); the gate is then never reached with one mask for every step
    (reason, error), = unregistered().values()
    say("chain_fault", run="unregistered_generator", capture_error=error)
    held["unregistered_generator"] = error is None
    check(not any(held.values()), f"a planted chain fault passed the gate: {held}")
    del fblocks
    part("mae")

    fargs = F.get_args(finetune_flags(data_root, "unused.pth", os.path.join(tmp_root, "x"))
                       + depth + ["--device", "cuda"])
    fpp, mix, micro = finetune_host_batches(fargs, CHAIN_SMALL_B, 4)
    steps = [{k: np.stack([micro[2 * i][k], micro[2 * i + 1][k]]) for k in micro[0]}
             for i in range(2)]
    ref = build_classifier(fargs, fargs.nb_classes, torch.float32, torch.device("cpu"))
    ref.init_weights(torch.Generator().manual_seed(0))
    fsd, flr = ref.state_dict(), np.linspace(1e-4, 4e-4, 64)
    del ref
    facts["finetune"] = check_chain_pair(
        torch, "finetune_ema_d4_k3", lambda: make_finetune_step(
            torch, fargs, fsd, dev, torch.bfloat16, fpp, mix, flr, update_freq=2, ema=True,
            chain=True),
        chain_blocks(steps, ks), it0s,
        ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"), CHAIN_TOL)

    seg_root = os.path.join(tmp_root, "chain_dsec")
    write_seg_pairs(seg_root, "train", 8, np.random.default_rng(28))

    def seg_batches(B, n):
        it = SegBatchIterator(scan_seg_pairs(seg_root, "imgs/train", "anns/train"),
                              SegPipelineConfig(batch_size=B, is_train=True, max_evs=SEG_EVENTS,
                                                presort_y=True))
        out = list(itertools.islice(it.batches(), n))
        for b in out:
            b.update(draw_seg_train_aug(b["aug_seed"], True))
        return out

    seg = build_segmentor(11, 512, 768, 12, 12, torch.float32, torch.device("cpu"))
    seg.init_weights(torch.Generator().manual_seed(0))
    ssd, lr_fn = seg.state_dict(), poly_lr_schedule(5e-4, 64, warmup_iters=4)
    del seg
    # cuDNN's backward of the seg heads' bf16 convolutions picks
    # nondeterministic algorithms (two eager loops differ from the first
    # chunk's grad norm on): both forms run with deterministic ones here
    with patched(torch.backends.cudnn, "deterministic", True):
        facts["seg"] = check_chain_pair(
            torch, "seg_d4_k3",
            lambda: (*make_seg_step(torch, ssd, dev, torch.bfloat16, lr_fn, depth=CHAIN_DEPTH,
                                    chain=True), None),
            chain_blocks(seg_batches(2, 4), ks), it0s,
            ("hist_planes_cols_sorted", "fused_attention_flat_long",
             "fused_attention_flat_long_bwd"), CHAIN_TOL)

    vargs = V.get_args(["--config", "configs/ncaltech.conf", "--data_path", data_root,
                        "--device", "cuda"])
    vpp, vhost = vae_host_batch(vargs, 4 * CHAIN_SMALL_B)
    vhost = split_batch(vhost, 4)
    for b in vhost:
        b.update(DP.draw_train_aug(b["aug_seed"], vpp, vpp.canvas_h, vpp.canvas_w))
    anneal, scheds = VaeAnnealState(vargs.learning_rate, 0.5, 1.0, 0.2, 0.5, every=1), []
    for k in ks:   # the host walks the anneal over each chunk's steps (every step)
        lrs, temps = [], []
        for _ in range(k):
            lrs.append(anneal.lr)
            temps.append(anneal.temp)
            anneal.after_step(anneal.global_step)
        scheds.append({"lr": lrs, "temp": temps})

    def make_vae():
        model = V.build_vae(vargs, torch.bfloat16, dev)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=vargs.learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        return model, make_vae_train_step(model, opt, vpp, vargs.clip, 0, chain=True), None

    facts["vae"] = check_chain_pair(torch, "vae_k3", make_vae, chain_blocks(vhost, ks), it0s,
                                    ("hist_planes_cols",), CHAIN_TOL, scheds=scheds)
    part("finetune_seg_vae")

    # -- readings, no claim: K=1 against K=8
    torch.cuda.empty_cache()
    args = R.get_args(base + ["--batch_size", "128"])
    pp, host = host_train_batch(args, 128)
    lr = np.full(64, args.lr)
    _, step, _ = make_step(torch, R, args, dev, torch.bfloat16, vae, pp, lr)
    _, chain, _ = make_step(torch, R, args, dev, torch.bfloat16, vae, pp, lr, chain=True)
    facts["read_pretrain"] = read_chain_speed(
        torch, gpu, "run_mem_pretraining_b128", step, chain, to_device(host, dev),
        on_card(chain_blocks([host], [CHAIN_K]))[0], 128)
    del step, chain
    part("read_pretrain")
    facts["read_batch_ops"] = read_batch_ops(torch, dev, gpu, pp, host)
    part("read_batch_ops")
    torch.cuda.empty_cache()
    (sb,) = seg_batches(8, 1)
    _, step = make_seg_step(torch, ssd, dev, torch.bfloat16, lr_fn)
    _, chain = make_seg_step(torch, ssd, dev, torch.bfloat16, lr_fn, chain=True)
    facts["read_seg"] = read_chain_speed(
        torch, gpu, "train_seg_b8", step, chain, to_device(sb, dev),
        on_card(chain_blocks([sb], [CHAIN_K]))[0], 8)
    del step, chain, vae
    torch.cuda.empty_cache()
    part("read_seg")
    say("chain_facts", seconds=round(time.perf_counter() - t0, 1), parts=parts)
    return facts


# ---------------------------------------------------------------------------
# the rest of fused_attention: K5b, K5d, K5e (head-major, not head-blocked)
# ---------------------------------------------------------------------------

def check_k5b(torch, dev, g):
    """K5b against its plain version on (B, H, N, D) and against K3f on the
    transposed operands (the same kernel body: bit for bit): the seg
    backbone's shape at B = 8 and 16 and the N = 401 finetune's micro-batch in
    bf16 (tensor cores), a ragged N, f32 (the scalar kernel) and D = 32 in
    bf16 (the D = 32 instantiation); and
    the F3 shape, N = 300 at 12 heads, head-blocked-eligible, which K5a's
    wrapper sends to the same key-tiled kernel under K5a's launch counter.
    Each launch counted once under its branch. Returns the max abs error at
    (8, 12, 1025, 64)."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops import attention as A

    bf, f32, first = torch.bfloat16, torch.float32, None
    for shape, dt in (((8, 12, 1025, 64), bf), ((16, 12, 1025, 64), bf),
                      ((FT_MICRO, 12, 401, 64), bf), ((2, 12, 577, 64), bf),
                      ((3, 12, 300, 64), bf), ((2, 12, 1025, 64), f32), ((2, 12, 577, 32), bf),
                      ((1, 12, 401, 32), f32)):
        tol = K5L_BF16_TOL if dt == bf else K5L_F32_TOL
        q, k, v, _, bias, scale, flat = k5_operands(torch, g, shape, dt, dev)
        name = A.fused_attention_route(*shape[1:3])[0]
        before = launch_counts().get(name, 0)
        o = A.fused_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        launched = launch_counts().get(name, 0) - before
        o_k3f = A.fused_attention_flat_long(flat(q), flat(k), flat(v), bias, scale)
        want = A.fused_attention_long_reference(q, k, v, bias, scale)
        err = rel_max_abs(o, want)
        equal = bool(torch.equal(flat(o), o_k3f))
        path = A.cuda_bhnd_kernel_path(q, k, v, bias)
        say("k5b_check", dtype=str(dt), shape=list(shape), branch=name, launches=launched,
            rel_max_abs=err, tol=tol, equals_k3f_on_transposed=equal, kernel=path)
        check(err <= tol, f"K5b {dt} {shape}: rel max abs err {err} > {tol}")
        check(equal, f"K5b {dt} {shape} differs from K3f on the transposed operands")
        check(launched == 1, f"K5b {dt} {shape}: {launched} launches under {name}")
        check(path == ("tiled_wgmma" if _bf16_wgmma(torch, shape, dt) else "tiled_scalar"),
              f"K5b {dt} {shape} took the {path} kernel")
        if first is None:
            first = (o.float() - want.float()).abs().max().item()
        del q, k, v, bias, o, o_k3f, want
    torch.cuda.empty_cache()
    return first


def _check_k5_bwd(torch, dev, g, tag, cases, autograd_shape):
    """check_k5d / check_k5e: each case against its plain version (dq, dk,
    dv relative max abs; db relative L2) and against K3b on the transposed
    operands (the same kernel body: bit for bit), bit-identical across two
    launches, one launch counted under its branch; then autograd through
    fused_attention at ``autograd_shape`` launches K5b and the backward once
    each. Returns the max abs error of the first case."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops import attention as A

    first = None
    for shape, dt in cases:
        bf16 = dt == torch.bfloat16
        tol = K5L_BF16_TOL if bf16 else K5L_F32_TOL
        q, k, v, do, bias, scale, flat = k5_operands(torch, g, shape, dt, dev)
        name = A.fused_attention_route(*shape[1:3])[1]
        before = launch_counts().get(name, 0)
        got = A.fused_attention_bwd(q, k, v, bias, do, scale)
        again = A.fused_attention_bwd(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        launched = launch_counts().get(name, 0) - before
        k3b = A.fused_attention_flat_long_bwd(flat(q), flat(k), flat(v), bias, flat(do), scale)
        plain = {"fused_attention_bwd": A.fused_attention_bwd_reference,
                 "fused_attention_bwd_whole": A.fused_attention_bwd_whole_reference,
                 "fused_attention_bwd_long": A.fused_attention_bwd_long_reference}[name]
        want = plain(q, k, v, bias, do, scale)
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        db = rel_l2(torch, got[3], want[3])
        equal = all(torch.equal(flat(a), b) for a, b in zip(got[:3], k3b[:3])) \
            and bool(torch.equal(got[3], k3b[3]))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        path = A.cuda_bhnd_bwd_kernel_path(q, k, v, bias)
        say(f"{tag}_check", dtype=str(dt), shape=list(shape), branch=name, launches=launched,
            rel_max_abs=errs, tol=tol, db_rel_l2=db, db_tol=K2B_DB_REL,
            equals_k3b_on_transposed=equal, identical_across_launches=same, kernel=path)
        check(max(errs.values()) <= tol and db <= K2B_DB_REL,
              f"{tag} {dt} {shape}: {errs}, db {db}")
        check(equal, f"{tag} {dt} {shape} differs from K3b on the transposed operands")
        check(same, f"{tag} {dt} {shape}: two launches on the same operands differ")
        check(launched == 2, f"{tag} {dt} {shape}: {launched} launches under {name} for 2 calls")
        check(path == ("tiled_wgmma" if _bf16_wgmma(torch, shape, dt) else "tiled_scalar"),
              f"{tag} {dt} {shape} took the {path} kernels")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        del q, k, v, do, bias, got, again, k3b, want
    torch.cuda.empty_cache()

    B, H, N, D = autograd_shape
    q, k, v = (torch.randn(B, H, N, D, generator=g).to(torch.bfloat16).to(dev).requires_grad_()
               for _ in range(3))
    bias = torch.randn(H, N, N, generator=g).to(dev).requires_grad_()
    do = torch.randn(B, H, N, D, generator=g).to(torch.bfloat16).to(dev)
    names = A.fused_attention_route(H, N)
    before = launch_counts()
    A.fused_attention(q, k, v, bias, 0.125).backward(do)
    torch.cuda.synchronize()
    after = launch_counts()
    launched = {n: after.get(n, 0) - before.get(n, 0) for n in names}
    want = A.fused_attention_bwd_reference(q.detach(), k.detach(), v.detach(), bias.detach(),
                                           do, 0.125)
    errs = [rel_max_abs(t.grad, w) for t, w in zip((q, k, v), want)]
    say(f"{tag}_autograd", shape=list(autograd_shape), launches=launched, rel_max_abs=errs,
        db_rel_l2=rel_l2(torch, bias.grad, want[3]))
    check(launched == {n: 1 for n in names}, f"autograd through fused_attention: {launched}")
    check(max(errs) <= K5L_BF16_TOL, f"autograd grads differ from the plain backward: {errs}")
    del q, k, v, bias, do, want
    torch.cuda.empty_cache()
    return first


def check_k5d(torch, dev, g):
    """K5d (N <= 448, not head-blocked-eligible) at the N = 401 finetune's
    micro-batch and at N = 448 in bf16 (tensor cores), f32 (the scalar
    kernels) and D = 32 in bf16; the F3 shape, N = 300 at 12 heads, which K5c's wrapper
    sends to the same kernels under K5c's counter. Returns the max abs error
    at (FT_MICRO, 12, 401, 64)."""
    bf, f32 = torch.bfloat16, torch.float32
    return _check_k5_bwd(torch, dev, g, "k5d", (
        ((FT_MICRO, 12, 401, 64), bf), ((2, 12, 448, 64), bf), ((3, 12, 300, 64), bf),
        ((2, 12, 401, 64), f32), ((2, 12, 401, 32), bf)), (2, 12, 401, 64))


def check_k5e(torch, dev, g):
    """K5e (N > 448) at train_seg's (16, 12, 1025, 64) and at B = 8 in bf16,
    at the boundary N = 449 and a ragged N = 577 (no multiple of the 64-wide
    tile or of the reference's 256-row block), f32 (the scalar kernels) and
    D = 32 in bf16. Returns the max abs error at (16, 12, 1025, 64)."""
    bf, f32 = torch.bfloat16, torch.float32
    return _check_k5_bwd(torch, dev, g, "k5e", (
        ((16, 12, 1025, 64), bf), ((8, 12, 1025, 64), bf), ((2, 12, 449, 64), bf),
        ((2, 12, 577, 64), bf), ((1, 12, 1025, 64), f32), ((1, 12, 577, 32), bf)),
        (2, 12, 1025, 64))


def time_k5_long(torch, dev, gpu):
    """K5b at the seg backbone's (8, 12, 1025, 64), K5d at the N = 401
    finetune's micro-batch (FT_MICRO, 12, 401, 64) and K5e at train_seg's
    (16, 12, 1025, 64), bf16: each beside its plain version (in turns), one
    scaled_dot_product_attention call on the same (B, H, N, D) operands with
    the bias as its mask (the forward for K5b, the backward through autograd
    for K5d and K5e, the mask's gradient included), the K3 kernel on the
    transposed operands, the profiler's device time per call of the body's
    kernels (K5d / K5e: rows, columns, bias sum), and the bound. Returns
    {name: (ms, plain_ms, sdpa_ms)}."""
    import torch.nn.functional as Fn

    from mem_tpu_torch.ops import attention as A

    out = {}
    for name, (B, N), bwd in (("K5b", (8, 1025), False), ("K5d", (FT_MICRO, 401), True),
                              ("K5e", (16, 1025), True)):
        q, k, v, do = (torch.randn(B, 12, N, 64, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        bias = torch.randn(12, N, N, device=dev)
        flat = lambda t: t.transpose(1, 2).reshape(B, N, 768).contiguous()  # noqa: E731
        fq, fk, fv, fdo = flat(q), flat(k), flat(v), flat(do)
        mask = bias.to(torch.bfloat16)[None].contiguous()
        if bwd:
            t_k, t_p = in_turns(
                torch, lambda: A.fused_attention_bwd_reference(q, k, v, bias, do, 0.125),
                lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125), runs=8)
            t_k3 = time_ms(lambda: A.fused_attention_flat_long_bwd(fq, fk, fv, bias, fdo,
                                                                          0.125), runs=8)
            qh, kh, vh, mh = (t.clone().requires_grad_() for t in (q, k, v, mask))
            o = Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=mh, scale=0.125)
            t_lib = time_ms(lambda: torch.autograd.grad(o, (qh, kh, vh, mh), do,
                                                               retain_graph=True), runs=8)
            t_dev = body_device_ms(lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125),
                                   ("rows_wgmma", "cols_wgmma", "bias_sum"))
            bnd, n_prod = attention_bwd_bound(B, N, 12, 64), 5
            del qh, kh, vh, mh, o
        else:
            t_k, t_p = in_turns(torch, lambda: A.fused_attention_reference(q, k, v, bias, 0.125),
                                lambda: A.fused_attention(q, k, v, bias, 0.125), runs=10)
            t_k3 = time_ms(lambda: A.fused_attention_flat_long(fq, fk, fv, bias, 0.125),
                           runs=10)
            t_lib = time_ms(lambda: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=0.125), runs=10)
            t_dev = body_device_ms(lambda: A.fused_attention(q, k, v, bias, 0.125),
                                   ("attention_long_fwd",))
            bnd, n_prod = attention_fwd_bound(B, N, 12, 64), 2
        say(f"time_{name.lower()}", gpu=gpu, batch=B, shape=[12, N, 64], dtype="bfloat16",
            kernel_ms=t_k, kernel_device_ms=t_dev, plain_ms=t_p, sdpa_ms=t_lib,
            k3_transposed_ms=t_k3,
            bound_ms=bnd[0], bound_by=bnd[1],
            kernel_tflop_s=n_prod * 2 * B * 12 * N * N * 64 / t_k / 1e9)
        out[name] = (t_k, t_p, t_lib)
        del q, k, v, do, bias, fq, fk, fv, fdo, mask
        torch.cuda.empty_cache()
    return out


def run_train_seg_cli_long_off(torch, data_root, pretrained, out_dir):
    """train_seg at full width on the card (B=16, bf16) with FLAT_ATTN_LONG =
    False: 2 iterations, the final evaluation (one batch of 16) and the final
    checkpoint, then test_seg on that checkpoint under the same toggle. The
    seg backbone's N = 1025 is not head-blocked-eligible, so the reference's
    rule sends it to the head-major kernels: K5b 12 times a forward, K5e 12
    times a train step, no K3f, K3b or K5d; K4 once a batch. Returns the
    train_seg run's launch counts."""
    from mem_tpu_torch.cli import test_seg as T
    from mem_tpu_torch.cli import train_seg as S
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    flags = ["--data_root", data_root, "--pretrained", pretrained, "--output_dir", out_dir,
             "--max_iters", "2", "--eval_interval", "4", "--save_interval", "4",
             "--device", "cuda"]
    t0 = time.perf_counter()
    with toggles(flat_attn_long=False):
        reset_launch_counts()                 # just before the main path
        hist = S.main(flags)
        counts = launch_counts()              # just after it
        t1 = time.perf_counter()
        reset_launch_counts()
        stats = T.main(["--data_root", data_root, "--checkpoint",
                        os.path.join(out_dir, "checkpoint-final.pth"), "--device", "cuda"])
        counts_test = launch_counts()
    say("train_seg_cli_flat_attn_long_off", model="EvBEiT ViT-B/16 + UPerNet + FCN",
        tokens=1025, batch=16, dtype="bfloat16", toggles=dict(FLAT_ATTN_LONG=False),
        train_steps=2, eval_forwards=1, history=hist, launches=counts,
        test_seg_mIoU=stats["mIoU"], launches_test_seg=counts_test,
        seconds=[round(t1 - t0, 2), round(time.perf_counter() - t1, 2)])
    check(counts == {"fused_attention_bwd_long": 24, "fused_attention_long": 36,
                     "hist_planes_cols_sorted": 3},
          f"train_seg with FLAT_ATTN_LONG = False launched {counts}")
    check([h[0] for h in hist] == [0] and all(np.isfinite(h[1]) for h in hist),
          f"train_seg with FLAT_ATTN_LONG = False: history {hist}")
    check(np.isfinite(stats["mIoU"]) and 0 <= stats["mIoU"] <= 1
          and counts_test == {"fused_attention_long": 24, "hist_planes_cols_sorted": 2},
          f"test_seg with FLAT_ATTN_LONG = False: mIoU {stats['mIoU']}, launches {counts_test}")
    return counts


def run_finetune_n401(torch, data_root, tmp_root):
    """run_class_finetuning at full width with --input_H / --input_W 320
    (N = 401 tokens: 12 x 401^2 x 4 B of bias is above the head-blocked
    budget, N is at most _WHOLE_BWD_MAX_N), seeded weights (no --finetune),
    bf16, FLAT_ATTN = False, one epoch (4 micro-batches of FT_MICRO) and its
    evaluation (2 batches). With ENABLED = True the reference's rule takes the
    kernels: K5b 12 times a micro-batch forward, K5d 12 times a train
    micro-batch. With ENABLED = False it takes the einsum path at N < 512, as
    the reference does: no K5 at all. Launch counts exact. Returns the first
    run's counts."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    def flags(out):
        return ["--config", "configs/ncaltech.conf", "--data_path", data_root,
                "--output_dir", os.path.join(tmp_root, out), "--nb_classes", "101",
                "--drop", "0", "--batch_size", str(2 * FT_MICRO), "--update_freq", "2",
                "--input_H", str(FT_N401_SIZE), "--input_W", str(FT_N401_SIZE),
                "--mixup_prob", "1.0", "--epochs", "1", "--model_ema", "0",
                "--warmup_steps", "2", "--num_workers", "4", "--device", "cuda"]

    runs, stamps = {}, [time.perf_counter()]
    for name, enabled in (("enabled", True), ("einsum", False)):
        with toggles(flat_attn=False, enabled=enabled):
            reset_launch_counts()             # just before the main path
            r = F.main(flags(f"ft_n401_{name}"))
            runs[name] = (r, launch_counts())  # just after it
        stamps.append(time.perf_counter())
    say("finetune_cli_n401", model="ft_vit", embed_dim=768, depth=12, heads=12,
        img=[FT_N401_SIZE] * 2, tokens=401, classes=101, batch=2 * FT_MICRO, update_freq=2,
        dtype="bfloat16", toggles=dict(FLAT_ATTN=False, ENABLED=[True, False]),
        history={n: r["history"] for n, (r, _) in runs.items()},
        evals={n: r["evals"] for n, (r, _) in runs.items()},
        launches={n: c for n, (_, c) in runs.items()},
        seconds=[round(b - a, 2) for a, b in zip(stamps, stamps[1:])])
    # an epoch: 128 files / (2 x 32) = 2 optimizer steps = 4 micro-batches;
    # the evaluation: 64 files / 32 = 2 batches
    check(runs["enabled"][1] == {"hist_planes_cols": 6, "fused_attention_long": 72,
                                 "fused_attention_bwd_whole": 48},
          f"the N = 401 finetune run with ENABLED = True launched {runs['enabled'][1]}")
    check(runs["einsum"][1] == {"hist_planes_cols": 6},
          f"the N = 401 finetune run with ENABLED = False launched {runs['einsum'][1]}")
    for n, (r, _) in runs.items():
        check([h[0] for h in r["history"]] == [0, 1]
              and all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in r["history"]),
              f"the N = 401 finetune run ({n}): history {r['history']}")
        check(len(r["evals"]) == 1 and np.isfinite(r["evals"][0][1]["loss"]),
              f"the N = 401 finetune run ({n}): evaluations {r['evals']}")
    return runs["enabled"][1]


# ---------------------------------------------------------------------------
# the experiment kernels: X1a, X1b, X1c (scripts/exp_voxelize.py) and X3
# (scripts/exp_attn_bwd.py)
# ---------------------------------------------------------------------------

X3_SHAPE = (128, 197, 12, 64)   # exp_attn_bwd.py's default: ViT-B's training width


X1_STRADDLE = ((2, 4_099, 129, 97), (16, 4_099, 65, 385))   # H and 2W one past a tile
X1_HOT = 70_001           # events on one cell of the hot case's second sample


def x1_cases(torch, g):
    """(case, (B, N, H, W), (xs, ys, wpos, wneg, col, ys of col)) on the CPU:
    the reference's seeded events at its seg and cls shapes; an odd shape with
    stray coordinates (negatives, the sentinels, values past them) and
    dyadic weights; the hot cell: at the seg shape (two samples) every event
    of the first sample on one pixel (180,224 counts) and X1_HOT of the
    second on another, the rest spread; and, at each tile width of the plan
    (x1_plan: N = 96, then 128), a shape whose H and 2W lie one row and two
    columns past a tile edge, N odd (ragged stages)."""
    from mem_tpu_torch.tools import exp_voxelize as X

    for tag, shape in X.SHAPES.items():
        yield tag, shape, X.make_events(*shape, "cpu")
    B, N, H, W = 3, 12_345, 37, 45
    xs = torch.randint(-2, W + 3, (B, N), generator=g, dtype=torch.int32)
    ys = torch.randint(-2, H + 3, (B, N), generator=g, dtype=torch.int32)
    levels = torch.tensor([0.0, 0.25, 0.5, 1.0])
    wpos, wneg = (levels[torch.randint(0, 4, (B, N), generator=g)] for _ in range(2))
    col = torch.randint(-2, 2 * W + 3, (B, N), generator=g, dtype=torch.int32)
    col[:, :500] = 2 * W
    yield "odd", (B, N, H, W), (xs, ys, wpos, wneg, col, ys)
    B, N, H, W = 2, X.SHAPES["seg"][1], X.SHAPES["seg"][2], X.SHAPES["seg"][3]
    xs, ys, wpos, wneg, col, ysp = X.make_events(B, N, H, W, "cpu")
    for t, v in ((xs, 5), (ys, 7), (wpos, 1.0), (wneg, 0.0), (col, 5)):
        t[0] = v
    for t, v in ((xs, 300), (ys, 401), (wpos, 0.0), (wneg, 1.0), (col, W + 300)):
        t[1, :X1_HOT] = v
    yield "hot", (B, N, H, W), (xs, ys, wpos, wneg, col, ys)
    for shape in X1_STRADDLE:
        yield f"straddle_n{X.x1_plan(*shape[:1], *shape[2:]).tile_n}", shape, \
            X.make_events(*shape, "cpu")


def check_x1(torch, dev, g):
    """X1a, X1b and X1c against their plain versions, bit for bit, with every
    chunk of the reference's sweep, in every case of x1_cases, each launched
    twice: the two outputs must be bit-identical; the hot cell must hold its
    counts exactly (f32 accumulation on the tensor cores below 2^24). X1a also
    on random f32 weights at the seg shape, to X1A_RANDOM_REL. Returns
    {counter name: max abs error at seg}."""
    from mem_tpu_torch.tools import exp_voxelize as X

    seg = {}
    for tag, (B, N, H, W), ev in x1_cases(torch, g):
        xs, ys, wpos, wneg, col, ysp = (t.to(dev) for t in ev)
        want_base = X.exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W)
        want = X.exp_voxelize_fused_reference(col, ysp, H, W)
        calls = {("exp_voxelize_base", 2048): functools.partial(
            X.exp_voxelize_base, xs, ys, wpos, wneg, H, W, 2048)}
        for chunk in (1024, 2048, 4096):
            calls[("exp_voxelize_fused_onehot", chunk)] = functools.partial(
                X.exp_voxelize_fused_onehot, col, ysp, H, W, chunk)
        calls[("exp_voxelize_fused_loop", 8192)] = functools.partial(
            X.exp_voxelize_fused_loop, col, ysp, H, W, 8192, 2048)
        got = {key: (call(), call()) for key, call in calls.items()}
        torch.cuda.synchronize()
        errs = {f"{n}_c{c}": (o - (want_base if n == "exp_voxelize_base" else want)).abs().max()
                .item() for (n, c), (o, _) in got.items()}
        same = all(torch.equal(o, again) for o, again in got.values())
        extra = {}
        if tag == "hot":
            extra = {"hot_cells": [want[0, 7, 5].item(), want[1, 401, W + 300].item()],
                     "hot_cells_x1b": [got["exp_voxelize_fused_onehot", 2048][0][0, 7, 5].item(),
                                       got["exp_voxelize_fused_onehot", 2048][0][1, 401, W + 300]
                                       .item()]}
            # (the second sample's other events may add to its hot cell)
            check(extra["hot_cells"][0] == N and extra["hot_cells"][1] >= X1_HOT,
                  f"x1_check hot: the plain version counts {extra['hot_cells']}")
        say("x1_check", case=tag, shape=[B, N, H, W], plan=X.x1_plan(B, H, W)._asdict(),
            max_abs_err=errs, identical_across_launches=same,
            events=int(want.sum().item()), weight_sum=float(want_base.sum().item()), **extra)
        check(max(errs.values()) == 0, f"X1 differs from its plain version at {tag}: {errs}")
        check(same, f"X1 at {tag}: two launches on the same events differ")
        if tag == "seg":
            seg = {n: errs[f"{n}_c{c}"] for n, c in got}
        del got
    B, N, H, W = X.SHAPES["seg"]
    xs, ys = (t.to(dev) for t in X.make_events(B, N, H, W, "cpu")[:2])
    wpos, wneg = (torch.rand(B, N, generator=g).to(dev) for _ in range(2))
    rel = rel_l2(torch, X.exp_voxelize_base(xs, ys, wpos, wneg, H, W),
                 X.exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W))
    say("x1_check", case="seg_random_weights", rel_l2=rel, tol=X1A_RANDOM_REL)
    check(rel <= X1A_RANDOM_REL, f"X1a on random weights: rel L2 {rel}")
    return seg


X2_ODD = (3, 12_345, 37, 45)   # an odd shape for X2, with stray coordinates
# H and 2W one past a tile (64-row tiles; 2N = 192 at the plan's N = 96, 256 at
# N = 128); N unaligned
X2_STRADDLE = ((2, 4_099, 129, 97), (16, 4_099, 65, 385))


def x2_sweeps():
    """The chunks of X2a and the (TH, chunk) of X2b and X2c in the reference
    script's sweeps (main, main2, main3 and both e2e runs)."""
    from mem_tpu_torch.tools import exp_voxelize2 as X2

    specs = X2.MAIN_TILED + X2.MAIN2_TILED + (X2.MAIN_E2E, X2.MAIN2_E2E)
    return (sorted({X2.MAIN_DENSE_CHUNK, *X2.CLS_DENSE_CHUNKS}),
            {dt: sorted({(TH, c) for d, TH, c in specs if d == dt}) for dt in ("bf16", "i8")})


def x2_cases(torch, g):
    """(case, (B, N, H, W), col, ys, dense only) on the CPU: the reference's
    seeded events at seg, y-sorted and not, at cls (X2a's shape there); the
    odd shape unsorted and y-sorted with negatives, the sentinels (col 2W, ys
    H, n_tiles * TH + 1 for TH = 32 / 64 and 128) and ys in [H, n_tiles * TH),
    N unaligned; the hot cell at the seg shape (two samples): every event of
    the first sample on one pixel (180,224 counts), X1_HOT of the second on
    another, the rest spread; and the X2_STRADDLE shapes, y-sorted."""
    from mem_tpu_torch.tools import exp_voxelize2 as X2

    for sort in (True, False):
        yield (f"seg_{'sorted' if sort else 'unsorted'}", X2.SEG,
               *X2.make_inputs(*X2.SEG, sort, "cpu"), False)
    yield "cls", X2.CLS, *X2.make_inputs(*X2.CLS, False, "cpu"), True
    B, N, H, W = X2_ODD
    col = torch.randint(-2, 2 * W + 3, (B, N), generator=g, dtype=torch.int32)
    ys = torch.randint(-2, X2.n_rows(H, 128) + 3, (B, N), generator=g, dtype=torch.int32)
    col[:, :500] = 2 * W
    ys[:, 500:1000] = H
    ys[:, 1000:1300] = X2.n_rows(H, 64) + 1
    ys[:, 1300:1600] = X2.n_rows(H, 128) + 1
    yield "odd_unsorted", X2_ODD, col, ys, False
    ys, order = torch.sort(ys, dim=1, stable=True)
    yield "odd_sorted", X2_ODD, torch.gather(col, 1, order), ys, False
    B, N, H, W = 2, *X2.SEG[1:]
    col, ys = X2.make_inputs(B, N, H, W, False, "cpu")
    col[0], ys[0] = 5, 7
    col[1, :X1_HOT], ys[1, :X1_HOT] = W + 300, 401
    yield "hot", (B, N, H, W), col, ys, False
    for shape in X2_STRADDLE:
        yield f"straddle_{shape[2]}x{2 * shape[3]}", shape, *X2.make_inputs(*shape, True, "cpu"), \
            False


def check_x2(torch, dev, g):
    """X2a, X2b and X2c against their plain versions, bit for bit, at every
    chunk and (TH, chunk) of the reference's sweeps, on every case of
    x2_cases (X2b and X2c on unsorted events too, where the skip must stay
    exact; the odd shapes also at chunks of one K-block), each launched
    twice: the two outputs must be bit-identical; the
    hot cell must hold its counts exactly (int32, and f32 below 2^24); and
    e2e_sort_tiled (both of the script's runs) at seg against the plain
    histogram of the unsorted events. Returns {counter name: max abs error at
    seg}."""
    from mem_tpu_torch.ops.voxelize_hist import hist_planes_cols_reference
    from mem_tpu_torch.tools import exp_voxelize2 as X2

    chunks, tiled = x2_sweeps()
    seg = {"exp_voxelize2_fused_i8": 0.0, "exp_voxelize2_tiled": 0.0,
           "exp_voxelize2_tiled_i8": 0.0}
    for tag, (B, N, H, W), col, ys, dense_only in x2_cases(torch, g):
        col, ys = col.to(dev), ys.to(dev)
        errs, same, cells, plans = {}, True, {}, {}

        def hot_cells(got):   # the hot case's two cells
            return [got[0, 7, 5].item(), got[1, 401, W + 300].item()] if tag == "hot" else None

        # the odd shapes also at one K-block a chunk: a slot of two K-blocks
        # (N = 96) then ends every chunk half empty
        small = tag.startswith("odd")
        want = X2.exp_voxelize2_fused_i8_reference(col, ys, H, W)
        for chunk in chunks + [128] * small:
            got, again = (X2.exp_voxelize2_fused_i8(col, ys, H, W, chunk) for _ in range(2))
            errs["exp_voxelize2_fused_i8", f"c{chunk}"] = (got - want).abs().max().item()
            same &= bool(torch.equal(got, again))
            cells[f"exp_voxelize2_fused_i8_c{chunk}"] = hot_cells(got)
            plans[f"c{chunk}"] = X2.x2_plan(B, H, W, None, chunk)._asdict()
        for dt, fn, name, key in (() if dense_only else (
                (torch.float32, X2.exp_voxelize2_tiled, "exp_voxelize2_tiled", "bf16"),
                (torch.int32, X2.exp_voxelize2_tiled_i8, "exp_voxelize2_tiled_i8", "i8"))):
            for TH, chunk in tiled[key] + [(32, X2.X2_DEPTH[key])] * small:
                want = X2.exp_voxelize2_tiled_reference(col, ys, H, W, TH, dt)
                got, again = (fn(col, ys, H, W, TH, chunk) for _ in range(2))
                check(got.shape == want.shape and got.dtype == dt,
                      f"{name} at {tag}: {tuple(got.shape)} {got.dtype}")
                errs[name, f"t{TH}_c{chunk}"] = (got - want).abs().max().item()
                same &= bool(torch.equal(got, again))
                cells[f"{name}_t{TH}_c{chunk}"] = hot_cells(got)
                plans[f"{key}_t{TH}_c{chunk}"] = X2.x2_plan(B, H, W, TH, chunk)._asdict()
        torch.cuda.synchronize()
        if tag.startswith("seg"):
            for (name, _), v in errs.items():
                seg[name] = max(seg[name], v)
        extra = {}
        if tag == "hot":
            want_cells = hot_cells(want)
            extra = {"hot_cells": want_cells, "hot_cells_kernels": cells}
            # (the second sample's other events may add to its hot cell)
            check(want_cells[0] == N and want_cells[1] >= X1_HOT
                  and all(v == want_cells for v in cells.values()),
                  f"x2_check hot: the plain version counts {want_cells}, the kernels {cells}")
        errs = {f"{n}_{c}": v for (n, c), v in errs.items()}
        say("x2_check", case=tag, shape=[B, N, H, W], max_abs_err=errs,
            identical_across_launches=same, events=int(want.sum().item()),
            plans=plans, **extra)
        check(max(errs.values()) == 0, f"X2 differs from its plain version at {tag}: {errs}")
        check(same, f"X2 at {tag}: two launches on the same events differ")
        del col, ys, want, got, again
    col, ys = (t.to(dev) for t in X2.make_inputs(*X2.SEG, False, "cpu"))
    B, N, H, W = X2.SEG
    planes = hist_planes_cols_reference(col, ys, H, W)
    for dt, TH, chunk in (X2.MAIN_E2E, X2.MAIN2_E2E):
        got = X2.e2e_sort_tiled(col, ys, H, W, TH, chunk, dt == "i8")
        torch.cuda.synchronize()
        err = (got[:, :H].to(torch.int32) - planes).abs().max().item()
        say("x2_check", case=f"seg_e2e_{dt}_t{TH}_c{chunk}", max_abs_err_vs_unsorted_plain=err,
            rows_past_h=int(got[:, H:].sum().item()))
        check(err == 0 and got[:, H:].sum().item() == 0,
              f"e2e_sort_tiled ({dt}, {TH}, {chunk}) differs from the unsorted histogram: {err}")
    return seg


def check_x3(torch, dev, g):
    """X3 at every shape against the plain pair inside K2b's gates, bit for
    bit against K2b's Hopper path (fused_attention_flat_bwd: the body X3
    varies, whose sums the pair only adds exact zeros to) on the same
    operands, and bit-identical across launches: the experiment's (128, 197,
    12, 64), the serving batch, and N = 37, 129, 256 and 16; X3 with the last
    key dropped (last_key_dropped) must fail the gates; X3 from a fresh
    thread gives the main thread's bits; f32, another head dim and N above
    256 must raise. Returns the max abs error against the plain version at
    the experiment's shape."""
    from mem_tpu_torch.ops import attention as A

    first = None
    names = ("dq", "dk", "dv", "db")

    def gates(got, want):
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(names[:3], got, want)}
        db = rel_l2(torch, got[3], want[3])
        return errs, db, max(errs.values()) <= K2B_BF16_TOL and db <= K2B_DB_REL

    for B, N, H in ((128, 197, 12), (8, 197, 12), (2, 37, 3), (2, 129, 2), (1, 256, 2),
                    (3, 16, 1)):
        q, k, v, do = (torch.randn(B, N, H * 64, generator=g).to(torch.bfloat16).to(dev)
                       for _ in range(4))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        pair = A.fused_attention_flat_bwd_pair(q, k, v, bias, do, 0.125)
        again = A.fused_attention_flat_bwd_pair(q, k, v, bias, do, 0.125)
        base = A.fused_attention_flat_bwd(q, k, v, bias, do, 0.125)
        want = A.fused_attention_flat_bwd_pair_reference(q, k, v, bias, do, 0.125)
        torch.cuda.synchronize()
        equal_k2b = {n: torch.equal(a, b) for n, a, b in zip(names, pair, base)}
        max_diff_k2b = {n: (a.float() - b.float()).abs().max().item()
                        for n, a, b in zip(names, pair, base)}
        identical = all(torch.equal(a, b) for a, b in zip(pair, again))
        errs, db, ok = gates(pair, want)
        say("x3_check", shape=[B, N, H, 64], equal_k2b=equal_k2b, max_abs_diff_k2b=max_diff_k2b,
            k2b_path=A.cuda_bwd_kernel_path(q, k, v, bias), identical_across_launches=identical,
            rel_max_abs=errs, tol=K2B_BF16_TOL, db_rel_l2=db, db_tol=K2B_DB_REL)
        check(ok, f"X3 at {B, N, H} differs from the plain pair: {errs}, db {db}")
        check(identical, f"X3 at {B, N, H} differs between two launches")
        check(all(equal_k2b.values()),
              f"X3 at {B, N, H} is not the bits of K2b's Hopper path: {max_diff_k2b}")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(pair, want))
            fault = last_key_dropped(A.fused_attention_flat_bwd_pair)(q, k, v, bias, do, 0.125)
            f_errs, f_db, f_ok = gates(fault, want)
            say("x3_fault", fault="last_key_dropped", shape=[B, N, H, 64], rel_max_abs=f_errs,
                db_rel_l2=f_db, fails_the_gates=not f_ok)
            check(not f_ok, f"X3 with the last key dropped passed the gates: {f_errs}, {f_db}")
            del fault
            fresh_thread_check(torch, "x3_fresh_thread", lambda: A.fused_attention_flat_bwd_pair(
                q, k, v, bias, do, 0.125))
        del q, k, v, do, bias, pair, again, base, want
    for dt, D, N in ((torch.float32, 64, 197), (torch.bfloat16, 32, 197),
                     (torch.bfloat16, 64, 257)):
        q = torch.zeros(1, N, 2 * D, dtype=dt, device=dev)
        bias = torch.zeros(2, N, N, device=dev)
        try:
            A.fused_attention_flat_bwd_pair(q, q, q, bias, q, 0.125)
        except ValueError:
            continue
        raise SmokeFailure(f"X3 took {dt} operands at D={D}, N={N}")
    return first


def run_experiment_tools(torch):
    """The experiments' entry points as a user runs them:
    ``exp_voxelize.main(["all"])`` (both shapes, every variant checked against
    its plain version and timed, K1 beside them), ``exp_attn_bwd.main([])``
    (the reference's defaults: B=128, steps=8) and
    ``exp_voxelize2.main(["all"])`` (main, main2 and main3: every variant
    checked and timed, K4 and K1 beside them), each with the launch counts
    set to 0 just before it and read just after; each must exit 0 and launch
    exactly what its loops call. Returns {tool: counts}."""
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.tools import exp_attn_bwd, exp_voxelize, exp_voxelize2

    runs, stamps = {}, [time.perf_counter()]
    for tool, call in (("exp_voxelize", lambda: exp_voxelize.main(["all"])),
                       ("exp_attn_bwd", lambda: exp_attn_bwd.main([])),
                       ("exp_voxelize2", lambda: exp_voxelize2.main(["all"]))):
        reset_launch_counts()                 # just before the path
        rc = call()
        runs[tool] = launch_counts()          # just after it
        stamps.append(time.perf_counter())
        check(rc == 0, f"{tool}.main exited {rc}")
    per_variant = 1 + exp_voxelize.WARMUP + exp_voxelize.RUNS   # the check, then the timing
    # exp_attn_bwd: the check, two timings of 1 + steps, two device-time
    # profiles (all three kernels, the rows kernel) over 3 + steps
    per_fn = 1 + 2 * (1 + 8) + 2 * (3 + 8)
    want = {"exp_voxelize": {"exp_voxelize_base": 2 * per_variant,
                             "exp_voxelize_fused_onehot": 6 * per_variant,
                             "exp_voxelize_fused_loop": 2 * per_variant,
                             "hist_planes_cols": 2 * (exp_voxelize.WARMUP + exp_voxelize.RUNS)},
            "exp_attn_bwd": {"fused_attention_flat_bwd": per_fn,
                             "fused_attention_flat_bwd_pair": per_fn}}
    X2 = exp_voxelize2
    per_x2 = 1 + X2.WARMUP + X2.RUNS   # the check, then the timing
    tiled = X2.MAIN_TILED + X2.MAIN2_TILED + (X2.MAIN_E2E, X2.MAIN2_E2E)
    want["exp_voxelize2"] = {
        "exp_voxelize2_fused_i8": (1 + len(X2.CLS_DENSE_CHUNKS)) * per_x2,
        "exp_voxelize2_tiled": sum(dt == "bf16" for dt, _, _ in tiled) * per_x2,
        "exp_voxelize2_tiled_i8": sum(dt == "i8" for dt, _, _ in tiled) * per_x2,
        "hist_planes_cols_sorted": per_x2, "hist_planes_cols": per_x2}
    say("experiment_tools", launches=runs,
        seconds=[round(b - a, 2) for a, b in zip(stamps, stamps[1:])])
    check(runs == want, f"the experiment tools launched {runs}, not {want}")
    return runs


X2_AIM_MS = {("exp_voxelize2_fused_i8", "seg"): 1.64, ("exp_voxelize2_fused_i8", "cls"): 0.52,
             ("exp_voxelize2_tiled", "sorted"): 0.35, ("exp_voxelize2_tiled_i8", "sorted"): 0.30}
X2_FRAGMENTS = ("x2_wgmma_kernel", "chunk_minmax_kernel")


def x2_work(X2, ys, H, W, TH, chunk, tile_rows):
    """(pairs, all pairs, operations) of a tiled launch on ``ys``: the (tile,
    chunk) pairs tiles of ``tile_rows`` rows consume (kept_pairs, from the
    bounds computed on the host) and the one-hot multiply-adds they take,
    2 tile_rows chunk 2W each: the kernel's at X2_ROWS, the reference's at
    TH."""
    kept = X2.kept_pairs(X2.chunk_bounds(ys.cpu(), chunk), X2.n_rows(H, TH), TH, tile_rows)
    return int(kept.sum()), kept.numel(), 2 * int(kept.sum()) * tile_rows * chunk * 2 * W


def x2_rate(gpu, name, case, shape, plan, ms, device_ms, ops, peak, dtype, aim, **pairs):
    """One ``x2_rate`` line: TOP/s of the contraction and its bound at the
    dtype's peak, the share of that bound by events and by device time."""
    t_ops = ops / peak * 1e3
    say("x2_rate", gpu=gpu, kernel=name, case=case, shape=shape, plan=plan._asdict(),
        kernel_ms=ms, device_ms=device_ms, top_s=ops / ms / 1e9, contraction_gop=ops / 1e9,
        contraction_ms_at_peak=t_ops, peak=dtype, share_of_contraction_bound=t_ops / ms,
        device_share_of_contraction_bound=device_ms and t_ops / device_ms, aim_ms=aim, **pairs)


def time_x2(torch, dev, gpu):
    """X2a at seg (unsorted events, chunk 2048) and cls (chunks 2048 and
    4096), X2b and X2c at their best (TH, chunk) of the reference's sweeps on
    y-sorted seg events (each configuration timed briefly, the fastest then in
    turns with its plain version) and at that (TH, chunk) on unsorted events
    too (the skip's effect), each with the torch.bincount yardstick over the
    rows the kernel writes, K1 and K4 on the same events, and the packed-key
    sort; device ms by the profiler, and one ``x2_rate`` line a variant and
    shape: TOP/s, the share of the contraction bound at the dtype's peak by
    events and by device (dense: every event enters every tile; tiled: the
    reference's kept (band, chunk) pairs, beside the (64-row tile, chunk)
    pairs the kernel keeps) and the aim. Returns {counter name: (ms, plain_ms, bound,
    library_ms)} at seg."""
    from mem_tpu_torch.ops import voxelize_hist as vh
    from mem_tpu_torch.tools import exp_voxelize2 as X2

    out = {}
    _, tiled = x2_sweeps()
    B, N, H, W = X2.SEG
    col, ys = X2.make_inputs(B, N, H, W, False, dev)
    cols, yss = X2.make_inputs(B, N, H, W, True, dev)
    t_sort = time_ms(lambda: X2.sort_packed(col, ys))
    t_k1 = time_ms(lambda: vh.hist_planes_cols(cols, yss, H, W))
    t_k4 = time_ms(lambda: vh.hist_planes_cols_sorted(cols, yss, H, W, presorted=True))
    say("time_x2_sort", gpu=gpu, shape=[B, N], sort_ms=t_sort, k1_sorted_events_ms=t_k1,
        k4_presorted_ms=t_k4)
    dense_dev = None
    for tag, (B, N, H, W), chunks in (("seg", X2.SEG, (X2.MAIN_DENSE_CHUNK,)),
                                      ("cls", X2.CLS, X2.CLS_DENSE_CHUNKS)):
        c, y = (col, ys) if tag == "seg" else X2.make_inputs(B, N, H, W, False, dev)
        want = X2.exp_voxelize2_fused_i8_reference(c, y, H, W)
        t_lib, lib_equal = bincount_ms(torch, c, y, H, W, want)
        k1 = time_ms(lambda: vh.hist_planes_cols(c, y, H, W))
        bnd = hist_bound(B, N, H, W)
        for chunk in chunks:
            kernel = lambda: X2.exp_voxelize2_fused_i8(c, y, H, W, chunk)  # noqa: E731
            t_k, t_p = in_turns(torch, lambda: X2.exp_voxelize2_fused_i8_reference(c, y, H, W),
                                kernel, runs=10)
            t_dev = body_device_ms(kernel, X2_FRAGMENTS[:1], n=10)
            say("time_exp_voxelize2_fused_i8", gpu=gpu, case=tag, shape=[B, N, H, W],
                chunk=chunk, kernel_ms=t_k, device_ms=t_dev, plain_ms=t_p, bincount_ms=t_lib,
                bincount_equals_plain=lib_equal, k1_ms=k1, bound_ms=bnd[0], bound_by=bnd[1],
                kernel_gev_s=B * N / t_k / 1e6)
            x2_rate(gpu, "exp_voxelize2_fused_i8", f"{tag}_c{chunk}", [B, N, H, W],
                    X2.x2_plan(B, H, W, None, chunk), t_k, t_dev, 2 * B * N * H * 2 * W,
                    PEAK_INT8_OPS, "int8", X2_AIM_MS["exp_voxelize2_fused_i8", tag])
            if tag == "seg":
                out["exp_voxelize2_fused_i8"] = (t_k, t_p, bnd, t_lib)
                dense_dev = t_dev
        del c, y, want
    B, N, H, W = X2.SEG
    for name, fn, dt, key in (("exp_voxelize2_tiled", X2.exp_voxelize2_tiled, torch.float32,
                               "bf16"),
                              ("exp_voxelize2_tiled_i8", X2.exp_voxelize2_tiled_i8, torch.int32,
                               "i8")):
        sweep = {cfg: time_ms(lambda: fn(cols, yss, H, W, *cfg), runs=5, warmup=2)
                 for cfg in tiled[key]}
        TH, chunk = min(sweep, key=sweep.get)
        rows = X2.n_rows(H, TH)
        plan = X2.x2_plan(B, H, W, TH, chunk)
        kernel = lambda: fn(cols, yss, H, W, TH, chunk)  # noqa: E731
        unsorted = lambda: fn(col, ys, H, W, TH, chunk)  # noqa: E731
        t_k, t_p = in_turns(torch, lambda: X2.exp_voxelize2_tiled_reference(
            cols, yss, H, W, TH, dt), kernel, runs=10)
        t_dev = body_device_ms(kernel, X2_FRAGMENTS, n=10)
        t_unsorted = time_ms(unsorted, runs=10)
        t_unsorted_dev = body_device_ms(unsorted, X2_FRAGMENTS, n=10)
        t_e2e = time_ms(lambda: X2.e2e_sort_tiled(col, ys, H, W, TH, chunk, key == "i8"),
                        runs=10)
        t_lib, lib_equal = bincount_ms(torch, cols, yss, rows, W, vh.hist_planes_cols_reference(
            cols, yss, rows, W))
        bnd = hist_bound(B, N, rows, W)
        say(f"time_{name}", gpu=gpu, shape=[B, N, H, W], best_th=TH, best_chunk=chunk,
            sweep_ms={f"t{a}_c{b}": v for (a, b), v in sweep.items()}, kernel_ms=t_k,
            device_ms=t_dev, plain_ms=t_p, unsorted_events_ms=t_unsorted,
            unsorted_events_device_ms=t_unsorted_dev, sort_and_kernel_ms=t_e2e,
            bincount_ms=t_lib, bincount_equals_plain=lib_equal, k1_ms=t_k1, k4_ms=t_k4,
            bound_ms=bnd[0], bound_by=bnd[1], kernel_gev_s=B * N / t_k / 1e6)
        peak, dtype = (PEAK_INT8_OPS, "int8") if key == "i8" else (PEAK_BF16_FLOPS, "bf16")
        # the unsorted aim: X2a's dense device time in the dtype's ratio (2x in bf16)
        for case, ev_ys, ms, dev_ms, aim in (
                ("sorted", yss, t_k, t_dev, X2_AIM_MS[name, "sorted"]),
                ("unsorted", ys, t_unsorted, t_unsorted_dev,
                 dense_dev and dense_dev * (2 if key == "bf16" else 1))):
            ref_pairs, all_pairs, ops = x2_work(X2, ev_ys, H, W, TH, chunk, TH)
            kept, _, kernel_ops = x2_work(X2, ev_ys, H, W, TH, chunk, X2.X2_ROWS)
            x2_rate(gpu, name, f"{case}_t{TH}_c{chunk}", [B, N, H, W], plan, ms, dev_ms, ops,
                    peak, dtype, aim, reference_pairs=ref_pairs, all_pairs=all_pairs,
                    tile_pairs=kept, tile_gop=kernel_ops / 1e9)
        out[name] = (t_k, t_p, bnd, t_lib)
    del col, ys, cols, yss
    torch.cuda.empty_cache()
    return out


def x1_variants(X, ev, H, W):
    """(counter name, kernel call, plain call, int32 / f32 arrays read) of
    X1a, X1b and X1c as the reference times them (chunk 2048; X1c 8192 with
    inner 2048), on make_events' arrays ``ev``."""
    xs, ys, wpos, wneg, col, ysp = ev
    return (("exp_voxelize_base", lambda: X.exp_voxelize_base(xs, ys, wpos, wneg, H, W, 2048),
             lambda: X.exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W), 4),
            ("exp_voxelize_fused_onehot", lambda: X.exp_voxelize_fused_onehot(col, ysp, H, W),
             lambda: X.exp_voxelize_fused_reference(col, ysp, H, W), 2),
            ("exp_voxelize_fused_loop",
             lambda: X.exp_voxelize_fused_loop(col, ysp, H, W, 8192, 2048),
             lambda: X.exp_voxelize_fused_reference(col, ysp, H, W), 2))


X1_AIM_MS = {"seg": 3.3, "cls": 1.04}   # half the contraction's rate at the bf16 peak


def time_experiments(torch, dev, gpu):
    """X1a, X1b and X1c at the seg shape (8 x 180,224 events, 440 x 640) on
    the reference's events, each beside its plain version (in turns), with
    the torch.bincount yardstick and K1 on the same packed events, and at the
    cls shape (64 x 30,720, 256 x 256); device ms by the profiler, and one
    ``x1_rate`` line a variant and shape: TFLOP/s of the one-hot contraction
    and its share of the contraction's time at the bf16 peak; X2 (see
    time_x2); X3 at X3_SHAPE bf16 beside its plain version and beside K2b's
    Hopper path (in turns), by events and by device time (all three
    kernels, and the rows kernel alone, where the two differ), and the SDPA
    backward by events. Returns {counter name: (ms, plain_ms, bound, library_ms)}."""
    from mem_tpu_torch.ops import attention as A
    from mem_tpu_torch.ops import voxelize_hist as vh
    from mem_tpu_torch.tools import exp_voxelize as X
    from mem_tpu_torch.tools.exp_attn_bwd import KERNELS, executed_gflop

    out = {}
    for tag in ("seg", "cls"):
        B, N, H, W = X.SHAPES[tag]
        ev = X.make_events(B, N, H, W, dev)
        col, ysp = ev[4:]
        flop = 2 * B * N * H * 2 * W   # the one-hot contraction
        t_flop = flop / PEAK_BF16_FLOPS * 1e3
        if tag == "seg":
            t_lib, lib_equal = bincount_ms(torch, col, ysp, H, W,
                                           vh.hist_planes_cols_reference(col, ysp, H, W))
            t_k1 = time_ms(lambda: vh.hist_planes_cols(col, ysp, H, W))
        for name, kernel, plain, arrays in x1_variants(X, ev, H, W):
            t_dev = kernel_device_ms(kernel, ("x1_wgmma_kernel",), n=10, per_launch=True)
            if tag == "seg":
                t_k, t_p = in_turns(torch, plain, kernel, runs=10)
                bnd = hist_bound(B, N, H, W, arrays)
                say(f"time_{name}", gpu=gpu, shape=[B, N, H, W], kernel_ms=t_k,
                    device_ms=t_dev, plain_ms=t_p, bincount_ms=t_lib,
                    bincount_equals_plain=lib_equal, k1_ms=t_k1, bound_ms=bnd[0],
                    bound_by=bnd[1], contraction_gflop=flop / 1e9,
                    contraction_ms_at_bf16_peak=t_flop, kernel_gev_s=B * N / t_k / 1e6)
                out[name] = (t_k, t_p, bnd, t_lib)
            else:
                t_k = time_ms(kernel, runs=10)
            say("x1_rate", gpu=gpu, kernel=name, case=tag, shape=[B, N, H, W],
                plan=X.x1_plan(B, H, W)._asdict(), kernel_ms=t_k, device_ms=t_dev,
                tflop_s=flop / t_k / 1e9, contraction_ms_at_bf16_peak=t_flop,
                share_of_contraction_bound=t_flop / t_k,
                device_share_of_contraction_bound=t_dev and t_flop / t_dev,
                aim_ms=X1_AIM_MS[tag])
        del ev, col, ysp
    out.update(time_x2(torch, dev, gpu))

    B, N, Hh, D = X3_SHAPE
    q, k, v, do = (torch.randn(B, N, Hh * D, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    bias = torch.randn(Hh, N, N, device=dev)
    x3 = lambda: A.fused_attention_flat_bwd_pair(q, k, v, bias, do, 0.125)  # noqa: E731
    k2b = lambda: A.fused_attention_flat_bwd(q, k, v, bias, do, 0.125)  # noqa: E731
    t_k, t_p = in_turns(torch, lambda: A.fused_attention_flat_bwd_pair_reference(
        q, k, v, bias, do, 0.125), x3, runs=10)
    t_k2, t_k2b = in_turns(torch, k2b, x3, runs=10)   # K2b, X3, X3, K2b
    # each kernel's mean per recorded launch (a trace can lose records), summed
    dev_ms = {name: [kernel_device_ms(fn, (f,), n=10, per_launch=True) for f in KERNELS]
              for name, fn in (("x3", x3), ("k2b", k2b))}
    d_k, d_k2b = (None if None in dev_ms[name] else sum(dev_ms[name]) for name in ("x3", "k2b"))
    r_k, r_k2b = (dev_ms[name][0] for name in ("x3", "k2b"))
    qh, kh, vhd, mask = (t.requires_grad_() for t in sdpa_operands(torch, q, k, v, bias))
    o = torch.nn.functional.scaled_dot_product_attention(qh, kh, vhd, attn_mask=mask, scale=0.125)
    doh = torch.randn_like(o)
    sdpa_bwd = lambda: torch.autograd.grad(o, (qh, kh, vhd, mask), doh,  # noqa: E731
                                           retain_graph=True)
    t_lib = time_ms(sdpa_bwd, runs=10)
    bnd = attention_bwd_bound(*X3_SHAPE)
    flop5 = 10 * B * Hh * N * N * D
    say("time_x3", gpu=gpu, batch=B, shape=[N, Hh, D], dtype="bfloat16", kernel_ms=t_k,
        kernel_ms_beside_k2b=t_k2, device_ms=d_k, rows_device_ms=r_k, plain_ms=t_p,
        k2b_ms=t_k2b, k2b_device_ms=d_k2b, k2b_rows_device_ms=r_k2b,
        x3_over_k2b_events=t_k2 / t_k2b, x3_over_k2b_device=d_k and d_k2b and d_k / d_k2b,
        sdpa_backward_ms=t_lib, bound_ms=bnd[0],
        bound_by=bnd[1], kernel_tflop_s=flop5 / t_k / 1e9,
        executed_gflop=executed_gflop(*X3_SHAPE, "pair"),
        executed_tflop_s=executed_gflop(*X3_SHAPE, "pair") / t_k, k2b_tflop_s=flop5 / t_k2b / 1e9,
        k2b_executed_gflop=executed_gflop(*X3_SHAPE, "base"))
    out["fused_attention_flat_bwd_pair"] = (t_k, t_p, bnd, t_lib)
    del q, k, v, do, bias, qh, kh, vhd, mask, o, doh
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the dataset tools and the optimizer switch: raw recordings -> the card,
# every --opt card against CPU, the warm-started pretraining with bf16 moments
# ---------------------------------------------------------------------------

RAW_CLASSES = 8          # N-Caltech101-like classes of the raw ATIS tree: 4 train, 2 val and
                         # 1 unlisted recording each -> 32 train and 16 val files
RAW_FT_BATCH = 16        # the finetune run on the processed tree: 2 steps an epoch, 3 epochs
OPT_STEPS = 7            # steps of each optimizer check: Lookahead (k = 6) syncs once
OPT_DEPTH = 1            # ft_vit at full width (768, 12 heads), 1 block, for the CPU's sake
OPT_F32_REL = 1e-5       # per-tensor displacement, card f32 vs CPU f32, relative L2
OPT_BF16_REL = 1e-3      # ... with bf16 moments (a flipped bf16 rounding moves one element)
OPT_CLIP = 50.0          # the global-norm clip of the checks: active (the norm reads ~400)
# the base lr of each check: every step moves a weight by a few % of its size
# or more, so that the f32 rounding of the weights stays ~1e-6 of the
# displacement (the f32 run against an f64 one of the same optimizer reads
# <= 3e-6 on the CPU at these rates; lamb and novograd read 1.5-1.8e-5 at
# 1e-2, where their steps are ~1 % of the weights)
OPT_BASE_LR = {"adadelta": 1.0, "sgd": 0.05, "nesterov": 0.05, "momentum": 0.05, "sgdp": 0.05,
               "radam": 0.1, "lamb": 0.1, "novograd": 1.0, "nvnovograd": 1.0}
OPT_FAULT_TENSOR = "blocks.0.mlp.fc2.weight"


def tree_bytes(root):
    """{path relative to root: file bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


def write_raw_recordings(root, rng):
    """Seeded raw recordings: ATIS .bin files in N-Caltech101's layout
    (<root>/Caltech101/<class>/image_NNNN.bin, 20k-60k events each) with its
    split file, and N-Cars .dat files (<root>/ncars_raw/n-cars_{train,test}/
    {cars,background}/, 2k-8k events each). Returns (caltech input, split
    file, ncars input, events written)."""
    from mem_tpu_torch.events.decoders import encode_atis_bytes, encode_ncars_bytes

    cal, lines, n_events = os.path.join(root, "Caltech101"), [], 0
    for c in range(RAW_CLASSES):
        os.makedirs(os.path.join(cal, f"class_{c}"))
        for i in range(7):
            ev = synthetic_events(rng, int(rng.integers(20_000, 60_001)))
            n_events += len(ev)
            with open(os.path.join(cal, f"class_{c}", f"image_{i:04d}.bin"), "wb") as f:
                f.write(encode_atis_bytes(ev))
            if i < 6:
                lines.append(f"{'train' if i < 4 else 'val'}/class_{c}/image_{i:04d}.npy")
    split = os.path.join(root, "ncaltech101_split.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    ncars = os.path.join(root, "ncars_raw")
    for name in ("n-cars_train", "n-cars_test"):
        for c in ("cars", "background"):
            os.makedirs(os.path.join(ncars, name, c))
            for i in range(8):
                ev = synthetic_events(rng, int(rng.integers(2_000, 8_001)))
                ev[:, 3] = (ev[:, 3] > 0).astype(np.float64)       # N-Cars: p in {0, 1}
                n_events += len(ev)
                with open(os.path.join(ncars, name, c, f"obj_{i:06d}_td.dat"), "wb") as f:
                    f.write(encode_ncars_bytes(ev))
    return cal, split, ncars, n_events


def run_raw_to_card(torch, gpu, tmp_root, rng):
    """Phase (a): raw recordings -> .npy with the port's process_dataset at
    --cores 2 (the native decoders): every .npy bit-equal to the numpy decoder
    of its raw file; the host rates of the native and the numpy decoders on
    the same buffers; then run_class_finetuning --opt lookahead_adamp on the
    processed tree on the card (6 steps: Lookahead syncs once) with exact K1 /
    K2f / K2b launch counts."""
    from mem_tpu_torch import native
    from mem_tpu_torch.cli import process_dataset as P
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.events import decoders
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    cal, split, ncars, n_events = write_raw_recordings(tmp_root, rng)
    check(native.available(), "libmemev did not build: no native decoders")
    trees = {}
    t0 = time.perf_counter()
    for ds, inp, extra in (("ncaltech101", cal, ["--split", split]), ("ncars", ncars, [])):
        out = os.path.join(tmp_root, "processed", ds)
        P.main(["--dataset", ds, "--input", inp, "--output", out, "--cores", "2", *extra])
        trees[ds] = tree_bytes(out)
    wall = time.perf_counter() - t0
    # each .npy against the numpy decoder of its raw file
    raw = {}
    for c in os.listdir(cal):
        for f in os.listdir(os.path.join(cal, c)):
            raw[os.path.join(c, f)] = os.path.join(cal, c, f)
    cal_tree = trees["ncaltech101"]
    for rel, data in cal_tree.items():
        split_name, c, f = rel.split(os.sep)
        with open(raw[os.path.join(c, f[:-4] + ".bin")], "rb") as fh:
            want = decoders.decode_atis_bytes(fh.read())
        got = np.load(io.BytesIO(data))
        check(got.dtype == want.dtype and got.tobytes() == want.tobytes(),
              f"{rel}: not the numpy decoder's events")
    for rel, data in trees["ncars"].items():
        split_name, c, f = rel.split(os.sep)
        src = os.path.join(ncars, {"train": "n-cars_train", "val": "n-cars_test"}[split_name], c,
                           f[:-4] + ".dat")
        with open(src, "rb") as fh:
            want = decoders.decode_ncars_bytes(fh.read())
        check(np.load(io.BytesIO(data)).tobytes() == want.tobytes(),
              f"ncars {rel}: not the numpy decoder's events")
    n_train = sum(k.startswith("train") for k in cal_tree)
    n_val = sum(k.startswith("val") for k in cal_tree)
    check((n_train, n_val) == (4 * RAW_CLASSES, 2 * RAW_CLASSES),
          f"the split routed {n_train} train and {n_val} val files")
    # the decoders alone, one process, on the buffers of every raw file (host numbers)
    bufs = []
    for p in raw.values():
        with open(p, "rb") as fh:
            bufs.append(("atis", fh.read()))
    for d, _, fs in os.walk(ncars):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                bufs.append(("ncars", fh.read()))
    fns = {"native": {"atis": native.decode_atis, "ncars": native.decode_ncars},
           "numpy": {"atis": decoders.decode_atis_bytes, "ncars": decoders.decode_ncars_bytes}}
    rates = {}
    for decoder in ("native", "numpy", "native", "numpy"):
        t0 = time.perf_counter()
        n = sum(len(fns[decoder][fmt](buf)) for fmt, buf in bufs)
        s = time.perf_counter() - t0
        rates.setdefault(decoder, []).append((len(bufs) / s, n / s))
    n_files = len(bufs)
    say("process_dataset", host="the chip host's CPU (not a device number)", gpu=gpu,
        files=n_files, events=n_events, cores=2, decoder="native",
        cli_seconds=wall, cli_files_per_s=n_files / wall, cli_events_per_s=n_events / wall,
        decode_files_per_s={k: [r[0] for r in v] for k, v in rates.items()},
        decode_events_per_s={k: [r[1] for r in v] for k, v in rates.items()},
        caltech_train=n_train, caltech_val=n_val)

    out_dir = os.path.join(tmp_root, "ft_raw")
    flags = ["--config", "configs/ncaltech.conf", "--data_path",
             os.path.join(tmp_root, "processed", "ncaltech101"), "--output_dir", out_dir,
             "--nb_classes", "101", "--batch_size", str(RAW_FT_BATCH), "--update_freq", "1",
             "--epochs", "3", "--save_ckpt_freq", "3", "--warmup_steps", "2",
             "--model_ema", "0", "--num_workers", "4", "--opt", "lookahead_adamp",
             "--device", "cuda"]
    t0 = time.perf_counter()
    with toggles():
        reset_launch_counts()                 # just before the main path
        r = F.main(flags)
        counts = launch_counts()              # just after it
    seconds = time.perf_counter() - t0
    payload = load_checkpoint(os.path.join(out_dir, "checkpoint-2.pth"))
    opt_state = payload["optimizer"]
    say("raw_finetune_cli", model="ft_vit", embed_dim=768, depth=12, heads=12, img=[224, 224],
        batch=RAW_FT_BATCH, opt="lookahead_adamp", history=r["history"],
        evals=[(e, s) for e, s, _ in r["evals"]], launches=counts,
        lookahead_count=opt_state["lookahead_count"], seconds=round(seconds, 2))
    # 32 train files / 16 = 2 steps an epoch, 3 epochs = 6 steps; an evaluation:
    # 16 val files / 16 = 1 batch a epoch
    steps, evals = 6, 3
    check(counts == {"hist_planes_cols": steps + evals, "fused_attention_flat": 12 * (steps + evals),
                     "fused_attention_flat_bwd": 12 * steps},
          f"the finetune run on the processed tree launched {counts}")
    check(opt_state["lookahead_count"] == steps and len(opt_state["lookahead_slow"]) > 0,
          "the checkpoint does not hold Lookahead's state")
    check(all(np.isfinite(h[1]) for h in r["history"]) and len(r["evals"]) == evals,
          f"finetune history {r['history']}, evals {r['evals']}")
    return counts


def opt_model(torch, depth, device, seed=0):
    """ft_vit at full width with every parameter drawn 0.02 N(0, 1) from a
    seed (the norms' scales too: a displacement then stays far above its
    tensor's rounding)."""
    from mem_tpu_torch.models.registry import create_model

    model = create_model("ft_vit", num_classes=101, img_size=(224, 224), patch_size=(16, 16),
                         embed_dim=768, depth=depth, num_heads=12, init_values=0.1,
                         use_rel_pos_bias=True, use_abs_pos_emb=True, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def opt_grads(torch, params, axes, t, g):
    """Step t's gradients, made on the CPU from the current CPU weights:
    tensor i gets, by (i + t) mod 3, a gradient orthogonal to the weight
    within each output channel (AdamP's channel view fires), one orthogonal
    to the whole tensor only, or one leaning on the weight (no projection):
    every AdamP decision far from its threshold."""
    out = []
    for i, p in enumerate(params):
        p = p.detach().double()
        d = 0.1 * torch.randn(p.shape, generator=g, dtype=torch.float64)
        kind = (i + t) % 3
        if p.ndim >= 2 and kind == 0:
            red = tuple(k for k in range(p.ndim) if k != axes[i])
            d -= p * (p * d).sum(red, keepdim=True) / (p * p).sum(red, keepdim=True)
        elif p.ndim >= 2 and kind == 1:
            d -= p * (p * d).sum() / (p * p).sum()
        elif kind == 2:
            d += 3.0 * torch.sign(p) * d.abs().mean()
        out.append(d.float())
    return out


def opt_run(torch, name, device, grads=None, fault=None):
    """OPT_STEPS steps of ``name`` (``bf16_`` prefix: bf16 moments) with
    layer decay 0.75 on opt_model, wd cosine 0.05 -> 0.2, the clip active.
    Without ``grads`` the gradients are made on the way (on the CPU) and
    returned. ``fault``: a parameter name whose update is skipped every
    step. Returns (start, end weights on the CPU, grads, AdamP decisions
    per step)."""
    from mem_tpu_torch.train import optim
    from mem_tpu_torch.train.schedules import cosine_scheduler

    opt_name = name.removeprefix("bf16_")
    model = opt_model(torch, OPT_DEPTH, device)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    start = {k: p.detach().cpu().clone() for k, p in named}
    with warnings.catch_warnings():   # novograd's note on the wd schedule
        warnings.simplefilter("ignore")
        opt = optim.create_optimizer(model, 1e-3, 0.05, opt=opt_name, layer_decay=0.75,
                                     num_layers=OPT_DEPTH, momentum=0.9,
                                     moment_dtype=torch.bfloat16 if name != opt_name else None)
    axes = optim.channel_axes(model)
    axes = [axes[p] for p in params]
    base = OPT_BASE_LR.get(optim.resolve_name(opt_name)[0], 1e-2)
    lr = cosine_scheduler(base, base / 10, 1, OPT_STEPS, warmup_steps=2,
                          start_warmup_value=base / 4)
    wd = cosine_scheduler(0.05, 0.2, 1, OPT_STEPS)
    made, fired, gen = [], [], torch.Generator().manual_seed(1)
    for t in range(OPT_STEPS):
        step_grads = grads[t] if grads is not None else opt_grads(torch, params, axes, t, gen)
        made.append(step_grads)
        for p, gr in zip(params, step_grads):
            p.grad = gr.to(device, copy=True)   # the clip scales it in place
        optim.clip_grad_global_norm(params, OPT_CLIP)
        optim.set_schedule(opt, float(lr[t]), float(wd[t]))
        keep = dict(named)[fault].detach().clone() if fault else None
        opt.step()
        if fault:
            with torch.no_grad():
                dict(named)[fault].copy_(keep)
        fired.append({k: float(opt.state[p]["fired"]) for k, p in named
                      if p.ndim >= 2 and "fired" in opt.state.get(p, {})})
    end = {k: p.detach().cpu().clone() for k, p in named}
    return start, end, made, fired


def opt_gate(torch, start, want, got, bound):
    """{tensor: relative L2 of its displacement, card against CPU} and the
    tensors past ``bound``."""
    rel = {}
    for k in want:
        dw, dg = want[k] - start[k], got[k] - start[k]
        den = torch.linalg.vector_norm(dw).item()
        num = torch.linalg.vector_norm(dg - dw).item()
        rel[k] = num / den if den > 0 else num
    return rel, sorted(k for k, v in rel.items() if v > bound)


def check_optimizers(torch, dev, gpu):
    """Phase (b): every --opt name (lookahead_adamp and bf16 moments too) for
    OPT_STEPS steps on full-width ft_vit f32 weights (OPT_DEPTH blocks), on
    the card and on the CPU from one gradient sequence made on the CPU:
    each tensor's displacement within OPT_F32_REL (bf16 moments
    OPT_BF16_REL), AdamP / SGDP decisions counted where they differ (must be
    0), and a planted fault (one tensor's update skipped on the card) that
    the gate must catch (each optimizer's update at full depth is timed by
    tools/step_timers.py optimizers)."""
    from mem_tpu_torch.train import optim

    names = [n for n in optim.OPTIMIZERS if n not in ("nesterov", "nvnovograd")]
    rows = {}
    for name in names + ["lookahead_adamp", "bf16_adamw"]:
        t0 = time.perf_counter()
        start, want, grads, fired_cpu = opt_run(torch, name, torch.device("cpu"))
        t1 = time.perf_counter()
        _, got, _, fired_card = opt_run(torch, name, dev, grads)
        bound_rel = OPT_BF16_REL if name.startswith("bf16_") else OPT_F32_REL
        rel, bad = opt_gate(torch, start, want, got, bound_rel)
        differ = sum(int(a[k] != b[k]) for a, b in zip(fired_cpu, fired_card) for k in a)
        compared = sum(len(a) for a in fired_cpu)
        top = sorted(rel, key=rel.get, reverse=True)[:3]
        rows[name] = dict(worst={k: rel[k] for k in top}, median_rel=statistics.median(
                              rel.values()), bound=bound_rel, past=bad,
                          decisions_compared=compared, decisions_differing=differ,
                          fired=sum(v for a in fired_cpu for v in a.values()),
                          cpu_s=round(t1 - t0, 2), card_s=round(time.perf_counter() - t1, 2))
        print(f"opt_row {name} {json.dumps(rows[name])}", flush=True)
    for name, row in rows.items():
        check(not row["past"], f"--opt {name}: card vs CPU past {row['bound']} on {row['past']}")
        check(row["decisions_differing"] == 0, f"--opt {name}: {row['decisions_differing']} "
              f"of {row['decisions_compared']} AdamP decisions differ")
        if "adamp" in name or name == "sgdp":
            check(0 < row["fired"] < row["decisions_compared"],
                  f"--opt {name}: the projection fired {row['fired']} of "
                  f"{row['decisions_compared']}")
    # the planted fault: one tensor's update skipped on the card side
    start, want, grads, _ = opt_run(torch, "adamw", torch.device("cpu"))
    _, got, _, _ = opt_run(torch, "adamw", dev, grads, fault=OPT_FAULT_TENSOR)
    rel, bad = opt_gate(torch, start, want, got, OPT_F32_REL)
    say("optimizer_check", gpu=gpu, model="ft_vit", embed_dim=768, depth=OPT_DEPTH,
        steps=OPT_STEPS, layer_decay=0.75, clip=OPT_CLIP, rows=rows,
        planted_fault=dict(tensor=OPT_FAULT_TENSOR, rel=rel[OPT_FAULT_TENSOR], caught=bad))
    check(bad == [OPT_FAULT_TENSOR], f"the planted optimizer fault gave {bad}")


def timm_state_dict(torch, args):
    """A seeded timm ``vit_base_patch16_224``-named state_dict at pt_vit's
    shapes (seed 3, so the copied tensors differ from the CLI's seed-0
    initialisation), with the qkv biases and a head the warm start leaves."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    pt = R.build_model(args, torch.float32, torch.device("cpu"))
    pt.init_weights(torch.Generator().manual_seed(3))
    sd = {k: v for k, v in pt.state_dict().items()
          if k.startswith(("patch_embed.", "norm.")) or re.match(
              r"blocks\.\d+\.(norm[12]|attn\.qkv\.weight|attn\.proj|mlp\.fc[12])", k)}
    for i in range(args.transformer_depth):
        sd[f"blocks.{i}.attn.qkv.bias"] = torch.zeros(3 * args.transformer_emb)
    sd["head.weight"] = torch.zeros(1000, args.transformer_emb)
    return sd


def run_warm_start_cli(torch, gpu, flags, tmp_root):
    """Phase (c): run_mem_pretraining --bf16_moments 1 --pretrained 1
    --init_ckpt <seeded timm .pth> at full width for 2 steps (one epoch at
    B=64, no eval) with exact launch counts; the checkpoint holds bf16
    moments and weights that moved from the timm ones by the 2 steps only."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    out_dir = os.path.join(tmp_root, "pt_warm")
    # lr 1e-5: two steps move the weights ~1e-3 of their size, the seed-0
    # initialisation lies ~1.4 away
    common = flags + ["--output_dir", out_dir, "--batch_size", "64", "--epochs", "1",
                      "--warmup_steps", "2", "--lr", "1e-5", "--warmup_lr", "1e-6",
                      "--min_lr", "1e-6", "--device", "cuda",
                      "--disable_eval_during_pretraining"]
    timm = timm_state_dict(torch, R.get_args(common))
    path = os.path.join(tmp_root, "timm_vit_b16_seed3.pth")
    torch.save(timm, path)
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    hist = R.main(common + ["--bf16_moments", "1", "--pretrained", "1", "--init_ckpt", path])
    counts = launch_counts()              # just after it
    payload = load_checkpoint(os.path.join(out_dir, "checkpoint-final.pth"))
    moments = {st["exp_avg"].dtype for st in payload["optimizer"]["state"].values()}
    rel = {k: (torch.linalg.vector_norm(payload["model"][k].float() - timm[k])
               / torch.linalg.vector_norm(timm[k])).item()
           for k in ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "norm.weight")}
    say("warm_start_cli", model="pt_vit", embed_dim=768, depth=12, batch=64, steps=len(hist),
        losses=[h[1] for h in hist], launches=counts, moments=sorted(map(str, moments)),
        rel_from_timm=rel, seconds=round(time.perf_counter() - t0, 2))
    check(len(hist) == 2 and all(np.isfinite(h[1]) for h in hist), f"history {hist}")
    check(counts == {"hist_planes_cols": 2, "fused_attention_flat": 24,
                     "fused_attention_flat_bwd": 24},
          f"the warm-started pretraining run launched {counts}")
    check(moments == {torch.bfloat16}, f"moments stored as {moments}")
    check(all(v < 1e-2 for v in rel.values()), f"weights far from the timm ones: {rel}")
    return counts


def run_dataset_tools_slice(torch, dev, gpu, tmp_root):
    """The dataset tools and the optimizer switch: phases (a), (b) and (c),
    their inputs drawn from a generator of their own (the B=128 step with
    bf16 moments is tools_slice's trace_pretrain bf16_moments=1)."""
    rng = np.random.default_rng(20)
    data_root, vae_path = write_training_inputs(torch, tmp_root, rng)
    flags = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
             "--discrete_vae_weight_path", vae_path, "--num_workers", "4"]
    t0 = time.perf_counter()
    run_raw_to_card(torch, gpu, tmp_root, rng)
    t1 = time.perf_counter()
    check_optimizers(torch, dev, gpu)
    t2 = time.perf_counter()
    run_warm_start_cli(torch, gpu, flags, tmp_root)
    t3 = time.perf_counter()
    say("dataset_tools_slice", seconds=dict(raw_to_card=round(t1 - t0, 2),
                                            optimizers=round(t2 - t1, 2),
                                            warm_start_cli=round(t3 - t2, 2)))


# ---------------------------------------------------------------------------
# the measuring tools (tools/trace_*.py, tools/bench_*.py) at a cut size
# ---------------------------------------------------------------------------

# tool arguments -> the launch counters' exact counts a traced step (a batch)
PT_STEP = {"hist_planes_cols": 1, "fused_attention_flat": 12, "fused_attention_flat_bwd": 12}
FT_FUSED = {**PT_STEP, "mlp_fused": 12, "mlp_fused_bwd": 12}
FT_BHND = {"hist_planes_cols": 1, "fused_attention": 12, "fused_attention_bwd": 12}
MAE_STEP = {"hist_planes_cols": 1, "fused_attention_flat": 20, "fused_attention_flat_bwd": 20}
SEG_STEP = {"hist_planes_cols_sorted": 1, "fused_attention_flat_long": 12,
            "fused_attention_flat_long_bwd": 12}
SEG_LONG_OFF = {"hist_planes_cols_sorted": 1, "fused_attention_long": 12,
                "fused_attention_bwd_long": 12}
# the smallest batch of each step timing the tools took over, at steps=2
TOOL_RUNS = (
    ("trace_pretrain", ["B=64", "steps=2"], PT_STEP),
    ("trace_pretrain", ["B=64", "steps=2", "bf16_moments=1"], PT_STEP),
    ("trace_finetune", ["B=64", "steps=2", "fused_mlp=1"], FT_FUSED),
    ("trace_finetune", ["B=64", "steps=2", "flat=0"], FT_BHND),
    ("trace_mae", ["B=128", "steps=2"], MAE_STEP),
    ("trace_vae", ["B=64", "steps=2"], {"hist_planes_cols": 1}),
    ("trace_seg", ["B=8", "steps=2"], SEG_STEP),
    ("trace_infer", ["mode=cls", "B=8", "steps=2"],
     {"hist_planes_cols": 1, "fused_attention_flat": 12}),
    ("trace_infer", ["mode=cls", "B=8", "steps=2", "int8=1"],
     {"hist_planes_cols": 1, "fused_attention_flat": 12, "int8_mm": 36}),   # INT8_PRODUCTS
)
# the larger batches and the other toggles of those timings, at steps=1 (run
# with the card to themselves: the MAE at B=512 takes most of its memory)
TOOL_RUNS_BIG = (
    ("trace_pretrain", ["B=128", "steps=1"], PT_STEP),
    ("trace_finetune", ["B=64", "steps=1"], PT_STEP),
    ("trace_finetune", ["B=128", "steps=1"], PT_STEP),
    ("trace_finetune", ["B=128", "steps=1", "fused_mlp=1"], FT_FUSED),
    ("trace_finetune", ["B=128", "steps=1", "flat=0"], FT_BHND),
    ("trace_mae", ["B=512", "steps=1"], MAE_STEP),
    ("trace_vae", ["B=192", "steps=1"], {"hist_planes_cols": 1}),
    ("trace_seg", ["B=16", "steps=1"], SEG_STEP),
    ("trace_seg", ["B=16", "steps=1", "flat_long=0"], SEG_LONG_OFF),
)


def run_tool(name, argv):
    """``mem_tpu_torch.tools.<name>.main(argv)`` with its output captured,
    printed (indented) and returned with its JSON lines and seconds."""
    import importlib

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(f"mem_tpu_torch.tools.{name}").main(argv)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    print("\n".join(f"  | {ln}" for ln in text.splitlines()[-60:]), flush=True)
    check(rc == 0, f"{name} {argv} exited {rc}")
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")], seconds


def run_tool_checks(runs, seconds):
    """Each (tool, arguments, counts a step) of ``runs`` through its main:
    device ms > 0, finite losses and the launch counters' counts exact.
    Returns {"tool arguments": its JSON line}; the seconds go to
    ``seconds``."""
    out = {}
    for name, argv, per_step in runs:
        lines, sec = run_tool(name, argv)
        tag = " ".join([name] + argv)
        seconds[tag] = round(sec, 2)
        res = lines[-1]
        out[tag] = res
        want = {k: v * res["steps"] for k, v in per_step.items()}
        counted = res["counted"]
        check(res["device_ms_per_step"] > 0, f"{tag}: no device time recorded")
        check(counted == want, f"{tag} launched {counted}, not {want}")
        losses = res.get("losses", [])
        check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    return out


def run_tools_slice(torch, gpu, tmp_root, serve_bench):
    """The ten measuring tools through their main on the card at a cut size
    (``serve_bench``: bench_serve's line and seconds from the served slice,
    where its server ran): every trace tool at steps=2 and the smallest batch
    of the chip_smoke timings it took over (TOOL_RUNS), each breakdown with
    device ms > 0, finite losses and the launch counters' counts exact; bf16
    moments under 0.6 of the f32 state; the int8 forward's int8 GEMMs in its
    families and none in the bf16 one's; bench_pretrain_step at B=64 (3
    iterations a mode), bench_host_loader at B=32 on 40 files (one batch a
    setting, a mask pool of 512)
    and bench_host_feed at B=64 / seg B=8 (two batches) against the steps
    traced here. It runs beside the multi-GPU slice's processes, so its
    times are not the tools' own readings (PERF.md section 5 has those)."""
    seconds = {"bench_serve": serve_bench[1]}
    out = run_tool_checks(TOOL_RUNS, seconds)
    pt, pt16 = out["trace_pretrain B=64 steps=2"], out["trace_pretrain B=64 steps=2 bf16_moments=1"]
    check(pt16["optimizer_state_bytes"] < 0.6 * pt["optimizer_state_bytes"],
          f"bf16 moments: state {pt16['optimizer_state_bytes']} of "
          f"{pt['optimizer_state_bytes']}")
    fam16 = out["trace_infer mode=cls B=8 steps=2"]["families"]
    fam8 = out["trace_infer mode=cls B=8 steps=2 int8=1"]["families"]
    check(fam16.get("int8 GEMMs", 0.0) == 0.0 and fam8.get("int8 GEMMs", 0.0) > 0,
          f"the int8 forward's families {fam8}, the bf16 one's {fam16}")
    lines, sec = run_tool("bench_pretrain_step", ["B=64", "iters=3"])
    seconds["bench_pretrain_step"] = round(sec, 2)
    check(len(lines) == 2 and all(r["ms_per_step"] > 0 and np.isfinite(r["losses"]).all()
                                  for r in lines), f"bench_pretrain_step gave {lines}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        from mem_tpu_torch.tools import bench_host_loader
        bench_host_loader.main(["files=40", "nbatches=1", "B=32", "pool=512"])
    seconds["bench_host_loader"] = round(time.perf_counter() - t0, 2)
    rates = [float(m) for m in re.findall(r": (\d+) samples/s", buf.getvalue())]
    print("\n".join(f"  | {ln}" for ln in buf.getvalue().splitlines()), flush=True)
    check(len(rates) == 16 and min(rates) > 0, f"bench_host_loader rates {rates}")
    lines, sec = run_tool("bench_host_feed", [
        "B=64", "seg_B=8", "nbatches=2", "files=130", f"dir={tmp_root}",
        f"step_ms={pt['wall_ms_per_step']}",
        f"seg_step_ms={out['trace_seg B=8 steps=2']['wall_ms_per_step']}"])
    seconds["bench_host_feed"] = round(sec, 2)
    feed = lines[-1]
    check(feed["staging"]["pinned_gb_s"] > 0 and all(r["loader_samples_per_s"] > 0
                                                     for r in feed["rows"]),
          f"bench_host_feed gave {feed}")
    say("tools_slice", gpu=gpu, seconds=seconds, beside="the multi-GPU slice's processes",
        device_ms_per_step={k: v["device_ms_per_step"] for k, v in out.items()},
        bench_serve=serve_bench[0])


def run_tools_big_slice(gpu):
    """The trace tools at the larger batches and the other toggles of the
    step timings they took over (TOOL_RUNS_BIG: pretraining B=128, the
    finetune micro-batch 64 under the default toggles and 128 under the
    default toggles, FUSED_MLP alone and FLAT_ATTN = False alone, the MAE at
    B=512, the VAE at B=192, seg B=16 under both FLAT_ATTN_LONG settings),
    one traced step each, with the card
    to themselves: device ms > 0, finite losses, exact launch counts."""
    seconds = {}
    out = run_tool_checks(TOOL_RUNS_BIG, seconds)
    say("tools_big_slice", gpu=gpu, seconds=seconds,
        device_ms_per_step={k: v["device_ms_per_step"] for k, v in out.items()},
        peak_mem_gib={k: v["peak_mem_gib"] for k, v in out.items()})


# ---------------------------------------------------------------------------
# the IMNET real-image slice: JPEG two-view pretraining, the timm finetune and
# the VAE on images
# ---------------------------------------------------------------------------

IMNET_CLASSES = ("n01440764", "n01443537")
IMNET_PER_CLASS = {"train": 32, "val": 8}   # 64 train and 16 val JPEGs
IMNET_CLI_B = 16         # the CLI runs' batch: 4 steps an epoch, one val batch
IMNET_STEP_B = 2         # the card-vs-CPU pretraining step
IMNET_BIG_B = 128        # the bf16 pretraining step of two stacked host batches of 64
IMNET_PRE_B = 8          # preprocess_image_cls card vs CPU
# preprocess_image_cls card vs CPU on one batch, one set of draws and one
# erasing noise tensor: RandAugment's rounds run in f32 and truncate to
# uint8 once, so a sum taken in another order can flip one level at a few
# pixels; everything after the uint8 stage is exact
IMNET_IMG_TOL = 1.0 / 255 + 1e-6
IMNET_IMG_FRAC = 1e-3
# the card's own erasing fill from a CUDA generator: |mean| and |std - 1|
# over the boxes' values (at least 24k at B=8, so 0.05 is over 7 sigma)
IMNET_FILL_TOL = 0.05


def write_imnet_jpegs(root, rng):
    """ImageNet-like synthetic JPEGs: two synset folders, sides 256-500 px,
    a per-class pattern under noise, in data_root/{train,val}."""
    from PIL import Image

    for split, n in IMNET_PER_CLASS.items():
        for ci, cls in enumerate(IMNET_CLASSES):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(256, 501, 2))
                yy, xx = np.mgrid[:h, :w]
                base = np.stack([(xx * (1 + ci) + yy) % 256, (2 * yy) % 256,
                                 np.full((h, w), 60 + 120 * ci)], -1)
                img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{cls}_{i:04d}.JPEG"), quality=90)
    say("imnet_inputs", classes=len(IMNET_CLASSES),
        files={s: n * len(IMNET_CLASSES) for s, n in IMNET_PER_CLASS.items()},
        sides=[256, 500], mb=round(sum(len(b) for b in tree_bytes(root).values()) / 2**20, 2))


def write_seeded_vae(torch, path):
    """A seeded VAE tokenizer .pth at the conf's size (224^2, 8192 tokens,
    codebook 32, 4 layers, 3 ResBlocks, hidden 384)."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    hp = dict(input_H=224, input_W=224, num_tokens=8192, emb_dim=32, num_layers=4,
              num_resnet_blocks=3, hidden_dim=384, channels=3, loss="mse")
    vae = DiscreteVAE((224, 224), num_tokens=8192, codebook_dim=32, num_layers=4,
                      num_resnet_blocks=3, hidden_dim=384)
    vae.init_weights(torch.Generator().manual_seed(21))
    torch.save({"model": vae.state_dict(), "hparams": hp}, path)
    return path


@contextlib.contextmanager
def fixed_fill(noise):
    """Within the block, RandomErasing fills from ``noise`` (moved to the
    batch's device) instead of drawing: one noise tensor for both sides."""
    from mem_tpu_torch.ops import image_ops as I

    real = I.fill_noise
    I.fill_noise = lambda shape, generator, device, dtype: noise.to(device, dtype).expand(shape)
    try:
        yield
    finally:
        I.fill_noise = real


def imnet_args(module, root, extra):
    return module.get_args(["--config", "configs/ncaltech.conf", "--data_set", "IMNET",
                            "--data_path", root] + extra)


def erasing_mask(torch, draws, shape):
    """(B, H, W) bool: the pixels inside a sample's erasing boxes, gate on."""
    B, H, W = shape[:3]
    use = torch.from_numpy(draws["er_use"]).reshape(B, 1, 1)
    ys = torch.arange(H).reshape(1, H, 1)
    xs = torch.arange(W).reshape(1, 1, W)
    mask = torch.zeros(B, H, W, dtype=torch.bool)
    for box in torch.from_numpy(draws["er_box"]).long().unbind(1):
        t, l, hh, ww = (v.reshape(B, 1, 1) for v in box.unbind(1))
        mask |= (ys >= t) & (ys < t + hh) & (xs >= l) & (xs < l + ww)
    return mask & use


def check_imnet_preprocess(torch, dev, root):
    """preprocess_image_cls at B=8, 224^2 (the finetune's --aa
    rand-m9-mstd0.5-inc1; RandomErasing at prob 1 so that every sample has a
    box), card vs CPU on one host batch, one set of draws and one erasing
    noise tensor, per-sample and batch_ops: exact after the uint8 stage up to
    IMNET_IMG_TOL at IMNET_IMG_FRAC of the values. A planted fault, the
    erasing box shifted by one row on the card, must fail the gate. Then the
    card's own fill, drawn from the step's CUDA generator: inside the boxes
    N(0, 1) moments within IMNET_FILL_TOL, outside them the fixed-fill
    result exactly; a const fill (planted) must fail the moments."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli.common import imnet_aug, imnet_pipelines
    from mem_tpu_torch.data.device_pipeline import draw_image_aug
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.train.steps import step_generator

    cpu = torch.device("cpu")
    args = imnet_args(F, root, ["--reprob", "1.0"])
    _, it, _, _ = imnet_pipelines(args, IMNET_PRE_B)
    host = next(iter(it.epoch(0)))
    noise = torch.randn(host["image"].shape, generator=torch.Generator().manual_seed(21))
    out = {}
    for batch_ops in (False, True):
        image_preproc, settings = imnet_aug(args, batch_ops)
        draws = draw_image_aug(host["aug_seed"], host["image"].shape[1:3], **settings)
        shifted = draws["er_box"].copy()
        top, h = shifted[..., 0], shifted[..., 2]
        shifted[..., 0] = np.where(top + h < 224, top + 1, top - 1)
        res = {}
        for name, d, box in (("cpu", cpu, draws["er_box"]), ("card", dev, draws["er_box"]),
                             ("box_shifted", dev, shifted)):
            batch = to_device({**host, **draws, "er_box": box}, d)
            with fixed_fill(noise):
                res[name] = image_preproc(batch).cpu()
        stats = {}
        for name in ("card", "box_shifted"):
            diff = (res[name] - res["cpu"]).abs()
            stats[name] = dict(max_abs=diff.max().item(),
                               frac_differing=(diff > 1e-6).float().mean().item())
        key = "batch_ops" if batch_ops else "per_sample"
        out[key] = stats
        erased = (res["cpu"] < 0) | (res["cpu"] > 1)
        say("imnet_preprocess_check", form=key, batch=IMNET_PRE_B, shape=list(host["image"].shape),
            aa=args.aa, reprob=1.0, rand_aug_gate_share=float(draws["ra_gate"].mean()),
            erased_share=erased.float().mean().item(), tol=IMNET_IMG_TOL,
            frac_tol=IMNET_IMG_FRAC, **stats)
        check(stats["card"]["max_abs"] <= IMNET_IMG_TOL
              and stats["card"]["frac_differing"] <= IMNET_IMG_FRAC,
              f"IMNET card images differ from the CPU's ({key}): {stats['card']}")
        check(stats["box_shifted"]["max_abs"] > IMNET_IMG_TOL,
              f"the image gate does not see the erasing box shifted by a row ({key})")
        check(erased.any(dim=(1, 2, 3)).all().item(), f"an erasing box is missing ({key})")

        inside = erasing_mask(torch, draws, host["image"].shape)
        batch = to_device({**host, **draws}, dev)
        fills = {}
        for mode in (args.remode, "const"):
            own = image_preproc(batch, remode=mode,
                                generator=step_generator(args.seed, 0, dev)).cpu()
            vals = own[inside]
            fills[mode] = dict(mean=vals.mean().item(), std=vals.std().item(),
                               values=vals.numel(),
                               outside_equal=bool(torch.equal(own[~inside], res["card"][~inside])))
        say("imnet_erasing_fill_check", form=key, generator="step_generator(seed, 0, cuda)",
            tol=IMNET_FILL_TOL, **fills)
        own = fills[args.remode]
        check(abs(own["mean"]) <= IMNET_FILL_TOL and abs(own["std"] - 1) <= IMNET_FILL_TOL,
              f"the card's erasing fill is not N(0, 1) ({key}): {own}")
        check(own["outside_equal"], f"the card's own fill changed pixels outside its boxes ({key})")
        planted = fills["const"]
        check(abs(planted["std"] - 1) > IMNET_FILL_TOL,
              f"the fill's moment gate does not see a const fill ({key})")
        out[key]["fill"] = fills
    return out


def check_imnet_pretrain_step(torch, dev, gpu, root, vae_path):
    """One make_pretrain_train_step of pt_vit at full width (ViT-B/16, 224^2,
    vocab 8192), depth 2, B=2, drop-path 0, on a two-view IMNET host batch
    with the conf's tokenizer: the tokens of vae_view card vs CPU; the step on
    the CPU in f32 and on the card in f32 and bf16 on the CPU's tokens (the
    loss and every gradient at the pretraining step's gates), and a planted
    fault, the two views swapped on the card, that must fail the f32 gate.
    Then one bf16 step at depth 12 with its launch counts (K2f and K2b 12
    times, nothing else), and the same from a fresh thread."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.cli.common import build_preproc, imnet_pipelines
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    cpu = torch.device("cpu")
    flags = ["--discrete_vae_weight_path", vae_path, "--drop_path", "0",
             "--batch_size", str(IMNET_STEP_B), "--dtype", "float32"]
    args = imnet_args(R, root, flags + ["--transformer_depth", "2"])
    _, it, _, _ = imnet_pipelines(args, IMNET_STEP_B, (14, 14))
    host = next(iter(it.epoch(0)))
    pp = build_preproc(args, True, color_jitter=args.color_jitter)
    vae_cpu, vae_card = R.load_vae(args, cpu), R.load_vae(args, dev)
    view = torch.from_numpy(host["vae_view"])
    with torch.no_grad():
        tok_cpu = vae_cpu.get_codebook_indices(view)
        tok_card = vae_card.get_codebook_indices(view.to(dev)).cpu()
    agree = (tok_cpu == tok_card).float().mean().item()
    say("imnet_vae_tokens_check", tokens=tok_cpu.numel(), agree=agree, bound=VAE_TOKENS_AGREE,
        distinct=int(tok_cpu.unique().numel()), min_distinct=VAE_MIN_DISTINCT)
    check(agree >= VAE_TOKENS_AGREE, f"IMNET VAE tokens agree on {agree}")
    check(tok_cpu.unique().numel() >= VAE_MIN_DISTINCT,
          f"the seeded VAE gave {tok_cpu.unique().numel()} distinct tokens")

    lr = np.array([args.lr])
    fixed = _FixedTokens(tok_cpu)
    out = {}
    for name, d, dt, vae, swap in (("cpu_f32", cpu, torch.float32, vae_cpu, False),
                                   ("card_f32", dev, torch.float32, fixed, False),
                                   ("card_bf16", dev, torch.bfloat16, fixed, False),
                                   ("views_swapped", dev, torch.float32, fixed, True)):
        model, step, _ = make_step(torch, R, args, d, dt, vae, pp, lr)
        batch = to_device(host, d)
        if swap:
            batch["patches"], batch["vae_view"] = batch["vae_view"], batch["patches"]
        m = step(batch, 0)
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        del model, step
    ref = out["cpu_f32"][0]
    loss_rel = {n: abs(out[n][0]["loss"] - ref["loss"]) / abs(ref["loss"])
                for n in ("card_f32", "card_bf16")}
    grads = {n: grad_rel(torch, out[n][1], out["cpu_f32"][1]) for n in out if n != "cpu_f32"}
    say("imnet_train_step_check", model="pt_vit", embed_dim=args.transformer_emb, depth=2,
        heads=args.transformer_heads, img=[224, 224], vocab=args.num_tokens,
        batch=IMNET_STEP_B, metrics={n: v[0] for n, v in out.items()}, loss_rel=loss_rel,
        grad_rel_l2_vs_cpu_f32=grads,
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad=STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL, bf16_grad=STEP_BF16_GRAD_REL))
    check(all(np.isfinite(v) for v in ref.values()), "IMNET CPU step metrics not finite")
    check(loss_rel["card_f32"] <= STEP_F32_LOSS_REL, f"IMNET f32 step loss rel {loss_rel}")
    check(grads["card_f32"]["max"] <= STEP_F32_GRAD_REL, f"IMNET f32 grads {grads['card_f32']}")
    check(loss_rel["card_bf16"] <= STEP_BF16_LOSS_REL, f"IMNET bf16 step loss rel {loss_rel}")
    check(grads["card_bf16"]["max"] <= STEP_BF16_GRAD_REL,
          f"IMNET bf16 grads {grads['card_bf16']}")
    check(grads["views_swapped"]["max"] > STEP_F32_GRAD_REL,
          f"the gradient gate does not see the two views swapped: {grads['views_swapped']}")

    # full depth, bf16: the launches of one step, on this thread and a fresh one
    args12 = imnet_args(R, root, flags)
    model, step, _ = make_step(torch, R, args12, dev, torch.bfloat16, vae_card, pp, lr)
    batch = to_device(host, dev)
    counts = {}

    def one(tag):
        reset_launch_counts()             # just before the step
        m = step(batch, 0)
        torch.cuda.synchronize()
        counts[tag] = launch_counts()     # just after it
        return m["loss"].item()

    losses = {"main": one("main")}
    fresh = {}
    t = threading.Thread(target=lambda: fresh.update(loss=one("fresh_thread")), daemon=True)
    t.start()
    t.join(timeout=300)
    check(not t.is_alive(), "the IMNET step on a fresh thread did not finish in 300 s")
    losses["fresh_thread"] = fresh.get("loss")
    want = {"fused_attention_flat": 12, "fused_attention_flat_bwd": 12}
    say("imnet_step_launches", depth=12, dtype="bfloat16", batch=IMNET_STEP_B, launches=counts,
        want=want, losses=losses)
    check(counts.get("main") == want, f"the IMNET bf16 step launched {counts.get('main')}")
    check(counts.get("fresh_thread") == want and losses["fresh_thread"] is not None
          and np.isfinite(losses["fresh_thread"]),
          f"the IMNET step from a fresh thread: {counts.get('fresh_thread')}, {losses}")
    del model, step
    torch.cuda.empty_cache()
    return grads


def run_imnet_clis(torch, root, vae_path, tmp_root):
    """The three CLIs with --data_set IMNET on the card at the conf's full
    width, one epoch of 4 steps (IMNET_CLI_B) each: run_mem_pretraining
    (ViT-B/16, bf16, the seeded tokenizer, --dump_recon_dir), then
    run_class_finetuning (ft_vit, the default --aa rand-m9-mstd0.5-inc1,
    --reprob 0.25, mixup and cutmix on, EMA), then train_vae (hidden 384,
    8192 tokens, an evaluation). Each must launch exactly: K2f once a block
    per forward and K2b once a block per train step; the VAE nothing of the
    port's. Returns each run's launch counts."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.cli import train_vae as T
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    def drive(tag, module, flags):
        out_dir = os.path.join(tmp_root, tag)
        t0 = time.perf_counter()
        reset_launch_counts()             # just before the main path
        res = module.main(["--config", "configs/ncaltech.conf", "--data_set", "IMNET",
                           "--data_path", root, "--output_dir", out_dir, "--epochs", "1",
                           "--batch_size", str(IMNET_CLI_B), "--device", "cuda"] + flags)
        counts = launch_counts()          # just after it
        return res, counts, out_dir, round(time.perf_counter() - t0, 2)

    dump = os.path.join(tmp_root, "imnet_dump")
    hist, pt_counts, pt_dir, pt_s = drive("imnet_pt", R, [
        "--discrete_vae_weight_path", vae_path, "--warmup_steps", "2",
        "--dump_recon_dir", dump])
    say("imnet_pretrain_cli", model="pt_vit", embed_dim=768, depth=12, heads=12, img=[224, 224],
        batch=IMNET_CLI_B, steps=len(hist), losses=[h[1] for h in hist],
        mlm_acc=[h[2] for h in hist], launches=pt_counts, checkpoints=sorted(os.listdir(pt_dir)),
        panels=sorted(os.listdir(dump)), seconds=pt_s)
    # 4 train steps and one val batch
    check(pt_counts == {"fused_attention_flat": 12 * 5, "fused_attention_flat_bwd": 12 * 4},
          f"the IMNET pretraining run launched {pt_counts}")
    check(len(hist) == 4 and all(np.isfinite(h[1]) for h in hist), f"IMNET losses {hist}")
    check("checkpoint-final.pth" in os.listdir(pt_dir) and "recon_ep0.png" in os.listdir(dump),
          "the IMNET pretraining run wrote no checkpoint or panel")

    ft, ft_counts, ft_dir, ft_s = drive("imnet_ft", F, [
        "--update_freq", "1", "--mixup_prob", "1.0", "--warmup_steps", "2"])
    say("imnet_finetune_cli", model="ft_vit", embed_dim=768, depth=12, heads=12, img=[224, 224],
        classes=len(IMNET_CLASSES), batch=IMNET_CLI_B, aa="rand-m9-mstd0.5-inc1",
        reprob=0.25, mixup_prob=1.0, history=ft["history"], evals=ft["evals"],
        launches=ft_counts, checkpoints=sorted(os.listdir(ft_dir)), seconds=ft_s)
    # 4 train steps; one val batch with the raw and with the EMA weights
    check(ft_counts == {"fused_attention_flat": 12 * 6, "fused_attention_flat_bwd": 12 * 4},
          f"the IMNET finetune run launched {ft_counts}")
    check(ft["history"] and all(np.isfinite(h[1]) for h in ft["history"])
          and np.isfinite(ft["evals"][0][1]["loss"]), f"IMNET finetune {ft}")
    check("checkpoint-0.pth" in os.listdir(ft_dir), "the IMNET finetune wrote no checkpoint")

    vh, vae_counts, vae_dir, vae_s = drive("imnet_vae", T, ["--eval_freq", "1"])
    hp = load_checkpoint(os.path.join(vae_dir, "checkpoint-final.pth"))["hparams"]
    say("imnet_vae_cli", hidden=384, tokens=8192, img=[224, 224], batch=IMNET_CLI_B,
        dtype="bfloat16", losses=[h[1] for h in vh], launches=vae_counts, hparams=hp,
        checkpoints=sorted(os.listdir(vae_dir)), seconds=vae_s)
    check(vae_counts == {}, f"the IMNET VAE run launched {vae_counts}")
    check(len(vh) == 4 and all(np.isfinite(h[1]) for h in vh), f"IMNET VAE losses {vh}")
    check(hp["input_H"] == hp["input_W"] == 224, f"IMNET VAE hparams {hp}")
    return {"pretrain": pt_counts, "finetune": ft_counts, "vae": vae_counts}


def check_imnet_big_step(torch, dev, root, vae_path):
    """The bf16 IMNET pretraining step at B=128 (ViT-B/16, depth 12, the
    seeded tokenizer; two host batches of 64 stacked): three steps on one
    batch, finite losses."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.cli.common import build_preproc, imnet_pipelines
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.train.schedules import cosine_scheduler

    pt_args = imnet_args(R, root, ["--discrete_vae_weight_path", vae_path])
    _, big, _, _ = imnet_pipelines(pt_args, 64, (14, 14))
    parts = [next(iter(big.epoch(e))) for e in range(2)]
    host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    lr = cosine_scheduler(pt_args.lr, pt_args.min_lr, 1, 100, warmup_steps=0)
    model, step, _ = make_step(torch, R, pt_args, dev, torch.bfloat16,
                               R.load_vae(pt_args, dev), build_preproc(pt_args, True), lr)
    losses = repeated_batch_losses(step, to_device(host, dev), 3)
    say("imnet_big_step", batch=IMNET_BIG_B, losses=losses)
    check(len(host["mask"]) == IMNET_BIG_B and all(np.isfinite(losses)),
          f"IMNET B={IMNET_BIG_B} losses {losses}")
    del model, step
    torch.cuda.empty_cache()


def run_imnet_slice(torch, dev, gpu, tmp_root):
    """The IMNET slice, its inputs drawn from a generator of its own."""
    rng = np.random.default_rng(21)
    root = os.path.join(tmp_root, "imagenet_jpeg")
    t = [time.perf_counter()]
    write_imnet_jpegs(root, rng)
    vae_path = write_seeded_vae(torch, os.path.join(tmp_root, "imnet_vae_seed21.pth"))
    t.append(time.perf_counter())
    check_imnet_preprocess(torch, dev, root)
    t.append(time.perf_counter())
    check_imnet_pretrain_step(torch, dev, gpu, root, vae_path)
    t.append(time.perf_counter())
    counts = run_imnet_clis(torch, root, vae_path, tmp_root)
    t.append(time.perf_counter())
    check_imnet_big_step(torch, dev, root, vae_path)
    t.append(time.perf_counter())
    names = ("inputs", "preprocess", "pretrain_step", "clis", "big_step")
    say("imnet_slice", seconds={n: round(b - a, 2) for n, a, b in zip(names, t, t[1:])})
    return counts


# ---------------------------------------------------------------------------
# W8A8 int8 serving (ops/quant.py, models.vit.INT8_GEMM), the logging and
# profiling sinks, the pipeline script
# ---------------------------------------------------------------------------

INT8_ROWS = (1576, 12608)     # ViT-B's token rows at serving B=8 and B=64
INT8_WIDTHS = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072)}  # (C_in, C_out)
INT8_PRODUCTS = 36            # int8 products a ViT-B forward: 12 blocks x (qkv, proj, fc1)
INT8_DATA_FILES = (8, 16)     # train / val .npy files of the finetune --eval run
INT8_EVAL_B = 16              # its eval batch: the val split in one batch
INT8_SEG_PAIRS = 8            # test_seg --int8 1: one batch of 8
PIPE_FILES = (12, 4)          # run-pipeline-torch.sh's tiny set: per class, train / val
                              # (3 steps an epoch at B=8: the pretraining stage traces its third)


def per_input_channel_scales(torch):
    """A planted fault for ``ops.quant.quantize_weight``: the weight scales
    taken per input channel (the absmax over the other axis), the output
    columns dequantized with their mean."""
    from mem_tpu_torch.ops import quant

    def faulty(w):
        wf = w.float()
        s_in = quant._scale(wf.abs().amax(dim=1))
        wq = torch.round(wf / s_in[:, None]).to(torch.int8)
        return wq, s_in.mean().expand(wf.shape[1]).contiguous()

    return faulty


def check_int8_ops(torch, dev, g):
    """The int8 pieces card vs CPU on the same inputs: quantize_activation /
    quantize_weight bit-equal, the torch._int_mm accumulators bit-equal to
    the exact CPU product of the same int8 operands at ViT-B's shapes (the
    weight as the models pass it, a transposed nn.Linear weight, and
    contiguous), dense_w8a8 in f32
    bit-equal or within one ulp (the count of each is printed); the planted
    per-input-channel scales must fail that gate; a refused shape raises."""
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import quant

    for R in INT8_ROWS:
        x = torch.randn(R, 768, generator=g).to(torch.bfloat16)
        x[1] = 0
        xq_c, rs_c = quant.quantize_activation(x)
        xq_d, rs_d = quant.quantize_activation(x.to(dev))
        q_same = torch.equal(xq_d.cpu(), xq_c) and torch.equal(rs_d.cpu(), rs_c)
        for name, (K, N) in INT8_WIDTHS.items():
            lin = (0.02 * torch.randn(N, K, generator=g))          # nn.Linear's (out, in)
            lin[:, 3] = 0
            w = lin.t()
            wq_c, cs_c = quant.quantize_weight(w)
            wq_d, cs_d = quant.quantize_weight(w.to(dev))
            w_same = torch.equal(wq_d.cpu(), wq_c) and torch.equal(cs_d.cpu(), cs_c)
            reset_launch_counts()
            acc_d = quant.int8_matmul(xq_d, wq_d)
            acc_dc = quant.int8_matmul(xq_d, wq_d.contiguous())
            counts = launch_counts()
            acc_c = quant.int8_matmul(xq_d.cpu(), wq_d.cpu())
            acc_same = torch.equal(acc_d.cpu(), acc_c) and torch.equal(acc_dc.cpu(), acc_c)
            b = torch.randn(N, generator=g)
            out_c = quant.dense_w8a8(x.float(), w, b)
            out_d = quant.dense_w8a8(x.float().to(dev), w.to(dev), b.to(dev)).cpu()
            ulp = torch.from_numpy(np.spacing(np.abs(out_c.numpy())))
            diff = (out_d - out_c).abs()
            within = bool((diff <= ulp).all())
            exact = int((diff == 0).sum())
            say("int8_ops_check", rows=R, product=name, shape=[R, K, N],
                quantize_bit_equal=q_same, weight_bit_equal=w_same,
                int32_bit_equal=acc_same, launches=counts,
                dense_f32_exact=exact, dense_f32_within_1ulp=within,
                dense_f32_elements=out_c.numel(), dense_max_abs=diff.max().item())
            check(q_same and w_same, f"int8 quantize card vs CPU differ at {R} rows, {name}")
            check(acc_same, f"torch._int_mm accumulators differ from the exact product, "
                            f"{R} x {K} x {N}")
            check(counts == {"int8_mm": 2}, f"int8_matmul launched {counts}")
            check(within, f"dense_w8a8 card vs CPU beyond one ulp: {diff.max().item()}")
    # the planted fault: per-input-channel weight scales on the card
    K, N = INT8_WIDTHS["fc1"]
    w = (0.02 * torch.randn(N, K, generator=g)).t()
    x = torch.randn(INT8_ROWS[0], K, generator=g)
    want = quant.dense_w8a8(x, w)
    real = quant.quantize_weight
    quant.quantize_weight = per_input_channel_scales(torch)
    try:
        got = quant.dense_w8a8(x.to(dev), w.to(dev)).cpu()
    finally:
        quant.quantize_weight = real
    caught = not bool(((got - want).abs() <= torch.from_numpy(
        np.spacing(np.abs(want.numpy())))).all())
    say("int8_fault_per_input_scales", rel_l2=rel_l2(torch, got, want), caught=caught)
    check(caught, "per-input-channel weight scales passed the dense_w8a8 gate")
    # a shape torch._int_mm refuses raises, never falls back
    try:
        quant.int8_matmul(torch.zeros(16, 768, dtype=torch.int8, device=dev),
                          torch.zeros(768, 768, dtype=torch.int8, device=dev))
        refused = False
    except ValueError:
        refused = True
    say("int8_refused_shape", rows=16, raised=refused)
    check(refused, "int8_matmul took 16 rows on the card")


def write_int8_inputs(torch, dev, root, rng):
    """The slice's inputs: an N-Caltech-like .npy set (INT8_DATA_FILES, 8
    classes), DSEC-like val pairs, and seeded full-width checkpoints of the
    serving ft_vit and the segmentor (drawn on the card from a CUDA
    generator: the CPU's draws of ~190 M values take seconds)."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.models.segmentation import build_segmentor

    data_root = os.path.join(root, "ncaltech101")
    for split, n in zip(("train", "val"), INT8_DATA_FILES):
        for i in range(n):
            d = os.path.join(data_root, split, f"class_{i % 8}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"image_{i:04d}.npy"),
                    synthetic_events(rng, int(rng.integers(20_000, 40_001))))
    seg_root = os.path.join(root, "dsec")
    write_seg_pairs(seg_root, "val", INT8_SEG_PAIRS, rng)
    paths = {n: os.path.join(root, f"{n}_seed22.pth") for n in ("ft_vit", "seg")}
    ft_args = serve.get_args(["--checkpoint", paths["ft_vit"], "--nb_classes", "101"])
    for name, model in (("ft_vit", build_classifier(ft_args, 101, torch.float32, dev)),
                        ("seg", build_segmentor(11, 512, 768, 12, 12, torch.float32, dev))):
        model.init_weights(torch.Generator(device=dev).manual_seed(22))
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}, "epoch": 0},
                   paths[name])
        del model
    return data_root, seg_root, paths


def check_int8_forwards(torch, dev, gpu, paths, rng):
    """The full-width int8 forwards: ft_vit at B=8 and the segmentor at B=2,
    card (bf16 + int8) against the CPU (f32 + int8, the plain products)
    within the bf16 gates, ft_vit also card f32 + int8 on the CPU's images
    within the f32 gate (1e-3), which the planted per-input-channel weight
    scales must fail; int8 against bf16 on the card (relative L2, top-1 /
    pixel agreement), the int8 products counted; the ft_vit int8 forward
    from a fresh thread. Returns the payloads the CLIs serve (the int8
    forward's timing and families are tools/trace_infer.py int8=1's)."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli.common import build_classifier, build_preproc
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.ops import quant
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    cpu = torch.device("cpu")
    args = serve.get_args(["--checkpoint", paths["ft_vit"], "--nb_classes", "101"])
    pp = build_preproc(args, is_train=False)
    payloads = [synthetic_events(rng, 30_000) for _ in range(64)]
    batch8 = serve.make_assemble(args, pp)([(p, False) for p in payloads[:8]], 8)
    sd = load_checkpoint(paths["ft_vit"])["model"]
    models = {}
    for name, dt, d in (("cpu", torch.float32, cpu), ("card", torch.bfloat16, dev),
                        ("card_f32", torch.float32, dev)):
        models[name] = build_classifier(args, 101, dt, d)
        models[name].load_state_dict(sd, strict=True)
        models[name].eval()
    with torch.inference_mode():
        images_cpu = preprocess_batch(serve.to_device(batch8, cpu), pp, is_train=False)
        images = preprocess_batch(serve.to_device(batch8, dev), pp, is_train=False)
        with vit.int8_gemm():
            want = models["cpu"](images_cpu)
            reset_launch_counts()
            got = models["card"](images)
            torch.cuda.synchronize()
            counts = launch_counts()
            got32 = models["card_f32"](images_cpu.to(dev)).cpu()
            real = quant.quantize_weight
            quant.quantize_weight = per_input_channel_scales(torch)
            try:
                faulted = models["card_f32"](images_cpu.to(dev)).cpu()
            finally:
                quant.quantize_weight = real
        bf16 = models["card"](images)
    del models["card_f32"]
    rel, rel32 = rel_l2(torch, got.cpu(), want), rel_l2(torch, got32, want)
    rel_fault = rel_l2(torch, faulted, want)
    rel_bf16 = rel_l2(torch, got, bf16)
    top1 = (got.argmax(-1) == bf16.argmax(-1)).float().mean().item()
    say("int8_logits_check", model="ft_vit", batch=8, rel_l2_card_vs_cpu_bf16=rel,
        bound_bf16=LOGITS_BF16_REL, rel_l2_card_vs_cpu_f32=rel32, bound_f32=LOGITS_F32_REL,
        rel_l2_int8_vs_bf16=rel_bf16, top1_agree_int8_vs_bf16=top1,
        rel_l2_f32_fault_per_input_scales=rel_fault, launches=counts,
        logits_abs_mean=want.abs().mean().item())
    check(bool(torch.isfinite(got).all()) and got.shape == (8, 101), "int8 logits not finite")
    check(rel <= LOGITS_BF16_REL, f"int8 ft_vit bf16 logits card vs CPU rel L2 {rel}")
    check(rel32 <= LOGITS_F32_REL, f"int8 ft_vit f32 logits card vs CPU rel L2 {rel32}")
    check(rel_fault > LOGITS_F32_REL,
          f"per-input-channel weight scales passed the f32 int8 gate ({rel_fault})")
    check(counts == {"int8_mm": INT8_PRODUCTS, "fused_attention_flat": 12},
          f"the int8 ft_vit forward launched {counts}")

    def forward():               # inference mode is per thread: entered on each
        with torch.inference_mode(), vit.int8_gemm():
            return (models["card"](images),)

    fresh_thread_check(torch, "int8_fresh_thread", forward)

    # the segmentor at B=2, card against CPU on the CPU's images
    seg_sd = load_checkpoint(paths["seg"])["model"]
    segs = {}
    for name, dt, d in (("cpu", torch.float32, cpu), ("card", torch.bfloat16, dev)):
        segs[name] = build_segmentor(11, 512, 768, 12, 12, dt, d)
        segs[name].load_state_dict(seg_sd, strict=True)
        segs[name].eval()
    seg_payloads = [synthetic_dsec_events(rng, 170_000).astype(np.float64) for _ in range(8)]
    assemble = serve.make_seg_assemble(SEG_EVENTS, True)
    tensors = lambda b, d: {n: torch.from_numpy(v).to(d) for n, v in b.items()}  # noqa: E731
    t0 = time.perf_counter()
    with torch.inference_mode():
        seg_images = seg_preprocess_batch(tensors(assemble(
            [(p, False) for p in seg_payloads[:2]], 2), cpu), False, y_sorted=True)[0]
        with vit.int8_gemm():
            seg_want = segs["cpu"](seg_images)[0]
            cpu_s = time.perf_counter() - t0
            reset_launch_counts()
            seg_got = segs["card"](seg_images.to(dev))[0]
            torch.cuda.synchronize()
            seg_counts = launch_counts()
        seg_bf16 = segs["card"](seg_images.to(dev))[0]
    del segs["cpu"]
    seg_rel = rel_l2(torch, seg_got.cpu(), seg_want)
    seg_rel_bf16 = rel_l2(torch, seg_got, seg_bf16)
    pix = (seg_got.argmax(-1) == seg_bf16.argmax(-1)).float().mean().item()
    say("int8_seg_logits_check", batch=2, cpu_seconds=round(cpu_s, 1),
        rel_l2_card_vs_cpu=seg_rel, bound=SEG_BF16_REL, rel_l2_int8_vs_bf16=seg_rel_bf16,
        pixel_agree_int8_vs_bf16=pix, launches=seg_counts)
    check(bool(torch.isfinite(seg_got).all()) and seg_got.shape == (2, 440, 640, 11),
          "int8 seg logits not finite")
    check(seg_rel <= SEG_BF16_REL, f"int8 seg logits card vs CPU rel L2 {seg_rel}")
    check(seg_counts == {"int8_mm": INT8_PRODUCTS, "fused_attention_flat_long": 12},
          f"the int8 seg forward launched {seg_counts}")
    del models["cpu"]
    return dict(args=args, pp=pp, model=models["card"], payloads=payloads,
                seg=segs["card"], seg_payloads=seg_payloads, seg_assemble=assemble)


def forward_families(torch, fn, n=2):
    """(device ms per call by ``step_timers.family``, the int8 GEMMs' kernel
    names) from torch.profiler over ``n`` calls of ``fn`` after 3 warm-up
    calls; the trace can lose records, so the sums are a floor."""
    from torch.profiler import ProfilerActivity, profile

    from mem_tpu_torch.tools.step_timers import device_records, family

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    fam, names = {}, set()
    for name, _, us in device_records(prof):
        f = family(name)
        fam[f] = fam.get(f, 0.0) + us / 1e3 / n
        if f == "int8 GEMMs":
            names.add(name[:90])
    return fam, sorted(names)


def check_int8_families(torch, dev, gpu, fw):
    """bf16 against int8 forwards on the card, cls at B=8 and 64 (the served
    forward: preprocessing, ft_vit, softmax, top-k) and seg at B=8: the int8
    forward's device records hold int8 GEMMs and the bf16 one's none (their
    times: tools/trace_infer.py int8=1)."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
    from mem_tpu_torch.models import vit

    cases = []
    for B in (8, 64):
        b = serve.to_device(serve.make_assemble(fw["args"], fw["pp"])(
            [(p, False) for p in fw["payloads"][:B]], B), dev)
        cases.append(("cls", B, functools.partial(serve.classify, fw["model"], fw["pp"], b, 5)))
    seg_b = {n: torch.from_numpy(v).to(dev) for n, v in fw["seg_assemble"](
        [(p, False) for p in fw["seg_payloads"]], 8).items()}
    cases.append(("seg", 8, lambda: fw["seg"](seg_preprocess_batch(
        seg_b, False, y_sorted=True)[0])[0].float().argmax(-1)))

    def int8(fn):
        def run():
            with vit.int8_gemm():
                return fn()
        return run

    with torch.inference_mode():
        for surface, B, fn in cases:
            fam16, _ = forward_families(torch, fn)
            fam8, names = forward_families(torch, int8(fn))
            say("int8_families_check", gpu=gpu, surface=surface, batch=B,
                families_bf16={k: round(v, 4) for k, v in fam16.items()},
                families_int8={k: round(v, 4) for k, v in fam8.items()},
                int8_gemm_kernels=names)
            check(fam16.get("int8 GEMMs", 0.0) == 0.0 and fam8.get("int8 GEMMs", 0.0) > 0,
                  f"the {surface} B={B} forwards' int8 GEMMs: bf16 {fam16}, int8 {fam8}")


def run_int8_clis(torch, data_root, seg_root, paths, fw):
    """serve --int8 1 on both surfaces over HTTP, test_seg --int8 1 (its
    table printed) and run_class_finetuning --int8 1 --eval, each with its
    launches counted exactly: per forward K1 or K4 once, K2f or K3f 12
    times and 36 int8 products."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli import test_seg as T
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.models import vit

    out = {}
    for surface, flags, reqs in (
            ("cls", ["--checkpoint", paths["ft_vit"], "--nb_classes", "101"], fw["payloads"][:10]),
            ("seg", ["--checkpoint", paths["seg"], "--surface", "seg", "--nb_classes", "11",
                     "--slice_max_evs", str(SEG_EVENTS)], fw["seg_payloads"][:3])):
        args = serve.get_args(flags + ["--batch_size", "8", "--max_wait_ms", "5", "--port", "0",
                                       "--int8", "1", "--device", "cuda"])
        with http_server(serve, args, quiet=True) as (post, read_stats, build_s):
            reset_launch_counts()
            if surface == "cls":
                with ThreadPoolExecutor(8) as pool:
                    answers = list(pool.map(post, reqs[:8]))
                answers += [post(p) for p in reqs[8:]]
            else:
                answers = [post(p) for p in reqs]
            counts = launch_counts()
            stats = read_stats()
        b = stats["batches"]
        want = ({"int8_mm": INT8_PRODUCTS * b, "fused_attention_flat": 12 * b,
                 "hist_planes_cols": b} if surface == "cls" else
                {"int8_mm": INT8_PRODUCTS * b, "fused_attention_flat_long": 12 * b,
                 "hist_planes_cols_sorted": b})
        say("int8_serve", surface=surface, requests=len(answers), batches=b,
            codes=sorted({a[0] for a in answers}), launches=counts,
            p50_ms=statistics.median(a[3] for a in answers), flag_after=vit.INT8_GEMM)
        check(all(a[0] == 200 for a in answers), f"serve --int8 1 ({surface}) answered "
                                                 f"{[a[0] for a in answers]}")
        check(counts == want, f"serve --int8 1 ({surface}) launched {counts}, not {want}")
        check(vit.INT8_GEMM is False, "serve --int8 1 left the flag set")
        out[surface] = counts

    reset_launch_counts()
    stats = T.main(["--data_root", seg_root, "--checkpoint", paths["seg"], "--int8", "1",
                    "--device", "cuda"])
    counts = launch_counts()
    say("int8_test_seg", pairs=INT8_SEG_PAIRS, mIoU=stats["mIoU"], aAcc=stats["aAcc"],
        launches=counts)
    check(np.isfinite(stats["mIoU"]), "test_seg --int8 1: mIoU not finite")
    check(counts == {"int8_mm": INT8_PRODUCTS, "fused_attention_flat_long": 12,
                     "hist_planes_cols_sorted": 1}, f"test_seg --int8 1 launched {counts}")
    out["test_seg"] = counts

    ft_out = os.path.join(os.path.dirname(paths["ft_vit"]), "ft_int8")
    reset_launch_counts()
    res = F.main(["--config", "configs/ncaltech.conf", "--data_path", data_root,
                  "--output_dir", ft_out,
                  "--batch_size", str(2 * INT8_EVAL_B), "--update_freq", "2", "--eval",
                  "--int8", "1", "--num_workers", "2", "--device", "cuda"])
    counts = launch_counts()
    stats = res["evals"][0][1]
    say("int8_finetune_eval", val_files=INT8_DATA_FILES[1], acc1=stats["acc1"],
        acc5=stats["acc5"], loss=stats["loss"], launches=counts)
    check(np.isfinite(stats["loss"]), "finetune --int8 1 --eval: loss not finite")
    check(counts == {"int8_mm": INT8_PRODUCTS, "fused_attention_flat": 12,
                     "hist_planes_cols": 1}, f"finetune --int8 1 --eval launched {counts}")
    out["finetune_eval"] = counts
    return out


def run_int8_slice(torch, dev, gpu, tmp_root, beside_pipeline=None):
    """W8A8 serving on the card, its inputs drawn from a generator of its
    own: the int8 pieces, the forwards, the CLIs; the pipeline script runs in
    processes of its own beside the checks and ``beside_pipeline()``; then
    the int8 families of the cls and seg forwards. Returns the CLIs' launch
    counts."""
    rng = np.random.default_rng(22)
    g = torch.Generator().manual_seed(22)
    t = [time.perf_counter()]
    pipeline = start_pipeline_script(tmp_root, rng)
    data_root, seg_root, paths = write_int8_inputs(torch, dev, tmp_root, rng)
    t.append(time.perf_counter())
    check_int8_ops(torch, dev, g)
    t.append(time.perf_counter())
    fw = check_int8_forwards(torch, dev, gpu, paths, rng)
    t.append(time.perf_counter())
    counts = run_int8_clis(torch, data_root, seg_root, paths, fw)
    t.append(time.perf_counter())
    if beside_pipeline is not None:
        beside_pipeline()
    t.append(time.perf_counter())
    finish_pipeline_script(torch, *pipeline)
    t.append(time.perf_counter())
    check_int8_families(torch, dev, gpu, fw)
    t.append(time.perf_counter())
    names = ("inputs", "ops", "forwards", "clis", "beside_pipeline", "pipeline_wait",
             "families")
    say("int8_slice", seconds={n: round(b - a, 2) for n, a, b in zip(names, t, t[1:])})
    return counts


def check_pretrain_sinks(torch, prof, logs, mem):
    """The sinks of a pretraining CLI run of depth 12 with --profile_dir
    ``prof`` and --log_dir ``logs/``: the trace of its third step
    names K1 once, K2f 12 times and K2b's rows, columns and bias-sum kernels
    12 times each; the TensorBoard event file exists where
    torch.utils.tensorboard imports; ``mem``, device_memory_stats() of this
    process, reports the card's peak."""
    traces = sorted(os.listdir(prof))
    check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"), f"traces {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(e.get("name", "") for e in events
                                  if e.get("cat") == "kernel")
    by = {tag: sum(c for n, c in kernels.items() if frag in n)
          for tag, frag in (("K1", "hist_band_kernel"),
                            ("K2f", "attention_long_fwd_wgmma_kernel"),
                            ("K2b_rows", "attention_long_bwd_rows_wgmma_kernel"),
                            ("K2b_cols", "attention_long_bwd_cols_wgmma_kernel"),
                            ("K2b_bias_sum", "attention_long_bwd_bias_sum_kernel"))}
    try:
        import torch.utils.tensorboard  # noqa: F401
        tb_imports = True
    except Exception:
        tb_imports = False
    tb_dir = os.path.join(logs, "pt")
    tb_files = sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir) else []
    peak = mem.get("cuda:0", {})
    say("pretrain_sinks", trace_files=traces, trace_kernels=sum(kernels.values()),
        trace_by_name=by, tensorboard_imports=tb_imports, tensorboard_files=tb_files,
        memory_stats=peak,
        peak_gib=(peak.get("peak_bytes_in_use") or 0) / 2**30)
    check(by == {"K1": 1, "K2f": 12, "K2b_rows": 12, "K2b_cols": 12, "K2b_bias_sum": 12},
          f"the traced step holds {by}, not K1 x1, K2f x12, K2b x12")
    check(bool(tb_files) == tb_imports, f"TensorBoard files {tb_files}, imports {tb_imports}")
    check(0 < (peak.get("peak_bytes_in_use") or 0) <= (peak.get("bytes_limit") or 0),
          f"device_memory_stats {mem}")


def start_pipeline_script(tmp_root, rng):
    """Start run-pipeline-torch.sh on a tiny conf on the card (bf16, width
    64, depth 12, two heads: K2 at head dim 32): VAE -> pretraining ->
    finetune, two epochs each, every stage a process of its own; the conf
    also sets profile_dir and log_dir, so the pretraining stage traces its
    third step and the pretraining and finetune stages log to TensorBoard
    (no wandb: where it is installed its init would reach for the network).
    Returns (the process, its start time, the experiment directory)."""
    import subprocess

    root = os.path.join(tmp_root, "pipe_data")
    for split, n_per in zip(("train", "val"), PIPE_FILES):
        for ci, cls in enumerate(("left", "right")):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(n_per):
                n = int(rng.integers(800, 1500))
                x_lo, x_hi = (5, 30) if ci == 0 else (34, 59)
                ev = np.zeros((n, 4))
                ev[:, 0] = rng.integers(x_lo, x_hi, n)
                ev[:, 1] = rng.integers(5, 59, n)
                ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
                ev[:, 3] = rng.choice([-1.0, 1.0], n)
                np.save(os.path.join(d, f"s{i}.npy"), ev)
    expdir = os.path.join(tmp_root, "pipe_exp")
    conf = os.path.join(tmp_root, "pipe.conf")
    with open(conf, "w") as f:
        f.write(f"expweek = chip\nexpname = pipe\ndata_path = {root}\n"
                f"profile_dir = {expdir}/profile\nlog_dir = {expdir}/tb/\n"
                "steps_per_dispatch = 1\n"   # the stage traces its third step
                "input_H = 32\ninput_W = 32\nslice_max_evs = 5000\nhotpixfilter = 0\n"
                "normalize_events = 1\nrand_aug = 0\nmax_random_shift_evs = 2\n"
                "num_workers = 0\nauto_resume = 0\nnum_layers = 2\nnum_tokens = 32\n"
                "emb_dim = 8\nhidden_dim = 16\nnum_resnet_blocks = 1\nvae_epochs = 2\n"
                "vae_batch_size = 8\nlearning_rate = 3e-4\nclip = 0.01\neval_freq = 10\n"
                "vae_save_ckpt_freq = 1\ntransformer_emb = 64\ntransformer_depth = 12\n"
                "transformer_heads = 2\nnum_mask_patches = 32\nmin_mask_patches_per_block = 4\n"
                "mask_pool_size = 16\npt_epochs = 2\npt_batch_size = 8\npt_lr = 1e-3\n"
                "warmup_epochs = 0\nsave_ckpt_freq = 1\nclass_epochs = 2\n"
                "class_batch_size = 8\nclass_lr = 2e-3\nclass_warmup_epochs = 0\n"
                "class_update_freq = 1\nmixup_prob = 0\nclass_save_ckpt_freq = 1\n")
    proc = subprocess.Popen(["bash", "run-pipeline-torch.sh", conf, expdir],
                            env=dict(os.environ, PYTHONPATH=os.getcwd(), PYTHON=sys.executable),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), expdir


def finish_pipeline_script(torch, proc, t0, expdir):
    """Wait for the script (600 s at most; killed past that) and check that
    every stage ran on the card, the tree ends pruned to final / best / the
    newest numbered checkpoint, and the pretraining stage's sinks
    (check_pretrain_sinks)."""
    import subprocess

    from mem_tpu_torch.utils.profiling import device_memory_stats

    try:
        out, err = proc.communicate(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    trees = {st: sorted(os.listdir(os.path.join(expdir, st))) if os.path.isdir(
        os.path.join(expdir, st)) else [] for st in ("vae", "pretrain", "finetune")}
    say("pipeline_torch", rc=proc.returncode, seconds=round(seconds, 2), trees=trees,
        on_card="device cuda" in out, acc1=re.findall(r"\* acc1 ([0-9.]+)", out),
        tail=None if proc.returncode == 0 else out[-1500:] + err[-1500:])
    check(proc.returncode == 0, "run-pipeline-torch.sh failed")
    check(trees == {"vae": ["checkpoint-1.pth", "checkpoint-final.pth"],
                    "pretrain": ["checkpoint-1.pth", "checkpoint-final.pth"],
                    "finetune": ["checkpoint-1.pth", "checkpoint-best.pth"]},
          f"the pipeline's pruned tree {trees}")
    check("device cuda" in out, "the pipeline's stages did not run on the card")
    check_pretrain_sinks(torch, os.path.join(expdir, "profile"), os.path.join(expdir, "tb"),
                         device_memory_stats())


# the trajectory check on the card (run_trajectory_card; the model, data and
# tokenizer: mem_tpu_torch/tools/trajectory.py CARD_GEO, CARD_VAE, drift_inputs)
TRAJ_STEPS = 192         # the loss plateaus by step ~64; 192 fit the phase in ~75 s
TRAJ_WINDOW = 32         # 6 windows of the run (parity_bf16_drift.py: 10 of 50 over 512)
TRAJ_WARMUP = 10         # the drift harness's warmup steps
TRAJ_FINAL_REL = 0.05    # B's final-window loss against the oracle's
TRAJ_LOSS_FALL = 1.0     # nats the oracle's masked loss must fall, first step to last window


def run_trajectory_card(torch, dev, gpu, tmp_root):
    """parity_bf16_drift.py's method with the port alone
    (mem_tpu_torch/tools/trajectory.py ``drift_arms``: run_pretrain over
    make_pretrain_train_step, create_optimizer, cosine_scheduler, the port's
    iterator, preprocess_batch and the CLIs' prefetch): pt_vit at full width
    cut to depth 4, B=32, the conf's f32 tokenizer, on a seeded set of 64
    class-structured samples from this phase's own generator; every arm
    takes the same host batches, draws and masks. The oracle: f32 with TF32
    off, every block's attention on the plain einsum path; A: f32 through
    the kernels (K2's scalar kernels); B: bf16 through K1, K2f and K2b on
    K3's Hopper bodies; C: the oracle's stack from a redrawn init (the
    run-to-run yardstick). B's largest windowed loss gap from the oracle
    must be within C's and its final-window loss within 5 % of the
    oracle's, A's gap below C's; the launches of K1 (once a step), K2f and
    K2b (once a block a step on the kernel arms, never on the plain ones)
    exact. The planted fault (trajectory_faults.bias_held_from_first_launch)
    on B's path must fail the check; its first step against the oracle's
    (the plain f32 step) is printed beside B's and the gates of
    check_train_step. It runs while run-pipeline-torch.sh's processes share
    the card (run_int8_slice), so its ms per step read that. Returns
    {kernel: {arm: launches}}."""
    from mem_tpu_torch.tools import trajectory as T
    from mem_tpu_torch.tools.trajectory_faults import bias_held_from_first_launch

    t0 = time.perf_counter()
    geo = T.CARD_GEO
    data, tokenizer, inits = T.drift_inputs(tmp_root, np.random.default_rng(25), geo,
                                            T.CARD_VAE)
    res = T.drift_arms(data, tokenizer, inits, dev, TRAJ_STEPS, TRAJ_WARMUP,
                       {"fault": bias_held_from_first_launch}, geo)
    runs, one_step = res["runs"], res["one_step"]
    env = {k: T.drift_envelope(runs["oracle"]["loss"], runs["A"]["loss"], runs[k]["loss"],
                               runs["C"]["loss"], TRAJ_WINDOW, TRAJ_FINAL_REL)
           for k in ("B", "fault")}
    w = TRAJ_WINDOW
    oracle = np.asarray(runs["oracle"]["loss"])
    fall = float(oracle[0] - oracle[-w:].mean())
    say("trajectory_card", gpu=gpu, model="pt_vit", embed_dim=geo.dim, heads=geo.heads,
        patch=geo.patch, img=geo.img, vocab=geo.vocab, depth=geo.depth,
        cut=f"depth 12 -> {geo.depth}", tokenizer="the conf's f32 VAE", batch=geo.batch,
        steps=TRAJ_STEPS, window=w, warmup=TRAJ_WARMUP, samples=64,
        loss_fall=fall, min_fall=TRAJ_LOSS_FALL,
        windowed_gap={"A": env["B"]["same_windowed_rel_dev"],
                      "B": env["B"]["low_windowed_rel_dev"],
                      "C": env["B"]["redrawn_windowed_rel_dev"],
                      "fault": env["fault"]["low_windowed_rel_dev"]},
        max_windowed_gap={"A": env["B"]["max_windowed_rel_dev_same"],
                          "B": env["B"]["max_windowed_rel_dev_low"],
                          "C": env["B"]["seed_run_to_run_dev"],
                          "fault": env["fault"]["max_windowed_rel_dev_low"]},
        final_window_loss={"oracle": env["B"]["oracle_final_window_loss"],
                           "A": env["B"]["same_final_window_loss"],
                           "B": env["B"]["low_final_window_loss"],
                           "C": env["B"]["redrawn_final_window_loss"],
                           "fault": env["fault"]["low_final_window_loss"]},
        final_rel={"B": env["B"]["final_rel_dev_low"],
                   "fault": env["fault"]["final_rel_dev_low"]}, final_bound=TRAJ_FINAL_REL,
        A_onset=env["B"]["same_onset"],
        ms_per_step={k: r["ms_per_step"] for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()},
        fault="K2b's bias held from its first launch", one_step=one_step,
        one_step_bounds=dict(loss=STEP_BF16_LOSS_REL, grad=STEP_BF16_GRAD_REL),
        fault_passes=bool(env["fault"]["pass_envelope"] and env["fault"]["pass_final"]),
        seconds=round(time.perf_counter() - t0, 1))
    check(fall >= TRAJ_LOSS_FALL, f"the oracle's masked loss fell {fall} < {TRAJ_LOSS_FALL}")
    for k, r in runs.items():
        kernels = TRAJ_STEPS * geo.depth if k in ("A", "B", "fault") else 0
        want = {"hist_planes_cols": TRAJ_STEPS, "fused_attention_flat": kernels,
                "fused_attention_flat_bwd": kernels}
        check(r["launches"] == want, f"trajectory arm {k} launched {r['launches']}, not {want}")
    check(env["B"]["pass_envelope"], "bf16 arm B's windowed gap "
          f"{env['B']['max_windowed_rel_dev_low']} > arm C's {env['B']['seed_run_to_run_dev']}")
    check(env["B"]["pass_final"], f"bf16 arm B's final-window loss is "
          f"{env['B']['final_rel_dev_low']} off the oracle's")
    check(env["B"]["max_windowed_rel_dev_same"] < env["B"]["seed_run_to_run_dev"],
          f"f32 arm A's windowed gap {env['B']['max_windowed_rel_dev_same']} >= arm C's")
    check(not (env["fault"]["pass_envelope"] and env["fault"]["pass_final"]),
          f"the trajectory check passed the planted fault: {env['fault']}")
    torch.cuda.empty_cache()
    return {k: {arm: r["launches"][k] for arm, r in runs.items()} for k in T.DRIFT_KERNELS}


# the resilience slice (run_resilience_slice): resume_card, and soak_card beside it
RESUME_KERNELS = ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd")
RESUME_BATCH = 64        # 2 steps an epoch over the N_TRAIN_FILES synthetic recordings
RESUME_EPOCHS = 3        # recycled at both inner boundaries: three processes
RESUME_SETUP_SIGTERM_S = 1.0   # the setup-time SIGTERM, seconds after the launch
SOAK_CARD_MINUTES = 1.5  # tools/soak.py cut to fit the phase: --minutes 1.5 (its default 90),
SOAK_CARD_FILES = 64     # 64 training files a class (384): one B=128 step an epoch


def _resume_arm(tmp_root, flags, tag, recycle=False, plant=None, processes=None):
    """One resume_card arm: the pretraining CLI through tools/resume.py under
    scripts/run_resilient.sh, or, given ``processes``, that many recycling
    processes one after the other without it; returns (its record lines,
    the last run, its output directory)."""
    import subprocess

    from mem_tpu_torch.tools.resume import read_records

    record = os.path.join(tmp_root, f"{tag}.jsonl")
    out = os.path.join(tmp_root, tag)
    trainer = [sys.executable, "-m", "mem_tpu_torch.tools.resume", record, "run_mem_pretraining",
               *(["--plant", plant] if plant else []), *flags, "--output_dir", out,
               *(["--rss_restart_gb", "0.001"] if recycle else [])]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    for _ in range(processes or 1):
        cmd = trainer if processes else ["bash", "scripts/run_resilient.sh", *trainer]
        r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=900)
    return read_records(record), r, out


def run_resume_card(torch, gpu, tmp_root):
    """resume_card: full-width pt_vit (768 / 12 heads / 224^2, vocab 8192) in
    bf16 on its own write_training_inputs (generator default_rng(26); the
    conf's f32 tokenizer), B=64, 3 epochs of 2 steps, each arm a CLI process
    (or three) under scripts/run_resilient.sh: straight, and recycled at
    every epoch boundary (--rss_restart_gb 0.001). Every step's loss and the
    final checkpoint (weights, AdamW state) must be bit-equal. The planted
    no-optimizer-state resume (tools/resume.py FAULTS), run to its second
    process, must fail that gate on its losses and its epoch-1 weights.
    The recycled and the fault arm run side by side. Beside the arms, a
    SIGTERM RESUME_SETUP_SIGTERM_S into a fresh CLI process (torch's import,
    the card's initialisation, the kernel library's load) must end in exit 0
    and a checkpoint. Returns the launches of the two gated arms."""
    import subprocess

    from mem_tpu_torch.tools.resume import state_diffs
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    t = [time.perf_counter()]
    data_root, vae_path = write_training_inputs(torch, tmp_root, np.random.default_rng(26))
    flags = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
             "--discrete_vae_weight_path", vae_path, "--num_workers", "4",
             "--batch_size", str(RESUME_BATCH), "--epochs", str(RESUME_EPOCHS),
             "--save_ckpt_freq", "1", "--warmup_steps", "2", "--device", "cuda",
             "--disable_eval_during_pretraining"]
    t.append(time.perf_counter())

    # the setup-time SIGTERM, beside the arms: the plain CLI, as a user runs it
    setup_out = os.path.join(tmp_root, "setup_sigterm")
    p = subprocess.Popen([sys.executable, "-m", "mem_tpu_torch.cli.run_mem_pretraining",
                          *flags, "--output_dir", setup_out],
                         env=dict(os.environ, PYTHONPATH=os.getcwd(), PYTHONUNBUFFERED="1"),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    pool = ThreadPoolExecutor(1)
    setup_run = pool.submit(lambda: (p.communicate(timeout=600)[0], time.perf_counter()))
    time.sleep(RESUME_SETUP_SIGTERM_S)
    t_sig = time.perf_counter()
    p.send_signal(signal.SIGTERM)

    def arm(tag, recycle=False, plant=None, processes=None):
        recs, r, out = _resume_arm(tmp_root, flags, tag, recycle, plant, processes)
        check(r.returncode == (3 if processes else 0),
              f"resume_card {tag}: exit {r.returncode}\n{(r.stdout + r.stderr)[-2000:]}")
        last = "1" if processes else "final"
        return dict(
            exits=[x["exit"] for x in recs], steps=[s for x in recs for s in x["steps"]],
            launches={k: sum(x["launches"].get(k, 0) for x in recs) for k in RESUME_KERNELS},
            epoch1=load_checkpoint(os.path.join(out, "checkpoint-1.pth"))["model"],
            final=load_checkpoint(os.path.join(out, f"checkpoint-{last}.pth")),
            resumes=re.findall(r"Auto-resumed from \S+ \(epoch (\d+)\)", r.stdout))

    # the arms: straight, then recycled and the fault side by side (the
    # fault's only to its second process, where it shows)
    arms = {"straight": arm("straight")}
    t.append(time.perf_counter())
    with ThreadPoolExecutor(2) as side:
        recycled = side.submit(arm, "recycled", True)
        fault = side.submit(arm, "fault", True, "no_optimizer_state", 2)
        arms.update(recycled=recycled.result(), fault=fault.result())
    t.append(time.perf_counter())
    text, t_exit = setup_run.result()
    pool.shutdown()
    setup_ckpts = sorted(os.listdir(setup_out)) if os.path.isdir(setup_out) else []
    t.append(time.perf_counter())
    straight, recycled, fault = arms["straight"], arms["recycled"], arms["fault"]
    diffs = state_diffs(straight["final"], recycled["final"])
    fault_diffs = state_diffs(straight["epoch1"], fault["epoch1"])
    equal_steps = recycled["steps"] == straight["steps"]
    fault_steps = [i for i, (a, b) in enumerate(zip(straight["steps"], fault["steps"]))
                   if a != b]
    steps_per = RESUME_EPOCHS * (N_TRAIN_FILES // RESUME_BATCH)
    say("resume_card", gpu=gpu, model="pt_vit", embed_dim=768, depth=12, heads=12,
        img=224, vocab=8192, dtype="bfloat16", batch=RESUME_BATCH, epochs=RESUME_EPOCHS,
        steps=steps_per, exits={k: a["exits"] for k, a in arms.items()},
        resumes={k: a["resumes"] for k, a in arms.items()},
        losses_straight=[v for _, v in straight["steps"]],
        losses_bit_equal=equal_steps, final_state_diffs=diffs[:10],
        fault="no_optimizer_state", fault_steps_differing=fault_steps,
        fault_state_diffs=len(fault_diffs),
        launches={k: a["launches"] for k, a in arms.items()},
        setup_sigterm=dict(after_s=RESUME_SETUP_SIGTERM_S, rc=p.returncode,
                           sigterm_to_exit_s=round(t_exit - t_sig, 2),
                           preempted=re.findall(r"preempted at epoch \d+", text),
                           checkpoints=setup_ckpts, tail=None if p.returncode == 0
                           else text[-1500:]),
        seconds={n: round(b - a, 2) for n, a, b in zip(
            ("inputs", "straight", "recycled_and_fault", "setup_sigterm_wait"), t, t[1:])})
    check(straight["exits"] == [0] and recycled["exits"] == [3, 3, 0],
          f"resume_card exits {straight['exits']} / {recycled['exits']}")
    check(recycled["resumes"] == ["1", "2"], f"resume_card resumes {recycled['resumes']}")
    check([s for s, _ in straight["steps"]] == list(range(steps_per))
          and all(np.isfinite(v) for _, v in straight["steps"]),
          f"resume_card straight steps {straight['steps']}")
    check(equal_steps, f"recycled losses {recycled['steps']} != straight {straight['steps']}")
    check(not diffs, f"recycled final state differs from straight: {diffs[:10]}")
    check(fault["exits"] == [3, 3] and fault["resumes"] == ["1"],
          f"resume_card fault arm exits {fault['exits']}, resumes {fault['resumes']}")
    check(bool(fault_steps) and bool(fault_diffs),
          "the planted no-optimizer-state resume passed the exact-resume gate")
    want = {"hist_planes_cols": steps_per, "fused_attention_flat": 12 * steps_per,
            "fused_attention_flat_bwd": 12 * steps_per}
    for tag in ("straight", "recycled"):
        check(arms[tag]["launches"] == want,
              f"resume_card {tag} launched {arms[tag]['launches']}, not {want}")
    check(p.returncode == 0 and "preempted at epoch 0: checkpoint saved" in text
          and setup_ckpts == ["checkpoint-0.pth"],
          f"the setup-time SIGTERM: exit {p.returncode}, {setup_ckpts}\n{text[-1500:]}")
    return {k: {tag: arms[tag]["launches"][k] for tag in ("straight", "recycled")}
            for k in RESUME_KERNELS}


def start_soak_card(tmp_root):
    """soak_card: tools/soak.py cut to fit (SOAK_CARD_MINUTES,
    SOAK_CARD_FILES), its trainers through tools/resume.py for their launch
    counts, in processes of its own."""
    import subprocess

    work = os.path.join(tmp_root, "soak")
    os.makedirs(work, exist_ok=True)
    log = open(os.path.join(work, "soak_output.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "mem_tpu_torch.tools.soak", "--minutes",
                             str(SOAK_CARD_MINUTES), "--files_per_class", str(SOAK_CARD_FILES),
                             "--workdir", work, "--record", os.path.join(work, "record.jsonl")],
                            env=dict(os.environ, PYTHONPATH=os.getcwd()), stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log, work, time.perf_counter()


def finish_soak_card(gpu, proc, log, work, t0):
    """Wait for the soak (600 s at most) and hold it to its own gates."""
    from mem_tpu_torch.tools.resume import read_records

    try:
        rc = proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait()
        log.close()
    seconds = time.perf_counter() - t0
    path = os.path.join(work, "soak.json")
    r = json.load(open(path)) if os.path.exists(path) else {}
    recs = read_records(os.path.join(work, "record.jsonl"))
    launches = {k: sum(x["launches"].get(k, 0) for x in recs) for k in RESUME_KERNELS}
    with open(os.path.join(work, "soak_output.log")) as f:
        tail = f.read()[-1500:]
    say("soak_card", gpu=gpu, rc=rc, seconds=round(seconds, 2),
        cuts=dict(minutes=SOAK_CARD_MINUTES, files_per_class=SOAK_CARD_FILES,
                  steps_per_epoch=2 * SOAK_CARD_FILES // 128, record=True),
        **{k: r.get(k) for k in ("gates", "epochs_completed", "sigterm_preemptions",
                                 "rss_recycles", "auto_resumes", "max_resume_loss_jump",
                                 "max_within_segment_loss_step", "samples_per_s", "rss_gb",
                                 "sigterm_to_exit_s", "launch_to_resume_s",
                                 "launch_to_first_logged_step_s", "setup_s", "events")},
        trainer_exits=[x["exit"] for x in recs], launches=launches,
        tail=None if rc == 0 else tail)
    check(rc == 0 and r.get("ok"), f"the soak failed its gates: {r.get('gates')}\n{tail}")
    for k in RESUME_KERNELS:
        check(launches[k] > 0, f"the soak's trainers launched no {k}")
    return launches


def run_resilience_slice(torch, gpu, tmp_root):
    """soak_card started first, in processes of its own; resume_card beside
    it; then the soak waited for. Each phase's seconds are printed."""
    torch.cuda.empty_cache()   # the children need the card's memory, not this cache
    t0 = time.perf_counter()
    soak = start_soak_card(tmp_root)
    resume = run_resume_card(torch, gpu, tmp_root)
    t1 = time.perf_counter()
    soak_launches = finish_soak_card(gpu, *soak)
    t2 = time.perf_counter()
    say("resilience_slice", seconds=dict(resume_card=round(t1 - t0, 2),
                                         soak_card=round(t2 - soak[3], 2),
                                         slice=round(t2 - t0, 2)))
    return {k: {"resume_card": resume[k], "soak_card": soak_launches[k]} for k in RESUME_KERNELS}


PAR_KERNELS = {   # kernel -> the parallel runs whose launches it counts
    "hist_planes_cols": (("chip1", "dp"), ("chip1", "zero1"), ("chip1", "fsdp"),
                         ("chip1", "tp1"), ("chip1", "fsdp_adafactor"), ("chip1", "tp1_lamb"),
                         ("chip1", "mae_tp1"), ("chip2", "dp"), ("chip2", "tp_adafactor"),
                         ("chip2", "fsdp_adafactor")),
    "fused_attention_flat": (("chip1", "dp"), ("chip1", "zero1"), ("chip1", "fsdp"),
                             ("chip1", "tp1"), ("chip1", "fsdp_adafactor"),
                             ("chip1", "tp1_lamb"), ("chip1", "mae_tp1"), ("chip2", "dp"),
                             ("chip2", "tp"), ("chip2", "tp_adafactor"),
                             ("chip2", "fsdp_adafactor"), ("chip2", "mae_tp")),
    "fused_attention_flat_bwd": (("chip1", "dp"), ("chip1", "zero1"), ("chip1", "fsdp"),
                                 ("chip1", "tp1"), ("chip1", "fsdp_adafactor"),
                                 ("chip1", "tp1_lamb"), ("chip1", "mae_tp1"), ("chip2", "dp"),
                                 ("chip2", "tp"), ("chip2", "tp_adafactor"),
                                 ("chip2", "fsdp_adafactor"), ("chip2", "mae_tp")),
    "mlp_fused": (("chip2", "tp"),),
    "mlp_fused_bwd": (("chip2", "tp"),),
    "fused_attention_flat_long": (("chip2", "seg"),),
    "fused_attention_flat_long_bwd": (("chip2", "seg"),),
    "hist_planes_cols_sorted": (("chip2", "seg"),),
}


def run_parallel_slice(torch, gpu, tmp_root, lines):
    """Multi-GPU training (parallel/, tools/mp_worker.py, tools/mp_chip.py),
    in two processes of its own: ``chip1`` (rank 0 alone, a world-size-1
    NCCL group: three
    full-width pretraining steps under DP, ZeRO-1, FSDP and TP against the
    same steps without a group; DP and ZeRO-1 bit-equal, FSDP and TP within
    mp_chip.FSDP_TP_REL; then the whole-tensor optimizers under FSDP and TP
    and the MAE at TP, bit-equal), then ``chip2`` (two processes on the one
    card over Gloo, named so: the DP step, the TP step at tp = 2 with
    FUSED_MLP, the seg step under DP, the MAE at tp = 2, each against one
    process within its gate and each with a planted fault that must miss
    it; Adafactor and AdamP at tp = 2 and Adafactor under FSDP, f32, each
    tensor's displacement within mp_chip.OPT_REL, each with its statistic
    taken over the local shard alone, which must miss it). Returns {kernel:
    {run: launches}} of the ranks' main paths (rank 0's; each process
    counts its own). It runs beside other slices' work on the same card, so
    it reads no time (tools/mp_worker.py chip on a card of its own does) and
    appends its lines to ``lines`` for the caller to print: a thread's
    print could land in a tool's captured output."""
    from mem_tpu_torch.tools import mp_chip, mp_worker

    def say(tag, **fields):
        lines.append(f"{tag} {json.dumps(fields)}")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    work = os.path.join(tmp_root, "par")
    res = {}
    outs = mp_worker.launch("chip", work, 2, env=env, timeout=600, cwd=os.getcwd())
    for rank, (code, log) in enumerate(outs):
        if code != 0:
            print(log[-6000:], file=sys.stderr)
        check(code == 0, f"mp_worker chip rank {rank} exited {code}")
    for mode, nproc in (("chip1", 1), ("chip2", 2)):
        res[mode] = [json.load(open(os.path.join(work, f"{mode}_r{r}.json")))
                     for r in range(nproc)]
    c1 = res["chip1"][0]
    for mode, r in c1["modes"].items():
        say("parallel_world1", gpu=gpu, backend=c1["backend"], mode=mode,
            placement=r["placement"], batch=c1["batch"], steps=c1["steps"],
            bit_equal=r["bit_equal"], weights_rel_l2=r["weights_rel_l2"],
            loss_equal=r["loss_equal"], peak_gb=r["peak_gb"],
            single_peak_gb=c1["single"]["peak_gb"], launches=r["launches"])
        if mode in ("dp", "zero1"):
            check(r["bit_equal"], f"{mode} at world size 1 is not bit-equal to no group")
        else:
            check(r["weights_rel_l2"] <= mp_chip.FSDP_TP_REL,
                  f"{mode} at world size 1: weights rel L2 {r['weights_rel_l2']}")
        for name in ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"):
            check(r["launches"].get(name, 0) > 0, f"{mode} launched no {name}")
    for pair, r in list(c1["opt_pairs"].items()) + [("mae_tp1", c1["mae_tp1"])]:
        say("parallel_world1_opt", gpu=gpu, backend=c1["backend"], run=pair,
            placement=r["placement"], batch=r.get("batch", c1["batch"]), steps=c1["steps"],
            bit_equal=r["bit_equal"], weights_rel_l2=r["weights_rel_l2"],
            loss_equal=r["loss_equal"], peak_gb=r["peak_gb"], launches=r["launches"])
        check(r["bit_equal"], f"{pair} at world size 1 is not bit-equal to no group "
              f"(weights rel L2 {r['weights_rel_l2']})")
        for name in ("fused_attention_flat", "fused_attention_flat_bwd"):
            check(r["launches"].get(name, 0) > 0, f"{pair} launched no {name}")
    r0, r1 = res["chip2"]
    for tag in ("tp_adafactor", "tp_adamp", "fsdp_adafactor"):
        ok, bad = r0[tag], r0[f"{tag}_fault"]
        say("parallel_two_process_opt", gpu=gpu, backend=r0["backend"], run=tag,
            worst_displacement=ok["worst_displacement"], gate=mp_chip.OPT_REL,
            fault_worst_displacement=bad["worst_displacement"], loss=ok["loss"],
            peak_gb=[ok["peak_gb"], r1[tag]["peak_gb"]], launches=ok["launches"])
        check(ok["worst_displacement"][1] <= mp_chip.OPT_REL,
              f"two-process {tag}: displacement rel L2 {ok['worst_displacement']} > "
              f"{mp_chip.OPT_REL}")
        check(bad["worst_displacement"][1] > mp_chip.OPT_REL,
              f"two-process {tag}: the local-shard statistic passed the gate "
              f"({bad['worst_displacement']})")
    gates = {"dp": mp_chip.DP_GRAD_REL, "tp": mp_chip.TP_GRAD_REL, "seg": mp_chip.SEG_GRAD_REL,
             "mae_tp": mp_chip.TP_GRAD_REL}
    for tag, gate in gates.items():
        ok, bad = r0[tag], r0[f"{tag}_fault"]
        say("parallel_two_process", gpu=gpu, backend=r0["backend"], run=tag,
            grad_rel_l2=ok["grad_rel_l2"], gate=gate, loss_rel=ok["loss_rel"],
            fault_grad_rel_l2=bad["grad_rel_l2"], fault_loss_rel=bad["loss_rel"],
            peak_gb=[ok["peak_gb"], r1[tag]["peak_gb"]],
            single_peak_gb=r0["single"][tag]["peak_gb"], launches=ok["launches"])
        check(ok["grad_rel_l2"] <= gate, f"two-process {tag}: gradients rel L2 "
              f"{ok['grad_rel_l2']} > {gate}")
        check(bad["grad_rel_l2"] > gate, f"two-process {tag}: the planted fault passed the "
              f"gate ({bad['grad_rel_l2']} <= {gate})")
    say("parallel_routes", gpu=gpu, **r0["routes"])
    say("parallel_phases", world1=c1["seconds"], two_process=[r0["seconds"], r1["seconds"]])
    check(r0["routes"]["tp_k6_route"] == "wgmma", f"K6 at hidden 1536: {r0['routes']}")
    for tag, names in (("tp", ("fused_attention_flat", "fused_attention_flat_bwd", "mlp_fused",
                               "mlp_fused_bwd")),
                       ("seg", ("fused_attention_flat_long", "fused_attention_flat_long_bwd",
                                "hist_planes_cols_sorted")),
                       ("dp", ("hist_planes_cols",)),
                       ("mae_tp", ("fused_attention_flat", "fused_attention_flat_bwd")),
                       ("tp_adafactor", ("hist_planes_cols", "fused_attention_flat",
                                         "fused_attention_flat_bwd")),
                       ("fsdp_adafactor", ("hist_planes_cols", "fused_attention_flat",
                                           "fused_attention_flat_bwd"))):
        for name in names:
            check(r0[tag]["launches"].get(name, 0) > 0 and r1[tag]["launches"].get(name, 0) > 0,
                  f"two-process {tag} launched no {name}")
    world1 = dict(c1["modes"], **c1["opt_pairs"], mae_tp1=c1["mae_tp1"])
    out = {name: {f"{c}.{run}": (world1[run] if c == "chip1" else r0[run])["launches"]
                  .get(name, 0) for c, run in runs}
           for name, runs in PAR_KERNELS.items()}
    say("parallel_slice", seconds=round(time.perf_counter() - t0, 1))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        run(torch)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
