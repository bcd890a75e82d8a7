#!/usr/bin/env python3
"""Drive tdnet_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
0. toolchain and card: torch, CUDA, nvcc, ``nvidia-smi`` name and power limit,
   and whether PIL, imageio and cv2 import in a child process (information
   only);
1. build every kernel library from ``tdnet_tpu_torch/csrc``, and the
   fault-check builds of K1 (``FAULT_DEFINES``), K5 (``K5_FAULT_DEFINES``) and
   K2 (``K2_FAULT_DEFINES``), one nvcc each, all at once;
2. the propagation-attention kernel (K1) against its plain PyTorch version at
   the streaming hop shapes (and a ragged batch of 2), f32 (TF32 off) and
   bf16, with and without the fc; max abs error, two calls bitwise equal, the
   median time of each (CUDA events), and the kernels each call runs with
   their device times (a ``torch.profiler`` trace); at the TD2 hop with the
   fc, ``F.scaled_dot_product_attention`` followed by ``torch.addmm`` (the
   same function), SDPA alone, and the bound (bf16 on the tensor cores; f32
   both ways, on the CUDA cores and in 3xTF32 on the tensor cores); K1's
   error word read after every call (``check_fault``) and clear; the sha256
   of K1's bf16 outputs at these shapes (``k1_bf16_digests``: K2's forward
   shares K1's kernels, so two trees are compared bit for bit); then, in a
   child process, K1 bf16 from the fault-check build (producers that fill
   nothing, consumers that give up after 4 tries) must be reported by
   ``check_fault``;
3. TD4-PSP18 at 769x1537 in f32 through ``Streamer`` on seeded random weights
   and 12 seeded synthetic frames, against the same stream with the plain
   attention (1e-3 x max|logits|); 3 kernel launches per warm frame; latency,
   frames/s and peak memory;
3b. the same f32 stream with torch's precision defaults (cuDNN TF32 on, as
   ``cli/test.py`` leaves them): phase 3's logits to 1e-5 x max|logits|; the
   stream with the runtime's ``no_tf32`` scope removed reported beside it;
4. the same stream in bf16, against its plain-attention run (3e-2 x
   max|logits|) and against the f32 stream (5e-2 x max|f32 logits|);
5. TD2-PSP50 at 1025x2049 in bf16, against its plain-attention run (3e-2 x
   max|logits|); one launch per warm frame; then K1 on the stream's own hop
   inputs (kept from the last call of the run) beside phase 2's kind of
   inputs at the same shape, both held to phase 2's bf16 rule and repeating
   bitwise, with how peaked each softmax is (the rows' score spread, the share
   of exp(s - m) that is 0 or below 2^-126), then timed in turns (stream,
   randn, stream, randn): median ms, the kernels' device ms, the SM clock,
   power draw and temperature after each; K1's error word read after every
   call and clear;
6. load the training libraries (K2: training attention, K3: dropout);
7. K2 against its plain version at the TD4 training hop shapes (2,145 x 2,145,
   run twice a step, and 18,721 x 2,145), f32, dropout off and on with one
   seed: the output to 1e-5 x max|output| and dq, dk, dv from a seeded dy to
   atol 2e-4 / rtol 1e-3; the keep rate within 0.9 +- 1e-3 (uniform scores,
   v of ones: each output row counts its kept keys); the forward and the
   backward (3xTF32 on the tensor cores) bitwise equal across two runs; each
   forward's rms distance from a float64 forward, kernel and plain, reported,
   not held to a bound (the kernel sums p v in key order, as cuBLAS's FFMA
   GEMM does at the last hop, where the two lie equally far; at 2,145 x 2,145
   cuBLAS splits the keys and lies closer); at each hop, kernel, plain and
   ``F.scaled_dot_product_attention`` (scale 1/8, no dropout) times, forward
   and backward, the kernels that the kernel's and SDPA's forward and
   backward run with their device times (from a ``torch.profiler`` trace),
   and the forward's and the backward's bounds both ways (f32 on the CUDA
   cores, 3xTF32 on the tensor cores); both hops' forward times beside
   SDPA's on one line;
7b. K2 in bf16 against its plain bf16 version (the TPU kernel's rounding
   points, ``kernels/propagation_attention_train.py``) at the same hops and
   seed and a ragged batch of 2 (``BATCHED``), dropout off and on (and, by the
   same rules alone, d_v 128 and 384 at ``K2_DV_CASES``), each
   kernel's registers and local memory and each shape's grids and waves
   logged, K2's error word read after every call: every output within one bf16 ulp of
   max|plain output| (both round one f32 sum a row to bf16; the sums' orders
   differ), dq, dk and dv within ``BF16_GRAD_RTOL`` x max|grad| of each
   tensor (ds rounds to bf16 from f32 sums taken in other orders), every
   output bf16; two runs bitwise equal; the keep rate within 0.9 +- 1e-3
   (q = 0 and v one-hot on 512 keys at a time, so an output is nonzero exactly
   where its key is kept); kernel, plain and ``F.scaled_dot_product_attention``
   (bf16, scale 1/8, no dropout) times, forward and backward, with the
   kernels' device times; the bounds in bf16 on the tensor cores; then, in a
   child process, K2 bf16 from its fault-check build must be reported;
7c. K2 in bf16 on the inputs of one bf16 TD4-PSP18 step (its three calls, each
   with the dy its backward received, ``step_attention_inputs``) beside randn
   inputs at the same shapes: the score spread, phase 7b's rules, two runs
   bitwise equal, then forward and backward timed in turns (step, randn,
   step, randn) with each kernel's device ms and the SM clock and power;
8. K3 against its plain version at [18,721, 512] and [2,145, 512]: output and
   backward (from a seeded dy) bit-identical, the same mask, the call on an x
   that needs no gradient identical too; keep rate within 0.9 +- 1e-3; the
   sha256 of its output and autograd dx at both row counts (``k3_digests``:
   run with a parent's package, two trees are compared bit for bit); at both
   row counts, K3's and ``F.dropout``'s calls in turns (kernel, F.dropout,
   F.dropout, kernel), the forward alone and forward plus backward through
   autograd (the train step's form, the kernels entry's ``ms``), the device
   time of each one's kernels from one ``torch.profiler`` trace of each form
   against the bound (bytes), and K3's forward plus backward with its inputs
   cold in L2 (``k3_turns``); one call's host time split into its parts, the
   parent wrapper's and the new one's, beside ``F.dropout``'s, and each whole
   call's CPU time from one trace (``k3_host_split``); the plain version's
   forward plus backward;
8b. the same in bf16 (x times 1 / 0.9 rounded to bf16, one rounding);
9. the TD4-PSP18 full training recipe at 769x1537, batch 1, f32: seeded
   student and ResNet-101 teacher, OHEM, KD, AdaOptimizer; a warm-up step and
   8 steps with pos_id 0-3, every loss finite, 3 launches a step of each of K2
   forward, K2 backward, K3 forward and K3 backward; ms/step and peak memory;
   then, from the recipe's seeded initial state at pos_id 1 (the same in
   every run: the state after the timed steps carries the nondeterministic
   backward's noise, and with it whether a ReLU input sits within an f32
   rounding of zero and flips between the paths), dropout off and then on
   (the same masks), one float64 run (the cuDNN path in float64, K2 and K3
   swapped for their plain versions, which take float64), which phase 14
   reuses, and the kernel path held by two rules, each a gate:
   - against float64, beside the plain path (K2 and K3 swapped for their
     plain versions): both losses to 1e-4 relative of float64's, and each
     gradient of the kernel path no farther from float64 than twice the
     plain path's distance plus 1e-3 x max(max|grad|, floor), the floor
     1e-5 x the float64 run's largest max|grad| (for gradients that vanish
     in exact arithmetic, such as a bias before a BatchNorm);
   - against the plain path: the loss to 1e-4 relative of the plain path's,
     each gradient to 1e-3 x max(max|grad|, floor) plus twice the kernel
     path's own run-to-run difference, which must stay within
     1e-2 x max|grad| on every gradient above the floor.
   Whether the kernel path's two identical steps repeat bit for bit is
   printed, and where they do not, the largest difference and its gradient.
   A forward that rounds otherwise than the plain path's GEMM flips some
   ReLUs and fails the second rule while it passes the first; the first
   alone passes a forward off by 1e-3 on one 64-row q block of the last hop
   (PERF.md, run A1), which the second flags. So phase 9 also runs that
   perturbed kernel path (the probe, ``PROBE_EPS``) and fails if its check
   does not flag it; the probe's share of each rule's limit is printed;
10. the fused deep-base stem tail (K4) against its plain version (the unfused
    cuDNN conv / BN / ReLU / max-pool sequence) at the TD2-PSP50 stem shape
    [1, 64, 513, 1025], the PSP-101 one [1, 64, 385, 769] and a small ragged
    one, f32 (TF32 off; 1e-4 x max|ref|) and bf16 (2e-2 x max|ref|: one bf16
    ulp before a BN can carry through conv2); two calls bitwise equal; kernel
    and plain times, at the TD2 shape the device time of the kernel and of the
    plain sequence from one trace, and the bound on the tensor cores (bf16;
    f32 in 3xTF32, with the CUDA cores' beside it);
11. TD2-PSP50 at 1025x2049 through ``Streamer(stem_impl="fused")``, in bf16
    and in f32; one K4 launch a frame and K1's launches as in phase 5; in
    each fused run, the stem tail of every frame, fused against plain with
    the backbone that took the frame, on the run's weights (the runner's K4
    layout), by phase 10's rules. The f32 logits against the plain-stem f32
    stream to 1e-3 x max|logits|. In bf16 that check is the gate: the kernel
    and cuDNN sum a conv in another order, so a few stem outputs round one
    bf16 ulp apart, and the random-weight net spreads that as it spreads any
    bf16 rounding, to about half of max|logits|, as far as the plain bf16
    stream lies from f32; so the fused bf16 stream's distances from the
    plain-stem bf16 stream (phase 5's) and from f32 are reported, not held
    to a bound;
12. PSP-101 at 769x1537 (``FrameRunner``, seeded weights, the 12 frames), f32
    and bf16, the fused stem against the plain stem by phase 11's rules (the
    stem tail of every frame; f32 logits to 1e-3 x max|logits|; bf16 logits
    reported); one K4 launch a frame; latency, frames/s and peak memory;
13. the dilated-conv kernel (K5) against its plain version at layer4's shapes
    (97x193 grid; TD4-PSP18's 256->512 d4, 512->512 d4 and d8, and TD2-PSP50's
    512->512 d16), f32 with
    TF32 off: forward and dgrad to 5e-5 x max|ref|, and the autograd
    function's output, dx and dW against ``F.conv2d`` autograd (dW 1e-4 x
    max|ref|: a sum over 18,721 pixels); two identical calls bitwise equal,
    forward and dgrad; kernel, plain and cuDNN times (``F.conv2d``,
    ``torch.nn.grad.conv2d_input``) and the bound both ways (3xTF32 on the
    tensor cores, the kernels line's, and f32 on the CUDA cores); at 512->512
    d4 the kernels that K5's and cuDNN's forward and dgrad run, with their
    device times (one trace of both) and the prep passes' share; the sha256
    of the kernel's output and dx at each shape (two trees compared bit for
    bit);
13b. K5 in bf16 against its plain version (bf16 products summed in f32,
    rounded once) at the same shapes: output and dx within 2^-7 x max|plain|
    (one bf16 ulp at the largest output: both round one f32 sum), bf16, two
    identical calls bitwise equal, the dgrad through autograd the direct
    call's; the rounding gate: the kernel's mean (|y| - |f64|) / ulp against a
    float64 conv within ``K5_BIAS_GATE`` of the plain version's (a long
    truncating chain on the tensor cores biases it); the share of outputs off
    the plain version's bits; each shape's grid and waves, and the kernel's
    registers and local memory; the sha256 of its output and dx at each shape
    (``k5_bf16_digests``); kernel (the dgrad by a direct call and through
    autograd), plain and cuDNN bf16 (``F.conv2d``, ``conv2d_input``) times
    with their device times, and the bound in bf16; the error word read after
    every call; then, in a child process, K5 bf16 from the fault-check build
    must be reported by ``check_fault``;
14. the phase-9 recipe with ``conv_wgrad="kernel"``: a warm-up step and 4
    steps, every loss finite, 16 forward and 16 dgrad K5 launches a step,
    ms/step and peak memory; then, from phase 9's initial state, dropout off
    and on, the loss and every gradient of the K5 path against phase 9's
    float64 run, beside the default cuDNN path, by phase 9's float64 rule:
    the losses to 1e-4 relative, and each K5 gradient no farther from float64
    than twice the cuDNN one plus 1e-3 x max(max|grad|, floor). Phase 9's
    kernel-vs-plain rule does not apply here: K5 and cuDNN sum layer4's convs
    in other orders, and at random init f32 gradients of the recipe move by
    up to a few percent of max|grad| when one ReLU flips, on both paths
    alike. The evidence is
    printed beside it: the farthest gradient from float64 of two more f32
    variants, deterministic cuDNN and K5's plain version on the card, and
    how many gradients' limits the cuDNN term dominates and how many K5
    gradients needed it;
15. the phase-9 recipe in bf16 mixed precision (``compute_dtype=
    torch.bfloat16``): a warm-up step and 4 steps, every loss finite, 3
    launches a step of each of K2's bf16 forward and backward and K3's bf16
    forward and backward and no f32 launch, ms/step and peak memory, the error
    word read after every step and comparison (phases 16 and 17 too); then,
    from phase 9's initial state, dropout off and on, the kernel path against
    phase 9's float64 run beside the bf16 plain path (K2 and K3 swapped for
    their bf16 plain versions): the kernel path's loss no farther from
    float64's than twice the plain path's plus 1e-3 relative, and each
    gradient no farther from float64 than twice the plain path's distance plus
    1e-3 x max(max|grad|, floor), the floor one bf16 ulp (2^-8) of the float64
    run's largest max|grad| (a gradient that vanishes in exact arithmetic reads
    bf16 rounding noise of about that size). Phase 9's kernel-vs-plain rule does not
    apply: bf16 rounds every activation, and a K2 that rounds its sums in
    another order flips ReLUs all over the net. The probe: K2's bf16 forward
    off by each eps of ``PROBE_LADDER_BF16`` on one 64-row q block of the last
    hop, each probe's share of the limit printed; the check must flag
    ``PROBE_EPS_BF16``;
16. the phase-9 recipe in bf16 with ``conv_wgrad="kernel"``: a warm-up step
    and 4 steps, every loss finite, 16 forward and 16 dgrad bf16 K5 launches a
    step and no f32 K5 launch, 3 + 3 of K2's and K3's bf16 kernels; ms/step,
    peak memory, device ms a step and the idle share from a profiler trace of
    2 steps; then, from phase 9's initial state, dropout off and on, the K5
    path (K2, K3 and K5 kernels) against phase 9's float64 run by phase 15's
    rule (``against_f64(..., bf16=True)``) beside the bf16 plain path (all
    three swapped for their plain versions); its and K5's plain version's
    shares of that rule beside the bf16 cuDNN path are printed, not held (two
    bf16 paths that sum layer4's convs in other orders are no yardstick for
    each other), with deterministic cuDNN's and plain K5's distances from
    float64, as phase 14 prints them;
17. the TD2-PSP50 full recipe (``td2_full_recipe``: ResNet-50 x 2 paths,
    projected before pooling, a 2-path ResNet-101 teacher, OHEM, AdaOptimizer)
    at 769x1537 with ``conv_wgrad="kernel"``, f32 and then bf16: a warm-up step
    and 4 steps each, every loss finite, launches a step K5 6 + 6, K2 1 + 1, K3
    1 + 1 in the step's dtype and none in the other; ms/step, peak memory,
    device ms and the idle share; then one float64 run from the recipe's seeded
    initial state (dropout off and on, as phase 9's), and the kernel path (K2,
    K3 and K5) against it beside the plain path (all three swapped for their
    plain versions), f32 by phase 9's float64 rule and bf16 by phase 15's; the
    probe (K2's forward off on one 64-row q block of the hop) at each eps of
    ``PROBE_LADDER_TD2``, each probe's share of the limit printed; the check
    must flag ``PROBE_GATE_TD2``.
18. the fused grouped-PSP + QKV trunk (``Streamer``'s default) against
    ``fused_trunk=False`` on the same seeded weights and frames, in turns
    (fused, unfused, fused, unfused; frames/s of 48 frames pipelined and the
    latency of frames 7-12 each);
    in each fused run the encoding of every frame against the pyramid
    feature's (``TRUNK_FRAC``); TD4-PSP18 at 769x1537 f32 (logits to
    ``FUSED_F32_FRAC`` x max|logits|), TD4-PSP18 bf16 (to its f32 fused twin
    by phase 4's rule) and TD2-PSP50 at 1025x2049 bf16 (its distance from an
    f32 fused run reported beside the unfused stream's); K1's launches the
    same in every run; argmax agreement printed;
19. the training CLI at full width: a seeded Cityscapes-layout tree of
    1024x2048 PNGs written by ``data/png.py`` (3 train, 2 val frames, 6
    predecessors each), ``cli.train.train`` on configs/td4_psp18_cityscapes.yml
    with the data path, 4 iterations, batch 2, validation and checkpoints every
    2 and a print every step; 2 more steps resumed from ``state_latest.pkl``
    (loaded bitwise equal, ``it`` 4 -> 6); ``cli.validate`` on the best
    checkpoint, its confusion matrix equal to the run's validation of those
    weights; losses finite, the error word read; ms a step split into the
    wait for ``ClipBatcher`` and the step, peak memory, K1, K2, K3 launches.
    Phase 19 keeps its tree for phase 20. From phase 0 on the backbone store
    (``utils/model_store.py``) looks in an empty local cache and downloads from
    ``file://`` URLs of a directory that does not exist (``offline_store``):
    no phase reaches the network;
20. the reference's checkpoints at full width (``reference_state`` writes a
    seeded port model, BNs, LayerNorms and biases drawn too, under the
    reference's key names with ``num_batches_tracked``; ``write_reference``
    saves it in the legacy format as ``{"epoch", "model_state", "best_iou"}``):
    TD4-PSP18 at 769x1537 (DataParallel's ``module.`` keys), TD2-PSP50 at
    1025x2049 and PSP-101 at 769x1537 through ``cli.convert`` (PSP-101 as the
    teacher source, ``--arch pspnet_4p``), every converted state bitwise equal
    to the seeded model's (PSP-101's parts and gathered head columns); then
    ``cli.test.main`` over 12 seeded 1024x2048 PNGs with each reference file
    as its checkpoint (TD4-PSP18 f32 and bf16, TD2-PSP50 and PSP-101 bf16 with
    ``--stem_impl fused``): "Loading pretrained model" printed, the saved class
    maps bitwise equal to a ``Streamer`` / ``FrameRunner`` on the seeded model
    over the same frames, K1 3 a warm TD4 frame and 1 a warm TD2 frame, K4 1 a
    frame, the latency lines printed; then ``cli.train.train`` on phase 19's
    tree (the YAML at full width, batch 2): 2 iterations with
    ``training.resume`` a seeded PSPNet-18 source and ``teacher_model`` the
    PSP-101 file, every path's backbone and PSP, head bn and out the source's,
    path p's head conv its gathered columns (``grouped_head_conv(w, 2, p %
    2)``), the teacher's group convs PSP-101's gathered columns, all bitwise
    before the first step; then 1 iteration without ``resume``, a seeded
    torchvision ResNet-18 in the store's cache as ``resnet18-<its sha256
    prefix>.pth``, every path's backbone bitwise the file's; losses finite, K2
    and K3 3 + 3 a step, ms a step and peak memory; the error word read after
    every run.
The line before the last is one JSON object of the kernels: K1 per dtype (its
error and times at the TD2 hop with the fc), K2 forward and backward in f32
and in bf16, K3 in f32 and in bf16, K4 per dtype (at the TD2 stem shape) and
K5 forward and dgrad in f32 and in bf16 (at 512->512 d4; launches of phases
14 and 17, and 16 and 17; phase 20's launches added to K1's, K2's, K3's and
K4's), each with launches, error, times, library time and
bound (K1's library time is SDPA followed by ``torch.addmm``, with SDPA alone
beside it; all add their device time); the last line
is ``{"ok": true, "device": {...}}``. TF32 stays off throughout, as the
runtime and the trainer set it for their own work anyway.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import types
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

SHAPES = [(1225, 1225), (18721, 1225), (33153, 2145), (700, 130)]   # (Lq, Lkv)
TRAIN_SHAPES = [(2145, 2145), (18721, 2145)]   # the TD4 training hops (Lq, Lkv)
DROP_ROWS = [18721, 2145]                       # K3's [rows, 512] on the training path
# phases 8 and 8b: CUDA-event calls a turn; a backward's host time through autograd's engine
# spreads by tens of us from call to call
K3_REPS = 50
TRAIN_STEPS = 8
K5_STEPS = 4
STEM_SHAPES = [(513, 1025), (385, 769), (21, 35)]   # K4's input (H, W): TD2, PSP-101, ragged
K5_GRID = (97, 193)                                 # the recipe's c4 grid at 769x1537
# layer4's (ci, co, dilation): TD4-PSP18's (256->512 d4, 512->512 d4 and d8) and TD2-PSP50's
# bottleneck conv2s (512->512 d4, d8 and d16)
K5_SHAPES = [(256, 512, 4), (512, 512, 4), (512, 512, 8), (512, 512, 16)]
K5_HEADLINE = (512, 512, 4)
K5_BF16_RTOL = 2.0 ** -7   # phase 13b: x max|plain|, one bf16 ulp at the largest output
# phase 13b's rounding gate: |kernel's mean (|y| - |f64|) / ulp - plain's|. One chain over all
# of K read +3.95e-3 at the d4 dgrad, chains of 64 channels about the plain version's (PERF.md
# §6); a mean over ~9.6 M outputs has about 1e-4 of noise
K5_BIAS_GATE = 1e-3
TD2_STEPS = 4              # phase 17's timed steps, each dtype
GRAD_RTOL = 1e-3     # per gradient tensor, x max(max|grad|, floor), in phases 9 and 14
GRAD_FLOOR = 1e-5    # x the run's largest max|grad|: below it a gradient counts as vanishing
# phase 15's floor: one bf16 ulp (2^-8) of the largest max|grad|. A gradient that vanishes in
# exact arithmetic (a bias before a BatchNorm) reads the rounding noise of the bf16 values
# it is summed from, which is about that size (PERF.md, run B2 of the bf16 step)
GRAD_FLOOR_BF16 = 2.0 ** -8
LOSS_RTOL = 1e-4     # each f32 path's loss against the float64 run's
NOISE_LIMIT = 1e-2   # the largest 2 x run-to-run / max|grad| allowed above the floor
POS_ID = 1           # the path whose step phases 9 and 14 compare
# phase 9's probe: K2's forward off by a relative PROBE_EPS on one 64-row q block (the 147th
# of 293) of the recipe's last hop, the smallest of 1e-4, 1e-3 and 1e-2 that the
# kernel-vs-plain rule flagged with dropout off and on (PERF.md, run A1)
PROBE_EPS = 1e-3
PROBE_LQ = TRAIN_SHAPES[-1][0]   # the last hop's q rows
PROBE_ROWS = slice(146 * 64, 147 * 64)
BF16_GRAD_RTOL = 1e-2   # phase 7b: K2 bf16's dq, dk, dv against its plain version, x max|grad|
BF16_STEPS = 4          # phase 15's timed steps
# phase 15's probe: K2's bf16 forward off by a relative PROBE_EPS_BF16 on PROBE_ROWS, the
# smallest of 0.01-3 that the float64 rule flagged with dropout off and on (0.1 and 3: with
# dropout on, bf16's scale 1.109375 puts both bf16 paths farther from float64's 1 / 0.9, and
# the limits with them; PERF.md, runs B3 and B4 of the bf16 step); the ladder's shares are printed
PROBE_EPS_BF16 = 3.0
PROBE_LADDER_BF16 = (1.0, 3.0)
# phase 17's probes (TD2-PSP50's one hop has PROBE_LQ q rows), f32 and bf16: each ladder's
# shares are printed and the check must flag the gate
PROBE_LADDER_TD2 = {"f32": (1e-3, 1e-2, 1e-1, 1.0), "bf16": (0.3, 1.0, 3.0)}
PROBE_GATE_TD2 = {"f32": 1e-1, "bf16": 3.0}   # the smallest flagged off and on (PERF.md, run H3)
# the H100 SXM's published peaks (NVIDIA's H100 datasheet): bytes/s of HBM3,
# FLOP/s of f32 on the CUDA cores and of bf16 on the tensor cores; f32 products in
# 3xTF32 on the tensor cores take three TF32 products each
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32X3 = 495e12 / 3
BATCHED = (2, 700, 130)   # (n, Lq, Lkv): the batch axis of the kernel's grid
# phase 7b's narrower values (n, Lq, Lkv, d_v): the other widths K2's kernels take
K2_DV_CASES = [(1, 257, 97, 128), (2, 130, 260, 384)]
# the fault-check builds of K1 and of K5: producers that fill nothing, consumers that give up
# after 4 tries
FAULT_DEFINES = ("TDNET_CONSUMER_POLLS=4", "TDNET_K1_STARVE")
K5_FAULT_DEFINES = ("TDNET_CONSUMER_POLLS=4", "TDNET_K5_STARVE")
K2_FAULT_DEFINES = ("TDNET_CONSUMER_POLLS=4", "TDNET_K2_STARVE")
D_K, D_V = 64, 512
N_FRAMES = 12
SEED = 0
HEADLINE = (1, 33153, 2145)   # the TD2 hop: the case each kernels entry reports


IMPORT_PROBE = """
import importlib
for name in ("PIL", "imageio", "cv2"):
    try:
        importlib.import_module(name)
        print(name, "yes", end="; ")
    except Exception as e:
        print(name, "no", f"({type(e).__name__})", end="; ")
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    from tdnet_tpu_torch.kernels.build import nvcc as nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc} | "
        f"python {sys.version.split()[0]}")
    log(f"[0] card: {smi} | devices: {torch.cuda.device_count()}")
    probe = subprocess.run([sys.executable, "-c", IMPORT_PROBE], capture_output=True, text=True)
    log(f"[0] image libraries importable here (information only; the port reads PNGs with "
        f"data/png.py): {probe.stdout.strip() or probe.stderr.strip()}")
    return smi


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time of the work on this card: the larger of its operations
    at the peak rate of their type and its bytes at the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_build() -> None:
    from tdnet_tpu_torch.kernels import dilated_conv, dropout, fused_stem, \
        propagation_attention, propagation_attention_train
    from tdnet_tpu_torch.kernels.build import compile_libraries
    mods = (propagation_attention, propagation_attention_train, dropout, fused_stem,
            dilated_conv)
    debug_mods = (propagation_attention, dilated_conv, propagation_attention_train)
    debug = {m.library_name(d): d for m, d in zip(debug_mods, (FAULT_DEFINES, K5_FAULT_DEFINES,
                                                                K2_FAULT_DEFINES))}
    t0 = time.perf_counter()
    compile_libraries({**{m.__name__.rsplit(".", 1)[1]: m.SOURCES for m in mods},
                       **{name: m.SOURCES for name, m in zip(debug, debug_mods)}}, debug)
    log(f"[1] built {', '.join(s for m in mods for s in m.SOURCES)} and the fault-check builds "
        f"of K1 ({' '.join(FAULT_DEFINES)}), K5 ({' '.join(K5_FAULT_DEFINES)}) and K2 "
        f"({' '.join(K2_FAULT_DEFINES)}) in {time.perf_counter() - t0:.1f} s (one nvcc each, "
        f"concurrently)")
    propagation_attention.build()


def device_rows(*fns, steps: int = 3) -> list[tuple[str, float]] | None:
    """The kernels that one call of each of ``fns`` runs, with their device
    ms, from a ``torch.profiler`` trace: one warm-up step (a trace started at
    a call dropped its first launches), then ``steps`` traced steps,
    averaged; user annotations (the profiler's step rows, whose device time is
    a span) left out. A trace that holds no kernel, or in which a kernel's
    launches are not a multiple of ``steps`` (a trace can lack a launch), is
    taken again, up to twice more; if the last still lacks launches, each
    kernel's time a call is its mean time a launch times its launches a step
    rounded up (logged as estimated); a trace with no kernel gives None: the
    device time is then not measured."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        traced = []
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=steps),
                on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
            for _ in range(1 + steps):
                for fn in fns:
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [(r.key, r.self_device_time_total / 1e3, r.count) for r in traced[0]
                if r.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(r, "is_user_annotation", False)
                and not r.key.startswith("ProfilerStep")]
        if rows and all(count % steps == 0 for _, _, count in rows):
            return sorted(((key, ms / steps) for key, ms, _ in rows), key=lambda r: -r[1])
    if not rows:
        log(f"device time not measured: three traces of {steps} steps held no kernel")
        return None
    log(f"device time estimated: the third trace of {steps} steps held launches "
        f"{[(key[:40], count) for key, _, count in rows]}; a kernel's time a call is its mean "
        f"a launch x its launches a step rounded up")
    return sorted(((key, ms / count * -(-count // steps)) for key, ms, count in rows),
                  key=lambda r: -r[1])


def format_rows(rows) -> str:
    """``device_rows``' result as one line."""
    if rows is None:
        return "not measured"
    return "; ".join(f"{key[:90]} {ms:.3f}" for key, ms in rows)


def attention_bounds(n, lq, lkv, fc, nbytes) -> dict:
    """The forward's bound both ways: every product in f32 on the CUDA cores,
    and in 3xTF32 on the tensor cores (the card's rate for f32-accurate
    products, and K1's route for p v and the fc)."""
    flops = 2 * n * lq * lkv * (D_K + D_V) + (2 * n * lq * D_V * D_V if fc else 0)
    return dict(flops=flops, f32=bound(flops, nbytes, PEAK_F32),
                tf32x3=bound(flops, nbytes, PEAK_TF32X3))


def fault_child(kernel: str = "K1") -> None:
    """A fault check, run in a child process (a fault there cannot end the
    run): K1's bf16 kernels from the build of ``FAULT_DEFINES``, K5's bf16
    kernel from the build of ``K5_FAULT_DEFINES``, or K2's bf16 forward and
    backward from the build of ``K2_FAULT_DEFINES``, on a small call, then
    ``check_fault``; prints one JSON line, whether it raised."""
    from tdnet_tpu_torch.kernels.fault import check_fault
    if kernel == "K1":
        from tdnet_tpu_torch.kernels import propagation_attention as pa
        from tdnet_tpu_torch.kernels.grid import attention_bf16_plan, sm_count
        q, k, v = (torch.randn(1, n, d, device="cuda").to(torch.bfloat16)
                   for n, d in ((700, D_K), (130, D_K), (130, D_V)))
        plan = attention_bf16_plan(1, 700, 130, D_V, sm_count(0))
        pa.launch_bf16(q, k, v, 8.0, None, None, plan, lib=pa.build(FAULT_DEFINES))
    elif kernel == "K2":
        from tdnet_tpu_torch.kernels import propagation_attention_train as pat
        n, lq, lkv = BATCHED
        q, k, v, dy = (torch.randn(n, m, d, device="cuda").to(torch.bfloat16)
                       for m, d in ((lq, D_K), (lkv, D_K), (lkv, D_V), (lq, D_V)))
        lib = pat.build(K2_FAULT_DEFINES)
        _, stats, bits = pat.launch_bf16_forward(q, k, v, 8.0, 0.1, SEED, lib=lib)
        pat.launch_bf16_backward(q, k, v, dy, stats, bits, 8.0, 0.1, SEED, lib=lib)
    else:
        from tdnet_tpu_torch.kernels import dilated_conv as dc
        x = torch.randn(1, 64, 13, 21, device="cuda").to(torch.bfloat16)
        w = torch.randn(128, 64, 3, 3, device="cuda").to(torch.bfloat16)
        dc.launch(x, w, 4, 4, lib=dc.build(K5_FAULT_DEFINES))
    torch.cuda.synchronize()
    try:
        check_fault("cuda")
        print(json.dumps({"reported": False}), flush=True)
    except RuntimeError as e:
        print(json.dumps({"reported": True, "error": str(e)}), flush=True)


def phase_fault_report(kernel: str = "K1", tag: str = "2") -> None:
    """A bf16 consumer of ``kernel`` (K1, K2 or K5) that gives up on a barrier is
    reported: ``fault_child`` in a child process must see ``check_fault`` raise."""
    defines = {"K1": FAULT_DEFINES, "K2": K2_FAULT_DEFINES, "K5": K5_FAULT_DEFINES}[kernel]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c",
                          f"import chip_smoke; chip_smoke.fault_child({kernel!r})"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    got = json.loads(lines[-1]) if out.returncode == 0 and lines else {}
    log(f"[{tag}] {kernel}'s fault-check build ({' '.join(defines)}) in a child process: exit "
        f"{out.returncode}, {got or out.stderr.strip()[-400:]} ({time.perf_counter() - t0:.1f} s)")
    if got.get("reported") is not True:
        raise AssertionError(f"[{tag}] a {kernel} consumer that gave up on its barrier was not "
                             f"reported")


def phase_kernel(card: str) -> dict:
    from tdnet_tpu_torch.kernels.propagation_attention import (
        check_fault, fused_propagation_attention, propagation_attention_plain)
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    headline = {}
    log(f"[2] kernel vs plain ({card}); tolerances: f32 2e-5 (5e-4 with fc), "
        f"bf16 3e-2 x max|ref|")
    for n, lq, lkv in [(1, *shape) for shape in SHAPES] + [BATCHED]:
        host = dict(q=rng.randn(n, lq, D_K), k=rng.randn(n, lkv, D_K),
                    v=rng.randn(n, lkv, D_V), w=rng.randn(D_V, D_V) * 0.05,
                    b=rng.randn(D_V) * 0.1)
        for dtype in (torch.float32, torch.bfloat16):
            t = {n: torch.tensor(a, dtype=torch.float32, device=dev).to(dtype).contiguous()
                 for n, a in host.items()}
            ref_in = {n: x.float() for n, x in t.items()}   # bf16-rounded inputs, in f32
            for fc in (False, True):
                fkw = dict(fc_w=t["w"], fc_b=t["b"]) if fc else {}
                rkw = dict(fc_w=ref_in["w"], fc_b=ref_in["b"]) if fc else {}
                got = fused_propagation_attention(t["q"], t["k"], t["v"], temperature=8.0,
                                                  **fkw)
                torch.cuda.synchronize()
                check_fault("cuda")
                ref = propagation_attention_plain(ref_in["q"], ref_in["k"], ref_in["v"],
                                                  temperature=8.0, **rkw)
                err = (got.float() - ref).abs().max().item()
                scale = ref.abs().max().item()
                tol = (5e-4 if fc else 2e-5) if dtype == torch.float32 else 3e-2 * scale
                if not (got.shape == ref.shape and np.isfinite(err) and err <= tol):
                    raise AssertionError(f"kernel disagrees at {n}x{lq}x{lkv} {dtype} fc={fc}: "
                                         f"max abs err {err} > {tol}")
                run = lambda: fused_propagation_attention(t["q"], t["k"], t["v"],
                                                          temperature=8.0, **fkw)
                if not torch.equal(run(), got):
                    raise AssertionError(f"[2] K1 at {n}x{lq}x{lkv} {dtype} fc={fc}: two calls "
                                         f"differ")
                ms = median_ms(run)
                check_fault("cuda")
                plain_ms = median_ms(lambda: propagation_attention_plain(
                    t["q"], t["k"], t["v"], temperature=8.0, **fkw))
                name = "bf16" if dtype == torch.bfloat16 else "f32"
                log(f"[2] n={n} {lq:6d} x {lkv:5d} {name:4s} fc={int(fc)}  max_abs_err {err:.3e} "
                    f"(tol {tol:.3e}), bitwise repeat  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
                rows = device_rows(run)
                check_fault("cuda")
                log(f"[2]   kernels (device ms): {format_rows(rows)}")
                if (n, lq, lkv) == HEADLINE and fc:
                    sdpa = lambda: F.scaled_dot_product_attention(
                        t["q"], t["k"], t["v"], scale=1.0 / 8.0)
                    sdpa_ms = median_ms(sdpa)
                    # the same function as the kernel with the fc: SDPA, then addmm
                    lib_ms = median_ms(lambda: torch.addmm(t["b"], sdpa().view(-1, D_V), t["w"]))
                    nbytes = t["q"].element_size() * (
                        n * lq * (D_K + D_V) + n * lkv * (D_K + D_V) + D_V * D_V + D_V)
                    b = attention_bounds(n, lq, lkv, fc, nbytes)
                    kernel_bound = b["tf32x3"] if dtype == torch.float32 else \
                        bound(b["flops"], nbytes, PEAK_BF16)
                    headline[name] = dict(max_abs_err=err, ms=ms,
                                          device_ms=None if rows is None
                                          else sum(t for _, t in rows),
                                          plain_ms=plain_ms, library_ms=lib_ms,
                                          library_sdpa_ms=sdpa_ms, **kernel_bound)
                    log(f"[2]   F.scaled_dot_product_attention then torch.addmm (the fc) "
                        f"{lib_ms:.3f} ms, SDPA alone {sdpa_ms:.3f} ms; {b['flops'] / 1e9:.2f} "
                        f"GFLOP, bound {kernel_bound['bound_ms']:.3f} ms by "
                        f"{kernel_bound['bound_by']}" + (
                            f" in 3xTF32 on the tensor cores ({PEAK_TF32X3 / 1e12:.0f} TFLOP/s), "
                            f"{b['f32']['bound_ms']:.3f} ms in f32 on the CUDA cores"
                            if dtype == torch.float32 else " in bf16"))
            del t, ref_in
    log("[2] K1's error word clear after every call above")
    k1_bf16_digests()
    phase_fault_report()
    return headline


def k1_bf16_digests() -> None:
    """K1's bf16 outputs at phase 2's shapes (and the ragged batch), without and
    with the fc, on seeded inputs, logged as sha256 digests; the package's
    public API alone, so that the same function run with another checkout's
    package compares the two trees' K1 bit for bit."""
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    gen = torch.Generator().manual_seed(SEED + 9)
    for n, lq, lkv in [(1, *shape) for shape in SHAPES] + [BATCHED]:
        q, k = (torch.randn(n, m, D_K, generator=gen).to("cuda", torch.bfloat16)
                for m in (lq, lkv))
        v = torch.randn(n, lkv, D_V, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(D_V, D_V, generator=gen) * 0.05).to("cuda", torch.bfloat16)
        b = (torch.randn(D_V, generator=gen) * 0.1).to("cuda", torch.bfloat16)
        plain = fused_propagation_attention(q, k, v, temperature=8.0)
        fc = fused_propagation_attention(q, k, v, temperature=8.0, fc_w=w, fc_b=b)
        log(f"[2] K1 bf16 n={n} {lq} x {lkv} sha256 without the fc {digest(plain)}, with it "
            f"{digest(fc)}")


def stream_frames(in_size, dtype):
    from tdnet_tpu_torch.stream.runtime import synthetic_frames
    return synthetic_frames(N_FRAMES, in_size, seed=SEED, device="cuda", dtype=dtype)


@contextlib.contextmanager
def swapped(module, name: str, replacement):
    """``module.name`` is ``replacement`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def plain_attention():
    """The streaming hops take the plain attention instead of the kernel's wrapper."""
    from tdnet_tpu_torch.kernels import propagation_attention as pa
    from tdnet_tpu_torch.nn import encoding
    return swapped(encoding, "fused_propagation_attention", pa.propagation_attention_plain)


def recording_attention(seen: dict):
    """The streaming hops go through the kernel's wrapper as before, and
    ``seen`` keeps copies of the inputs of the last call."""
    from tdnet_tpu_torch.kernels import propagation_attention as pa
    from tdnet_tpu_torch.nn import encoding

    def record(q, k, v, **kw):
        seen.clear()
        seen.update(q=q.clone(), k=k.clone(), v=v.clone(), **kw)
        return pa.fused_propagation_attention(q, k, v, **kw)
    return swapped(encoding, "fused_propagation_attention", record)


def score_spread(q, k, temperature) -> str:
    """How peaked the softmax of q kᵀ / temperature is: the median over rows
    of max - min of the scaled scores, and the shares of exp(s - max) that
    are 0 in f32 and that lie below 2^-126 (f32's subnormals and 0)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    e = torch.exp(s - s.amax(-1, keepdim=True))
    spread = (s.amax(-1) - s.amin(-1)).median().item()
    return (f"median row spread {spread:.2f}, exp(s - m) == 0: {(e == 0).float().mean().item():.4f},"
            f" < 2^-126: {(e < 2.0 ** -126).float().mean().item():.4f}")


def phase_stream_inputs(card: str, hop: dict) -> None:
    """K1 on one warm frame's hop inputs of the TD2-PSP50 bf16 stream (``hop``,
    from ``recording_attention``) and on phase 2's kind of inputs at the same
    shape (randn q, k, v; w x 0.05, b x 0.1), timed in turns (stream, randn,
    stream, randn): the median of 10 CUDA-event calls, the kernels' device ms
    and the SM clock, power draw and temperature after each. The kernel on the
    stream's inputs is held to phase 2's bf16 rule and repeats bitwise."""
    from tdnet_tpu_torch.cli.profile import smi
    from tdnet_tpu_torch.kernels.propagation_attention import (
        check_fault, fused_propagation_attention, propagation_attention_plain)
    n, lq, _ = hop["q"].shape
    lkv = hop["k"].shape[1]
    rng = np.random.RandomState(SEED)
    host = dict(q=rng.randn(n, lq, D_K), k=rng.randn(n, lkv, D_K), v=rng.randn(n, lkv, D_V),
                fc_w=rng.randn(D_V, D_V) * 0.05, fc_b=rng.randn(D_V) * 0.1)
    randn = {name: torch.tensor(a, dtype=torch.float32, device="cuda").to(torch.bfloat16)
             for name, a in host.items()}
    randn["temperature"] = 8.0
    cases = {"stream": hop, "randn": randn}
    for name, c in cases.items():
        kw = dict(temperature=c["temperature"], fc_w=c["fc_w"], fc_b=c["fc_b"])
        got = fused_propagation_attention(c["q"], c["k"], c["v"], **kw)
        ref = propagation_attention_plain(c["q"].float(), c["k"].float(), c["v"].float(),
                                          temperature=kw["temperature"], fc_w=c["fc_w"].float(),
                                          fc_b=c["fc_b"].float())
        err = (got.float() - ref).abs().max().item()
        tol = 3e-2 * ref.abs().max().item()
        same = torch.equal(fused_propagation_attention(c["q"], c["k"], c["v"], **kw), got)
        check_fault("cuda")
        log(f"[5] {name} inputs {n}x{lq}x{lkv}, temperature {kw['temperature']:g}: max_abs_err "
            f"{err:.3e} (tol {tol:.3e}), two calls {'bitwise equal' if same else 'DIFFERENT'}; "
            f"{score_spread(c['q'], c['k'], kw['temperature'])}")
        if not (np.isfinite(err) and err <= tol and same):
            raise AssertionError(f"[5] K1 on the {name} inputs: max abs err {err} > {tol} or "
                                 f"two calls differ")
        del got, ref
    for name in ("stream", "randn", "stream", "randn"):
        c = cases[name]
        run = lambda: fused_propagation_attention(c["q"], c["k"], c["v"],
                                                  temperature=c["temperature"],
                                                  fc_w=c["fc_w"], fc_b=c["fc_b"])
        ms = median_ms(run)
        rows = format_rows(device_rows(run))
        check_fault("cuda")
        log(f"[5] K1 on the {name} inputs ({card}): {ms:.3f} ms; device ms: {rows}; after it "
            f"{smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")


def check_close(tag, got, want, frac, what):
    """Every frame of ``got`` within ``frac`` x max|want| of ``want``."""
    worst = (0.0, 0.0, 1.0)   # (err / tol, err, tol)
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a.float() - b.float()).abs().max().item()
        tol = frac * b.float().abs().max().item()
        worst = max(worst, (err / tol, err, tol))
        if not err <= tol:
            raise AssertionError(f"[{tag}] frame {i}: {what} logits differ by {err} > {tol}")
    log(f"[{tag}] {what} logits: worst frame max abs diff {worst[1]:.4e} against a bound of "
        f"{worst[2]:.4e} ({frac:g} x max|logits|), {worst[0]:.3f} of it")


def drive(make_runner, frames, card, tag, what):
    """Step the frames one at a time through the runner ``make_runner()``
    builds, then once pipelined; returns (logits on the host, K1 launches, K4
    launches) of the stepped run. The peak memory is the run's own: weights,
    cache and activations, not the frames."""
    from tdnet_tpu_torch.kernels.fused_stem import fused_stem_tail
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runner = make_runner()
    fused_propagation_attention.launches = 0
    fused_stem_tail.launches = 0
    outs = [runner.step(f)[0].cpu() for f in frames]
    launches = (fused_propagation_attention.launches, fused_stem_tail.launches)
    if runner.ctx.stem_impl == "fused":
        check_stem(tag, runner, frames)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    cfg = runner.cfg
    for o in outs:
        if o.shape != (1, *cfg.in_size, cfg.nclass) or not torch.isfinite(o).all():
            raise AssertionError(f"{tag}: bad logits {tuple(o.shape)}")
    runner.reset()
    _, spf = runner.run_pipelined(frames)
    log(f"[{tag}] {what} {cfg.in_size[0]}x{cfg.in_size[1]} {str(runner.dtype)[6:]} stem "
        f"{runner.ctx.stem_impl} ({card}): hard-synced latency {runner.meter.avg * 1e3:.2f} "
        f"ms/frame (frames 7-{N_FRAMES}), pipelined {1.0 / spf:.2f} frames/s, peak memory "
        f"{peak:.0f} MiB, launches K1 {launches[0]} K4 {launches[1]}")
    return outs, *launches


def report_bf16_stream(tag, fused, plain, ref, what):
    """How far the fused bf16 stream lies from the plain-stem bf16 stream and
    from ``ref`` (the f32 stream), beside the plain bf16 stream's own
    distance from it: a report (the stem check inside the run is the gate);
    returns the ratio of the two distances."""
    dist = lambda xs, ys: max((a.float() - r.float()).abs().max().item() for a, r in zip(xs, ys))
    d_fused, d_plain = dist(fused, ref), dist(plain, ref)
    log(f"[{tag}] {what} logits (report): fused vs plain {dist(fused, plain):.4e}; distance "
        f"from f32: fused {d_fused:.4e}, plain {d_plain:.4e} ({d_fused / d_plain:.3f} of it); "
        f"max|f32 logits| {max(r.float().abs().max().item() for r in ref):.4e}")
    return d_fused / d_plain


def check_stem(tag, runner, frames) -> None:
    """K4 inside a fused run: the stem tail of every frame, fused against
    plain, with the backbone that took the frame (path ``i % path_num`` of a
    TDNet) on the run's weights (BNs folded, the runner's K4 layout), by
    phase 10's rules."""
    from tdnet_tpu_torch.ops import max_pool
    model = runner.model
    backbones = [p.backbone for p in model.paths] if hasattr(model, "paths") \
        else [model.backbone]
    frac = 2e-2 if runner.dtype == torch.bfloat16 else 1e-4
    worst = 0.0
    with torch.inference_mode():
        for i, f in enumerate(frames):
            bb = backbones[i % len(backbones)]
            x = f.to(runner.dtype).permute(0, 3, 1, 2).contiguous()
            got = bb.stem.fused(x, bb.bn1)
            want = max_pool(bb.bn1(bb.stem(x), "relu"), 3, 2, 1)
            err = (got.float() - want.float()).abs().max().item()
            tol = frac * want.float().abs().max().item()
            worst = max(worst, err / tol)
            if not (got.shape == want.shape and err <= tol):
                raise AssertionError(f"[{tag}] frame {i}: stem tail in the run, fused vs plain "
                                     f"{err} > {tol}")
    log(f"[{tag}] stem tail of all {len(frames)} frames in the run ({len(backbones)} "
        f"backbone(s)), fused vs plain: worst {worst:.3f} of {frac:g} x max|ref|")


def run_stream(arch, in_size, dtype, frames, card, tag, kernel=True, stem_impl="plain"):
    """Stream the frames through a fresh seeded TDNet; returns (logits on the
    host, K1 launches, K4 launches). ``kernel=False``: the attention is the
    plain version, which launches nothing."""
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    from tdnet_tpu_torch.nn import BACKBONES
    from tdnet_tpu_torch.stream.runtime import Streamer
    cfg = tdnet_config(arch, in_size=in_size)
    deep_base = BACKBONES[cfg.backbone]().deep_base
    outs, launches, stem_launches = drive(
        lambda: Streamer(init_tdnet(cfg, torch.Generator().manual_seed(SEED)).to("cuda"),
                         dtype=dtype, stem_impl=stem_impl), frames, card, tag, arch)
    warm = N_FRAMES - cfg.window
    expected = (cfg.window * warm if kernel else 0,
                N_FRAMES if stem_impl == "fused" and deep_base else 0)
    if (launches, stem_launches) != expected:
        raise AssertionError(f"{tag}: K1 / K4 launches {launches} / {stem_launches}, expected "
                             f"{expected[0]} / {expected[1]}")
    return outs, launches, stem_launches


def phase_tf32_defaults(card: str, td4, outs32) -> None:
    """Phase 3b: the TD4-PSP18 f32 stream with torch's own precision defaults
    (cuDNN ``allow_tf32`` True, as ``cli/test.py`` leaves it) must give phase 3's
    logits (taken with TF32 off for the whole process) to 1e-5 x max|logits|:
    the runtime's ``no_tf32`` scope holds whatever the caller set. Beside it,
    the same stream with that scope removed (TF32 on) is reported."""
    from tdnet_tpu_torch.stream import runtime
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    try:
        frames = stream_frames(td4, torch.float32)
        outs, _, _ = run_stream("td4-psp18", td4, torch.float32, frames, card, "3b")
        with swapped(runtime, "no_tf32", contextlib.nullcontext):
            tf32, _, _ = run_stream("td4-psp18", td4, torch.float32, frames, card, "3b-tf32")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    dist = lambda xs: max((a - b).abs().max().item() for a, b in zip(xs, outs32))
    scale = max(o.abs().max().item() for o in outs32)
    same = all(torch.equal(a, b) for a, b in zip(outs, outs32))
    log(f"[3b] f32 stream with torch's defaults (cudnn.allow_tf32 True): logits "
        f"{'bitwise equal to' if same else 'differ from'} phase 3's, max abs diff "
        f"{dist(outs):.3e} (limit {1e-5 * scale:.3e}); with the runtime's scope removed (TF32 "
        f"on) {dist(tf32):.3e}, max|logits| {scale:.3e}")
    if not dist(outs) <= 1e-5 * scale:
        raise AssertionError("[3b] the f32 stream computes otherwise with torch's defaults")


def phase_td2_stream(card: str, td2) -> tuple[list, int]:
    """Phase 5: the TD2-PSP50 bf16 stream against its plain-attention run, then
    K1 on one warm frame's hop inputs (``phase_stream_inputs``); returns the
    stream's logits and K1 launches."""
    frames = stream_frames(td2, torch.bfloat16)
    hop = {}
    with recording_attention(hop):
        outs, launches, _ = run_stream("td2-psp50", td2, torch.bfloat16, frames, card, "5")
    with plain_attention():
        plain, _, _ = run_stream("td2-psp50", td2, torch.bfloat16, frames, card, "5-plain",
                                 kernel=False)
    check_close("5", outs, plain, 3e-2, "kernel-path vs plain-attention bf16")
    del plain, frames
    phase_stream_inputs(card, hop)
    return outs, launches


def phase_train_build() -> None:
    from tdnet_tpu_torch.kernels import dropout, propagation_attention_train
    t0 = time.perf_counter()
    propagation_attention_train.build()
    dropout.build()
    log(f"[6] loaded propagation_attention_train.cu and dropout.cu in "
        f"{time.perf_counter() - t0:.2f} s (built in phase 1)")


def _fwd_bwd(fn, q, k, v, dy, **kw):
    """(output, dq, dk, dv) of ``fn`` on leaf copies of q, k, v."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(dy)
    torch.cuda.synchronize()
    return [out.detach()] + [t.grad for t in leaves]


def _train_attention_times(q, k, v, dy, k2, p2, tag: str = "7") -> dict:
    """(forward ms, backward ms) of the kernel, the plain version and SDPA, and
    under "device" the kernel's forward and backward device ms (None where
    the trace is not measured)."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    times = {}
    for name, fn, kw in (("kernel", k2, dict(dropout_rate=0.1, seed=SEED)),
                         ("plain", p2, dict(dropout_rate=0.1, seed=SEED)),
                         ("sdpa", None, {})):
        if fn is None:
            fwd = lambda: F.scaled_dot_product_attention(*leaves, scale=1.0 / 8.0)
        else:
            fwd = lambda: fn(*leaves, temperature=8.0, **kw)
        out = fwd()
        bwd = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)
        times[name] = (median_ms(fwd), median_ms(bwd))
        if name != "plain":   # the kernels each forward and backward runs
            rows = [device_rows(fwd), device_rows(bwd)]
            log(f"[{tag}] {name} forward kernels (device ms): {format_rows(rows[0])}")
            log(f"[{tag}] {name} backward kernels (device ms): {format_rows(rows[1])}")
            if name == "kernel":
                times["device"] = tuple(None if r is None else sum(t for _, t in r)
                                        for r in rows)
        del out
    return times


def phase_train_attention(card: str) -> dict:
    """K2 against its plain version; returns the kernels entries' numbers."""
    from tdnet_tpu_torch.kernels.propagation_attention_train import (
        propagation_attention_train as k2, propagation_attention_train_plain as p2)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    log(f"[7] training attention kernel vs plain ({card}); tolerances: output 1e-5 x "
        f"max|output|, dq/dk/dv atol 2e-4 rtol 1e-3, keep rate 0.9 +- 1e-3; the forward and "
        f"the backward bitwise equal across two runs")
    res = dict(fwd_err=0.0, bwd_err=0.0)
    hop_ms = {}
    for lq, lkv in TRAIN_SHAPES:
        q, k = (torch.randn(1, n, D_K, generator=gen).to(dev) for n in (lq, lkv))
        v = torch.randn(1, lkv, D_V, generator=gen).to(dev)
        dy = torch.randn(1, lq, D_V, generator=gen).to(dev)
        for rate in (0.0, 0.1):
            kw = dict(temperature=8.0, dropout_rate=rate, seed=SEED + 17)
            got, want = _fwd_bwd(k2, q, k, v, dy, **kw), _fwd_bwd(p2, q, k, v, dy, **kw)
            f_err = (got[0] - want[0]).abs().max().item()
            f_tol = 1e-5 * want[0].abs().max().item()
            g_err = max((a - b).abs().max().item() for a, b in zip(got[1:], want[1:]))
            ok = f_err <= f_tol and all(torch.allclose(a, b, atol=2e-4, rtol=1e-3)
                                        for a, b in zip(got[1:], want[1:]))
            again = _fwd_bwd(k2, q, k, v, dy, **kw)
            same = [torch.equal(got[0], again[0]),
                    all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))]
            with torch.no_grad():
                o64 = p2(q.double(), k.double(), v.double(), **kw)
            rms = lambda o: ((o.double() - o64).pow(2).mean().sqrt()
                             / o64.pow(2).mean().sqrt()).item()
            d_kernel, d_plain = rms(got[0]), rms(want[0])
            log(f"[7] {lq:6d} x {lkv:5d} dropout {rate}: output max abs err {f_err:.3e} "
                f"(tol {f_tol:.3e}), dq/dk/dv max abs err {g_err:.3e}; second forward / "
                f"backward {' / '.join('bitwise equal' if x else 'DIFFERENT' for x in same)}; "
                f"forward's rms distance from float64 over its rms: kernel {d_kernel:.3e}, "
                f"plain {d_plain:.3e}")
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain version at {lq}x{lkv} "
                                     f"dropout {rate}")
            if not all(same):
                raise AssertionError(f"K2 is not deterministic at {lq}x{lkv} dropout {rate}: "
                                     f"forward / backward repeat {same}")
            del o64
            res["fwd_err"] = max(res["fwd_err"], f_err)
            res["bwd_err"] = max(res["bwd_err"], g_err)
            del got, want, again
        # keep rate: uniform scores (q = 0) and v of ones make o_i = kept_i / (0.9 Lkv)
        ones = torch.ones(1, lkv, 128, device=dev)
        o = k2(torch.zeros_like(q), k, ones, temperature=8.0, dropout_rate=0.1, seed=SEED + 17)
        kept = torch.round(o[..., 0].double() * 0.9 * lkv).sum().item()
        rate = kept / (lq * lkv)
        log(f"[7] {lq:6d} x {lkv:5d} observed keep rate {rate:.6f} over {lq * lkv} elements")
        if abs(rate - 0.9) > 1e-3:
            raise AssertionError(f"K2 keep rate {rate} outside 0.9 +- 1e-3")
        del o, ones

        times = _train_attention_times(q, k, v, dy, k2, p2)
        log(f"[7] {lq} x {lkv} forward / backward ms: kernel {times['kernel'][0]:.3f} / "
            f"{times['kernel'][1]:.3f}, plain {times['plain'][0]:.3f} / "
            f"{times['plain'][1]:.3f}, F.scaled_dot_product_attention (no dropout) "
            f"{times['sdpa'][0]:.3f} / {times['sdpa'][1]:.3f}")
        io = 4 * (lq * (D_K + D_V) + lkv * (D_K + D_V))   # q, k, v and o or dy, f32
        fwd_bs = attention_bounds(1, lq, lkv, False, io)
        fwd_b = fwd_bs["tf32x3"]   # the card's rate for f32-accurate products
        bwd_flops, bwd_bytes = 2 * lq * lkv * (2 * D_V + 3 * D_K), 2 * io + 4 * 2 * lq
        bwd_b = bound(bwd_flops, bwd_bytes, PEAK_TF32X3)
        bwd_b32 = bound(bwd_flops, bwd_bytes, PEAK_F32)
        log(f"[7] {lq} x {lkv} bounds: forward {fwd_bs['flops'] / 1e9:.2f} GFLOP: "
            f"{fwd_b['bound_ms']:.3f} ms in 3xTF32 on the tensor cores, "
            f"{fwd_bs['f32']['bound_ms']:.3f} ms in f32 on the CUDA cores; the kernel's "
            f"forward at {fwd_bs['flops'] / times['kernel'][0] / 1e9:.1f} TFLOP/s; backward "
            f"{bwd_flops / 1e9:.2f} GFLOP: "
            f"{bwd_b['bound_ms']:.3f} ms in 3xTF32 on the tensor cores "
            f"({PEAK_TF32X3 / 1e12:.0f} TFLOP/s), {bwd_b32['bound_ms']:.3f} ms in f32 on the "
            f"CUDA cores; the kernel's backward at "
            f"{bwd_flops / times['kernel'][1] / 1e9:.1f} TFLOP/s")
        hop_ms[lq, lkv] = times
        del q, k, v, dy
    log("[7] forward ms, kernel / F.scaled_dot_product_attention: " + "; ".join(
        f"{lq} x {lkv} {t['kernel'][0]:.3f} / {t['sdpa'][0]:.3f}" for (lq, lkv), t in hop_ms.items()))
    # the kernels entries report the last hop, the largest
    return {
        "fwd": dict(max_abs_err=res["fwd_err"], ms=times["kernel"][0],
                    device_ms=times["device"][0], plain_ms=times["plain"][0],
                    library_ms=times["sdpa"][0], **fwd_b),
        "bwd": dict(max_abs_err=res["bwd_err"], ms=times["kernel"][1],
                    device_ms=times["device"][1], plain_ms=times["plain"][1],
                    library_ms=times["sdpa"][1], **bwd_b)}


def _fwd_bwd_call(fn, x: torch.Tensor, dy: torch.Tensor):
    """One forward and backward through autograd, as a train step runs it: x's
    gradient set to None first, so that no call adds into the last one's."""
    def run():
        x.grad = None
        fn(x).backward(dy)
    return run


def k3_turns(dtype: torch.dtype, tag: str, gen: torch.Generator) -> dict:
    """K3's and ``F.dropout``'s calls at each of ``DROP_ROWS``, in turns (kernel,
    F.dropout, F.dropout, kernel; each the median of ``K3_REPS`` CUDA-event
    calls): the forward alone on an x that needs no gradient, and forward plus
    backward through autograd (``_fwd_bwd_call``), the train step's form; then
    the device time of each one's kernels from one ``torch.profiler`` trace of
    each form, and K3's forward plus backward with x and dy cold, rotating over
    as many (x, dy) as hold 200 MB (the traces of the two calls in turns leave
    x in L2 wherever it fits). Returns rows -> the kernels entry's numbers:
    forward plus backward (``ms``, ``library_ms``, ``device_ms`` warm and
    ``device_cold_ms``, the bound of its two launches) and the forward alone
    (``forward_*``), each side's two turns averaged."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.dropout import dropout

    def split(traced):
        if traced is None:
            return None, None, "not measured"
        mine = [t for t in traced if kernel_family(t[0], train=True) == "K3 dropout"]
        theirs = [t for t in traced if t not in mine]
        return (sum(t for _, t in mine), sum(t for _, t in theirs),
                f"K3 {format_rows(mine)}; F.dropout {format_rows(theirs)}")

    out = {}
    for rows in DROP_ROWS:
        x = torch.randn(rows, D_V, generator=gen).to("cuda", dtype)
        xg = x.clone().requires_grad_(True)
        dy = torch.randn(rows, D_V, generator=gen).to("cuda", dtype)
        calls = {"forward": (lambda: dropout(x, 0.1, SEED),
                             lambda: F.dropout(x, 0.1, training=True)),
                 "forward+backward": (
                     _fwd_bwd_call(lambda t: dropout(t, 0.1, SEED), xg, dy),
                     _fwd_bwd_call(lambda t: F.dropout(t, 0.1, training=True), xg, dy))}
        r = {}
        for what, (kernel, lib) in calls.items():
            turns = [median_ms(f, reps=K3_REPS) for f in (kernel, lib, lib, kernel)]
            r[what] = ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
            log(f"[{tag}] [{rows}, {D_V}] {what} ms in turns (kernel, F.dropout, F.dropout, "
                f"kernel): {', '.join(f'{t:.4f}' for t in turns)}; kernel / F.dropout "
                f"{r[what][0] / r[what][1]:.3f}")
        one = bound(0, 2 * dtype.itemsize * rows * D_V, PEAK_BF16)
        both = bound(0, 4 * dtype.itemsize * rows * D_V, PEAK_BF16)   # x, y, dy, dx
        n_sets = -(-200_000_000 // (4 * dtype.itemsize * rows * D_V))
        dev, lib_dev, rows_fwd = split(device_rows(*calls["forward"]))
        dev2, lib_dev2, rows_both = split(device_rows(*calls["forward+backward"]))
        sets = [(torch.randn(rows, D_V, generator=gen).to("cuda", dtype).requires_grad_(True),
                 torch.randn(rows, D_V, generator=gen).to("cuda", dtype))
                for _ in range(n_sets)]
        cold = device_rows(lambda: [_fwd_bwd_call(lambda t: dropout(t, 0.1, SEED), *s)()
                                    for s in sets])
        cold_ms = None if cold is None else split(cold)[0] / len(sets)
        del sets
        log(f"[{tag}] [{rows}, {D_V}] forward device ms, one trace: {rows_fwd}; bound "
            f"{one['bound_ms']:.4f} ms by {one['bound_by']}"
            + ("" if dev is None else f", K3 at {one['bound_ms'] / dev:.3f} of it"))
        log(f"[{tag}] [{rows}, {D_V}] forward+backward device ms, one trace: {rows_both}; "
            f"K3 cold (over {n_sets} x and dy) "
            + ("not measured" if cold_ms is None else f"{cold_ms:.4f}")
            + f"; bound {both['bound_ms']:.4f} ms by {both['bound_by']}"
            + ("" if dev2 is None or cold_ms is None else
               f", K3 at {both['bound_ms'] / dev2:.3f} of it warm, "
               f"{both['bound_ms'] / cold_ms:.3f} cold"))
        out[rows] = dict(ms=r["forward+backward"][0], library_ms=r["forward+backward"][1],
                         device_ms=dev2, device_cold_ms=cold_ms, library_device_ms=lib_dev2,
                         forward_ms=r["forward"][0], library_forward_ms=r["forward"][1],
                         forward_device_ms=dev, library_forward_device_ms=lib_dev,
                         **both)
    return out


class _NoWork(torch.autograd.Function):
    """An autograd function that does no work: what its bookkeeping costs."""
    @staticmethod
    def forward(ctx, x, rate, seed):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def host_us(fn, calls: int = 1000, rounds: int = 3) -> float:
    """Host µs of one call of ``fn``: ``time.perf_counter_ns`` over ``calls``
    back-to-back calls with no synchronize, the median of ``rounds``; the card
    synchronized before each round."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter_ns() - t0) / calls / 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def k3_host_split(dtype: torch.dtype, tag: str) -> None:
    """The host time of one K3 call split into its parts (``host_us``): the
    parent wrapper's (a ``torch.cuda.Stream`` object for the handle) beside
    the ones the wrapper takes now (the raw stream handle), with whole calls of
    ``dropout`` and ``F.dropout`` beside them, then each call's CPU time from
    one ``torch.profiler`` trace. At [2,145, 512],
    whose kernel takes less device time than a call's host time, so the launch
    queue never fills. The wrapper's internals are read through names that the
    parent's package has too (``build``, ``_rate_args``, the two C entry
    points), so the same function times a parent's tree."""
    from tdnet_tpu_torch.kernels import dropout as kd
    rows, rate, dev = DROP_ROWS[1], 0.1, torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(rows, D_V, generator=gen).to(dev, dtype)
    xg = x.clone().requires_grad_(True)
    dy = torch.randn(rows, D_V, generator=gen).to(dev, dtype)
    y = torch.empty_like(x)
    lib = kd.build()
    entry = lib.tdnet_dropout if dtype == torch.float32 else lib.tdnet_dropout_bf16
    threshold, inv_keep = kd._rate_args(rate, dtype)
    xp, yp, n, index = x.data_ptr(), y.data_ptr(), x.numel(), x.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw_stream = torch._C._cuda_getCurrentRawStream
    base_apply = torch._C._FunctionBase.__dict__["apply"].__get__(None, _NoWork)
    ctx = types.SimpleNamespace(rate=rate, seed=SEED)
    mask = torch.ops.aten.native_dropout(x, rate, True)[1]
    tally = types.SimpleNamespace(launches=0)   # priced like the wrapper's counter

    def count():
        tally.launches += 1

    def checks():
        return (x.device.type == "cpu" or x.device.type != "cuda"
                or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous())

    parts = [
        ("loop and lambda alone", lambda: None),
        ("dropout(), x needs no gradient", lambda: kd.dropout(x, rate, SEED)),
        ("dropout(), x requires grad (forward)", lambda: kd.dropout(xg, rate, SEED)),
        ("dropout() forward + backward",
         _fwd_bwd_call(lambda t: kd.dropout(t, rate, SEED), xg, dy)),
        ("F.dropout, x needs no gradient", lambda: F.dropout(x, rate, training=True)),
        ("F.dropout, x requires grad (forward)", lambda: F.dropout(xg, rate, training=True)),
        ("F.dropout forward + backward",
         _fwd_bwd_call(lambda t: F.dropout(t, rate, training=True), xg, dy)),
        ("K3's backward as autograd's node calls it",
         lambda: kd._DropoutKernel.backward(ctx, dy)),
        ("F.dropout's backward op, aten.native_dropout_backward",
         lambda: torch.ops.aten.native_dropout_backward(dy, mask, 1 / (1 - rate))),
        ("checks: device, dtype, contiguity", checks),
        ("grad test: is_grad_enabled() and requires_grad",
         lambda: torch.is_grad_enabled() and xg.requires_grad),
        ("build() and _rate_args() lookups", lambda: (kd.build(), kd._rate_args(rate, dtype))),
        ("autograd.Function.apply, a function that does no work",
         lambda: _NoWork.apply(xg, rate, SEED)),
        ("_FunctionBase.apply (its C entry), the same function",
         lambda: base_apply(xg, rate, SEED)),
        ("torch.empty_like", lambda: torch.empty_like(x)),
        ("stream: torch.cuda.current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("stream: torch._C._cuda_getCurrentRawStream(index)", lambda: raw_stream(index)),
        ("x.device.index", lambda: x.device.index),
        ("x.get_device()", lambda: x.get_device()),
        ("two data_ptr()", lambda: (x.data_ptr(), y.data_ptr())),
        ("x.numel()", lambda: x.numel()),
        ("ctypes call (marshalling and launch)",
         lambda: entry(xp, yp, n, SEED, threshold, inv_keep, stream)),
        ("counter update (a stand-in's)", count)]
    us = {name: host_us(fn) for name, fn in parts}
    log(f"[{tag}] host us a call at [{rows}, {D_V}] {str(dtype)[6:]} (1,000 back-to-back calls, "
        f"median of 3 rounds): " + "; ".join(f"{name} {t:.2f}" for name, t in us.items()))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    calls = 20
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            with torch.profiler.record_function("K3 call"):
                kd.dropout(x, rate, SEED)
            with torch.profiler.record_function("F.dropout call"):
                F.dropout(x, rate, training=True)
        torch.cuda.synchronize()
    cpu = [r for r in prof.key_averages()
           if r.device_type == torch.autograd.DeviceType.CPU and r.count >= calls]
    log(f"[{tag}] one torch.profiler trace of {calls} calls each, x needs no gradient, CPU us a "
        f"call (total / self): " + "; ".join(
            f"{r.key} {r.cpu_time_total / calls:.2f} / {r.self_cpu_time_total / calls:.2f}"
            for r in sorted(cpu, key=lambda r: -r.cpu_time_total)))


def k3_digests(dtype: torch.dtype, tag: str) -> None:
    """K3's output and autograd dx at each of ``DROP_ROWS`` as sha256 digests,
    the package's public API alone, so that the same function run with another
    checkout's package compares the two kernels bit for bit."""
    from tdnet_tpu_torch.kernels.dropout import dropout
    gen = torch.Generator().manual_seed(SEED + 7)
    for rows in DROP_ROWS:
        x = torch.randn(rows, D_V, generator=gen).to("cuda", dtype).requires_grad_(True)
        dy = torch.randn(rows, D_V, generator=gen).to("cuda", dtype)
        y = dropout(x, 0.1, SEED + 5)
        dx, = torch.autograd.grad(y, x, dy)
        log(f"[{tag}] [{rows}, {D_V}] {str(dtype)[6:]} sha256 of the kernel's output "
            f"{digest(y)}, of its dx {digest(dx)}")


def phase_dropout(card: str, dtype: torch.dtype = torch.float32) -> dict:
    """Phases 8 (f32) and 8b (bf16): K3 against its plain version, its calls
    timed beside ``F.dropout``'s (``k3_turns``), the host split of one call
    (``k3_host_split``) and the sha256 of its outputs (``k3_digests``); returns
    the kernels entry's numbers at 18,721 rows, forward plus backward through
    autograd as the train step runs it."""
    from tdnet_tpu_torch.kernels.dropout import _rate_args, dropout, dropout_plain
    f32 = dtype == torch.float32
    tag = "8" if f32 else "8b"
    gen = torch.Generator().manual_seed(SEED + (1 if f32 else 4))
    log(f"[{tag}] dropout kernel vs plain in {str(dtype)[6:]} ({card}): bit-identical output "
        f"and backward, keep rate 0.9 +- 1e-3; the scale launched {_rate_args(0.1, dtype)[1]!r}")
    for rows in DROP_ROWS:
        x = torch.randn(rows, D_V, generator=gen).to("cuda", dtype).requires_grad_(True)
        xp = x.detach().clone().requires_grad_(True)
        dy = torch.randn(rows, D_V, generator=gen).to("cuda", dtype)
        got, want = dropout(x, 0.1, SEED + 5), dropout_plain(xp, 0.1, SEED + 5)
        got.backward(dy)
        want.backward(dy)
        no_grad = dropout(x.detach(), 0.1, SEED + 5)   # x that needs no gradient
        torch.cuda.synchronize()
        keep = (got != 0).double().mean().item()
        same, same_bwd = torch.equal(got.detach(), want.detach()), torch.equal(x.grad, xp.grad)
        same_no_grad = torch.equal(no_grad, got.detach())
        log(f"[{tag}] [{rows}, {D_V}]: output identical {same}, backward identical {same_bwd}, "
            f"the call without a gradient identical {same_no_grad}, keep rate {keep:.6f}, "
            f"dtypes {got.dtype} / {x.grad.dtype}")
        if not same_bwd:
            bad = x.grad != xp.grad
            log(f"[{tag}]   {int(bad.sum())} backward elements differ, max abs "
                f"{(x.grad - xp.grad).abs().max().item():.3e}; at kept positions "
                f"{int((bad & (want != 0)).sum())}; kernel backward == kernel forward of dy: "
                f"{torch.equal(x.grad, dropout(dy, 0.1, SEED + 5))}")
        if not (same and same_bwd and same_no_grad and abs(keep - 0.9) <= 1e-3
                and got.dtype == dtype and x.grad.dtype == dtype):
            raise AssertionError(f"[{tag}] K3 disagrees with its plain version at "
                                 f"[{rows}, {D_V}]")
    k3_digests(dtype, tag)
    rows = DROP_ROWS[0]
    xg = torch.randn(rows, D_V, generator=gen).to("cuda", dtype).requires_grad_(True)
    dy = torch.randn(rows, D_V, generator=gen).to("cuda", dtype)
    plain_ms = median_ms(_fwd_bwd_call(lambda t: dropout_plain(t, 0.1, SEED), xg, dy))
    del xg, dy
    times = k3_turns(dtype, tag, gen)
    k3_host_split(dtype, tag)
    t = times[rows]
    log(f"[{tag}] [{rows}, {D_V}] forward+backward ms: kernel {t['ms']:.4f}, plain "
        f"{plain_ms:.4f}, F.dropout {t['library_ms']:.4f}; bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']} ({4 * dtype.itemsize * rows * D_V / 1e6:.1f} MB)")
    return dict(max_abs_err=0.0, plain_ms=plain_ms, **t)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (7 fraction bits), normals only."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126))) - 7)


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two runs' outputs
    compared bit for bit across processes."""
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy()).hexdigest()[:16]


def rounding_bias(out: torch.Tensor, exact: torch.Tensor) -> float:
    """The mean of (|out| - |exact|) in units of bf16's spacing at |exact|: a long
    chain that truncates on the tensor core shows as a bias that one rounding of
    an f32 sum lacks."""
    return ((out.double().abs() - exact.abs()) / bf16_ulp(exact)).mean().item()


def rounding_gate(got: torch.Tensor, plain: torch.Tensor,
                  exact: torch.Tensor) -> tuple[float, float, bool]:
    """Phase 13b's gate: the kernel's rounding bias against ``exact`` (float64),
    the plain version's, and whether they lie within ``K5_BIAS_GATE``."""
    bias, plain_bias = rounding_bias(got, exact), rounding_bias(plain, exact)
    return bias, plain_bias, abs(bias - plain_bias) <= K5_BIAS_GATE


def keep_rate_bf16(k2, lq: int, lkv: int, k) -> float:
    """K2 bf16's keep rate at (lq, lkv) from its forward on keys k [n, lkv, 64]:
    with q = 0 (uniform p) and v one-hot on a block of 512 keys (key 512 c + j
    -> column j), output (b, i, j) is nonzero exactly where key 512 c + j is
    kept for row i of batch b."""
    kept, n = 0, k.shape[0]
    q = torch.zeros(n, lq, D_K, device="cuda", dtype=torch.bfloat16)
    for c0 in range(0, lkv, D_V):
        v = torch.zeros(n, lkv, D_V, device="cuda", dtype=torch.bfloat16)
        width = min(D_V, lkv - c0)
        v[:, c0 + torch.arange(width), torch.arange(width)] = 1.0
        o = k2(q, k, v, temperature=8.0, dropout_rate=0.1, seed=SEED + 17)
        kept += (o[..., :width] != 0).sum().item()
    return kept / (n * lq * lkv)


def k2_bf16_layout(n: int, lq: int, lkv: int) -> str:
    """K2 bf16's grids at (n, lq, lkv): each kernel's blocks and waves (blocks over
    the card's block slots: two an SM for the stats, p v and dq kernels, one for
    the t and dk/dv passes)."""
    from tdnet_tpu_torch.kernels.grid import (sm_count, train_backward_grids,
                                              train_backward_plan, train_forward_grids,
                                              train_forward_plan, train_waves)
    sms = sm_count(0)
    fwd = train_forward_plan(n, lq, lkv, D_V, sms)
    bwd = train_backward_plan(n, lq, lkv, D_V, sms)
    grids = {**train_forward_grids(fwd, n, lq, lkv, D_V),
             **train_backward_grids(bwd, n, lq, lkv)}
    per_sm = dict(stats=2, pv=2, t=1, dkdv=1, dq=2)
    return "; ".join(f"{name} {g[0]}x{g[1]}x{g[2]} = {g[0] * g[1] * g[2]} blocks, "
                     f"{train_waves(g[0] * g[1] * g[2], per_sm[name], sms):.2f} waves"
                     for name, g in grids.items())


def phase_train_attention_bf16(card: str) -> dict:
    """Phase 7b: K2 in bf16 against its plain bf16 version; returns the kernels
    entries' numbers."""
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention_train import (
        bf16_attributes, propagation_attention_train as k2,
        propagation_attention_train_plain as p2)
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 3)
    log(f"[7b] training attention kernel vs plain in bf16 ({card}); rule: every output within "
        f"one bf16 ulp of max|plain output|, dq/dk/dv within {BF16_GRAD_RTOL:g} x max|grad| of "
        f"each tensor; keep rate 0.9 +- 1e-3; the forward and the backward bitwise equal "
        f"across two runs; K2's error word read after every call")
    for drop in (False, True):
        attrs = bf16_attributes(drop)
        log(f"[7b] kernels at d_v {D_V}, dropout {'on' if drop else 'off'}: " + "; ".join(
            f"{name} {a['registers']} registers a thread at launch, {a['local_bytes']} bytes of "
            f"local memory" for name, a in attrs.items()) + " (consumers take 232 or 240 "
            "registers by setmaxnreg)")
    res = dict(fwd_err=0.0, bwd_err=0.0)
    for n, lq, lkv in [(1, *shape) for shape in TRAIN_SHAPES] + [BATCHED]:
        q, k = (torch.randn(n, m, D_K, generator=gen).to("cuda", bf) for m in (lq, lkv))
        v = torch.randn(n, lkv, D_V, generator=gen).to("cuda", bf)
        dy = torch.randn(n, lq, D_V, generator=gen).to("cuda", bf)
        log(f"[7b] n={n} {lq} x {lkv} grids: {k2_bf16_layout(n, lq, lkv)}")
        for rate in (0.0, 0.1):
            kw = dict(temperature=8.0, dropout_rate=rate, seed=SEED + 17)
            got = _fwd_bwd(k2, q, k, v, dy, **kw)
            check_fault("cuda")
            want = _fwd_bwd(p2, q, k, v, dy, **kw)
            again = _fwd_bwd(k2, q, k, v, dy, **kw)
            check_fault("cuda")
            same = [torch.equal(got[0], again[0]),
                    all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))]
            f_err = (got[0].float() - want[0].float()).abs().max().item()
            f_tol = bf16_ulp(want[0].float().abs().max()).item()
            shares = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                      for a, b in zip(got[1:], want[1:])]
            dtypes = {t.dtype for t in got}
            log(f"[7b] n={n} {lq:6d} x {lkv:5d} dropout {rate}: output max abs err {f_err:.3e} "
                f"(one ulp {f_tol:.3e}); dq/dk/dv max abs err / max|grad| "
                f"{', '.join(f'{x:.2e}' for x in shares)}; second forward / backward "
                f"{' / '.join('bitwise equal' if x else 'DIFFERENT' for x in same)}; dtypes "
                f"{sorted(str(d) for d in dtypes)}")
            if not (f_err <= f_tol and max(shares) <= BF16_GRAD_RTOL and dtypes == {bf}):
                raise AssertionError(f"[7b] K2 bf16 disagrees with its plain version at "
                                     f"n={n} {lq}x{lkv} dropout {rate}")
            if not all(same):
                raise AssertionError(f"[7b] K2 bf16 is not deterministic at n={n} {lq}x{lkv}: "
                                     f"{same}")
            res["fwd_err"] = max(res["fwd_err"], f_err)
            res["bwd_err"] = max(res["bwd_err"], max(
                (a.float() - b.float()).abs().max().item() for a, b in zip(got[1:], want[1:])))
            del got, want, again
        rate = keep_rate_bf16(k2, lq, lkv, k)
        check_fault("cuda")
        log(f"[7b] n={n} {lq:6d} x {lkv:5d} observed keep rate {rate:.6f} over {n * lq * lkv} "
            f"elements")
        if abs(rate - 0.9) > 1e-3:
            raise AssertionError(f"[7b] K2 bf16 keep rate {rate} outside 0.9 +- 1e-3")
        if n == 1:
            times = _train_attention_times(q, k, v, dy, k2, p2, tag="7b")
            check_fault("cuda")
            io = 2 * (lq * (D_K + D_V) + lkv * (D_K + D_V))   # q, k, v and o or dy, bf16
            fwd_b = bound(2 * lq * lkv * (D_K + D_V), io, PEAK_BF16)
            bwd_b = bound(2 * lq * lkv * (2 * D_V + 3 * D_K), 2 * io + 4 * 2 * lq, PEAK_BF16)
            log(f"[7b] {lq} x {lkv} forward / backward ms: kernel {times['kernel'][0]:.3f} / "
                f"{times['kernel'][1]:.3f} (device {times['device'][0]} / "
                f"{times['device'][1]}), "
                f"plain {times['plain'][0]:.3f} / {times['plain'][1]:.3f}, "
                f"F.scaled_dot_product_attention (bf16, no dropout) {times['sdpa'][0]:.3f} / "
                f"{times['sdpa'][1]:.3f}; bounds in bf16 ({PEAK_BF16 / 1e12:.0f} TFLOP/s): "
                f"forward {2 * lq * lkv * (D_K + D_V) / 1e9:.2f} GFLOP "
                f"{fwd_b['bound_ms']:.4f} ms, "
                f"backward {2 * lq * lkv * (2 * D_V + 3 * D_K) / 1e9:.2f} GFLOP "
                f"{bwd_b['bound_ms']:.4f} ms")
            last = dict(times=times, fwd_b=fwd_b, bwd_b=bwd_b)
        del q, k, v, dy
    for n, lq, lkv, dv in K2_DV_CASES:   # the rules only
        q, k = (torch.randn(n, m, D_K, generator=gen).to("cuda", bf) for m in (lq, lkv))
        v, dy = (torch.randn(n, m, dv, generator=gen).to("cuda", bf) for m in (lkv, lq))
        for rate in (0.0, 0.1):
            kw = dict(temperature=8.0, dropout_rate=rate, seed=SEED + 17)
            got = _fwd_bwd(k2, q, k, v, dy, **kw)
            check_fault("cuda")
            want = _fwd_bwd(p2, q, k, v, dy, **kw)
            f_err = (got[0].float() - want[0].float()).abs().max().item()
            f_tol = bf16_ulp(want[0].float().abs().max()).item()
            shares = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                      for a, b in zip(got[1:], want[1:])]
            log(f"[7b] n={n} {lq} x {lkv}, d_v {dv}, dropout {rate}: output max abs err "
                f"{f_err:.3e} (one ulp {f_tol:.3e}); dq/dk/dv max abs err / max|grad| "
                f"{', '.join(f'{x:.2e}' for x in shares)}")
            if not (f_err <= f_tol and max(shares) <= BF16_GRAD_RTOL):
                raise AssertionError(f"[7b] K2 bf16 disagrees with its plain version at "
                                     f"n={n} {lq}x{lkv} d_v {dv} dropout {rate}")
    log("[7b] K2's error word clear after every call above")
    phase_fault_report("K2", "7b")
    # the kernels entries report the last training hop, the largest
    times, fwd_b, bwd_b = last["times"], last["fwd_b"], last["bwd_b"]
    return {
        "fwd": dict(max_abs_err=res["fwd_err"], ms=times["kernel"][0],
                    device_ms=times["device"][0], plain_ms=times["plain"][0],
                    library_ms=times["sdpa"][0], **fwd_b),
        "bwd": dict(max_abs_err=res["bwd_err"], ms=times["kernel"][1],
                    device_ms=times["device"][1], plain_ms=times["plain"][1],
                    library_ms=times["sdpa"][1], **bwd_b)}


def recording_train_attention(calls: list):
    """The training hops go through K2's wrapper as before, and ``calls`` gets,
    for each call, copies of its q, k, v and keywords, and of the dy its
    backward receives (a hook on the output)."""
    from tdnet_tpu_torch.kernels import propagation_attention_train as pat
    from tdnet_tpu_torch.nn import encoding

    def record(q, k, v, **kw):
        rec = dict(q=q.detach().clone(), k=k.detach().clone(), v=v.detach().clone(), **kw)
        calls.append(rec)
        out = pat.propagation_attention_train(q, k, v, **kw)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("dy", g.detach().clone()))
        return out
    return swapped(encoding, "propagation_attention_train", record)


def step_attention_inputs() -> list[dict]:
    """The inputs of K2's three calls in one bf16 step of the TD4-PSP18 full
    recipe (seeded, from its initial state, pos_id 0): q, k, v, temperature,
    dropout rate and seed of each call, and the dy its backward received."""
    from tdnet_tpu_torch.train.trainer import td4_full_recipe
    state, step, teacher, frames, labels, _ = td4_full_recipe(seed=SEED,
                                                              compute_dtype=torch.bfloat16)
    calls: list[dict] = []
    with recording_train_attention(calls):
        step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    del state, step, teacher, frames, labels
    torch.cuda.empty_cache()
    return calls


def phase_step_inputs_bf16(card: str) -> None:
    """Phase 7c: K2 in bf16 on the inputs of one bf16 TD4-PSP18 step (each of its
    three calls, with the dy its backward received, ``step_attention_inputs``)
    beside ``randn`` inputs at the same shape (and the call's rate and seed): how
    peaked each softmax is (``score_spread``), both held to phase 7b's rules and
    repeating bitwise, then timed in turns (step, randn, step, randn): forward and
    backward, the median of 10 CUDA-event calls, each kernel's device ms, and the
    SM clock and power after each; K2's error word read after every call."""
    from tdnet_tpu_torch.cli.profile import smi
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention_train import (
        propagation_attention_train as k2, propagation_attention_train_plain as p2)
    t0 = time.perf_counter()
    calls = step_attention_inputs()
    log(f"[7c] K2 bf16 on one bf16 TD4-PSP18 step's inputs ({card}): {len(calls)} calls "
        f"recorded ({time.perf_counter() - t0:.1f} s); rules as phase 7b's")
    gen = torch.Generator().manual_seed(SEED + 7)
    for i, call in enumerate(calls):
        if "dy" not in call:
            raise AssertionError(f"[7c] call {i}: its backward received no dy")
        n, lq, _ = call["q"].shape
        lkv = call["k"].shape[1]
        kw = dict(temperature=call["temperature"], dropout_rate=call["dropout_rate"],
                  seed=call["seed"])
        randn = {name: torch.randn(*call[name].shape, generator=gen).to("cuda", torch.bfloat16)
                 for name in ("q", "k", "v", "dy")}
        cases = {"step": call, "randn": randn}
        for name, c in cases.items():
            got, want = _fwd_bwd(k2, c["q"], c["k"], c["v"], c["dy"], **kw), \
                _fwd_bwd(p2, c["q"], c["k"], c["v"], c["dy"], **kw)
            again = _fwd_bwd(k2, c["q"], c["k"], c["v"], c["dy"], **kw)
            check_fault("cuda")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            f_err = (got[0].float() - want[0].float()).abs().max().item()
            f_tol = bf16_ulp(want[0].float().abs().max()).item()
            shares = [(a.float() - b.float()).abs().max().item()
                      / max(b.float().abs().max().item(), 1e-30)
                      for a, b in zip(got[1:], want[1:])]
            log(f"[7c] call {i} {name} inputs {n}x{lq}x{lkv}, temperature "
                f"{kw['temperature']:g}, "
                f"dropout {kw['dropout_rate']:g}: output max abs err {f_err:.3e} (one ulp "
                f"{f_tol:.3e}); dq/dk/dv max abs err / max|grad| "
                f"{', '.join(f'{x:.2e}' for x in shares)}; two runs "
                f"{'bitwise equal' if same else 'DIFFERENT'}; "
                f"{score_spread(c['q'], c['k'], kw['temperature'])}")
            if not (f_err <= f_tol and max(shares) <= BF16_GRAD_RTOL and same
                    and all(t.dtype == torch.bfloat16 for t in got)):
                raise AssertionError(f"[7c] K2 bf16 on call {i}'s {name} inputs: output err "
                                     f"{f_err} > {f_tol}, grads {shares}, or two runs differ")
            del got, want, again
        for name in ("step", "randn", "step", "randn"):
            c = cases[name]
            leaves = [c[x].detach().requires_grad_(True) for x in ("q", "k", "v")]
            fwd = lambda: k2(*leaves, **kw)
            out = fwd()
            bwd = lambda: torch.autograd.grad(out, leaves, c["dy"], retain_graph=True)
            ms = (median_ms(fwd), median_ms(bwd))
            rows = (device_rows(fwd), device_rows(bwd))
            check_fault("cuda")
            log(f"[7c] call {i} {lq} x {lkv} on the {name} inputs ({card}): forward {ms[0]:.3f} "
                f"ms, backward {ms[1]:.3f} ms; forward device ms: {format_rows(rows[0])}; "
                f"backward device ms: {format_rows(rows[1])}; after it "
                f"{smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")
            del out, leaves
    log("[7c] K2's error word clear after every call above")


def plain_train_kernels():
    """The training hops take the plain attention and the plain dropout
    instead of the kernels' wrappers."""
    from tdnet_tpu_torch.kernels import dropout as kd
    from tdnet_tpu_torch.kernels import propagation_attention_train as pat
    from tdnet_tpu_torch.nn import encoding, module
    stack = contextlib.ExitStack()
    stack.enter_context(swapped(encoding, "propagation_attention_train",
                                pat.propagation_attention_train_plain))
    stack.enter_context(swapped(module, "dropout", kd.dropout_plain))
    return stack


def _loss_and_grads(model, loss_of, frames, labels, pos_id, teacher):
    from tdnet_tpu_torch.nn import step_generator
    model.zero_grad(set_to_none=True)
    loss, _ = loss_of(model, frames, labels, pos_id, step_generator(SEED, 0), teacher)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}


class F64Verdict(NamedTuple):
    """What ``against_f64`` found; ``problem`` is empty where the rule holds."""
    problem: str
    rel: float          # the larger of the two paths' losses' relative distances from float64
    floor: float        # GRAD_FLOOR x the largest max|grad| of the float64 run
    worst: tuple        # (the largest distance / limit, its gradient)
    plain_term: int     # gradients whose limit is mostly twice the plain path's distance
    beyond: int         # gradients of the path beyond GRAD_RTOL x max(max|grad|, floor)
    dists: dict         # gradient -> (the path's and the plain path's distance, its limit)


def against_f64(path, plain, ref, bf16: bool = False) -> F64Verdict:
    """Hold a path's (loss, gradients) to the float64 run ``ref`` beside the
    plain path's: both losses within LOSS_RTOL of float64's (``bf16``: the
    path's loss no farther from float64's than twice the plain path's plus
    GRAD_RTOL relative, and the floor GRAD_FLOOR_BF16), and each
    gradient of the path no farther from float64 than twice the plain path's
    distance plus GRAD_RTOL x max(max|grad|, floor). Two f32 paths that
    round otherwise flip different ReLU inputs that lie within an f32 rounding
    of zero, and at random init one flip moves a gradient by percents of
    max|grad|; float64 tells a path that is as accurate as the plain one from
    a faulty one, which a comparison of the two f32 paths cannot."""
    (loss_k, gk), (loss_p, gp), (loss_d, gd) = path, plain, ref
    floor_rel = GRAD_FLOOR_BF16 if bf16 else GRAD_FLOOR
    rel = max(abs(loss_k - loss_d), abs(loss_p - loss_d)) / abs(loss_d)
    held = (abs(loss_k - loss_d) <= 2 * abs(loss_p - loss_d) + GRAD_RTOL * abs(loss_d) if bf16
            else rel <= LOSS_RTOL)
    problem = "" if held else f"losses {loss_k} and {loss_p}, float64 {loss_d}"
    if set(gk) != set(gd) or set(gp) != set(gd):
        missing = sorted(set(gd) ^ set(gk) | set(gd) ^ set(gp))
        return F64Verdict(f"gradient sets differ on {missing[:3]}", rel, 0.0, (np.inf, ""), 0,
                          0, {})
    floor = floor_rel * max(g.abs().max().item() for g in gd.values())
    worst, plain_term, beyond, dists = (0.0, ""), 0, 0, {}
    for k, g in gd.items():
        scale = max(g.abs().max().item(), floor)
        g = g.to(gk[k].device)
        e_k, e_p = ((x[k].double() - g).abs().max().item() for x in (gk, gp))
        limit = 2 * e_p + GRAD_RTOL * scale
        if not e_k <= limit and not problem:
            problem = (f"gradient {k}: {e_k:.3e} from float64, the plain path {e_p:.3e}, "
                       f"max(max|grad|, floor) {scale:.3e}")
        worst = max(worst, (e_k / limit, k))
        plain_term += 2 * e_p > GRAD_RTOL * scale
        beyond += e_k > GRAD_RTOL * scale
        dists[k] = (e_k, e_p, limit)
    return F64Verdict(problem, rel, floor, worst, plain_term, beyond, dists)


def describe(v: F64Verdict) -> str:
    return (f"worst {v.worst[0]:.3f} of its limit ({v.worst[1]}); the plain term dominates "
            f"{v.plain_term} of {len(v.dists)} limits, {v.beyond} gradients lie beyond "
            f"{GRAD_RTOL:g} x max(max|grad|, floor {v.floor:.2e}); losses' largest rel "
            f"{v.rel:.2e}")


def f64_references(loss_fn, model, start, teacher, frames, labels) -> dict:
    """The float64 run that phases 9 and 14 hold the f32 paths to, dropout
    off and on: the loss and gradients (on the host) from ``start`` at
    ``POS_ID``, the cuDNN path in float64 with K2 and K3 swapped for their
    plain versions (which take float64), the same step generator and so the
    same masks as the f32 paths."""
    from tdnet_tpu_torch.train.trainer import make_loss_of
    model64, teacher64 = copy.deepcopy(model).double(), copy.deepcopy(teacher).double()
    refs = {}
    with plain_train_kernels():
        for use_dropout in (False, True):
            model64.load_state_dict(start)
            loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, conv_wgrad="cudnn")
            loss, grads = _loss_and_grads(model64, loss_of, frames.double(), labels, POS_ID,
                                          teacher64)
            refs[use_dropout] = (loss, {k: g.cpu() for k, g in grads.items()})
    return refs


def kernel_vs_plain(path, plain, noise) -> dict:
    """Phase 9's rule before it also held the paths to float64: the kernel
    path's (loss, gradients) ``path`` against the plain path's, the loss
    within LOSS_RTOL relative and each gradient within GRAD_RTOL x
    max(max|grad|, floor) plus twice the kernel path's run-to-run difference
    ``noise``. Returns the first problem (``problem``, "" for none), the
    largest share of a gradient's limit and how many gradients needed the
    run-to-run term."""
    (loss_k, got), (loss_p, plain) = path, plain
    rel = abs(loss_k - loss_p) / abs(loss_p)
    problem = "" if rel <= LOSS_RTOL else f"loss {loss_k} vs plain {loss_p} (rel {rel:.2e})"
    if set(got) != set(plain):
        differ = f"gradient sets differ on {sorted(set(got) ^ set(plain))[:3]}"
        return dict(problem=problem or differ,
                    worst=(np.inf, ""), needed=0)
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in plain.values())
    worst, needed = (0.0, ""), 0
    for k, g in plain.items():
        scale = g.abs().max().item()
        err = (got[k] - g).abs().max().item()
        tol = GRAD_RTOL * max(scale, floor)
        if not err <= tol + 2 * noise[k] and not problem:
            problem = (f"gradient {k}: kernel vs plain {err:.3e}, max|grad| {scale:.3e}, "
                       f"run-to-run {noise[k]:.3e}")
        needed += err > tol
        worst = max(worst, (err / (tol + 2 * noise[k]), k))
    return dict(problem=problem, worst=worst, needed=needed)


def faulty_forward(eps: float):
    """K2's forward with a relative error ``eps`` on one 64-row q block of
    the last hop (``PROBE_ROWS`` of ``PROBE_LQ``), its backward untouched: a
    fault for phase 9's check to flag."""
    from tdnet_tpu_torch.nn import encoding
    kernel = encoding.propagation_attention_train

    def faulty(q, k, v, **kw):
        o = kernel(q, k, v, **kw)
        if q.shape[1] != PROBE_LQ:
            return o
        err = torch.zeros_like(o)
        err[:, PROBE_ROWS] = eps * o.detach()[:, PROBE_ROWS]
        return o + err

    return swapped(encoding, "propagation_attention_train", faulty)


def check_path(path, plain, ref, noise) -> tuple[str, F64Verdict, dict]:
    """Phase 9's check of a path's (loss, gradients): ``against_f64`` and
    ``kernel_vs_plain`` both. Returns the first problem ("" for none) and the
    two findings."""
    held, old = against_f64(path, plain, ref), kernel_vs_plain(path, plain, noise)
    return held.problem or old["problem"], held, old


def compare_paths(loss_of, model, start, frames, labels, teacher, ref, use_dropout: bool) -> None:
    """The kernel path's loss and gradients against the float64 run ``ref``
    and against the plain path's (K2 and K3 swapped for their plain versions),
    from the state ``start`` and the same step generator (so the same dropout
    masks): ``check_path``. The kernel path also runs with
    ``faulty_forward(PROBE_EPS)``, which the check must flag."""
    model.load_state_dict(start)
    run = lambda: _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)
    loss_a, ga = run()
    loss_b, gb = run()
    with faulty_forward(PROBE_EPS):
        probed = run()
    with plain_train_kernels():
        plain = run()
    noise = {k: (ga[k] - gb[k]).abs().max().item() for k in ga}
    problem, held, old = check_path((loss_a, ga), plain, ref, noise)
    setting = f"dropout {'on' if use_dropout else 'off'}, pos_id {POS_ID}"
    repeat = loss_a == loss_b and all(torch.equal(ga[k], gb[k]) for k in ga)
    largest = max(noise, key=noise.get)
    log(f"[9] two identical steps of the kernel path ({setting}): " + (
        "loss and every gradient bitwise equal" if repeat else
        f"DIFFER: losses {loss_a!r} / {loss_b!r}, largest gradient difference "
        f"{noise[largest]:.3e} on {largest}"))
    log(f"[9] kernel path vs float64, beside the plain path ({setting}): loss {loss_a:.6f}, "
        f"plain {plain[0]:.6f}, float64 {ref[0]:.6f}; {describe(held)}")
    nearest = sorted(held.dists.items(), key=lambda kv: -kv[1][0] / kv[1][2])[:5]
    log("[9] nearest their limits (kernel / plain distance from float64, limit): " + "; ".join(
        f"{k} {e_k:.2e} / {e_p:.2e}, {limit:.2e}" for k, (e_k, e_p, limit) in nearest))
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in plain[1].values())
    noisiest = max((2 * noise[k] / g.abs().max().item(), k) for k, g in plain[1].items()
                   if g.abs().max().item() > floor)
    log(f"[9] kernel path vs plain path: worst {old['worst'][0]:.3f} of {GRAD_RTOL:g} x "
        f"max(max|grad|, floor) + 2 x run-to-run ({old['worst'][1]}), {old['needed']} needing "
        f"the run-to-run term; largest 2 x run-to-run / max|grad| above the floor "
        f"{noisiest[0]:.2e} ({noisiest[1]}, limit {NOISE_LIMIT:g})")
    flagged, held_x, old_x = check_path(probed, plain, ref, noise)
    log(f"[9] probe: K2's forward off by {PROBE_EPS:g} on rows {PROBE_ROWS.start}-"
        f"{PROBE_ROWS.stop - 1} of {PROBE_LQ}: {'flagged' if flagged else 'PASSED'}; "
        f"against float64 worst {held_x.worst[0]:.3f} of its limit ({held_x.worst[1]}), "
        f"against the plain path worst {old_x['worst'][0]:.3f} ({old_x['worst'][1]})")
    if problem:
        raise AssertionError(f"[9] kernel path ({setting}): {problem}")
    if noisiest[0] > NOISE_LIMIT:
        raise AssertionError(f"[9] run-to-run difference {noisiest[0]:.2e} x max|grad| on "
                             f"{noisiest[1]} is above {NOISE_LIMIT:g}")
    if not flagged:
        raise AssertionError(f"[9] the check passed K2's forward off by {PROBE_EPS:g} "
                             f"({setting}): it cannot see such a fault")


def phase_train(card: str):
    """The full recipe's train step; returns the recipe (state, its initial
    state dict, teacher, frames, labels, loss_fn, the float64 references) and
    the per-kernel launches of the 8 measured steps."""
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train.trainer import make_loss_of, td4_full_recipe
    state, step, teacher, frames, labels, loss_fn = td4_full_recipe(seed=SEED)
    model, cfg = state.model, state.model.cfg
    # the paths are compared from the seeded initial state: the state after the
    # timed steps carries the noise of cuDNN's nondeterministic weight gradients,
    # so whether some ReLU input sits within an f32 rounding of zero, and flips
    # between the paths, would change from run to run
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    in_size = cfg.in_size
    log(f"[9] TD4-PSP18 full recipe {in_size[0]}x{in_size[1]} b1 f32 ({card}): kv_stride "
        f"{cfg.kv_stride}, aux, OHEM n_min {in_size[0] * in_size[1] // 16}, KD from ResNet-101, "
        f"AdaOptimizer; {sum(p.numel() for p in model.parameters())} student parameters")
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[9] warm-up step: loss {m['loss'].item():.5f} kd {m['kd'].item():.5f} "
        f"({time.perf_counter() - t0:.2f} s)")

    counters = ((propagation_attention_train, "launches"),
                (propagation_attention_train, "backward_launches"),
                (dropout, "launches"), (dropout, "backward_launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, frames, labels, i % cfg.path_num, teacher)
        loss = m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss) or not np.isfinite(m["kd"].item()):
            raise AssertionError(f"[9] step {i}: loss {loss}, kd {m['kd'].item()}")
    launches = [getattr(fn, attr) for fn, attr in counters]
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[9] {TRAIN_STEPS} steps, pos_id 0-3: losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"median {float(np.median(times)):.1f} ms/step (min {min(times):.1f}, max "
        f"{max(times):.1f}); peak memory {peak:.0f} MiB; launches K2 fwd/bwd "
        f"{launches[0]}/{launches[1]}, K3 fwd/bwd {launches[2]}/{launches[3]}")
    if launches != [3 * TRAIN_STEPS] * 4:
        raise AssertionError(f"[9] launches {launches}, expected {3 * TRAIN_STEPS} of each")

    t0 = time.perf_counter()
    refs = f64_references(loss_fn, model, start, teacher, frames, labels)
    log(f"[9] float64 run from the initial state, dropout off and on: losses "
        f"{refs[False][0]:.6f} / {refs[True][0]:.6f} ({time.perf_counter() - t0:.1f} s)")
    for use_dropout in (False, True):
        loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout)
        compare_paths(loss_of, model, start, frames, labels, teacher, refs[use_dropout],
                      use_dropout)
    return ((state, start, teacher, frames, labels, loss_fn, refs),
            dict(fwd=launches[0], bwd=launches[1], drop=launches[2] + launches[3]))


def phase_stem_kernel(card: str) -> dict:
    """K4 against its plain version; returns the kernels entries' numbers (at
    the TD2 stem shape) per dtype."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.fused_stem import fused_stem_plain, fused_stem_tail, stem_tail
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    log(f"[10] fused stem kernel vs plain ({card}); tolerances: f32 1e-4, bf16 2e-2 x max|ref|; "
        f"two calls bitwise equal")
    head = {}
    for h, w in STEM_SHAPES:
        x = torch.randn(1, 64, h, w, generator=gen).relu_().to(dev)
        w1 = (torch.randn(64, 64, 3, 3, generator=gen) * 0.06).to(dev)
        w2 = (torch.randn(128, 64, 3, 3, generator=gen) * 0.06).to(dev)
        sb1, sb2 = (torch.stack([torch.rand(c, generator=gen) + 0.5,
                                 torch.randn(c, generator=gen) * 0.1]).to(dev) for c in (64, 128))
        for dtype, frac in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = (x.to(dtype), w1.to(dtype), sb1, w2.to(dtype), sb2)
            tail = stem_tail(*args[1:])   # laid out once, as a runner does
            got = fused_stem_tail(args[0], tail)
            torch.cuda.synchronize()
            ref = fused_stem_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            tol = frac * ref.float().abs().max().item()
            if not (got.shape == ref.shape and np.isfinite(err) and err <= tol):
                raise AssertionError(f"[10] K4 disagrees at {h}x{w} {dtype}: max abs err {err} "
                                     f"> {tol}")
            if not torch.equal(fused_stem_tail(args[0], tail), got):
                raise AssertionError(f"[10] K4 at {h}x{w} {dtype}: two calls differ")
            run = lambda: fused_stem_tail(args[0], tail)
            ms = median_ms(run)
            plain_ms = median_ms(lambda: fused_stem_plain(*args))
            hp, wp = (h + 1) // 2, (w + 1) // 2
            es = got.element_size()
            flops = 2 * h * w * 9 * 64 * (64 + 128)
            nbytes = es * (64 * h * w + 128 * hp * wp + 9 * 64 * (64 + 128)) + 4 * 2 * (64 + 128)
            b32 = bound(flops, nbytes, PEAK_F32)
            # the kernel's route: bf16, or f32 in 3xTF32, on the tensor cores
            b = bound(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32X3)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            log(f"[10] [1, 64, {h}, {w}] {name:4s} max_abs_err {err:.3e} (tol {tol:.3e}), bitwise "
                f"repeat; kernel {ms:.3f} ms  plain (cuDNN conv sequence) {plain_ms:.3f} ms  "
                f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} on the tensor cores"
                + (f" in 3xTF32, {b32['bound_ms']:.4f} ms on the CUDA cores" if name == "f32"
                   else ""))
            if (h, w) == STEM_SHAPES[0]:
                # one trace of the kernel and the plain sequence, split by name
                both = device_rows(run, lambda: fused_stem_plain(*args))
                device_ms = None
                if both is not None:
                    rows = [r for r in both if kernel_family(r[0]) == "K4 fused stem"]
                    device_ms = sum(t for _, t in rows)
                    log(f"[10] [1, 64, {h}, {w}] {name} device ms, one trace: kernel "
                        f"{device_ms:.4f} ({'; '.join(f'{k[:60]} {t:.4f}' for k, t in rows)}); "
                        f"plain {sum(t for r in both if r not in rows for t in r[1:]):.4f}")
                head[name] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                  library_ms=None, **b)
            del got, ref, args, tail
    return head


def phase_psp101(card: str) -> dict:
    """PSP-101 over the 12 frames, fused stem against plain stem, f32 and
    bf16; returns the fused runs' K4 launches per dtype."""
    from tdnet_tpu_torch.models import STREAM_SIZE, PSPNet, PSPNetConfig, init_pspnet
    from tdnet_tpu_torch.stream.runtime import FrameRunner
    cfg = PSPNetConfig(backbone="resnet101", in_size=STREAM_SIZE["psp101"])
    state = init_pspnet(cfg, torch.Generator().manual_seed(SEED)).state_dict()

    def make(dtype, stem_impl):
        net = PSPNet(cfg, "cuda")
        net.load_state_dict(state)
        return FrameRunner(net, dtype=dtype, stem_impl=stem_impl)

    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        frames = stream_frames(cfg.in_size, dtype)
        for stem_impl in ("fused", "plain"):
            run = drive(lambda: make(dtype, stem_impl), frames, card, "12", "psp101")
            want = (0, N_FRAMES if stem_impl == "fused" else 0)
            if run[1:] != want:
                raise AssertionError(f"[12] {stem_impl} stem: K1 / K4 launches {run[1:]}, "
                                     f"expected {want}")
            runs[name, stem_impl] = run
        del frames
    check_close("12", runs["f32", "fused"][0], runs["f32", "plain"][0], 1e-3,
                "fused-stem vs plain-stem f32")
    report_bf16_stream("12", runs["bf16", "fused"][0], runs["bf16", "plain"][0],
                      runs["f32", "plain"][0], "fused-stem vs plain-stem bf16")
    return {name: runs[name, "fused"][2] for name in ("f32", "bf16")}


def phase_dilated_conv(card: str) -> dict:
    """K5 against its plain version and cuDNN; returns the kernels entries'
    numbers (at ``K5_HEADLINE``) for the forward and the dgrad."""
    from tdnet_tpu_torch.cli.profile import kernel_family
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil, dgrad_weights, dilated_conv_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    h, w = K5_GRID
    log(f"[13] dilated conv kernel vs plain and cuDNN ({card}) at {h}x{w}; tolerances: output "
        f"and dx 5e-5, dW 1e-4 x max|ref|; two identical calls bitwise equal")
    errs = dict(fwd=0.0, dgrad=0.0)
    head = {}
    for ci, co, d in K5_SHAPES:
        x = torch.randn(1, ci, h, w, generator=gen).to(dev)
        wt = (torch.randn(co, ci, 3, 3, generator=gen) / (9 * ci) ** 0.5).to(dev)
        dy = torch.randn(1, co, h, w, generator=gen).to(dev)
        xg, wg = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        y = conv2d_dil(xg, wg, d, d)
        y.backward(dy)
        torch.cuda.synchronize()
        xc, wc = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        yc = F.conv2d(xc, wc, padding=d, dilation=d)
        yc.backward(dy)
        checks = {  # name: (got, want, fraction of max|want|)
            "fwd vs plain": (y, dilated_conv_plain(x, wt, d, d), 5e-5),
            "dgrad vs plain": (xg.grad, dilated_conv_plain(dy, dgrad_weights(wt), d, d), 5e-5),
            "fwd vs cuDNN": (y, yc, 5e-5),
            "dx vs cuDNN": (xg.grad, xc.grad, 5e-5),
            "dW vs cuDNN": (wg.grad, wc.grad, 1e-4)}
        found = {}
        for name, (got, want, frac) in checks.items():
            err = (got.detach() - want.detach()).abs().max().item()
            tol = frac * want.abs().max().item()
            found[name] = f"{err:.2e} (tol {tol:.2e})"
            if not (got.shape == want.shape and err <= tol):
                raise AssertionError(f"[13] K5 {ci}->{co} d{d}: {name} max abs err {err} > {tol}")
            if name.endswith("vs plain"):
                part = name.split()[0]
                errs[part] = max(errs[part], err)
        log(f"[13] {ci}->{co} d{d} max abs err: " + ", ".join(f"{k} {v}" for k, v in found.items())
            + f"; sha256 of the kernel's output {digest(y)}, of its dx {digest(xg.grad)}")
        del yc, checks

        x_dg = x.clone().requires_grad_(True)
        y_dg = conv2d_dil(x_dg, wt, d, d)   # only x needs a gradient: the backward is the dgrad
        dgrad = lambda: torch.autograd.grad(y_dg, x_dg, dy, retain_graph=True)[0]
        with torch.no_grad():
            repeats = dict(fwd=torch.equal(conv2d_dil(x, wt, d, d), y.detach()))
        repeats["dgrad"] = torch.equal(dgrad(), xg.grad)
        if not all(repeats.values()):
            raise AssertionError(f"[13] K5 {ci}->{co} d{d}: two calls differ: {repeats}")
        del y
        with torch.no_grad():
            t = dict(fwd=(median_ms(lambda: conv2d_dil(x, wt, d, d)),
                          median_ms(lambda: dilated_conv_plain(x, wt, d, d)),
                          median_ms(lambda: F.conv2d(x, wt, padding=d, dilation=d))))
        t["dgrad"] = (
            median_ms(dgrad),
            median_ms(lambda: dilated_conv_plain(dy, dgrad_weights(wt), d, d)),
            median_ms(lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=d, dilation=d)))
        flops, nbytes = 2 * h * w * 9 * ci * co, 4 * (ci * h * w + co * h * w + 9 * ci * co)
        b, b32 = bound(flops, nbytes, PEAK_TF32X3), bound(flops, nbytes, PEAK_F32)
        for part in ("fwd", "dgrad"):
            log(f"[13] {ci}->{co} d{d} {part:5s} ms: kernel {t[part][0]:.3f}, plain "
                f"{t[part][1]:.3f}, cuDNN {t[part][2]:.3f}; bound {b['bound_ms']:.3f} ms "
                f"(3xTF32 tensor cores) by {b['bound_by']}, {b32['bound_ms']:.3f} ms (f32 CUDA "
                f"cores); bitwise repeat {repeats[part]}")
        if (ci, co, d) == K5_HEADLINE:
            traces = dict(
                fwd=(lambda: conv2d_dil(x, wt, d, d),
                     lambda: F.conv2d(x, wt, padding=d, dilation=d)),
                dgrad=(dgrad, lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=d,
                                                                 dilation=d)))
            device = {}
            for part, (kernel_fn, cudnn_fn) in traces.items():
                both = device_rows(kernel_fn, cudnn_fn)   # one trace, split by name
                device[part] = None
                if both is None:
                    continue
                rows = [r for r in both if kernel_family(r[0], train=True) == "K5 dilated conv"]
                rows_c = [r for r in both if r not in rows]
                device[part] = sum(ms for _, ms in rows)
                prep = sum(ms for k, ms in rows if "prep_" in k)
                log(f"[13] {ci}->{co} d{d} {part} device ms: kernel {device[part]:.3f} (prep "
                    f"{prep:.3f}, {prep / max(device[part], 1e-9):.1%}): "
                    f"{'; '.join(f'{k[:70]} {ms:.3f}' for k, ms in rows)}")
                log(f"[13] {ci}->{co} d{d} {part} device ms: cuDNN {sum(ms for _, ms in rows_c):.3f}: "
                    f"{'; '.join(f'{k[:70]} {ms:.3f}' for k, ms in rows_c)}")
            head = {part: dict(ms=t[part][0], device_ms=device[part], plain_ms=t[part][1],
                               library_ms=t[part][2], **b) for part in ("fwd", "dgrad")}
        del y_dg, x_dg
    return {part: dict(max_abs_err=errs[part], **head[part]) for part in ("fwd", "dgrad")}


def k5_bf16_digests() -> None:
    """Phase 13b's inputs (its seed and draws) through ``conv2d_dil`` and its
    autograd dgrad, logged as sha256 digests; the package's public API alone,
    so that the same function run with another checkout's package compares
    the two kernels bit for bit."""
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 4)
    h, w = K5_GRID
    for ci, co, d in K5_SHAPES:
        x = torch.randn(1, ci, h, w, generator=gen).to(dev, bf).requires_grad_(True)
        wt = (torch.randn(co, ci, 3, 3, generator=gen) / (9 * ci) ** 0.5).to(dev, bf)
        dy = torch.randn(1, co, h, w, generator=gen).to(dev, bf)
        y = conv2d_dil(x, wt, d, d)
        dx, = torch.autograd.grad(y, x, dy)
        log(f"[13b] {ci}->{co} d{d} sha256 of the kernel's output {digest(y)}, of its dx "
            f"{digest(dx)}")


def phase_dilated_conv_bf16(card: str) -> dict:
    """Phase 13b: K5 in bf16 against its plain version and cuDNN's bf16 convs;
    returns the kernels entries' numbers (at ``K5_HEADLINE``) for the forward
    and the dgrad (its ms the direct call's, as cuDNN's ``conv2d_input``)."""
    from tdnet_tpu_torch.kernels.dilated_conv import (BM, BN, bf16_attributes, conv2d_dil,
                                                      conv_plan, dgrad_weights,
                                                      dilated_conv_plain, launch)
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.grid import sm_count
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 4)
    h, w = K5_GRID
    sms, attrs = sm_count(0), bf16_attributes()
    log(f"[13b] dilated conv kernel in bf16 vs plain and cuDNN bf16 ({card}) at {h}x{w}; "
        f"tolerance: output and dx {K5_BF16_RTOL:g} x max|plain|; two identical calls bitwise "
        f"equal; rounding gate |kernel's mean (|y| - |f64|) / ulp - plain's| <= "
        f"{K5_BIAS_GATE:g}; dil_wgmma: {attrs['registers']} registers a thread at launch (its "
        f"consumers take 240 by setmaxnreg), {attrs['local_bytes']} bytes of local memory a "
        f"thread")
    k5_bf16_digests()
    errs = dict(fwd=0.0, dgrad=0.0)
    head = {}
    for ci, co, d in K5_SHAPES:
        x = torch.randn(1, ci, h, w, generator=gen).to(dev, bf)
        wt = (torch.randn(co, ci, 3, 3, generator=gen) / (9 * ci) ** 0.5).to(dev, bf)
        dy = torch.randn(1, co, h, w, generator=gen).to(dev, bf)
        wd = dgrad_weights(wt)
        plan = conv_plan(ci, co, h, w, d, d, bf)
        tiles = -(-plan.ho * plan.wp // BM)
        log(f"[13b] {ci}->{co} d{d}: grid {plan.np_ // BN} x {tiles} = "
            f"{plan.np_ // BN * tiles} blocks, one an SM: {plan.np_ // BN * tiles / sms:.2f} "
            f"waves on {sms} SMs")
        x_dg = x.clone().requires_grad_(True)
        y_dg = conv2d_dil(x_dg, wt, d, d)   # only x needs a gradient: the backward is the dgrad
        dgrad = lambda: torch.autograd.grad(y_dg, x_dg, dy, retain_graph=True)[0]
        fns = dict(  # part: (kernel, plain, cuDNN bf16), each one call
            fwd=(lambda: conv2d_dil(x, wt, d, d), lambda: dilated_conv_plain(x, wt, d, d),
                 lambda: F.conv2d(x, wt, padding=d, dilation=d)),
            dgrad=(lambda: launch(dy, wt, d, d, flip=True),
                   lambda: dilated_conv_plain(dy, wd, d, d),
                   lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=d, dilation=d)))
        exact = dict(fwd=dilated_conv_plain(x.double(), wt.double(), d, d),
                     dgrad=dilated_conv_plain(dy.double(), wd.double(), d, d))
        flops = 2 * h * w * 9 * ci * co
        b = bound(flops, 2 * (ci * h * w + co * h * w + 9 * ci * co), PEAK_BF16)
        for part, (kernel_fn, plain_fn, cudnn_fn) in fns.items():
            with torch.no_grad():
                got, plain = kernel_fn(), plain_fn()
                again = kernel_fn()
            torch.cuda.synchronize()
            check_fault("cuda")
            err = (got.float() - plain.float()).abs().max().item()
            tol = K5_BF16_RTOL * plain.float().abs().max().item()
            if not (got.dtype == bf and got.shape == plain.shape and err <= tol):
                raise AssertionError(f"[13b] K5 bf16 {ci}->{co} d{d} {part}: {got.dtype} "
                                     f"{tuple(got.shape)}, max abs err {err} > {tol}")
            if not torch.equal(got, again):
                raise AssertionError(f"[13b] K5 bf16 {ci}->{co} d{d} {part}: two calls differ")
            if part == "dgrad" and not torch.equal(dgrad(), got):
                raise AssertionError(f"[13b] K5 bf16 {ci}->{co} d{d}: the autograd dgrad is not "
                                     f"the direct call's")
            errs[part] = max(errs[part], err)
            # how each rounds against float64: the share of outputs off the plain version's
            # bits, and the rounding gate (each one's mean rounding bias)
            bias, plain_bias, ok = rounding_gate(got, plain, exact[part])
            differ = (got != plain).double().mean().item()
            timed = (kernel_fn, plain_fn, cudnn_fn) + ((dgrad,) if part == "dgrad" else ())
            with torch.no_grad():
                t = [median_ms(fn) for fn in timed]
                rows = [device_rows(fn) for fn in timed]
            check_fault("cuda")
            dev_ms = [None if r is None else sum(ms for _, ms in r) for r in rows]
            shown = lambda v: "not measured" if v is None else f"{v:.3f}"
            via = (f", through autograd {t[3]:.3f} (device {shown(dev_ms[3])})"
                   if part == "dgrad" else "")
            log(f"[13b] {ci}->{co} d{d} {part:5s}: max abs err {err:.3e} (tol {tol:.3e}), "
                f"{differ:.2%} of outputs off the plain bits, mean (|y| - |f64|) / ulp kernel "
                f"{bias:+.2e} plain {plain_bias:+.2e} (gate {'passed' if ok else 'FAILED'}); "
                f"ms kernel {t[0]:.3f} (device {shown(dev_ms[0])}){via}, plain {t[1]:.3f} "
                f"(device {shown(dev_ms[1])}), cuDNN bf16 {t[2]:.3f} (device "
                f"{shown(dev_ms[2])}); bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
            if not ok:
                raise AssertionError(f"[13b] K5 bf16 {ci}->{co} d{d} {part}: rounding bias "
                                     f"{bias:+.3e} against the plain version's "
                                     f"{plain_bias:+.3e}, more than {K5_BIAS_GATE:g} apart")
            if (ci, co, d) == K5_HEADLINE:
                log(f"[13b] {ci}->{co} d{d} {part} kernels: {format_rows(rows[0])}")
                head[part] = dict(ms=t[0], device_ms=dev_ms[0], plain_ms=t[1], library_ms=t[2],
                                  **b)
                if part == "dgrad":
                    head[part].update(autograd_ms=t[3], autograd_device_ms=dev_ms[3])
        del y_dg, x_dg
    phase_fault_report("K5", "13b")
    return {part: dict(max_abs_err=errs[part], **head[part]) for part in ("fwd", "dgrad")}


def phase_train_k5(card: str, state, start, teacher, frames, labels, loss_fn, refs) -> dict:
    """The recipe with the dilated convs through K5; returns the forward and
    dgrad launches of the measured steps."""
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
    from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_step
    step = make_train_step(loss_fn=loss_fn, conv_wgrad="kernel")
    model, cfg = state.model, state.model.cfg
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[14] TD4-PSP18 full recipe, conv_wgrad=kernel ({card}): warm-up step loss "
        f"{m['loss'].item():.5f} ({time.perf_counter() - t0:.2f} s)")
    conv2d_dil.launches = conv2d_dil.backward_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(K5_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, frames, labels, i % cfg.path_num, teacher)
        loss = m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not np.isfinite(loss) or not np.isfinite(m["kd"].item()):
            raise AssertionError(f"[14] step {i}: loss {loss}, kd {m['kd'].item()}")
    launches = dict(fwd=conv2d_dil.launches, dgrad=conv2d_dil.backward_launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[14] {K5_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; median "
        f"{float(np.median(times)):.1f} ms/step (min {min(times):.1f}, max {max(times):.1f}); "
        f"peak memory {peak:.0f} MiB; K5 launches fwd/dgrad {launches['fwd']}/{launches['dgrad']}")
    want = 4 * cfg.path_num * K5_STEPS   # 4 dilated convs in each path's layer4
    if launches != dict(fwd=want, dgrad=want):
        raise AssertionError(f"[14] K5 launches {launches}, expected {want} of each")
    for use_dropout in (False, True):
        compare_with_f64(make_loss_of, loss_fn, model, start, teacher, frames, labels,
                         refs[use_dropout], use_dropout)
    return launches


def phase_train_bf16(card: str, state, start, teacher, frames, labels, loss_fn, refs) -> dict:
    """Phase 15: the recipe in bf16 mixed precision; returns the bf16 K2 and K3
    launches of the measured steps."""
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_step
    bf = torch.bfloat16
    step = make_train_step(loss_fn=loss_fn, compute_dtype=bf)
    model, cfg = state.model, state.model.cfg
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[15] TD4-PSP18 full recipe, compute_dtype bfloat16 ({card}): warm-up step loss "
        f"{m['loss'].item():.5f} ({time.perf_counter() - t0:.2f} s)")
    counters = ((propagation_attention_train, "bf16_launches"),
                (propagation_attention_train, "bf16_backward_launches"),
                (dropout, "bf16_launches"), (dropout, "bf16_backward_launches"),
                (propagation_attention_train, "launches"), (dropout, "launches"))
    _, launches = run_steps("15", step, state, frames, labels, teacher, BF16_STEPS, counters)
    if launches != [3 * BF16_STEPS] * 4 + [0, 0]:
        raise AssertionError(f"[15] launches {launches}, expected {3 * BF16_STEPS} of each bf16 "
                             f"kernel and no f32 launch")

    def run(use_dropout):
        model.load_state_dict(start)
        loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, compute_dtype=bf)
        return _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)

    for use_dropout in (False, True):
        setting = f"dropout {'on' if use_dropout else 'off'}, pos_id {POS_ID}"
        path = run(use_dropout)
        with plain_train_kernels():
            plain = run(use_dropout)
        held = against_f64(path, plain, refs[use_dropout], bf16=True)
        log(f"[15] bf16 kernel path vs float64, beside the bf16 plain path ({setting}): loss "
            f"{path[0]:.6f}, plain {plain[0]:.6f}, float64 {refs[use_dropout][0]:.6f}; "
            f"{describe(held)}")
        if held.problem:
            raise AssertionError(f"[15] bf16 kernel path vs float64 ({setting}): {held.problem}")
        flagged = {}
        for eps in PROBE_LADDER_BF16:
            with faulty_forward(eps):
                probed = run(use_dropout)
            v = against_f64(probed, plain, refs[use_dropout], bf16=True)
            flagged[eps] = bool(v.problem)
            log(f"[15] probe: K2's bf16 forward off by {eps:g} on rows {PROBE_ROWS.start}-"
                f"{PROBE_ROWS.stop - 1} of {PROBE_LQ} ({setting}): "
                f"{'flagged' if v.problem else 'passed'}, worst {v.worst[0]:.3f} of its limit "
                f"({v.worst[1]})")
        smallest = min((e for e, f in flagged.items() if f), default=None)
        log(f"[15] the probe's gate is eps {PROBE_EPS_BF16:g}; the smallest eps of "
            f"{PROBE_LADDER_BF16} the rule flags ({setting}): {smallest}")
        if not flagged[PROBE_EPS_BF16]:
            raise AssertionError(f"[15] the check passed K2's bf16 forward off by "
                                 f"{PROBE_EPS_BF16:g} ({setting}): it cannot see such a fault")
        check_fault("cuda")
    log("[15] the error word clear after every step and comparison above")
    return dict(fwd=launches[0], bwd=launches[1], drop=launches[2] + launches[3])


def run_steps(tag: str, step, state, frames, labels, teacher, n: int, counters):
    """``n`` synchronized steps, pos_id 0, 1, ..., every loss finite, with the
    launch ``counters`` ((function, attribute) pairs) set to 0 just before;
    returns (ms of each step, each counter's launches); logs the peak MiB. The
    error word of K1 and K5 is read after each step."""
    from tdnet_tpu_torch.kernels.fault import check_fault
    for fn, attr in counters:
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, frames, labels, i % state.model.cfg.path_num, teacher)
        loss = m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        check_fault("cuda")
        losses.append(loss)
        if not np.isfinite(loss) or not np.isfinite(m["kd"].item()):
            raise AssertionError(f"[{tag}] step {i}: loss {loss}, kd {m['kd'].item()}")
    launches = [getattr(fn, attr) for fn, attr in counters]
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[{tag}] {n} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; median "
        f"{float(np.median(times)):.1f} ms/step (min {min(times):.1f}, max {max(times):.1f}); "
        f"peak memory {peak:.0f} MiB; launches " + ", ".join(
            f"{fn.__name__}.{attr} {c}" for (fn, attr), c in zip(counters, launches)))
    return times, launches


def idle_share(tag: str, step, state, frames, labels, teacher, times, steps: int = 2) -> None:
    """Device ms a step from a ``torch.profiler`` trace of ``steps`` steps (the
    kernels' self device time), its five largest families and PERF.md §5's
    "pool + LN + K3" column (K3 alone beside it, and each K3 launch's device
    us in the order they ran: set beside ``k3_turns``' warm and cold times,
    they say whether the step's K3 inputs sit in L2), and the idle share
    against the traced wall time and against the median of the untraced
    ``times``."""
    from tdnet_tpu_torch.cli.profile import device_breakdown, kernel_family
    from tdnet_tpu_torch.kernels.fault import check_fault
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(state, frames, labels, i % state.model.cfg.path_num, teacher)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / steps
    check_fault("cuda")
    device_ms, families, _ = device_breakdown(prof, steps, train=True)
    top = "; ".join(f"{k} {v:.2f}" for k, v in list(families.items())[:5])
    k3 = families.get("K3 dropout", 0.0)
    small = k3 + families.get("adaptive pool", 0.0) + families.get("layer norm", 0.0)
    k3_us = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel_family(e.name, train=True) == "K3 dropout"]
    log(f"[{tag}] device {device_ms:.2f} ms/step over {steps} traced steps ({top}; pool + LN + "
        f"K3 {small:.3f}, K3 {k3:.4f}; K3 launches, device us in order: "
        f"{', '.join(f'{t:.2f}' for t in k3_us)}); idle "
        f"{1 - device_ms / traced:.3f} traced ({traced:.1f} ms/step), "
        f"{1 - device_ms / float(np.median(times)):.3f} unprofiled")


def plain_dilated_conv():
    """K5's wrapper runs its plain version instead of the kernel (in the
    forward and in the dgrad)."""
    from tdnet_tpu_torch.kernels import dilated_conv
    plain_k5 = lambda x, w, p, d, counter, flip=False: dilated_conv.dilated_conv_plain(
        x, dilated_conv.dgrad_weights(w) if flip else w, p, d)
    return swapped(dilated_conv, "_forward", plain_k5)


def phase_train_bf16_k5(card: str, state, start, teacher, frames, labels, loss_fn,
                        refs) -> dict:
    """Phase 16: the recipe in bf16 mixed precision with the dilated convs
    through K5; returns the bf16 K5 forward and dgrad launches of the
    measured steps."""
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_step
    bf = torch.bfloat16
    step = make_train_step(loss_fn=loss_fn, conv_wgrad="kernel", compute_dtype=bf)
    model, cfg = state.model, state.model.cfg
    t0 = time.perf_counter()
    m = step(state, frames, labels, 0, teacher)
    torch.cuda.synchronize()
    log(f"[16] TD4-PSP18 full recipe, compute_dtype bfloat16, conv_wgrad=kernel ({card}): "
        f"warm-up step loss {m['loss'].item():.5f} ({time.perf_counter() - t0:.2f} s)")
    counters = ((conv2d_dil, "bf16_launches"), (conv2d_dil, "bf16_backward_launches"),
                (conv2d_dil, "launches"), (conv2d_dil, "backward_launches"),
                (propagation_attention_train, "bf16_launches"),
                (propagation_attention_train, "bf16_backward_launches"),
                (dropout, "bf16_launches"), (dropout, "bf16_backward_launches"))
    times, launches = run_steps("16", step, state, frames, labels, teacher, BF16_STEPS,
                                counters)
    k5 = 4 * cfg.path_num * BF16_STEPS   # 4 dilated convs in each path's layer4
    want = [k5, k5, 0, 0] + [3 * BF16_STEPS] * 4
    if launches != want:
        raise AssertionError(f"[16] launches {launches}, expected {want}")
    idle_share("16", step, state, frames, labels, teacher, times)
    for use_dropout in (False, True):
        compare_with_f64(make_loss_of, loss_fn, model, start, teacher, frames, labels,
                         refs[use_dropout], use_dropout, compute_dtype=bf, tag="16")
    return dict(fwd=launches[0], dgrad=launches[1])


def phase_td2_train(card: str) -> dict:
    """Phase 17: the TD2-PSP50 full recipe with the dilated convs through K5,
    f32 and bf16; returns each dtype's K5 forward and dgrad launches of the
    measured steps."""
    from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train.trainer import make_loss_of, make_train_step, td2_full_recipe
    t0 = time.perf_counter()
    state, _, teacher, frames, labels, loss_fn = td2_full_recipe(seed=SEED, conv_wgrad="kernel")
    model, cfg = state.model, state.model.cfg
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    in_size = cfg.in_size
    log(f"[17] TD2-PSP50 full recipe {in_size[0]}x{in_size[1]} b1, conv_wgrad=kernel ({card}): "
        f"{cfg.backbone} x {cfg.path_num} paths, kv_stride {cfg.kv_stride}, pool_before_proj "
        f"{cfg.pool_before_proj}, aux, OHEM n_min {in_size[0] * in_size[1] // 16}, KD from a "
        f"{teacher.cfg.path_num}-path {teacher.cfg.backbone}, AdaOptimizer; "
        f"{sum(p.numel() for p in model.parameters())} student parameters (built in "
        f"{time.perf_counter() - t0:.1f} s)")
    per_step = dict(k5=3 * cfg.path_num, k2=1, k3=1)   # 3 dilated conv2s a path; one hop
    launches = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        step = make_train_step(loss_fn=loss_fn, conv_wgrad="kernel", compute_dtype=dtype)
        t0 = time.perf_counter()
        m = step(state, frames, labels, 0, teacher)
        torch.cuda.synchronize()
        log(f"[17] {name}: warm-up step loss {m['loss'].item():.5f} "
            f"({time.perf_counter() - t0:.2f} s)")
        pre, other = ("", "bf16_") if dtype is None else ("bf16_", "")
        counters = [(fn, p + attr) for p in (pre, other) for fn in
                    (conv2d_dil, propagation_attention_train, dropout)
                    for attr in ("launches", "backward_launches")]
        times, got = run_steps(f"17 {name}", step, state, frames, labels, teacher, TD2_STEPS,
                               counters)
        want = [TD2_STEPS * per_step[k] for k in ("k5", "k5", "k2", "k2", "k3", "k3")] + [0] * 6
        if got != want:
            raise AssertionError(f"[17] {name} launches {got}, expected {want}")
        idle_share(f"17 {name}", step, state, frames, labels, teacher, times)
        launches[name] = dict(fwd=got[0], dgrad=got[1])

    t0 = time.perf_counter()
    refs = f64_references(loss_fn, model, start, teacher, frames, labels)
    log(f"[17] float64 run from the initial state at {in_size[0]}x{in_size[1]}, dropout off "
        f"and on: losses {refs[False][0]:.6f} / {refs[True][0]:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        for use_dropout in (False, True):
            setting = f"{name}, dropout {'on' if use_dropout else 'off'}, pos_id {POS_ID}"

            def run():
                model.load_state_dict(start)
                loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout,
                                       conv_wgrad="kernel", compute_dtype=dtype)
                return _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)

            path = run()
            with plain_train_kernels(), plain_dilated_conv():
                plain = run()
            ref = refs[use_dropout]
            held = against_f64(path, plain, ref, bf16=dtype is not None)
            log(f"[17] kernel path (K2, K3, K5) vs float64, beside the plain path ({setting}): "
                f"loss {path[0]:.6f}, plain {plain[0]:.6f}, float64 {ref[0]:.6f}; "
                f"{describe(held)}")
            if held.problem:
                raise AssertionError(f"[17] kernel path vs float64 ({setting}): {held.problem}")
            flagged = {}
            for eps in PROBE_LADDER_TD2[name]:
                with faulty_forward(eps):
                    probed = run()
                v = against_f64(probed, plain, ref, bf16=dtype is not None)
                flagged[eps] = bool(v.problem)
                log(f"[17] probe: K2's forward off by {eps:g} on rows {PROBE_ROWS.start}-"
                    f"{PROBE_ROWS.stop - 1} of {PROBE_LQ} ({setting}): "
                    f"{'flagged' if v.problem else 'passed'}, worst {v.worst[0]:.3f} of its "
                    f"limit ({v.worst[1]})")
            if not flagged[PROBE_GATE_TD2[name]]:
                raise AssertionError(f"[17] the check passed K2's forward off by "
                                     f"{PROBE_GATE_TD2[name]:g} ({setting}): it cannot see "
                                     f"such a fault")
            check_fault("cuda")
    log("[17] the error word clear after every step and comparison above")
    del state, teacher, model, refs
    torch.cuda.empty_cache()
    return launches


def compare_with_f64(make_loss_of, loss_fn, model, start, teacher, frames, labels, ref,
                     use_dropout: bool, compute_dtype=None, tag: str = "14") -> None:
    """The K5 path's loss and gradients against phase 9's float64 run ``ref``,
    from the state ``start`` (``against_f64``). f32 (phase 14): beside the
    cuDNN path. bf16 (phase 16): by phase 15's rule, beside the bf16 plain
    path (K2, K3 and K5 swapped for their plain versions); the cuDNN path is
    no yardstick there, since two bf16 paths that sum layer4's convs in other
    orders round different outputs, and on a few gradients that are mostly
    bf16 noise K5's plain version, which rounds as the TPU kernel does, lies
    up to 1.85 of the limit beside cuDNN (PERF.md, run H3); both distances
    beside cuDNN are printed. Beside them, the distances from float64 of
    deterministic cuDNN and of K5's plain version."""
    from tdnet_tpu_torch.kernels.fault import check_fault
    setting = f"dropout {'on' if use_dropout else 'off'}, pos_id {POS_ID}"

    def run(conv_wgrad):
        model.load_state_dict(start)
        loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, conv_wgrad=conv_wgrad,
                               compute_dtype=compute_dtype)
        return _loss_and_grads(model, loss_of, frames, labels, POS_ID, teacher)

    k5, cudnn = run("kernel"), run("cudnn")
    check_fault("cuda")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        _, g_det = run("cudnn")
    with plain_dilated_conv():
        plain = run("kernel")
    beside_cudnn = against_f64(k5, cudnn, ref, bf16=compute_dtype is not None)
    if compute_dtype is None:
        held = beside_cudnn
        log(f"[{tag}] K5 path vs float64, beside the cuDNN path ({setting}): loss {k5[0]:.6f} / "
            f"{cudnn[0]:.6f} / {ref[0]:.6f}; {describe(held)}")
    else:
        with plain_train_kernels(), plain_dilated_conv():
            all_plain = run("kernel")
        held = against_f64(k5, all_plain, ref, bf16=True)
        log(f"[{tag}] K5 path vs float64, beside the plain path ({setting}): loss {k5[0]:.6f} / "
            f"{all_plain[0]:.6f} / {ref[0]:.6f}; {describe(held)}")
        log(f"[{tag}] beside the cuDNN path (loss {cudnn[0]:.6f}), by the same rule: the K5 path "
            f"worst {beside_cudnn.worst[0]:.3f} of its limit ({beside_cudnn.worst[1]}), K5's "
            f"plain version {against_f64(plain, cudnn, ref, bf16=True).worst[0]:.3f}")
    farthest = {}
    for name, grads in (("K5", k5[1]), ("cuDNN", cudnn[1]), ("deterministic cuDNN", g_det),
                        ("plain K5", plain[1])):
        farthest[name] = max(
            ((grads[k].double() - g.to(grads[k].device)).abs().max().item()
             / max(g.abs().max().item(), held.floor), k) for k, g in ref[1].items())
    log(f"[{tag}] farthest gradient from float64, x max(max|grad|, floor): " + "; ".join(
        f"{name} {e:.2e} ({k})" for name, (e, k) in farthest.items()))
    if held.problem:
        raise AssertionError(f"[{tag}] K5 path vs float64 ({setting}): {held.problem}")


FUSED_F32_FRAC = 1e-4      # phase 18: f32 fused vs unfused logits, x max|logits|
TRUNK_FRAC = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}   # phase 18: the fused encoding's
# outputs vs the pyramid feature's, x max|plain| (CPU, random init: up to 9.4e-7 f32, 1.15e-2 bf16)
TD2_BF16_RATIO = 1.5       # phase 18: TD2 bf16 fused stream's distance from f32 fused, x the
# unfused bf16 stream's (H100 runs: 1.207 on every reading)
AGREEMENT_MIN = 0.9999     # phase 19: pixel agreement if the confusion matrices differ
MEAN_IOU = "Mean IoU : \t"  # the score's key, as the reference prints it
TREE_SIZE = (1024, 2048)   # phase 19: the Cityscapes frames
TREE_SPLITS = (("train", 3), ("val", 2))
TREE_PREDECESSORS = 6
TREE_FILTERS = (0, 1, 2, 3, 4)  # phase 19: row filters in turn, as adaptive encoders mix them


def argmax_agreement(xs, ys) -> float:
    """The share of pixels whose class (argmax over the last axis) agrees."""
    same = sum((a.float().argmax(-1) == b.float().argmax(-1)).sum().item() for a, b in zip(xs, ys))
    return same / sum(a[..., 0].numel() for a in xs)


def check_trunk(tag, runner, frames) -> None:
    """The fused encoding inside a fused run: for every frame, on the c4 of
    the sub-network that took it (the run's weights, BNs folded), the five
    outputs of ``fused_psp_encoding`` against the pyramid feature's (z built,
    the projections over it), each within ``TRUNK_FRAC[dtype]`` x max|plain|."""
    from tdnet_tpu_torch.nn import apply_encoding_cached, apply_encoding_full, apply_pyramid_pooling
    from tdnet_tpu_torch.nn.fused_trunk import fused_psp_encoding
    cfg, frac = runner.cfg, TRUNK_FRAC[runner.dtype]
    worst = (0.0, "")
    with torch.inference_mode():
        for i, f in enumerate(frames):
            p = i % cfg.path_num
            sub, pid = runner.model.paths[p], cfg.psp_pid(p)
            _, c4 = sub.backbone(f.to(runner.dtype).permute(0, 3, 1, 2).contiguous(), runner.ctx)
            got = fused_psp_encoding(sub.psp, sub.enc, c4, pid=pid, groups=cfg.psp_groups,
                                     kv_stride=cfg.kv_stride)
            z = apply_pyramid_pooling(sub.psp, c4, groups=cfg.psp_groups, pid=pid)
            want = (*apply_encoding_full(sub.enc, z),
                    *apply_encoding_cached(sub.enc, z, kv_stride=cfg.kv_stride))
            for name, g, w in zip(("q", "v", "q_c", "k_c", "v_c"), got, want):
                err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                worst = max(worst, (err / frac, f"{name} of frame {i}"))
                if not (g.shape == w.shape and err <= frac):
                    raise AssertionError(f"[{tag}] frame {i}: fused {name} vs the pyramid "
                                         f"feature's, {err:.3e} x max|plain| > {frac:g}")
    log(f"[{tag}] the fused encoding of all {len(frames)} frames in the run against the pyramid "
        f"feature's (q, v, q_c, k_c, v_c): worst {worst[0]:.3f} of {frac:g} x max|plain| "
        f"({worst[1]})")


def trunk_turns(arch, in_size, dtype, card, tag):
    """One seeded TDNet streamed through ``Streamer(fused_trunk=True)`` and
    ``(fused_trunk=False)`` in turns (fused, unfused, fused, unfused) on the
    same frames: each turn steps the 12 frames (K1 launches counted, latency
    of frames 7-12) and then runs them 4 times over pipelined; the first fused
    run's trunk is checked (``check_trunk``). Returns the logits of the first
    turn of each form, by form, left on the card (the comparisons run there)."""
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    from tdnet_tpu_torch.stream.runtime import Streamer
    cfg = tdnet_config(arch, in_size=in_size)
    model = init_tdnet(cfg, torch.Generator().manual_seed(SEED)).to("cuda")
    frames = stream_frames(in_size, dtype)
    expected = cfg.window * (N_FRAMES - cfg.window)
    outs, rows = {}, {True: [], False: []}
    for turn in range(2):
        for fused in (True, False):
            runner = Streamer(model, dtype=dtype, fused_trunk=fused)
            fused_propagation_attention.launches = 0
            o = [runner.step(f)[0] for f in frames]
            launches = fused_propagation_attention.launches
            if launches != expected or not all(torch.isfinite(x).all() for x in o):
                raise AssertionError(f"[{tag}] fused_trunk={fused}: K1 launches {launches} "
                                     f"(expected {expected}) or logits not finite")
            latency = runner.meter.avg * 1e3
            runner.reset()
            _, spf = runner.run_pipelined(frames * 4)
            rows[fused].append(f"{1.0 / spf:.2f} frames/s, {latency:.2f} ms")
            if fused not in outs:
                outs[fused] = o
                if fused:
                    check_trunk(tag, runner, frames)
    log(f"[{tag}] {arch} {in_size[0]}x{in_size[1]} {str(dtype)[6:]} ({card}), in turns: fused "
        f"{'; '.join(rows[True])} | unfused {'; '.join(rows[False])} (pipelined frames/s, "
        f"latency of frames 7-{N_FRAMES}); K1 launches {expected} in every run "
        f"({cfg.window} a warm frame)")
    del model, runner
    torch.cuda.empty_cache()
    return outs


def phase_fused_trunk(card: str, td4, td2) -> None:
    """Phase 18: the fused grouped-PSP + QKV trunk at full width against the
    unfused stream (``trunk_turns``; in every fused run the trunk itself is
    held to the pyramid feature's, ``check_trunk``): TD4-PSP18 f32 logits by
    ``FUSED_F32_FRAC``; TD4-PSP18 bf16 against its f32 fused twin by phase 4's
    rule; TD2-PSP50 bf16's distance from an f32 fused run at most
    ``TD2_BF16_RATIO`` x the unfused bf16 stream's (phase 11: random-init bf16
    TD2 streams lie too far from f32 for phase 4's rule). Argmax agreement
    printed for each."""
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    from tdnet_tpu_torch.stream.runtime import Streamer
    t0 = time.perf_counter()
    td4_32 = trunk_turns("td4-psp18", td4, torch.float32, card, "18")
    check_close("18", td4_32[True], td4_32[False], FUSED_F32_FRAC, "TD4 f32 fused vs unfused")
    td4_16 = trunk_turns("td4-psp18", td4, torch.bfloat16, card, "18")
    check_close("18", td4_16[True], td4_32[True], 5e-2, "TD4 bf16 fused vs its f32 fused twin")
    report_bf16_stream("18", td4_16[True], td4_16[False], td4_32[True],
                       "TD4 bf16 fused vs unfused")
    log(f"[18] TD4 argmax agreement, fused vs unfused: f32 "
        f"{argmax_agreement(td4_32[True], td4_32[False]):.6f}, bf16 "
        f"{argmax_agreement(td4_16[True], td4_16[False]):.6f}; bf16 fused vs f32 fused "
        f"{argmax_agreement(td4_16[True], td4_32[True]):.6f}")
    del td4_32, td4_16
    td2_16 = trunk_turns("td2-psp50", td2, torch.bfloat16, card, "18")
    model = init_tdnet(tdnet_config("td2-psp50", in_size=td2),
                       torch.Generator().manual_seed(SEED)).to("cuda")
    runner = Streamer(model, dtype=torch.float32)
    ref = [runner.step(f, timed=False)[0] for f in stream_frames(td2, torch.float32)]
    ratio = report_bf16_stream("18", td2_16[True], td2_16[False], ref,
                               "TD2 bf16 fused vs unfused")
    if not ratio <= TD2_BF16_RATIO:
        raise AssertionError(f"[18] TD2 bf16: the fused stream lies {ratio:.3f}x as far from "
                             f"f32 as the unfused one (> {TD2_BF16_RATIO})")
    log(f"[18] TD2 argmax agreement: bf16 fused vs unfused "
        f"{argmax_agreement(td2_16[True], td2_16[False]):.6f}; against the f32 fused stream: "
        f"fused {argmax_agreement(td2_16[True], ref):.6f}, unfused "
        f"{argmax_agreement(td2_16[False], ref):.6f}")
    del td2_16, ref, model, runner
    torch.cuda.empty_cache()
    log(f"[18] {time.perf_counter() - t0:.1f} s in all")


def write_tree(root: str) -> None:
    """A seeded Cityscapes-layout tree of ``TREE_SIZE`` PNGs written by
    ``data/png.py``, rows filtered by ``TREE_FILTERS`` in turn: per annotated
    frame its image, its labelIds and
    ``TREE_PREDECESSORS`` predecessors. Train sequences pan a scene 4 pixels a
    frame; val sequences repeat the annotated frame, so that the predecessor
    gaps validation draws (unseeded, as the reference's) leave its input
    unchanged."""
    import shutil
    from tdnet_tpu_torch.data.png import write_png
    rng = np.random.RandomState(SEED)
    h, w = TREE_SIZE
    ids = np.array([0, 4, 7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33])
    pan = 4 * TREE_PREDECESSORS
    for split, n in TREE_SPLITS:
        for i in range(n):
            city, seq, cur = f"city{i % 2}", f"{i:06d}", 30 + 10 * i
            blocks = rng.randint(0, 248, (h // 32, (w + pan) // 32 + 1, 3)).astype(np.uint8)
            scene = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w + pan]
            scene = scene + rng.randint(0, 8, scene.shape, dtype=np.uint8)
            seq_dir = os.path.join(root, "leftImg8bit_sequence", split, city)
            os.makedirs(seq_dir, exist_ok=True)
            name = lambda k: f"{city}_{seq}_{cur - k:06d}_leftImg8bit.png"
            for k in range(TREE_PREDECESSORS + 1):
                off = pan if split == "val" else pan - 4 * k
                write_png(os.path.join(seq_dir, name(k)), scene[:, off:off + w], level=1,
                          filters=TREE_FILTERS)
            for base in ("leftImg8bit", "gtFine"):
                os.makedirs(os.path.join(root, base, split, city), exist_ok=True)
            shutil.copyfile(os.path.join(seq_dir, name(0)),
                            os.path.join(root, "leftImg8bit", split, city, name(0)))
            labels = np.repeat(np.repeat(rng.choice(ids, (h // 64, w // 64)), 64, 0), 64, 1)
            write_png(os.path.join(root, "gtFine", split, city,
                                   f"{city}_{seq}_{cur:06d}_gtFine_labelIds.png"),
                      labels.astype(np.uint8), level=1, filters=TREE_FILTERS)


def decode_times(root: str) -> None:
    """``read_png`` on one annotated frame of the tree (rows filtered by
    ``TREE_FILTERS`` in turn, so Average and Paeth rows undone a diagonal at a
    time) and on the same frame rewritten with filter 0 on every row, 3 reads
    each, the median; the two decodes equal."""
    import glob
    from tdnet_tpu_torch.data.png import read_png, write_png
    path = sorted(glob.glob(os.path.join(root, "leftImg8bit", "train", "*", "*.png")))[0]
    plain = os.path.join(os.path.dirname(root), "filter0.png")
    write_png(plain, read_png(path), level=1)
    ms = {}
    for name, p in ((f"filters {TREE_FILTERS} in turn (the tree's)", path),
                    ("filter 0", plain)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            img = read_png(p)
            times.append(1e3 * (time.perf_counter() - t))
        ms[name] = (float(np.median(times)), img)
    a, b = (v[1] for v in ms.values())
    if not np.array_equal(a, b):
        raise AssertionError("[19] read_png: the filtered frame decodes differently")
    log(f"[19] read_png of a {TREE_SIZE[0]}x{TREE_SIZE[1]} RGB frame (host, median of 3): "
        f"{'; '.join(f'{k} {v[0]:.1f} ms' for k, v in ms.items())}; a Cityscapes clip reads 4 "
        f"frames and a label")


def phase_train_cli(card: str) -> str:
    """Phase 19: ``cli.train.train`` on configs/td4_psp18_cityscapes.yml at its
    full width on a seeded tree (``write_tree``), overriding only the data
    path, 4 iterations, batch 2, validation and checkpoints every 2 and a print
    every step; then 2 more steps resumed from ``state_latest.pkl`` (the loaded
    state equal to the saved one bit for bit, ``it`` going on from 4); then
    ``cli.validate`` on the best checkpoint, whose confusion matrix must equal
    the one the run's validation gave those weights (or, if it does not, the
    predictions agree in ``AGREEMENT_MIN`` of the pixels). Every loss finite,
    the error word read after every step and validation; ms a step split into
    the wait for ``ClipBatcher`` and the step, the peak memory, and K2's, K3's
    and K1's launches; first, one frame's decode time (``decode_times``).
    Returns the tree's root, which phase 20 trains on again."""
    import logging
    import shutil
    from tdnet_tpu_torch.cli import train as cli_train
    from tdnet_tpu_torch.cli import validate as cli_validate
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.models import init_tdnet
    from tdnet_tpu_torch.train import trainer
    from tdnet_tpu_torch.utils import checkpoint as ckpt
    from tdnet_tpu_torch.utils.config import (load_config, model_config_from_yaml,
                                              opt_kwargs_from_yaml)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase19")
    shutil.rmtree(work, ignore_errors=True)
    root, logdir, resumed_dir = (os.path.join(work, d) for d in ("cityscapes", "run", "resumed"))
    t0 = time.perf_counter()
    write_tree(root)
    log(f"[19] wrote a {TREE_SIZE[0]}x{TREE_SIZE[1]} Cityscapes-layout tree ("
        f"{', '.join(f'{n} {s}' for s, n in TREE_SPLITS)} frames, {TREE_PREDECESSORS} "
        f"predecessors each) in {time.perf_counter() - t0:.1f} s")
    decode_times(root)
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "td4_psp18_cityscapes.yml"))
    cfg["data"]["path"] = root
    cfg["training"].update(train_iters=4, batch_size=2, val_interval=2, print_interval=1,
                           ckpt_interval=2)
    logger = logging.getLogger("tdnet_tpu_torch.chip_smoke")
    preds = []
    real_eval = trainer.make_eval_step

    def recording_eval():
        step = real_eval()

        def call(model, frames, pos_id):
            out = step(model, frames, pos_id)
            preds.append(out.cpu())
            return out
        return call
    counters = ((propagation_attention_train, "launches"),
                (propagation_attention_train, "backward_launches"),
                (dropout, "launches"), (dropout, "backward_launches"),
                (fused_propagation_attention, "launches"))

    def run(tag, run_cfg, run_dir, **kw):
        for fn, attr in counters:
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t = time.perf_counter()
        os.makedirs(run_dir)
        with swapped(trainer, "make_eval_step", recording_eval):
            state, best = cli_train.train(run_cfg, logger, run_dir, device="cuda", stats=stats,
                                          **kw)
        check_fault("cuda")
        wall = time.perf_counter() - t
        n = len(stats["step_s"])
        launches = [getattr(fn, attr) for fn, attr in counters]
        if not (np.all(np.isfinite(stats["losses"])) and launches[:4] == [3 * n] * 4):
            raise AssertionError(f"[19] {tag}: losses {stats['losses']}, launches {launches}")
        log(f"[19] {tag} ({card}): {n} steps of batch {cfg['training']['batch_size']} at "
            f"{state.model.cfg.in_size[0]}x{state.model.cfg.in_size[1]}, it {state.it}; losses "
            f"{', '.join(f'{x:.4f}' for x in stats['losses'])}; ms a step: waiting on "
            f"ClipBatcher {ms_list(stats['data_s'])}, the step {ms_list(stats['step_s'])} (medians "
            f"{1e3 * float(np.median(stats['data_s'])):.1f} / "
            f"{1e3 * float(np.median(stats['step_s'])):.1f}; data "
            f"{sum(stats['data_s']) / (sum(stats['data_s']) + sum(stats['step_s'])):.3f} of the "
            f"steps' time); {stats['val_passes']} validation passes, best mean IoU {best:.5f}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches K2 "
            f"fwd/bwd {launches[0]}/{launches[1]}, K3 fwd/bwd {launches[2]}/{launches[3]}, K1 "
            f"{launches[4]}; {wall:.1f} s in all")
        return state, stats

    state, stats = run("train", copy.deepcopy(cfg), logdir)
    first_preds = list(preds)
    latest = os.path.join(logdir, "state_latest.pkl")
    mcfg = model_config_from_yaml(cfg, streaming=False)
    loaded = trainer.make_train_state(init_tdnet(mcfg, torch.Generator().manual_seed(1)).cuda(),
                                      opt_kwargs=opt_kwargs_from_yaml(cfg))
    ckpt.load_train_state(latest, loaded)
    same = all(torch.equal(v, loaded.model.state_dict()[k])
               for k, v in state.model.state_dict().items())
    saved_opt, loaded_opt = state.optimizer.state_dict(), loaded.optimizer.state_dict()
    same_opt = all(torch.equal(a["momentum_buffer"], b["momentum_buffer"]) for a, b in zip(
        saved_opt["state"].values(), loaded_opt["state"].values()))
    log(f"[19] state_latest.pkl loaded: model {'bitwise equal' if same else 'DIFFERS'}, "
        f"optimizer {'bitwise equal' if same_opt else 'DIFFERS'}, it {loaded.it}")
    if not (same and same_opt and loaded.it == 4 and len(saved_opt["state"]) > 0):
        raise AssertionError("[19] the resumed state is not the saved one")
    del loaded
    resume_cfg = copy.deepcopy(cfg)
    resume_cfg["training"]["train_iters"] = 6
    resumed, _ = run("resumed", resume_cfg, resumed_dir, resume_state=latest, max_steps=2)
    if resumed.it != 6:
        raise AssertionError(f"[19] resumed run ended at it {resumed.it}, expected 6")
    del state, resumed
    torch.cuda.empty_cache()

    best_path = os.path.join(logdir, "td4_psp_cityscapes_best_model.pkl")
    cfg["validating"]["resume"] = best_path
    vstats = {}
    args = types.SimpleNamespace(measure_time=True, max_batches=None, device="cuda")
    preds.clear()
    with swapped(trainer, "make_eval_step", recording_eval):
        score, _ = cli_validate.validate(cfg, args, stats=vstats)
    check_fault("cuda")
    equal = np.array_equal(vstats["confusion"], stats["best_confusion"])
    agree = float(np.mean(np.concatenate([a.numpy().ravel() for a in preds]) == np.concatenate(
        [first_preds[stats["best_pass"]].numpy().ravel()])))
    log(f"[19] cli.validate on {os.path.basename(best_path)}: mean IoU "
        f"{score[MEAN_IOU]:.6f}; confusion matrix "
        f"{'equal to' if equal else 'DIFFERENT from'} the run's validation pass "
        f"{stats['best_pass']} of those weights; pixels agreeing {agree:.6f}; "
        f"{ms_list(vstats['batch_s'])} ms a batch")
    if not (equal or agree >= AGREEMENT_MIN):
        raise AssertionError(f"[19] validate vs the run's validation: agreement {agree}")
    for d in (logdir, resumed_dir):
        shutil.rmtree(d, ignore_errors=True)
    return root


# phase 20: the reference's checkpoints
REF_SEED = SEED + 20
REF_BEST_IOU = np.float64(0.7391)   # a numpy scalar, as the reference's best_iou may be
# the reference's names of the port's modules, by part: FCN heads (conv5 = conv, bn, relu,
# dropout, conv), the PSPNet head (conv5 = pyramid, conv, bn, relu, dropout, conv), the TDNet
# pyramid and the encoding's projections
FCN_NAMES = {"conv": "conv5.0", "bn": "conv5.1", "out": "conv5.4"}
PSP_HEAD_NAMES = {"conv.conv": "conv5.1", "conv.bn": "conv5.2", "out": "conv5.5",
                  **{f"psp.conv{i}.{m}": f"conv5.0.conv{i}.{j}"
                     for i in range(1, 5) for m, j in (("conv", 0), ("bn", 1))}}
PYRAMID_NAMES = {f"conv{i}.{m}": f"conv{i}.{j}" for i in range(1, 5)
                 for m, j in (("conv", 0), ("bn", 1))}
ENCODING_NAMES = {"w_vs": "w_vs.0.conv", **{f"{w}.{m}": f"{w}.{r}" for w in ("w_qs", "w_ks")
                                             for m, r in (("conv0", "0.conv"), ("bn0", "0.bn"),
                                                          ("conv1", "1.conv"))}}
STEM_NAMES = {"stem.conv0": "conv1.0", "stem.bn0": "conv1.1", "stem.conv1": "conv1.3",
              "stem.bn1": "conv1.4", "stem.conv2": "conv1.6"}
NAMINGS = ("testing", "training", "psp_source", "psp101", "torchvision")


def _renamed(key: str, names: dict) -> str:
    module, _, leaf = key.rpartition(".")
    return f"{names[module]}.{leaf}"


def _resnet_name(key: str, deep_base: bool) -> str:
    module, _, leaf = key.rpartition(".")
    if module.startswith("stem."):
        module = STEM_NAMES[module] if deep_base else "conv1"
    module = module.replace("downsample.conv", "downsample.0").replace("downsample.bn",
                                                                        "downsample.1")
    return f"{module}.{leaf}"


def reference_state(model, cfg, naming: str) -> dict:
    """A port model's state under the reference's key names, with
    ``num_batches_tracked`` beside each BatchNorm: the inverse of the port's
    importer (``utils/torch_import.py``), in the namings the reference's
    checkpoints have:
    - ``testing``: a TDNet as the Testing twins (td4-psp18.pkl, td2-psp50.pkl)
      hold it, ``pretrained{i}``, ``psp{i}``, ``enc{i}``, ``layer_norm{i}``,
      ``head{i}``, the hops' fcs as 1x1 convs [out, in, 1, 1] stored
      pre-rotated (``atn{p+1}_{s+1}``, s = (p + h + 1) % P; TD2 ``atn{p+1}``);
    - ``training``: the same and the aux heads ``auxlayer{i}`` (a best model);
    - ``psp_source``: a single-path PSPNet, ``pretrained``, ``head.conv5.*``,
      ``auxlayer`` (the bootstrap and teacher sources);
    - ``psp101``: the same without the aux head (Testing's psp101.pkl);
    - ``torchvision``: a ResNet as torchvision names it, with a seeded ``fc``.
    ``cfg`` is the model's config (TDNetConfig, PSPNetConfig or ResNetConfig)."""
    from tdnet_tpu_torch.nn import BACKBONES
    if naming not in NAMINGS:
        raise ValueError(f"naming {naming!r} not in {NAMINGS}")
    out = OrderedDict()
    if naming in ("testing", "training"):
        deep = BACKBONES[cfg.backbone]().deep_base
        for key, v in model.state_dict().items():
            m = re.fullmatch(r"atn\.(\d+)\.(\d+)\.(w|b)", key)
            if m:
                p, h = int(m[1]), int(m[2])
                hop = (f"atn{p + 1}" if cfg.path_num == 2
                       else f"atn{p + 1}_{(p + h + 1) % cfg.path_num + 1}")
                out[f"{hop}.fc.0.conv.weight" if m[3] == "w" else f"{hop}.fc.0.conv.bias"] = (
                    v.t()[:, :, None, None] if m[3] == "w" else v)
                continue
            p, part, rest = re.fullmatch(r"paths\.(\d+)\.(\w+)\.(.+)", key).groups()
            i = int(p) + 1
            if part == "aux" and naming == "testing":
                continue
            out[{"backbone": lambda: f"pretrained{i}." + _resnet_name(rest, deep),
                 "psp": lambda: f"psp{i}." + _renamed(rest, PYRAMID_NAMES),
                 "enc": lambda: f"enc{i}." + _renamed(rest, ENCODING_NAMES),
                 "ln": lambda: f"layer_norm{i}.ln.{rest}",
                 "head": lambda: f"head{i}." + _renamed(rest, FCN_NAMES),
                 "aux": lambda: f"auxlayer{i}." + _renamed(rest, FCN_NAMES)}[part]()] = v
    elif naming in ("psp_source", "psp101"):
        for key, v in model.state_dict().items():
            part, _, rest = key.partition(".")
            if part == "aux" and naming == "psp101":
                continue
            deep = cfg.backbone_cfg.deep_base
            out[{"backbone": lambda: "pretrained." + _resnet_name(rest, deep),
                 "head": lambda: "head." + _renamed(rest, PSP_HEAD_NAMES),
                 "aux": lambda: "auxlayer." + _renamed(rest, FCN_NAMES)}[part]()] = v
    else:
        for key, v in model.state_dict().items():
            out[_resnet_name(key, cfg.deep_base)] = v
        gen = torch.Generator().manual_seed(REF_SEED)
        out["fc.weight"] = torch.randn(1000, cfg.out_channels, generator=gen) * 0.01
        out["fc.bias"] = torch.zeros(1000)
    with_count = OrderedDict()
    for key, v in out.items():
        with_count[key] = v.detach().cpu().clone()
        if key.endswith(".running_var"):
            with_count[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(40000)
    return with_count


def seeded(model, seed: int):
    """``model`` with its BatchNorms, LayerNorms and biases drawn from ``seed``
    (the reference's init leaves them constant, so a name map that swapped two
    of them would not show)."""
    from tdnet_tpu_torch.nn import Attention
    from tdnet_tpu_torch.ops import BatchNorm, Conv2d, LayerNorm2d
    gen = torch.Generator().manual_seed(seed)
    def draw(t, base=0.0):
        t.copy_(base + 0.1 * torch.randn(t.shape, generator=gen))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, LayerNorm2d)):
                draw(m.weight, 1.0)
                draw(m.bias)
            if isinstance(m, BatchNorm):
                draw(m.running_mean)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
            elif isinstance(m, Conv2d) and m.bias is not None:
                draw(m.bias)
            elif isinstance(m, Attention):
                draw(m.b)
    return model


def seeded_model(kind: str, in_size, seed: int = REF_SEED):
    """A seeded port model: a TDNet twin (``td4-psp18``, ``td2-psp50``: the
    streaming twin), a PSPNet (``psp18``: ResNet-18 with the aux head, the
    bootstrap source; ``psp101``) or a ResNet-18 (``resnet18``); and its config."""
    from tdnet_tpu_torch.models import PSPNetConfig, init_pspnet, init_tdnet, tdnet_config
    from tdnet_tpu_torch.nn import BACKBONES, ResNet, init_resnet
    gen = torch.Generator().manual_seed(seed)
    if kind in ("td4-psp18", "td2-psp50"):
        cfg = tdnet_config(kind, in_size=in_size)
        return seeded(init_tdnet(cfg, gen), seed), cfg
    if kind in ("psp18", "psp101"):
        cfg = PSPNetConfig(backbone="resnet" + kind[3:], in_size=in_size, aux=kind == "psp18")
        return seeded(init_pspnet(cfg, gen), seed), cfg
    cfg = BACKBONES[kind]()
    net = ResNet(cfg)
    init_resnet(net, gen)
    return seeded(net, seed), cfg


def write_reference(path: str, state: dict, prefix: str = "") -> None:
    """A reference checkpoint, as its PyTorch 1.1 wrote it: the legacy
    (non-zip) format, ``{"epoch", "model_state", "best_iou"}``."""
    model_state = OrderedDict((prefix + k, v) for k, v in state.items())
    payload = {"epoch": 40000, "model_state": model_state, "best_iou": REF_BEST_IOU}
    torch.save(payload, path, _use_new_zipfile_serialization=False)


def offline_store(work: str) -> None:
    """The backbone store on local directories only: ``TORCH_HOME`` an empty
    directory here, the download URLs ``file://`` ones of a directory that does
    not exist. No phase reaches the network, and phase 19's store misses."""
    import shutil
    from tdnet_tpu_torch.utils import model_store
    shutil.rmtree(work, ignore_errors=True)
    nowhere = os.path.join(work, "no_mirror")
    os.environ["TORCH_HOME"] = os.path.join(work, "torch_home")
    os.environ["ENCODING_REPO"] = f"file://{nowhere}/"
    model_store.TORCHVISION_URL = f"file://{nowhere}/{{name}}-{{sha}}.pth"
    zoo = os.path.expanduser("~/.encoding/models")
    cached = sorted(os.listdir(zoo)) if os.path.isdir(zoo) else []
    log(f"[0] backbone store: TORCH_HOME {os.environ['TORCH_HOME']} (empty), downloads from "
        f"{model_store.TORCHVISION_URL}; {zoo}: {cached[:4] if cached else 'nothing'}")


def phase_reference_convert(work: str, sizes: dict) -> dict:
    """Phase 20 step 1: seeded TD4-PSP18 (DataParallel's ``module.`` keys),
    TD2-PSP50 and PSP-101 written as reference files (``reference_state``,
    ``write_reference``), then ``cli.convert`` on each: the TDNets' converted
    states bitwise equal to the seeded models', PSP-101's (the teacher surgery,
    ``--arch pspnet_4p``, the convert that takes a PSPNet) to the seeded model's
    parts and its gathered head columns. Returns the reference files by kind."""
    from tdnet_tpu_torch.cli import convert
    from tdnet_tpu_torch.utils.surgery import grouped_head_conv
    files = {}
    for kind, naming, prefix in (("td4-psp18", "testing", "module."),
                                 ("td2-psp50", "testing", ""), ("psp101", "psp101", "")):
        t = time.perf_counter()
        model, cfg = seeded_model(kind, sizes[kind])
        want = {k: v.detach().clone() for k, v in model.state_dict().items()}
        files[kind] = src = os.path.join(work, f"{kind}.pkl")
        write_reference(src, reference_state(model, cfg, naming), prefix)
        dst = os.path.join(work, f"{kind}_converted.pt")
        size = ["--in_size", str(cfg.in_size[0]), str(cfg.in_size[1])]
        argv = ["--arch", kind, "--streaming"] if kind != "psp101" else ["--arch", "pspnet_4p"]
        with contextlib.redirect_stdout(sys.stderr):
            convert.main(argv + ["--src", src, "--dst", dst] + size)
        got = torch.load(dst, weights_only=True)["model_state"]
        if kind == "psp101":
            w = want["head.conv.conv.weight"]
            want = {**{k: v for k, v in want.items() if k.startswith("backbone.")},
                    **{k[5:]: v for k, v in want.items() if k.startswith("head.psp.")},
                    **{f"groups.{g}.weight": grouped_head_conv(w, 4, g) for g in range(4)},
                    **{"head." + k[10:]: v for k, v in want.items()
                       if k.startswith("head.conv.bn.")},
                    **{k: v for k, v in want.items() if k.startswith("head.out.")}}
        same = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        log(f"[20] {kind} {cfg.in_size[0]}x{cfg.in_size[1]}: reference file "
            f"{os.path.getsize(src) / 2**20:.0f} MiB (legacy format, {prefix or 'no'} prefix), "
            f"converted ({' '.join(argv)}): {len(got)} tensors "
            f"{'bitwise equal to' if same else 'DIFFERENT from'} the seeded model's; "
            f"{time.perf_counter() - t:.1f} s")
        if not same:
            bad = sorted(set(got) ^ set(want)) or [k for k in want if not torch.equal(got[k],
                                                                                    want[k])]
            raise AssertionError(f"[20] {kind}: converted state differs at {bad[:4]}")
        del model, got, want
    return files


def phase_reference_serve(card: str, work: str, files: dict, sizes: dict) -> dict:
    """Phase 20 step 2: ``cli.test.main`` over 12 seeded 1024x2048 PNG frames
    with each reference file as its checkpoint path (TD4-PSP18 f32 and bf16,
    TD2-PSP50 and PSP-101 bf16 with ``--stem_impl fused``): "Loading pretrained
    model" printed, the saved class maps bitwise equal to those of a
    ``Streamer`` / ``FrameRunner`` on the seeded model over the same frames,
    K1 3 a warm TD4 frame and 1 a warm TD2 frame, K4 1 a frame, the error word
    clear. Returns the runs' launches by kernel and dtype."""
    import io
    from tdnet_tpu_torch.cli import test as cli_test
    from tdnet_tpu_torch.data.png import read_png, write_png
    from tdnet_tpu_torch.data.streaming import CITYSCAPES_COLORS, FrameSource, decode_segmap
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.fused_stem import fused_stem_tail
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    from tdnet_tpu_torch.stream.runtime import FrameRunner, Streamer
    frames_dir = os.path.join(work, "frames", "clip")
    os.makedirs(frames_dir)
    rng = np.random.RandomState(REF_SEED)
    h, w = TREE_SIZE
    scene = np.repeat(np.repeat(rng.randint(0, 256, (h // 16, w // 16 + 2, 3)), 16, 0), 16, 1)
    for t in range(N_FRAMES):
        write_png(os.path.join(frames_dir, f"frame_{t:03d}.png"),
                  scene[:, 2 * t:2 * t + w].astype(np.uint8), level=1)
    launches = {"K1 f32": 0, "K1 bf16": 0, "K4 bf16": 0}
    for kind, dtype, stem in (("td4-psp18", "float32", "plain"), ("td4-psp18", "bfloat16", "plain"),
                              ("td2-psp50", "bfloat16", "fused"), ("psp101", "bfloat16", "fused")):
        tag = f"{kind} {dtype} stem {stem}"
        out_dir = os.path.join(work, "out", kind + "-" + dtype)
        size = sizes[kind]
        argv = ["--img_path", os.path.dirname(frames_dir), "--output_path", out_dir,
                "--model", kind, f"--_{kind.replace('-', '_')}_path", files[kind],
                "--device", "cuda", "--dtype", dtype, "--stem_impl", stem,
                "--in_size", str(size[0]), str(size[1])]
        fused_propagation_attention.launches = fused_stem_tail.launches = 0
        printed = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli_test.main(argv)
        wall = time.perf_counter() - t
        check_fault("cuda")
        n = (fused_propagation_attention.launches, fused_stem_tail.launches)
        lines = printed.getvalue().splitlines()
        window = {"td4-psp18": 3, "td2-psp50": 1, "psp101": 0}[kind]
        want = (window * (N_FRAMES - window), N_FRAMES if stem == "fused" else 0)
        if not (any(ln.startswith("Loading pretrained model from") for ln in lines)
                and n == want):
            raise AssertionError(f"[20] cli.test {tag}: launches K1/K4 {n} (expected {want}); "
                                 f"printed {lines[:2]}")
        launches["K1 f32" if dtype == "float32" else "K1 bf16"] += n[0]
        launches["K4 bf16"] += n[1]
        model, cfg = seeded_model(kind, size)
        runner = (FrameRunner if kind == "psp101" else Streamer)(
            model.to("cuda"), dtype=getattr(torch, dtype), stem_impl=stem)
        rows = np.arange(size[0] // 4) * size[0] // (size[0] // 4)
        cols = np.arange(size[1] // 4) * size[1] // (size[1] // 4)
        same = 0
        for x, name, folder, _ in FrameSource(os.path.dirname(frames_dir), size):
            pred = runner.step(torch.from_numpy(x), timed=False)[0][0].argmax(-1)
            want_map = decode_segmap(pred.to(torch.uint8).cpu().numpy()[rows][:, cols],
                                     CITYSCAPES_COLORS)
            same += np.array_equal(read_png(os.path.join(out_dir, folder, name)), want_map)
        check_fault("cuda")
        log(f"[20] cli.test {tag} ({card}), {size[0]}x{size[1]}: {lines[0]}; "
            f"{lines[-2].strip()}; launches K1 {n[0]} K4 {n[1]}; class maps of {same} of "
            f"{N_FRAMES} frames bitwise equal to the seeded model's own run; {wall:.1f} s")
        if same != N_FRAMES:
            raise AssertionError(f"[20] cli.test {tag}: {N_FRAMES - same} class maps differ")
        del model, runner
        torch.cuda.empty_cache()
    return launches


def phase_reference_train(card: str, work: str, root: str, files: dict, sizes: dict) -> dict:
    """Phase 20 steps 3 and 4: ``cli.train.train`` on phase 19's tree with the
    YAML at full width, batch 2: 2 iterations with ``training.resume`` a seeded
    PSPNet-18 source and ``teacher.teacher_model`` the PSP-101 reference file,
    every path's backbone and PSP bitwise the source's, path p's head conv
    ``grouped_head_conv(w, 2, p % 2)`` (its bn and out the source's), the
    teacher's group convs the gathered columns of PSP-101's; then 1 iteration
    without ``resume``, a seeded torchvision ResNet-18 in the store's local
    cache (``resnet18-<its sha256 prefix>.pth``), every path's backbone bitwise
    the file's. Both checked before the first step; losses finite, K2 and K3
    3 + 3 a step, the error word clear. Returns the launches by kernel."""
    import logging
    from tdnet_tpu_torch import models
    from tdnet_tpu_torch.cli import train as cli_train
    from tdnet_tpu_torch.kernels.dropout import dropout
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
    from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
    from tdnet_tpu_torch.train import trainer
    from tdnet_tpu_torch.utils.config import load_config
    from tdnet_tpu_torch.utils.surgery import grouped_head_conv
    src, src_cfg = seeded_model("psp18", sizes["td4-psp18"])
    source = {k: v.detach().clone() for k, v in src.state_dict().items()}
    files["psp18"] = os.path.join(work, "psp18.pkl")
    write_reference(files["psp18"], reference_state(src, src_cfg, "psp_source"))
    psp101 = {k: v.detach().clone() for k, v in seeded_model("psp101", sizes["psp101"])[0]
              .state_dict().items()}
    backbone, backbone_cfg = seeded_model("resnet18", None)
    imagenet = {k: v.detach().clone() for k, v in backbone.state_dict().items()}
    store = os.path.join(work, "torch_home", "hub", "checkpoints")
    os.makedirs(store)
    tmp = os.path.join(store, "resnet18.tmp")
    torch.save(reference_state(backbone, backbone_cfg, "torchvision"), tmp)
    with open(tmp, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    os.replace(tmp, os.path.join(store, f"resnet18-{sha[:8]}.pth"))
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "td4_psp18_cityscapes.yml"))
    cfg["data"]["path"] = root
    cfg["teacher"]["teacher_model"] = files["psp101"]
    cfg["training"].update(batch_size=2, val_interval=1000, print_interval=1, ckpt_interval=0)
    counters = ((propagation_attention_train, "launches"),
                (propagation_attention_train, "backward_launches"),
                (dropout, "launches"), (dropout, "backward_launches"),
                (fused_propagation_attention, "launches"))
    total = [0] * len(counters)
    real_state, real_freeze = trainer.make_train_state, models.freeze
    logger = logging.getLogger("tdnet_tpu_torch.chip_smoke")

    def run(tag, iters, resume, torch_home):
        """The students as ``make_train_state`` gets them and the teacher as
        ``freeze`` gets it from the file, both before the first (timed) step."""
        seen = {}

        def record_state(model, **kw):
            seen["model"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            return real_state(model, **kw)

        def record_freeze(teacher):
            seen["teacher"] = {k: v.detach().cpu().clone() for k, v in teacher.state_dict().items()}
            return real_freeze(teacher)
        run_cfg = copy.deepcopy(cfg)
        run_cfg["training"].update(train_iters=iters, resume=resume)
        run_dir = os.path.join(work, "run-" + tag)
        os.makedirs(run_dir)
        for fn, attr in counters:
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        saved_home = os.environ["TORCH_HOME"]
        os.environ["TORCH_HOME"] = torch_home
        t = time.perf_counter()
        try:
            with swapped(trainer, "make_train_state", record_state), \
                    swapped(models, "freeze", record_freeze):
                cli_train.train(run_cfg, logger, run_dir, device="cuda", stats=stats)
        finally:
            os.environ["TORCH_HOME"] = saved_home
        check_fault("cuda")
        n = len(stats["step_s"])
        launches = [getattr(fn, attr) for fn, attr in counters]
        for i, x in enumerate(launches):
            total[i] += x
        if not (n == iters and np.all(np.isfinite(stats["losses"]))
                and launches[:4] == [3 * n] * 4):
            raise AssertionError(f"[20] train {tag}: losses {stats['losses']}, launches "
                                 f"{launches}")
        log(f"[20] cli.train {tag} ({card}): {n} steps of batch 2 at "
            f"{sizes['td4-psp18'][0]}x{sizes['td4-psp18'][1]}; losses "
            f"{', '.join(f'{x:.4f}' for x in stats['losses'])}; ms a step "
            f"{ms_list(stats['step_s'])} (waiting on ClipBatcher {ms_list(stats['data_s'])}); "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches K2 "
            f"fwd/bwd {launches[0]}/{launches[1]}, K3 fwd/bwd {launches[2]}/{launches[3]}, K1 "
            f"{launches[4]}; {time.perf_counter() - t:.1f} s in all")
        return seen

    def held(tag, pairs):
        bad = [name for name, got, want in pairs if not torch.equal(got, want)]
        log(f"[20] {tag}: {len(pairs) - len(bad)} of {len(pairs)} tensors bitwise equal")
        if bad:
            raise AssertionError(f"[20] {tag}: {bad[:4]} differ")

    seen = run("bootstrap", 2, files["psp18"], os.environ["TORCH_HOME"])
    student, teacher = seen["model"], seen["teacher"]
    pairs = []
    for p in range(4):
        pairs += [(f"paths.{p}.{k}", student[f"paths.{p}.{k}"], v) for k, v in source.items()
                  if k.startswith("backbone.")]
        pairs += [(f"paths.{p}.{k[5:]}", student[f"paths.{p}.{k[5:]}"], v)
                  for k, v in source.items() if k.startswith("head.psp.")]
        pairs += [(f"paths.{p}.{k}", student[f"paths.{p}.{k}"], v) for k, v in source.items()
                  if k.startswith(("aux.", "head.out."))]
        pairs += [(f"paths.{p}.head.bn.{k[13:]}", student[f"paths.{p}.head.bn.{k[13:]}"], v)
                  for k, v in source.items() if k.startswith("head.conv.bn.")]
        pairs.append((f"paths.{p}.head.conv.weight", student[f"paths.{p}.head.conv.weight"],
                      grouped_head_conv(source["head.conv.conv.weight"], 2, p % 2)))
    held("the bootstrapped students before step 1 against the PSPNet-18 source", pairs)
    held("the teacher against the PSP-101 file", [
        (f"groups.{g}.weight", teacher[f"groups.{g}.weight"],
         grouped_head_conv(psp101["head.conv.conv.weight"], 4, g)) for g in range(4)] + [
        (k, teacher[k], v) for k, v in psp101.items() if k.startswith("backbone.")])
    seen = run("imagenet", 1, os.path.join(work, "no_source.pkl"),
               os.path.join(work, "torch_home"))
    held("every path's backbone before step 1 against the store's resnet18 file", [
        (f"paths.{p}.backbone.{k}", seen["model"][f"paths.{p}.backbone.{k}"], v)
        for p in range(4) for k, v in imagenet.items()])
    return {"fwd": total[0], "bwd": total[1], "drop": total[2] + total[3], "K1 f32": total[4]}


def phase_reference(card: str, root: str) -> dict:
    """Phase 20: the reference's checkpoints at full width (steps 1-4 above);
    returns its launches by kernel."""
    import shutil
    from tdnet_tpu_torch.models import STREAM_SIZE
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase20")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    files = phase_reference_convert(work, STREAM_SIZE)
    launches = phase_reference_serve(card, work, files, STREAM_SIZE)
    trained = phase_reference_train(card, work, root, files, STREAM_SIZE)
    launches["K1 f32"] += trained.pop("K1 f32")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(root), ignore_errors=True)
    log(f"[20] {time.perf_counter() - t0:.1f} s in all")
    return {**launches, **trained}


def ms_list(xs) -> str:
    return ", ".join(f"{1e3 * x:.1f}" for x in xs)


def main() -> int:
    card = phase_toolchain()
    offline_store(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "store"))
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = phase_kernel(card)

    from tdnet_tpu_torch.models import STREAM_SIZE
    td4, td2 = STREAM_SIZE["td4-psp18"], STREAM_SIZE["td2-psp50"]
    f32_frames = stream_frames(td4, torch.float32)
    outs32, n32, _ = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3")
    with plain_attention():
        plain, _, _ = run_stream("td4-psp18", td4, torch.float32, f32_frames, card, "3-plain",
                                 kernel=False)
    check_close("3", outs32, plain, 1e-3, "kernel-path vs plain-attention f32")
    del plain, f32_frames
    phase_tf32_defaults(card, td4, outs32)

    bf16_frames = stream_frames(td4, torch.bfloat16)
    outs16, n16, _ = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4")
    with plain_attention():
        plain, _, _ = run_stream("td4-psp18", td4, torch.bfloat16, bf16_frames, card, "4-plain",
                                 kernel=False)
    check_close("4", outs16, plain, 3e-2, "kernel-path vs plain-attention bf16")
    check_close("4", outs16, outs32, 5e-2, "bf16 vs f32")
    del outs16, outs32, plain, bf16_frames

    outs2, n2 = phase_td2_stream(card, td2)
    launches = {"f32": n32, "bf16": n16 + n2}

    phase_train_build()
    k2 = phase_train_attention(card)
    k2_bf16 = phase_train_attention_bf16(card)
    phase_step_inputs_bf16(card)
    k3 = phase_dropout(card)
    k3_bf16 = phase_dropout(card, torch.bfloat16)
    recipe, train_launches = phase_train(card)

    k4 = phase_stem_kernel(card)
    stem_launches = {"f32": 0, "bf16": 0}
    td2_frames = stream_frames(td2, torch.bfloat16)
    fused2, _, stem_launches["bf16"] = run_stream("td2-psp50", td2, torch.bfloat16, td2_frames,
                                                  card, "11", stem_impl="fused")
    td2_frames = stream_frames(td2, torch.float32)
    fused32, _, stem_launches["f32"] = run_stream("td2-psp50", td2, torch.float32, td2_frames,
                                                  card, "11-f32", stem_impl="fused")
    plain32, _, _ = run_stream("td2-psp50", td2, torch.float32, td2_frames, card,
                               "11-f32-plain")
    check_close("11", fused32, plain32, 1e-3, "fused-stem vs plain-stem f32")
    report_bf16_stream("11", fused2, outs2, plain32, "fused-stem vs plain-stem bf16")
    del fused2, outs2, fused32, plain32, td2_frames
    for name, n in phase_psp101(card).items():
        stem_launches[name] += n
    k5 = phase_dilated_conv(card)
    k5_bf16 = phase_dilated_conv_bf16(card)
    k5_launches = phase_train_k5(card, *recipe)
    bf16_launches = phase_train_bf16(card, *recipe)
    k5_bf16_launches = phase_train_bf16_k5(card, *recipe)
    del recipe
    td2_launches = phase_td2_train(card)
    phase_fused_trunk(card, td4, td2)
    root = phase_train_cli(card)
    reference = phase_reference(card, root)
    launches["f32"] += reference["K1 f32"]
    launches["bf16"] += reference["K1 bf16"]
    stem_launches["bf16"] += reference["K4 bf16"]
    train_launches = {k: n + reference[k] for k, n in train_launches.items()}

    src = "tdnet_tpu_torch/csrc/"
    entries = [{"name": f"propagation_attention_{dt}", "route": "cuda",
                "source": src + "propagation_attention.cu",
                "replaces": "tdnet_tpu/kernels/propagation_attention.py:127",
                "launches": launches[dt], **k1[dt]} for dt in ("f32", "bf16")]
    entries += [
        {"name": "propagation_attention_train_fwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:154",
         "launches": train_launches["fwd"], **k2["fwd"]},
        {"name": "propagation_attention_train_bwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:188",
         "launches": train_launches["bwd"], **k2["bwd"]},
        {"name": "dropout", "route": "cuda", "source": src + "dropout.cu",
         "replaces": "tdnet_tpu/kernels/dropout.py:38",
         "launches": train_launches["drop"], **k3},
        {"name": "propagation_attention_train_bf16_fwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:154",
         "launches": bf16_launches["fwd"], **k2_bf16["fwd"]},
        {"name": "propagation_attention_train_bf16_bwd", "route": "cuda",
         "source": src + "propagation_attention_train.cu",
         "replaces": "tdnet_tpu/kernels/propagation_attention_train.py:188",
         "launches": bf16_launches["bwd"], **k2_bf16["bwd"]},
        {"name": "dropout_bf16", "route": "cuda", "source": src + "dropout.cu",
         "replaces": "tdnet_tpu/kernels/dropout.py:38",
         "launches": bf16_launches["drop"], **k3_bf16}]
    entries += [{"name": f"fused_stem_{dt}", "route": "cuda", "source": src + "fused_stem.cu",
                 "replaces": "tdnet_tpu/kernels/fused_stem.py:199",
                 "launches": stem_launches[dt], **k4[dt]} for dt in ("f32", "bf16")]
    entries += [{"name": f"dilated_conv_{part}", "route": "cuda",
                 "source": src + "dilated_conv.cu",
                 "replaces": "tdnet_tpu/kernels/dilated_conv.py:87",
                 "launches": k5_launches[part] + td2_launches["f32"][part], **k5[part]}
                for part in ("fwd", "dgrad")]
    entries += [{"name": f"dilated_conv_bf16_{part}", "route": "cuda",
                 "source": src + "dilated_conv.cu",
                 "replaces": f"tdnet_tpu/kernels/dilated_conv.py:{line}",
                 "launches": k5_bf16_launches[part] + td2_launches["bf16"][part],
                 **k5_bf16[part]} for part, line in (("fwd", 87), ("dgrad", 127))]
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
