#!/usr/bin/env python3
"""Drives the PyTorch port (object_detector_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ with nvcc, one process per source
     (a source built before, unchanged, is reused); print each kernel's
     registers and spills (ptxas), its SASS counts of the opcodes that show
     its design (cuobjdump: B6 and B2 must hold IMMA and no IDP4A, the NMS
     scan's warp route no block barrier) and the dynamic shared memory of
     B6 and of the NMS scan's two routes;
  3. hold the NMS kernel against its plain PyTorch version, bit-equal: at
     the SSD-300 bs=64 shape (R=1280 rows, k=512, max_out=100) on dense,
     sparse, tie-heavy and negative-corner rows; at 20, 80 and 5120 rows;
     at k = 1, 100, the warp route's widest row (512), the block route's
     narrowest (513) and the widest the wrapper takes (8192); hold the stem
     kernel (B2) against its plain version on saturating codes,
     all-negative biases, sizes whose pooled tiles are partial, one
     full-width image (bs=1) and quotients at or next to half-integers, and
     the L2Norm (B3) on all-zero pixels, C = 16 and C = 2048, a pixel count
     that leaves its persistent grid's last round partial, and values y at
     (n + 1/2) * s and one ulp either side, signed and past the clip;
  4. serve the full-width ssd300_vgg16_voc float model through the Predictor
     at bs=1 (seeded random weights), check that the NMS kernel ran, hold it
     against its plain version on that path's own rows, time it there (20
     rows) beside its bound and time the bs=1 p50;
  5. serve ssd300_infer_bs64 at bs=64 through make_predict_fn, check that the
     NMS kernel ran, hold its detections against the plain path, time img/s;
  6. profile both float paths and time the NMS kernel against its plain
     version on the bs=64 path's inputs (its device time by CUDA graph
     replay here and in phases 4, 18 and 21);
  7. serve ssd300_infer_bs64 at bs=64 through make_int8_predict_fn
     (calibrated on 8 synthesized images), on the B2 route (ODT_STEM_FP=0:
     conv1_1 through the engine's int8 conv, then B2, up to phase 23): check
     that the stem, L2Norm and
     NMS kernels all ran, hold the detections bit-equal to the same
     QuantParams run with the plain versions of the stem and L2Norm, hold
     each kernel (the NMS kernel too, on the rows the int8 logits give it)
     bit-equal to its plain version on the path's own inputs, time img/s;
  8. serve one image through Predictor(int8=True) at full width, bs=1: check
     that all three kernels ran, hold the stem and L2Norm kernels bit-equal
     to their plain versions on that path's own inputs (its conv1_1 codes
     (1, 300, 300, 64) and its tap (1, 38, 38, 512)) and the NMS kernel on
     that path's rows, hold the served
     detections bit-equal to the same QuantParams run with the plain
     versions, and time its p50 beside the float path's;
  9. profile both int8 paths and time the stem and L2Norm kernels
     against their plain versions and their bounds on the bs=64 and the
     bs=1 path's own inputs (by CUDA-graph replay), the stem also beside
     its GEMM yardstick (conv1_2 as one torch._int_mm over im2col rows
     laid out beforehand);
 10. check the outputs against a reference on small inputs: the card against
     the CPU, float32 with TF32 off, for the tiny config's detections and the
     full-width model's logits; and on the same QuantParams, the int8 tap
     codes (tiny and full width) and the tiny config's int8 detections;
 11. hold the pool-backward kernel bit-equal to its plain PyTorch version at
     the four SSD-300 bs=32 pool shapes in bfloat16 and at one in float32, on
     random, tie-heavy (post-ReLU), three-level (the maximum ties at any
     positions), all-zero and negative-zero inputs, and on a small
     (1, 6, 10, 3) case whose 3 channels take the one-channel route;
     report whether ATen's max-pool backward is bit-equal on the same inputs;
 12. train full-width ssd300_vgg16_voc with model.pool_grad_kernel=True at
     bs=32 in bfloat16 through train(): the synthetic dataset, augmentation
     on, seeded random weights, DecodedCache, epoch_batches, the prefetcher,
     a checkpoint; check every loss finite and 4 pool-kernel launches a step;
 13. hold the training path: the kernel equals its plain version bit for bit
     on that path's own activations and cotangents at each of the four
     pools, and one step's gradients through the kernel equal the same
     step's through the plain version;
 14. overfit one batch (no augmentation, no warmup): the loss falls;
 15. one step's loss and gradients on the card against the CPU (tiny_test,
     float32, TF32 off);
 16. time the training step at bs=32, profile it, and time the pool kernel
     at the path's four shapes beside its bound, its plain version and
     ATen's max-pool backward;
 17. hold the fused ResNet stem and the fused bottleneck kernels bit-equal
     to their plain PyTorch versions on synthetic cases: the stem on random
     and saturated inputs with extreme biases, on a size whose pooled H/4
     and W/4 its 8 x 16 tile does not divide, on pixels at (n + 1/2) *
     in_scale and one ulp either side (the input quantize's ties), on
     quotients y / out_scale at or next to half-integers (the requant's
     ties) and on one full-width 512 x 512 image; the bottleneck at each of
     ResNet-50's four shapes, on H and W that its tile does not divide, with
     a large conv1 bias (a halo pixel outside the image that was not zeroed
     would show), on a zero input, at its narrowest widths (C = Cm = 64), at
     widths that are not powers of two (C = 448, Cm = 320) and on codes
     whose quotients y / s lie at or next to half-integers (deq = s / 2);
 18. serve full-width ssd512_resnet50_coco (seeded random weights, seeded
     non-trivial BatchNorm statistics) in float at bs=64 through
     make_predict_fn: check that the NMS kernel ran (5120 rows), hold it
     against its plain version on that path's rows, time it there beside its
     plain version and its bound from those rows, time img/s;
 19. serve it in int8 at bs=64 through make_int8_predict_fn (calibrated on 8
     seeded images): check that the stem kernel ran once, the bottleneck
     kernel 12 times and the NMS kernel once a forward; hold the detections
     bit-equal to the same QuantParams run with the plain versions, and each
     kernel bit-equal to its plain version on the path's own inputs (the
     normalized images; the input of each of the twelve blocks; the 5120
     rows the int8 logits give the NMS kernel); hold the bottleneck-only spec
     bit-equal to the unfused spec at every tap, the stem within one code of
     the unfused chain, and the spec with both kernels within a stated mean
     code difference of the unfused spec at each tap; time img/s with the kernels
     and with the unfused spec (ODT_STEM_KERNEL=0, ODT_FUSED_BOTTLENECK=0)
     on the same QuantParams;
 20. time the stem kernel and each of the twelve bottleneck launches on the
     bs=64 path's inputs beside their bounds, their plain versions, the
     engine's unfused chain for the same work (which must give the
     bottleneck's codes, and the stem's within one code on 1e-4 of them: the
     chain divides where the stem multiplies by the reciprocal) and the
     products alone as torch._int_mm on operands laid out beforehand (their
     GEMM yardsticks; the stem's and its own time by CUDA graph replay);
 21. serve one image through the Predictor in float and in int8 at bs=1: the
     same launch counts, the kernels bit-equal to their plain versions on
     that path's inputs (the NMS kernel on the (80, 512) rows of the float
     and of the int8 path), the served detections equal to the plain
     versions' run, p50 and a profile of both, the bottleneck's twelve
     launches timed on that path's inputs, the stem kernel on that path's
     image beside the same comparisons as in phase 20, and the NMS kernel on
     the float path's 80 rows;
 22. on a small ResNet-50 config (64 px): the float32 logits and the int8 tap
     codes, logits and detections on the card against the CPU (the CPU runs
     the kernels' plain versions), and what bfloat16 gives on the card
     against the CPU's float32;
 23. hold B4 (all of VGG block 1 in one kernel) bit-equal to its plain
     version on synthetic cases: saturating codes, all-negative biases, a
     zero input, a large positive conv1_1 bias, a size whose pooled tiles
     are partial, bs=1, quotients at or next to half-integers;
 24. serve ssd300_infer_bs64 at bs=64 in int8 with B4 selected
     (ODT_STEM_FP=1): one B4 launch and no B2 launch a forward, the
     detections bit-equal to the plain versions' run and to the B2 route's on
     the same QuantParams, B4, B3 and B1 bit-equal to their plain versions on
     the path's own inputs; img/s of both routes in turns and a profile; B4
     timed on the path's input codes beside its bound, its plain version,
     the chain it replaces (which must give its codes), its GEMM yardstick
     and B2 on the chain's conv1_1 codes (B2 runs B4's conv1_2 stage);
 25. serve one image through Predictor(int8=True) with B4 selected: the same
     launch counts and holds, the served detections equal to the B2 route's,
     the p50 of both routes in turns and a profile;
 26. resume phase 12's training for 100 steps without warmup, then run
     `evaluate` through the CLI's main, in-process, on that checkpoint, over
     the 64-image synthetic set it learned at eval.batch_size=48 (two
     batches, the second overlapping the first): int8 with B4 (two B4
     launches, mAP above 0), int8 on the B2 route (the same mAP dict) and
     float (the same keys), each a voc07 dict of finite values; time each in
     img/s, and the sweep alone on a built cache;
 27. serve full-width retinanet_fpn_coco (seeded random weights, seeded
     non-trivial BatchNorm statistics; 49104 anchors) in float at bs=64
     through make_predict_fn: the NMS kernel once and no other kernel, held
     against its plain version on the path's 5120 rows and timed there
     beside its bound; img/s; a profile of the call and of each stage
     (normalize, trunk, FPN, heads, postprocess) on its own;
 28. serve it in int8 at bs=64 through make_int8_predict_fn (calibrated on 8
     seeded images): B6 once, B7 twelve times and B1 once a forward; the
     detections bit-equal to the same QuantParams run with the plain
     versions, each kernel bit-equal to its plain version on the path's own
     inputs (images, the twelve blocks' inputs, the 5120 rows); the
     bottleneck-only spec bit-equal to the unfused spec at the three trunk
     taps and every FPN and head requant point, the spec with both kernels
     within stated mean code differences of it at the taps and P3 to P7;
     img/s with the kernels and on the unfused spec; B6, B7 and B1 timed on
     the path's inputs; a profile of the call and of each stage;
 29. serve one image through the Predictor in float and in int8 at bs=1:
     the same launch counts, the kernels held on the path's inputs (B1 on its
     80 rows), the served detections equal to the plain versions' run, the
     p50 of both beside the device busy time of a profile window;
 30. tiny_retinanet_config (128 px) on the card against the CPU: float32
     logits within 1e-3 with TF32 off; on the CPU's QuantParams the int8
     taps, the codes at every FPN and head requant point and the logits
     bit-equal and the detections equal; evaluate_dataset in float and int8
     on the card, a COCO dict of finite values each, with their launches;
 31. train full-width ssd512_resnet50_coco (512 px, 80 classes, 24564
     anchors, bfloat16, BatchNorm with batch statistics) at bs=32 through
     train() on the synthetic set for 6 steps with a checkpoint: every
     metric finite with a positive anchor, all 106 running statistics moved
     from their init, finite, variances >= 0, no kernel launched; then the
     step on one augmented batch: median ms of 10 after warm-up, img/s,
     peak memory, a profile window, and its BatchNorm passes and its loss
     each profiled alone;
 32. the same for retinanet_fpn_coco (49104 anchors, mesh.data_parallel=1);
 33. serve each trained checkpoint through the CLI's main in-process:
     `predict --checkpoint` in float and --int8, each equal to a Predictor
     on the restored state_dict (the EMA or the params, with the running
     statistics), with one forward's launches (int8: B6 once, B7 twelve
     times, B1 once), the int8 kernels held bit-equal to their plain
     versions on the trained model's own inputs and the served detections
     equal to the plain versions' run; `evaluate --checkpoint` in float and
     int8 over the 64-image synthetic set, COCO dicts of finite values;
 34. one training step of the 64 px SSD/ResNet-50 config and of
     tiny_retinanet_config on the card against the CPU, in float64 compute
     and in float32 with TF32 off: loss, every gradient, the updated params
     and EMA and the running statistics, within the bounds
     `resnet_train_card_vs_cpu` states;
 35. tiny_test trained 60 steps at 5e-3 on 16 synthetic images (crop and
     expand off) on the card: the int8 engine's mAP within 0.08 of the
     float model's and above 0.3 (reference tests/test_e2e.py:76);
 36. data-parallel training over torch.distributed, two gloo ranks in
     processes of their own on the one card (NCCL refuses two ranks on one
     device): full-width ssd300_voc_train_dp8 at 32 images a rank (the
     preset's 256 / 8), the pool kernel on, augmentation on, float32 with
     TF32 off; one step through make_train_step(mesh=...) against one
     process's step at bs=64 from the same state and batch: loss within
     1e-4 relative, params and EMA within 2e-5 (the reference's dp8
     bounds), the ranks bit-equal, the pool kernel launched 4 times on each
     rank and bit-equal to its plain version on the rank's own inputs, the
     bytes all-reduced a step; then bfloat16 steps timed on each rank with
     the gradient all-reduce alone and a profile window (recorded: gloo
     stages CUDA tensors through the host);
 37. the same for full-width retinanet_fpn_coco at 2 images a rank (the
     preset's 32 / 16) with BatchNorm on the global batch's moments: in
     float64 the loss, params, EMA and the 106 running statistics within
     the CPU step tests' float64 bounds of one process at bs=4, float32
     recorded beside it, and the float64 step with per-rank moments
     outside those bounds;
 38. `train` under torch.distributed.run with one process on NCCL
     (ssd300_voc_train_dp8 at mesh.data_parallel=-1, bs=32, the pool kernel
     on): a group of one, imgs_per_sec_chip = imgs_per_sec, a checkpoint
     that `predict --checkpoint` serves (B1 once, held on its rows); the
     preset unmodified refused with the reference's "requested 8-way data
     parallelism but only 1 devices"; the step through an NCCL group of
     one timed against the step without a mesh at bs=32, in turns;
 39. hold the NMS scan's bfloat16-coordinate instantiation (the
     reference's coord_bf16) bit-equal to its plain version at the serving
     paths' shapes (1280, 5120, 80 and 20 rows of 512 columns; 5120 rows of
     class_top_k's 256 and 128), at k = 1, at a threshold whose bfloat16
     t / (1 + t) rounds through float32, and on its block route through
     per_class_nms_batched (80 rows of 896);
 40. the serving knobs, each alone and all together (per_level_heads,
     nms_class_top_k 256 and 128, nms_packed_sort, nms_coord_bf16), on
     int8 ssd512_resnet50_coco, retinanet_fpn_coco and ssd300_infer_bs64
     (B4) at bs=64 through make_int8_predict_fn: the launches a forward (one
     scan of the instantiation the coordinates pick), the scan held
     bit-equal to its plain version on each path's own rows with the
     detections through it equal to the plain path's, the per-level
     detection set equal to the concat path's, each knob's Jaccard index
     against the default path, the trunk kernels (B6 and B7, or B4 and B3)
     held on the knob path's inputs, img/s of each knob in turns with the
     default path, and the scan timed on each path's rows;
 41. model.remat_block1 on the ssd300_vgg16_voc bs=32 training step (bf16,
     augmentation and the pool kernel on): three steps with and without it
     from the same weights, seed and batch with cuDNN deterministic, the
     losses and parameters no further apart than two runs without it, 4
     pool-kernel launches a step either way, the peak memory of a step and
     the step ms in turns;
 42. torchvision-layout VGG16 (with its classifier) and ResNet-50 dicts at
     full width from the key and shape inventory (He-scaled, seeded), saved
     as .pth and converted by `python -m
     object_detector_tpu_torch.cli.convert_weights` in a subprocess, read by
     load_backbone_npz and grafted by inject_backbone into
     ssd300_infer_bs64 and ssd512_resnet50_coco; each served at bs=64 in
     float (B1 once, held on its rows) and int8 (B4, B3 and B1, or B6, B7
     twelve times and B1, each held bit-equal to its plain version on the
     path's inputs), img/s recorded; three bs=32 fine-tuning steps of
     ssd300_vgg16_voc from the converted VGG16 with the pool kernel (4 B5
     launches a step, finite losses);
 43. utils.profiling: `trace` around two converted int8 SSD-300 bs=64
     calls writes a Chrome trace whose kernel events name B4, B3 and B1
     (a window's first kernel records can be lost after earlier profiler
     sessions; the count of each kernel's events is printed);
     `StepTimer` laps over 20 bs=32 fine-tuning steps within 5% of CUDA
     events on the same steps (medians); `enable_debug_checks` raises
     FloatingPointError on a NaN pixel in a forward on the card and not on
     the clean forward, and its handle undoes it;
 44. host work: 512 seeded smooth JPEGs (500x375 and 375x500) decoded into
     a DecodedCache at 300 px by the native pool and by PIL (forced), which
     decoder ran, each's images/s and thread count and the host's CPU; the
     two within the reference's mean absolute difference of 8; two gloo
     ranks on the card sharing one spill directory: both finish with the
     in-process cache's images and exactly one decodes. Without the pool's
     library, the reason, decoder "pil" and the PIL numbers only.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

R, K, MAX_OUT = 1280, 512, 100
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, int8 tensor-core
# operations/s, and float32 operations/s outside the tensor cores. The
# sheet's 67 TFLOP/s counts an FMA as two operations; the NMS scan and the
# L2Norm have no FMA (they build with -fmad=false), so each of their
# operations is one instruction at half that rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12 / 2
# float32 operations per column per emit step of the NMS scan: 2 argmax
# compares (greater, equal for the tie-break), 4 for iw (min, max, subtract,
# clamp), 3 for ih (min, max, subtract), 1 multiply for inter, 1 add for the
# right-hand side, 1 suppress compare. Integer work (the tie-break's column
# compare, c == w) is not counted.
NMS_OPS_PER_COLUMN_STEP = 2 + 4 + 3 + 1 + 1 + 1
# Per column once per row: 2 subtracts, 2 clamps, the area multiply and its
# multiply by t.
NMS_OPS_PER_COLUMN_HOISTED = 6
# float32 operations per element of the L2Norm: square and add into the
# sum, the two products, the divide, the rounding and the two clamps.
L2NORM_OPS_PER_ELEMENT = 2 + 2 + 1 + 1 + 2
# Compares per channel of a window in the pool backward: 3 for the maximum
# of four and 4 equalities. Counted against the float32 rate; the bytes win.
POOL_BWD_OPS_PER_WINDOW = 3 + 4
# The pools' inputs in an SSD-300 training step, (H, W, C) in the reference's
# terms; pool3's 75 x 75 is padded to 76 x 76.
TRAIN_BATCH = 32
POOL_SHAPES = ((300, 300, 64), (150, 150, 128), (76, 76, 256), (38, 38, 512))
# Overfitting one bs=32 batch of the synthetic dataset for OVERFIT_STEPS
# steps of SGD at OVERFIT_LR must bring the loss below OVERFIT_FALL of its
# first value. On an NVIDIA H100 80GB HBM3 (700 W) the loss went from 4.13 to
# 2.50, 0.605 of its start, falling at every tenth step.
OVERFIT_STEPS, OVERFIT_LR, OVERFIT_FALL = 60, 2e-3, 0.8


# The kernels the two int8 SSD-300 serving paths must launch on the B2 route
# (ODT_STEM_FP=0): conv1_1 through the engine's int8 conv, then B2.
INT8_PATH_KERNELS = ("nms_rows", "stem_conv12_pool", "l2norm_requant")
# Launches of one int8 SSD-300 forward with B4 selected (ODT_STEM_FP=1).
STEM_FP_LAUNCHES = {"nms_rows": 1, "nms_rows_bf16": 0, "stem_conv12_pool": 0,
                    "l2norm_requant": 1, "max_pool_bwd": 0, "resnet_stem": 0,
                    "fused_bottleneck": 0, "stem_fused_producer": 1}
# The evaluate phase: the synthetic set's 64 images at eval.batch_size=48 are
# two batches, the second overlapping the first by 32 rows.
EVAL_BATCH, EVAL_IMAGES = 48, 64
# Steps the evaluate phase trains phase 12's checkpoint on before it sweeps.
EVAL_TRAIN_STEPS = 100
# Launches of one int8 SSD-512/ResNet-50 forward: the stem once, the
# bottleneck kernel for blocks 2 and later of the four stages (2 + 3 + 5 + 2),
# the NMS scan once; no kernel of the VGG path.
RESNET_INT8_LAUNCHES = {"resnet_stem": 1, "fused_bottleneck": 12, "nms_rows": 1,
                        "nms_rows_bf16": 0, "stem_conv12_pool": 0, "l2norm_requant": 0,
                        "max_pool_bwd": 0, "stem_fused_producer": 0}
# (C, Cm, H = W) of the bottleneck kernel's inputs at 512 px, with the number
# of blocks of each stage that run it.
RESNET_BLOCKS = ((256, 64, 128, 2), (512, 128, 64, 3), (1024, 256, 32, 5), (2048, 512, 16, 2))
# Limits on the mean code difference at each of SSD-512's seven taps between
# the spec with both kernels and the unfused spec on the same QuantParams.
TAP_MEAN_CODE_DIFF_LIMITS = (0.01, 0.1, 0.2, 0.3, 0.3, 0.5, 0.5)
# Limits on the mean code difference between the spec with both kernels and
# the unfused spec on the same QuantParams, at RetinaNet's three trunk taps
# and its five pyramid levels. A drift alarm: the guard is the
# bottleneck-only spec, bit-equal to the unfused spec at every requant point.
# An NVIDIA H100 80GB HBM3 (700 W) read 0.0017, 0.023, 0.049 of a code at C3
# to C5 and 0.112, 0.117, 0.146, 0.162, 0.213 at P3 to P7 (at most 10 codes
# anywhere); the limits are one and a half to three times those.
# Steps train() takes on each ResNet-50 family at full width (phases 31 and
# 32), and the steps timed after warm-up on one batch.
RESNET_TRAIN_STEPS, RESNET_TIMED_STEPS = 6, 10
# Phase 35, the reference's tests/test_e2e.py setup and bounds: tiny_test
# trained E2E_STEPS steps at E2E_LR on E2E_IMAGES synthetic images, then
# |float mAP - int8 mAP| < E2E_MAX_GAP and int8 mAP > E2E_MIN_INT8.
E2E_STEPS, E2E_LR, E2E_IMAGES, E2E_MAX_GAP, E2E_MIN_INT8 = 60, 5e-3, 16, 0.08, 0.3
RETINANET_MEAN_CODE_DIFF_LIMITS = {"C3": 0.005, "C4": 0.04, "C5": 0.1, "fpn/P3": 0.2,
                                   "fpn/P4": 0.25, "fpn/P5": 0.3, "fpn/P6": 0.3, "fpn/P7": 0.35}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def rows_case(np, torch, kind: str, seed: int, rows: int = R, k: int = K):
    """(coords (4, rows, k), scores (rows, k)) on the card for one kernel case."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (2, rows, k))
    wh = rng.uniform(0.02, 0.3, (2, rows, k))
    coords = np.concatenate([xy, np.minimum(xy + wh, 1.0)]).astype(np.float32)
    if kind == "sparse":  # about 1% of candidates above 0.01
        scores = np.where(rng.uniform(0, 1, (rows, k)) < 0.01,
                          rng.uniform(0.01, 1, (rows, k)), rng.uniform(0, 0.01, (rows, k)))
    elif kind == "ties":  # five distinct scores, every box duplicated
        scores = rng.integers(0, 5, (rows, k)) / 4.0
        coords[:, :, 1::2] = coords[:, :, 0::2]
    else:  # dense; negative: corners outside [0, 1], the winner's are max(x[w], 0)
        scores = rng.uniform(0, 1, (rows, k))
        if kind == "negative":
            coords -= 0.4
    return (torch.from_numpy(coords).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed between CUDA events: the kernel's own time where a call is
    too short to hide the host's enqueue (cuda_ms would time the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int) -> list:
    """Host-clock times of fn() + synchronize, one per call, after 3 warmups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# Kernel-name fragments that group the profile's device time.
PROFILE_GROUPS = (
    ("nms_kernel", ("nms_rows_",)),
    ("stem_kernel", ("stem_conv12_pool_kernel",)),
    ("stem_fp_kernel", ("stem_fp_kernel",)),
    ("l2norm_kernel", ("l2norm_requant_kernel",)),
    ("pool_bwd_kernel", ("pool_bwd_kernel",)),
    ("resnet_stem_kernel", ("resnet_stem_kernel",)),
    ("bottleneck_kernel", ("bottleneck_kernel",)),
    ("conv_or_gemm", ("conv", "cudnn", "gemm", "xmma", "implicit", "wgrad", "dgrad", "cutlass",
                      "imma", "sm90")),
)


def profile_window(torch, fn, iters: int) -> dict:
    """Device time by kernel over iters calls of fn() (torch.profiler), the
    device's busy share of the window's wall time, and the device operations
    (kernels and copies) a call issues. Reports "not measured" if the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    launched = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels[e.key] = kernels.get(e.key, 0.0) + us
        launched += e.count
    busy_us = sum(kernels.values())
    if busy_us <= 0:
        return {"device_time": "not measured"}
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, us in kernels.items():
        low = name.lower()
        group = next((g for g, frags in PROFILE_GROUPS if any(f in low for f in frags)), "other")
        groups[group] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_call": wall_us / iters / 1e3,
        "device_busy_ms_per_call": busy_us / iters / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops_per_call": launched / iters,
        "device_ms_per_call_by_group": {g: us / iters / 1e3 for g, us in groups.items()},
        "top_kernels_ms_per_call": [[name[:90], us / iters / 1e3] for name, us in top],
    }


# SASS opcodes that show a kernel's design: tensor-core products (IMMA), the
# CUDA cores' dot products (IDP4A), ldmatrix, cp.async, block barriers, warp
# shuffles and reductions.
SASS_OPS = ("IMMA", "IDP4A", "LDSM", "LDGSTS", "BAR", "SHFL", "REDUX")


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol, with its template arguments
    (the length-prefixed component that ends in "_kernel", then "I...E":
    integer literals "Li<n>E", "f" for float and length-prefixed type
    names), as in "nms_rows_kernel<__nv_bfloat16,16>"."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # a hash's digits may run into the length
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            if name.endswith("_kernel"):
                pos, args = m.end() + len(name), []
                if mangled.startswith("I", pos):  # the template argument list, up to its "E"
                    pos += 1
                    while arg := re.match(r"Li(\d+)E|f|(\d+)", mangled[pos:]):
                        pos += arg.end()
                        if arg.group(2):  # a type's name, its length first
                            args.append(mangled[pos:pos + int(arg.group(2))])
                            pos += int(arg.group(2))
                        else:
                            args.append(arg.group(1) or "float")
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def sass_counts(library: str) -> dict:
    """{kernel: {opcode: count}} for each kernel function of a built
    library, from `cuobjdump -sass` (kernel names shortened to the
    function and its template arguments)."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    check(CUDA_HOME is not None, "no CUDA toolkit found for cuobjdump")
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", library],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {library} failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = {op: 0 for op in SASS_OPS}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn is not None:
            # The opcode without its modifiers; the dot product prints as IDP.4A.
            op = "IDP4A" if m.group(1).startswith("IDP.4A") else m.group(1).split(".")[0]
            if op in SASS_OPS:
                counts[fn][op] += 1
    return counts


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    """(least ms, "bytes" or "operations") for work of these sizes."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_bound_ms(scores_out, rows: int, k: int, max_out: int, coord_bytes: int = 4):
    """Least time for the NMS scan on these inputs: bytes (4 coordinate
    planes of ``coord_bytes`` a value and the float32 scores read once, 2
    outputs written once) over HBM bandwidth, against the float32
    operations this data needs (each row runs its valid emits plus the one
    step that finds nothing, at most max_out) over the float32 peak. The
    bfloat16 instantiation does the same operations, each in float32 and
    then rounded."""
    steps = (scores_out > 0).sum(dim=1).add(1).clamp(max=max_out).sum().item()
    bytes_moved = 4 * rows * k * coord_bytes + rows * k * 4 + rows * max_out * 8
    ops = NMS_OPS_PER_COLUMN_STEP * k * steps + NMS_OPS_PER_COLUMN_HOISTED * rows * k
    return bound(bytes_moved, ops, F32_OPS_PER_S)


def nms_timing(torch, nms_kernel, held: dict, plain_iters: int) -> dict:
    """The NMS kernel on a path's captured rows (``hold_nms``'s result): its
    device time (a CUDA graph's replay, so that a launch shorter than the
    host's enqueue is still timed on the card), the plain version's time,
    and the bound from the rows each row really ran."""
    coords, scores, kwargs = held["coords"], held["scores"], held["kwargs"]
    rows, k = scores.shape
    bound_ms, bound_by = nms_bound_ms(held["kernel_scores"], rows, k, kwargs["max_out"],
                                      coords.element_size())
    return {"rows": rows, "k": k, "max_out": kwargs["max_out"], "coords": str(coords.dtype),
            "ms": graph_ms(torch, lambda: nms_kernel.nms_rows(coords, scores, **kwargs), 20),
            "plain_ms": cuda_ms(
                torch, lambda: nms_kernel.nms_rows_reference(coords, scores, **kwargs), plain_iters),
            "bound_ms": bound_ms, "bound_by": bound_by}


def stem_bound_ms(q1, out):
    """conv1_2's multiply-adds as 2 int8 operations each over the int8
    tensor-core peak, against q1 read once, the weights, deq and bias read
    once and the pooled codes written once."""
    b, h, w, c = q1.shape
    ops = 2 * b * h * w * c * c * 9
    bytes_moved = q1.numel() + 9 * c * c + 2 * 4 * c + out.numel()
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def l2norm_bound_ms(q0):
    """The tap read once and written once (and gamma), against the float32
    operations per element over the non-FMA float32 rate."""
    c = q0.shape[-1]
    return bound(2 * q0.numel() + 4 * c, L2NORM_OPS_PER_ELEMENT * q0.numel(), F32_OPS_PER_S)


def pool_bwd_bound_ms(x, g):
    """x and g read once, dx written once (the kernel recomputes the maximum
    and does not read y), against the compares over the float32 rate."""
    windows = g.numel()
    bytes_moved = (2 * x.numel() + g.numel()) * x.element_size()
    return bound(bytes_moved, POOL_BWD_OPS_PER_WINDOW * windows, F32_OPS_PER_S)


def stem_timing(torch, stem, args, kw) -> dict:
    """B2 on a path's own conv1_1 codes: its device time (a CUDA graph's
    replay), its plain version's, the GEMM yardstick's (conv1_2 as one
    torch._int_mm over im2col rows laid out beforehand, graph-replayed) and
    the bound."""
    q1 = args[0]
    out = stem.stem_conv12_pool(*args, **kw)
    bound_ms, bound_by = stem_bound_ms(q1, out)
    del out
    gemms = [(im2col3x3(torch, q1), col_major(args[1].reshape(576, 64)))]
    yardstick = sum(graph_ms(torch, lambda a=a, b=b: torch._int_mm(a, b), 5) for a, b in gemms)
    del gemms
    iters = 10 if q1.shape[0] > 1 else 50
    return {"input": list(q1.shape),
            "ms": graph_ms(torch, lambda: stem.stem_conv12_pool(*args, **kw), iters),
            "plain_ms": cuda_ms(torch, lambda: stem.stem_conv12_pool_reference(*args), 3),
            "gemm_yardstick_ms": yardstick, "bound_ms": bound_ms, "bound_by": bound_by}


def l2norm_timing(torch, l2norm, args) -> dict:
    """B3 on a path's own tap: its device time (a CUDA graph's replay), its
    plain version's and the bound."""
    bound_ms, bound_by = l2norm_bound_ms(args[0])
    return {"input": list(args[0].shape),
            "ms": graph_ms(torch, lambda: l2norm.l2norm_requant(*args), 50),
            "plain_ms": cuda_ms(torch, lambda: l2norm.l2norm_requant_reference(*args), 10),
            "bound_ms": bound_ms, "bound_by": bound_by}


def stem_fp_bound_ms(x_q, out):
    """Both convs' multiply-adds (27 and 576 a pixel and output channel) as 2
    int8 operations each over the int8 tensor-core peak, against the input
    codes read once, the two kernels, four vectors read once and the pooled
    codes written once."""
    b, h, w, _ = x_q.shape
    ops = 2 * b * h * w * 64 * (27 + 576)
    bytes_moved = x_q.numel() + (27 + 576) * 64 + 4 * 4 * 64 + out.numel()
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def resnet_stem_bound_ms(images, out):
    """The float image read once and the pooled codes written once (and the
    weights, deq and bias), against the 7x7 conv's multiply-adds as 2 int8
    operations each over the int8 tensor-core peak."""
    b, h, w, _ = images.shape
    ops = 2 * b * (h // 2) * (w // 2) * 64 * 147
    bytes_moved = images.numel() * 4 + out.numel() + 147 * 64 + 2 * 4 * 64
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def bottleneck_bound_ms(x, cm):
    """x read once and the output written once (and the three kernels and six
    vectors), against the three convs' multiply-adds as 2 int8 operations
    each over the int8 tensor-core peak."""
    c = x.shape[-1]
    pixels = x.numel() // c
    ops = 2 * pixels * (2 * c * cm + 9 * cm * cm)
    bytes_moved = 2 * x.numel() + 2 * c * cm + 9 * cm * cm + 4 * (4 * cm + 2 * c)
    return bound(bytes_moved, ops, INT8_OPS_PER_S)


def im2col3x3(torch, a):
    """(B, H, W, K) codes -> (B*H*W, 9*K) rows of a SAME 3x3, tap-major, the
    rows of the GEMM that a 3x3 conv is."""
    b, h, w, k = a.shape
    ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    return torch.cat([ap[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)],
                     dim=-1).reshape(b * h * w, 9 * k)


def col_major(w_kn):
    """A (K, N) right operand in column-major order, the layout cuBLASLt
    takes on its int8 tensor-core path."""
    return w_kn.t().contiguous().t()


def gemm_yardstick_ms(torch, gemms, iters: int) -> float:
    """Device ms of the products alone: one torch._int_mm a (rows, K) x (K, N)
    pair, on operands laid out beforehand, no epilogue. A yardstick of what
    cuBLASLt's tensor cores take for the same multiply-adds; the port never
    calls it."""
    return sum(cuda_ms(torch, lambda a=a, b=b: torch._int_mm(a, b), iters) for a, b in gemms)


def bottleneck_gemms(torch, x, w1, w2, w3):
    """The bottleneck's three products over its output pixels as GEMMs:
    x . w1, the 3x3's im2col rows of mid1 . w2, mid2 . w3 (mid codes drawn
    at random: the values do not change the time)."""
    b, h, w, c = x.shape
    cm = w1.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(20)
    mid = torch.randint(-127, 128, (b, h, w, cm), generator=gen, device=x.device,
                        dtype=torch.int8)
    return [(x.reshape(-1, c), col_major(w1)), (im2col3x3(torch, mid), col_major(w2.reshape(9 * cm, cm))),
            (mid.reshape(-1, cm), col_major(w3))]


def stem_fp_gemms(torch, x_q, w1, w2):
    """VGG block 1's two products over the pre-pool pixels as GEMMs: the
    input's im2col rows (27 codes padded to 32) . w1, and the 3x3's im2col
    rows of conv1_1's codes (drawn at random) . w2."""
    b, h, w, _ = x_q.shape
    rows1 = torch.nn.functional.pad(im2col3x3(torch, x_q), (0, 5))
    w1_kn = torch.nn.functional.pad(w1.reshape(27, 64), (0, 0, 0, 5))
    gen = torch.Generator(device=x_q.device).manual_seed(24)
    q1 = torch.randint(-127, 128, (b, h, w, 64), generator=gen, device=x_q.device,
                       dtype=torch.int8)
    return [(rows1, col_major(w1_kn)), (im2col3x3(torch, q1), col_major(w2.reshape(576, 64)))]


def resnet_stem_gemms(torch, int8_ops, images, w_q, in_scale):
    """B6's products as one GEMM: the quantized image's 7x7/s2 pad-3 im2col
    rows (147 codes, padded to 160) . the (160, 64) kernel."""
    pad = torch.nn.functional.pad
    x = int8_ops.quantize(images.clone(), int8_ops.scale_tensor(in_scale, images.device))
    b, h, w, _ = x.shape
    xp = pad(x, (0, 0, 3, 3, 3, 3))
    rows = torch.cat([xp[:, ky:ky + h:2, kx:kx + w:2] for ky in range(7) for kx in range(7)],
                     dim=-1)
    w_kn = pad(w_q.reshape(147, 64), (0, 0, 0, 13))
    return [(pad(rows.reshape(-1, 147), (0, 13)), col_major(w_kn))]


def resnet_stem_timing(torch, int8_ops, resnet_stem, qp, op, stem_args, stem_kw) -> dict:
    """B6 on a path's own stem inputs: its device time (a CUDA graph's
    replay), its plain version's, the engine's unfused chain's (which must
    stay within one code of the kernel on 1e-4 of the codes: it divides where
    the kernel multiplies by the reciprocal), the GEMM yardstick's (the same
    products as torch._int_mm on im2col rows laid out beforehand, device
    time) and the bound."""
    images = stem_args[0]
    out = resnet_stem.resnet_stem(*stem_args, **stem_kw)
    chain = unfused_stem(int8_ops, qp, op, images)
    diff = (out.int() - chain.int()).abs()
    vs_chain = {"max_code_diff": int(diff.max()),
                "share_differing": float((diff > 0).float().mean())}
    check(vs_chain["max_code_diff"] <= 1 and vs_chain["share_differing"] <= 1e-4,
          f"B6 on {tuple(images.shape)}: further from the unfused chain than one code on 1e-4 "
          f"of the codes: {vs_chain}")
    bound_ms, bound_by = resnet_stem_bound_ms(images, out)
    del out, chain, diff
    gemms = resnet_stem_gemms(torch, int8_ops, images, stem_args[1], stem_args[4])
    yardstick = sum(graph_ms(torch, lambda a=a, b=b: torch._int_mm(a, b), 5) for a, b in gemms)
    del gemms
    return {"input": list(images.shape),
            "ms": graph_ms(torch, lambda: resnet_stem.resnet_stem(*stem_args, **stem_kw), 20),
            "plain_ms": cuda_ms(torch, lambda: resnet_stem.resnet_stem_reference(*stem_args), 2),
            "unfused_chain_ms": cuda_ms(torch, lambda: unfused_stem(int8_ops, qp, op, images), 3),
            "gemm_yardstick_ms": yardstick, "bound_ms": bound_ms, "bound_by": bound_by,
            "vs_unfused_chain": vs_chain}


def main() -> int:
    started = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from object_detector_tpu_torch.anchors.priors import ssd_anchors
        from object_detector_tpu_torch.cli.predictor import Predictor
        from object_detector_tpu_torch.convert import init_params
        from object_detector_tpu_torch.core.config import get_config
        from object_detector_tpu_torch.data.voc import VOC_CLASSES
        from object_detector_tpu_torch.eval.evaluator import make_int8_predict_fn, make_predict_fn
        from object_detector_tpu_torch.data.pipeline import DecodedCache, make_place
        from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
        from object_detector_tpu_torch.core import config as port_config
        from object_detector_tpu_torch.cli.main import main as cli_main
        from object_detector_tpu_torch.eval.evaluator import evaluate_dataset
        from object_detector_tpu_torch.kernels import (
            bottleneck, build, l2norm, pool_bwd, resnet_stem, stem, stem_fp,
        )
        from object_detector_tpu_torch.kernels import nms as nms_kernel
        from object_detector_tpu_torch.anchors.priors import anchors_for_model, retinanet_anchors
        from object_detector_tpu_torch.models.retinanet import build_model
        from object_detector_tpu_torch.models.ssd import SSDModel
        from object_detector_tpu_torch.ops import int8 as int8_ops
        from object_detector_tpu_torch.ops import pooling
        from object_detector_tpu_torch.ops.augment import normalize
        from object_detector_tpu_torch.ops.postprocess import postprocess
        from object_detector_tpu_torch.quant import engine
        from object_detector_tpu_torch.train.loop import init_model_state, train
        from object_detector_tpu_torch.train.step import make_train_step
    except ImportError as e:
        fail(f"the object_detector_tpu_torch package is not importable here: {e}")

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    wrappers = kernel_wrappers()

    def counted(fn):
        """Runs the main path fn() with every launch count set to 0 just
        before; returns its result and the counts just after."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {name: w.launches for name, w in wrappers.items()}

    mark = [started]

    def mark_seconds(phases: str) -> None:
        """Prints the seconds that ``phases`` took (since the last mark) and
        the seconds since the script started."""
        now = time.perf_counter()
        print(json.dumps({"phase": "seconds", "phases": phases, "seconds": now - mark[0],
                          "since_start": now - started}))
        mark[0] = now

    # 1. The card.
    gpu = gpu_line()
    print(gpu)
    where = {"gpu": gpu}

    # 2. Build every kernel.
    t0 = time.perf_counter()
    logs = build.build()
    missing = [n for n in build.SOURCES if not build.library_path(n).exists()]
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(logs),
                      "already_built": sorted(set(build.SOURCES) - set(logs))}))
    check(not missing, f"no library for {missing} after the build")
    for name, log in logs.items():
        for line in log.splitlines():
            entry = line.find("Compiling entry function")
            if entry >= 0:
                print(f"ptxas[{name}]: " + kernel_name(line[entry:].split("'")[1]))
            elif "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    # What each kernel was built into: B6's and B2's products on the tensor
    # cores and none on __dp4a; the NMS scan's warp route without a block
    # barrier.
    sass = {name: sass_counts(str(build.library_path(name))) for name in build.SOURCES}
    for name, fns in sass.items():
        print(json.dumps({"phase": "sass", "library": name, "counts": fns}))
    for lib, fn in (("resnet_stem", "resnet_stem_kernel"), ("stem", "stem_conv12_pool_kernel")):
        counts = sass[lib].get(fn, {})
        check(counts.get("IMMA", 0) > 0 and counts.get("IDP4A", 1) == 0,
              f"{fn}'s SASS is not the tensor-core design: {counts}")
    # The counter sees __dp4a where a kernel has it: the L2Norm's sum of squares.
    check(all(c["IDP4A"] > 0 for c in sass["l2norm"].values()),
          f"no IDP4A counted in the L2Norm's SASS: {sass['l2norm']}")
    for prefix in ("nms_rows_kernel<float,", "nms_rows_kernel<__nv_bfloat16,"):
        warp_routes = {fn: c for fn, c in sass["nms"].items() if fn.startswith(prefix)}
        check(len(warp_routes) == 5 and all(c["BAR"] == 0 for c in warp_routes.values()),
              f"the NMS scan's warp route ({prefix}) is not five barrier-free kernels: "
              f"{warp_routes}")
    print(json.dumps({"phase": "dynamic_smem_bytes", "resnet_stem": resnet_stem.smem_bytes(),
                      "nms_rows_warp_route_block_at_k512": 4 * 512 * 16,
                      "nms_rows_block_route_per_column": 24,
                      "nms_rows_warp_route_max_k": nms_kernel.warp_route_max_k()}))
    check(nms_kernel.warp_route_max_k() == nms_kernel.WARP_ROUTE_MAX_K,
          "the built NMS library's warp route disagrees with WARP_ROUTE_MAX_K")

    # 3. Each kernel against its plain version on synthetic cases, bit-equal.
    # The NMS scan: the four kinds at the SSD-300 bs=64 shape, the bs=1
    # paths' 20 and 80 rows and SSD-512 bs=64's 5120; k = 1, a k that is not
    # a multiple of 32, the warp route's widest row and the block route's
    # narrowest, the block route's 48 KB of dynamic shared memory (2048
    # columns) and the widest row the wrapper takes.
    max_abs_err = 0.0
    widest = nms_kernel.WARP_ROUTE_MAX_K
    nms_cases = [("dense", R, K), ("sparse", R, K), ("ties", R, K), ("negative", R, K),
                 ("dense", 20, K), ("dense", 80, K), ("dense", 5120, K), ("dense", 64, 1),
                 ("ties", 64, 100), ("dense", 64, widest), ("dense", 64, widest + 1),
                 ("dense", 16, 2048), ("dense", 16, nms_kernel.MAX_K)]
    for i, (case, rows, k) in enumerate(nms_cases):
        coords, scores = rows_case(np, torch, case, seed=i, rows=rows, k=k)
        kw = dict(max_out=min(MAX_OUT, k), iou_threshold=0.45, score_threshold=0.01)
        got_s, got_c = nms_kernel.nms_rows(coords, scores, **kw)
        torch.cuda.synchronize()
        want_s, want_c = nms_kernel.nms_rows_reference(coords, scores, **kw)
        err = (got_s - want_s).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
              f"nms kernel differs from nms_rows_reference ({case}, {rows} x {k}): max_abs_err "
              f"{err}, {int((got_c != want_c).sum())} columns differ")
        print(json.dumps({"phase": "nms_kernel_vs_plain", "case": case, "rows": rows, "k": k,
                          "route": "warp" if k <= widest else "block", "bit_equal": True,
                          "emitted": int((got_s > 0).sum())}))
    del coords, scores, got_s, got_c, want_s, want_c
    gen = torch.Generator(device="cuda").manual_seed(1)
    stem_err = stem_kernel_cases(torch, stem, gen)
    l2norm_err = l2norm_kernel_cases(torch, np, l2norm, gen)

    cfg1 = get_config("ssd300_vgg16_voc")
    cfg64 = get_config("ssd300_infer_bs64")
    params = init_params(SSDModel(cfg1), seed=0).state_dict()
    anchors_np = ssd_anchors(cfg64.anchors, cfg64.model.image_size)
    rng = np.random.default_rng(0)
    launches = {}

    mark_seconds("1 to 3")

    # 4. Full-width SSD-300 through the Predictor, bs=1.
    predictor = Predictor(cfg1, params, VOC_CLASSES, device="cuda")
    image = rng.integers(0, 80, (375, 500, 3), dtype=np.uint8)
    image[100:300, 150:400] = (200, 60, 40)
    dets, launches["float_bs1"] = counted(
        lambda: predictor.predict_array(image, score_threshold=0.0))
    check(launches["float_bs1"]["nms_rows"] >= 1,
          "the bs=1 Predictor path never launched the NMS kernel")
    check(len(dets) > 0, "the bs=1 Predictor returned no detections")
    for d in dets:
        check(np.all(np.isfinite(d.box)) and 0 <= d.box[0] <= d.box[2] <= 500
              and 0 <= d.box[1] <= d.box[3] <= 375 and 0 < d.score <= 1,
              f"bad detection {d}")
    # The kernel against its plain version on the rows this path gave it.
    from PIL import Image

    s1 = cfg1.model.image_size
    canvas1 = np.array(Image.fromarray(image).resize((s1, s1), Image.BILINEAR), np.uint8)
    bs1_rows, _ = hold_path(torch, nms_kernel, normalize, predictor.model,
                            torch.from_numpy(canvas1[None]).cuda(), anchors_np, cfg1)
    check(bs1_rows["scores"].shape[0] == cfg1.model.num_classes,
          f"bs=1 NMS rows {tuple(bs1_rows['scores'].shape)}, expected one per class")
    max_abs_err = max(max_abs_err, bs1_rows["max_abs_err"])
    # The kernel at these 20 rows: one row's serial chain of emit steps sets
    # the time; 20 rows (five blocks) cannot fill 132 SMs.
    nms20 = nms_timing(torch, nms_kernel, bs1_rows, 3)
    predict1 = make_predict_fn(cfg1, predictor.model, anchors_np, device="cuda")
    canvas = rng.integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    p50_bs1 = statistics.median(host_ms(torch, lambda: predict1(canvas), 50))
    print(json.dumps({"phase": "predictor_bs1", "detections": len(dets),
                      "launches": launches["float_bs1"],
                      "nms_rows": list(bs1_rows["scores"].shape), "nms_timing": nms20,
                      "kernel_vs_plain_bit_equal": True, "p50_ms": p50_bs1, **where}))

    # 5. ssd300_infer_bs64 at bs=64 through make_predict_fn.
    model = SSDModel(cfg64)
    model.load_state_dict(params)
    predict = make_predict_fn(cfg64, model, anchors_np, device="cuda")
    images = torch.randint(0, 256, (64, 300, 300, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    predict(images)
    det, launches["float_bs64"] = counted(lambda: predict(images))
    check(launches["float_bs64"]["nms_rows"] >= 1, "the bs=64 path never launched the NMS kernel")
    check(det.boxes.shape == (64, cfg64.eval.max_detections, 4)
          and bool(torch.isfinite(det.boxes).all()) and bool(torch.isfinite(det.scores).all()),
          "bs=64 detections are not finite or have the wrong shape")

    bs64_rows, det_k = hold_path(torch, nms_kernel, normalize, model, images,
                                 anchors_np, cfg64)
    max_abs_err = max(max_abs_err, bs64_rows["max_abs_err"])
    with torch.inference_mode():
        same_as_postprocess = postprocess(*bs64_rows["head"],
                                          torch.from_numpy(anchors_np).cuda(), cfg64)
    check(torch.equal(same_as_postprocess.scores, det_k.scores),
          "postprocess() and decode_nms() disagree")
    bs64_ms = host_ms(torch, lambda: predict(images), 10)
    img_per_s = 64 / (statistics.median(bs64_ms) / 1e3)
    print(json.dumps({"phase": "predict_bs64", "valid_detections": int(det.valid.sum()),
                      "launches": launches["float_bs64"], "median_ms": statistics.median(bs64_ms),
                      "img_per_s": img_per_s, **where}))

    print(json.dumps({"phase": "profile_bs64", **profile_window(torch, lambda: predict(images), 3),
                      **where}))
    print(json.dumps({"phase": "profile_bs1",
                      **profile_window(torch, lambda: predict1(canvas), 10), **where}))

    # 6. The NMS kernel against its plain version on the bs=64 path's own
    # inputs (held bit-equal in phase 5).
    nms1280 = nms_timing(torch, nms_kernel, bs64_rows, 3)
    print(json.dumps({"phase": "nms_timing", **nms1280, **where}))
    del model, predict, bs64_rows, det, det_k, same_as_postprocess

    # 7. The int8 engine at bs=64 through make_int8_predict_fn, on the B2
    # route (conv1_1 through the engine's int8 conv, then B2) up to phase 23.
    os.environ["ODT_STEM_FP"] = "0"
    calib = rng.integers(0, 256, (8, 300, 300, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    predict8 = make_int8_predict_fn(cfg64, params, anchors_np, calib, device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    predict8(images)
    det8, launches["int8_bs64"] = counted(lambda: predict8(images))
    for name in INT8_PATH_KERNELS:
        check(launches["int8_bs64"][name] >= 1,
              f"the int8 bs=64 path never launched the {name} kernel")
    check(det8.boxes.shape == (64, cfg64.eval.max_detections, 4)
          and bool(torch.isfinite(det8.boxes).all()) and bool(torch.isfinite(det8.scores).all())
          and bool(det8.valid.any()), "int8 bs=64 detections are not finite or are empty")
    held = hold_int8_path(torch, engine, stem, l2norm, postprocess, normalize, predict8,
                          images, anchors_np, cfg64)
    check(_same_detections(torch, held["detections"], det8),
          "int8 bs=64: the served detections differ from the same QuantParams' rerun")
    stem_err = max(stem_err, held["stem_err"])
    l2norm_err = max(l2norm_err, held["l2norm_err"])
    max_abs_err = max(max_abs_err, held["nms_err"])
    int8_ms = host_ms(torch, lambda: predict8(images), 10)
    int8_img_per_s = 64 / (statistics.median(int8_ms) / 1e3)
    print(json.dumps({"phase": "int8_predict_bs64", "quantize_s": quantize_s,
                      "valid_detections": int(det8.valid.sum()),
                      "launches": launches["int8_bs64"], "kernels_vs_plain_bit_equal": True,
                      "nms_rows": held["nms_rows"],
                      "stem_input": list(held["stem_args"][0].shape),
                      "l2norm_input": list(held["l2norm_args"][0].shape),
                      "median_ms": statistics.median(int8_ms), "img_per_s": int8_img_per_s,
                      "float_img_per_s": img_per_s, **where}))

    # 8. Full-width int8 SSD-300 through the Predictor, bs=1.
    predictor8 = Predictor(cfg1, params, VOC_CLASSES, device="cuda", int8=True)
    dets8, launches["int8_bs1"] = counted(
        lambda: predictor8.predict_array(image, score_threshold=0.0))
    for name in INT8_PATH_KERNELS:
        check(launches["int8_bs1"][name] >= 1,
              f"the int8 bs=1 Predictor path never launched the {name} kernel")
    check(len(dets8) > 0 and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1 for d in dets8),
          "the int8 bs=1 Predictor returned no or bad detections")
    # The kernels against their plain versions on the inputs this path gave
    # them, and the served detections against the plain versions' run.
    held1 = hold_int8_path(torch, engine, stem, l2norm, postprocess, normalize,
                           predictor8._predict, torch.from_numpy(canvas1[None]).cuda(),
                           anchors_np, cfg1)
    stem_err = max(stem_err, held1["stem_err"])
    l2norm_err = max(l2norm_err, held1["l2norm_err"])
    max_abs_err = max(max_abs_err, held1["nms_err"])
    ih, iw = image.shape[:2]
    check(served_equal(torch, dets8, held1["detections"], iw, ih),
          "int8 bs=1: the served detections differ from the plain versions' run on the same canvas")
    p50_int8_bs1 = statistics.median(host_ms(torch, lambda: predictor8._predict(canvas), 50))
    print(json.dumps({"phase": "int8_predictor_bs1", "detections": len(dets8),
                      "launches": launches["int8_bs1"], "kernels_vs_plain_bit_equal": True,
                      "nms_rows": held1["nms_rows"],
                      "stem_input": list(held1["stem_args"][0].shape),
                      "l2norm_input": list(held1["l2norm_args"][0].shape),
                      "p50_ms": p50_int8_bs1, "float_p50_ms": p50_bs1, **where}))
    sa1, la1 = held1["stem_args"], held1["l2norm_args"]
    skw1 = held1["stem_kw"]
    del held1

    # 9. Profile of the int8 bs=64 path; the stem and L2Norm kernels against
    # their plain versions on the bs=64 and the bs=1 path's own inputs (held
    # bit-equal in 7 and 8), by CUDA-graph replay: a bs=1 launch is shorter
    # than the host's enqueue.
    print(json.dumps({"phase": "profile_int8_bs64",
                      **profile_window(torch, lambda: predict8(images), 3), **where}))
    print(json.dumps({"phase": "profile_int8_bs1",
                      **profile_window(torch, lambda: predictor8._predict(canvas), 10), **where}))
    stem64 = stem_timing(torch, stem, held["stem_args"], held["stem_kw"])
    stem1 = stem_timing(torch, stem, sa1, skw1)
    l2norm64 = l2norm_timing(torch, l2norm, held["l2norm_args"])
    l2norm1 = l2norm_timing(torch, l2norm, la1)
    print(json.dumps({"phase": "int8_kernel_timing", "stem": stem64, "stem_bs1": stem1,
                      "l2norm": l2norm64, "l2norm_bs1": l2norm1, **where}))
    del predict8, held, sa1, la1, skw1

    # 10. Against a reference on small inputs: the card vs the CPU.
    # TF32 off, so the card's float32 convs and matmuls are full float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = get_config("tiny_test")
    tiny_params = init_params(SSDModel(tiny), seed=1).state_dict()
    tiny_anchors = ssd_anchors(tiny.anchors, tiny.model.image_size)
    tiny_images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    dets_by_device = {}
    for device in ("cuda", "cpu"):
        m = SSDModel(tiny)
        m.load_state_dict(tiny_params)
        out = make_predict_fn(tiny, m, tiny_anchors, use_pallas=True, device=device)(tiny_images)
        dets_by_device[device] = [t.cpu().numpy() for t in out]
    (gb, gs, gc, gv), (wb, ws, wc, wv) = dets_by_device["cuda"], dets_by_device["cpu"]
    check(gv.any() and np.array_equal(gv, wv) and np.array_equal(gc[gv], wc[gv])
          and np.allclose(gs[gv], ws[gv], atol=1e-4) and np.allclose(gb[gv], wb[gv], atol=1e-4),
          "tiny_test detections on the card differ from the CPU reference")
    full = get_config("ssd300_vgg16_voc").override({"model.compute_dtype": "float32"})
    x = torch.from_numpy(rng.normal(0, 1, (1, 300, 300, 3)).astype(np.float32))
    logits = {}
    for device in ("cuda", "cpu"):
        m = SSDModel(full)
        m.load_state_dict(params)
        with torch.inference_mode():
            logits[device] = [t.cpu() for t in m.to(device).eval()(x.to(device))]
    err_full = max((a - b).abs().max().item() for a, b in zip(logits["cuda"], logits["cpu"]))
    check(logits["cuda"][0].shape == (1, 8732, 20) and err_full <= 1e-3,
          f"full-width float32 logits on the card differ from the CPU by {err_full}")
    int8_check = int8_reference_check(torch, np, engine, postprocess, normalize,
                                      make_int8_predict_fn, predictor8, tiny, tiny_params,
                                      tiny_anchors, tiny_images, full, rng)
    print(json.dumps({"phase": "reference_check", "tiny_valid": int(gv.sum()),
                      "full_width_f32_max_abs_err": err_full, **int8_check}))


    torch.backends.cudnn.allow_tf32 = True  # phase 10 is over: cuDNN's default again

    mark_seconds("4 to 10")

    # 11. The pool-backward kernel against its plain version, bit-equal.
    pool_err, aten_equal = pool_kernel_cases(torch, np, pool_bwd)

    # 12. Train full-width SSD-300 at bs=32 through train().
    train_cfg = get_config("ssd300_vgg16_voc").override({
        "model.pool_grad_kernel": True, "data.dataset": "synthetic",
        "train.batch_size": TRAIN_BATCH, "train.log_every": 1,
    })
    check(train_cfg.model.compute_dtype == "bfloat16", "the training preset is not bfloat16")
    dataset = make_synthetic_dataset(num_images=64, image_size=train_cfg.model.image_size)
    train_steps = 6
    # The checkpoint stays for the evaluate phase (26); the directory is
    # removed when the run ends, whichever way it ends.
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    ckpt_dir = f"{work.name}/ckpt"
    t0 = time.perf_counter()
    state, launches["train_bs32"] = counted(lambda: train(
        train_cfg, dataset, num_steps=train_steps, metrics_path=f"{work.name}/train.jsonl",
        checkpoint_dir=ckpt_dir, device="cuda"))
    train_s = time.perf_counter() - t0
    with open(f"{work.name}/train.jsonl") as f:
        rows = [json.loads(line) for line in f]
    saved = sorted(os.listdir(ckpt_dir))
    check(state.step == train_steps and [r["step"] for r in rows] == list(range(1, train_steps + 1)),
          f"train() logged steps {[r['step'] for r in rows]}")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in ("loss", "cls_loss", "box_loss", "grad_norm"))
              and r["num_positives"] >= 1, f"bad training metrics {r}")
    check(launches["train_bs32"]["max_pool_bwd"] == 4 * train_steps,
          f"{launches['train_bs32']['max_pool_bwd']} pool-kernel launches in {train_steps} steps, "
          f"expected 4 a step")
    check(all(torch.isfinite(p).all() for p in state.params.values()),
          "parameters are not finite after training")
    check(saved == [f"step_{train_steps}.pt"], f"train() left checkpoints {saved}")
    print(json.dumps({"phase": "train_bs32", "steps": train_steps, "seconds": train_s,
                      "launches": launches["train_bs32"],
                      "pool_launches_per_step": launches["train_bs32"]["max_pool_bwd"] / train_steps,
                      "losses": [r["loss"] for r in rows],
                      "grad_norms": [r["grad_norm"] for r in rows], **where}))
    del state

    # 13. Hold the training path: the kernel on the path's own activations and
    # cotangents, and one step's gradients through the kernel and the plain one.
    cache = DecodedCache(dataset, train_cfg.model.image_size, train_cfg.data.max_boxes, 4)
    batch = make_place(torch.device("cuda"))(cache.gather(np.arange(TRAIN_BATCH)))
    torch.cuda.current_stream().wait_event(batch.pop("_ready"))
    anchors_train = ssd_anchors(train_cfg.anchors, train_cfg.model.image_size)
    held_train = hold_train_path(torch, pool_bwd, pooling, init_model_state, make_train_step,
                                 train_cfg, anchors_train, batch)
    pool_err = max(pool_err, held_train["pool_err"])
    print(json.dumps({"phase": "hold_train_path", "pool_inputs": held_train["shapes"],
                      "kernel_vs_plain_bit_equal": True,
                      "gradients": held_train["gradients"], **where}))

    # 14. Overfit one batch: no augmentation, no warmup.
    over_cfg = train_cfg.override({"train.warmup_steps": 0, "train.base_lr": OVERFIT_LR,
                                   "train.num_steps": 10**6})
    model_o, state_o = init_model_state(over_cfg, seed=0, device="cuda")
    step_o = make_train_step(over_cfg, model_o, anchors_train, device="cuda", augment=False)
    gen_o = torch.Generator().manual_seed(0)
    over = []
    for _ in range(OVERFIT_STEPS):
        state_o, m = step_o(state_o, batch, gen_o)
        over.append(m["loss"])
    over = [float(v) for v in over]
    check(all(np.isfinite(over)) and over[-1] < OVERFIT_FALL * over[0],
          f"overfitting one batch did not bring the loss below {OVERFIT_FALL} of its start: {over}")
    print(json.dumps({"phase": "overfit_one_batch", "steps": OVERFIT_STEPS, "lr": OVERFIT_LR,
                      "first": over[0], "last": over[-1], "fall": over[-1] / over[0],
                      "every_10th": over[::10], **where}))
    del model_o, state_o, step_o

    # 15. One step on the card against the CPU, float32 with TF32 off.
    step_check = train_step_reference_check(torch, np, init_model_state, make_train_step,
                                            DecodedCache, make_synthetic_dataset, tiny,
                                            tiny_anchors)
    print(json.dumps({"phase": "train_step_card_vs_cpu", **step_check}))

    # 16. Step time and profile at bs=32 with augmentation; the pool kernel at
    # the path's four shapes beside its bound, its plain version and ATen's.
    model_t, state_t = init_model_state(train_cfg, seed=0, device="cuda")
    step_t = make_train_step(train_cfg, model_t, anchors_train, device="cuda", augment=True)
    gen_t = torch.Generator().manual_seed(0)

    def one_step():
        step_t(state_t, batch, gen_t)

    step_ms = host_ms(torch, one_step, 20)
    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    train_img_per_s = TRAIN_BATCH / (statistics.median(step_ms) / 1e3)
    print(json.dumps({"phase": "train_step_timing", "batch": TRAIN_BATCH,
                      "median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
                      "max_ms": max(step_ms), "img_per_s": train_img_per_s,
                      "peak_memory_gib": peak_gb, **where}))
    print(json.dumps({"phase": "profile_train_bs32", **profile_window(torch, one_step, 5), **where}))
    del model_t, state_t, step_t
    pool_rows = []
    for x, y, g in held_train["inputs"]:
        _, idx = torch.nn.functional.max_pool2d(x, 2, 2, return_indices=True)
        aten = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
            g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
        check(torch.equal(aten(), pool_bwd.max_pool_bwd(x, y, g)),
              f"ATen's backward differs from the kernel at {tuple(x.shape)}")
        b_ms, b_by = pool_bwd_bound_ms(x, g)
        pool_rows.append({
            "x": list(x.shape), "dtype": str(x.dtype),
            "ms": cuda_ms(torch, lambda: pool_bwd.max_pool_bwd(x, y, g), 50),
            "plain_ms": cuda_ms(torch, lambda: pool_bwd.max_pool_bwd_reference(x, y, g), 5),
            "aten_backward_ms": cuda_ms(torch, aten, 50),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    pool_sum = {k: sum(r[k] for r in pool_rows)
                for k in ("ms", "plain_ms", "aten_backward_ms", "bound_ms")}
    print(json.dumps({"phase": "pool_bwd_timing", "per_pool": pool_rows, "per_step": pool_sum,
                      "aten_bit_equal_on_path": True, "aten_bit_equal_on_cases": aten_equal,
                      **where}))

    del held_train, batch, cache
    torch.cuda.empty_cache()

    mark_seconds("11 to 16")

    # 17. The two ResNet kernels against their plain versions on synthetic cases.
    rstem_err, bott_err = resnet_kernel_cases(torch, resnet_stem, bottleneck)

    # 18. Full-width ssd512_resnet50_coco in float at bs=64 through make_predict_fn.
    cfg512 = get_config("ssd512_resnet50_coco")
    check(cfg512.eval.int8_logits_bf16 and cfg512.model.compute_dtype == "bfloat16",
          "the SSD-512 preset no longer asks for bf16 logits and a bf16 float model")
    params512 = init_params(SSDModel(cfg512), seed=0, random_batch_stats=True).state_dict()
    anchors512 = ssd_anchors(cfg512.anchors, cfg512.model.image_size)
    check(anchors512.shape == (24564, 4), f"SSD-512 anchors {anchors512.shape}")
    model512 = SSDModel(cfg512)
    model512.load_state_dict(params512)
    predict512 = make_predict_fn(cfg512, model512, anchors512, device="cuda")
    images512 = torch.randint(0, 256, (64, 512, 512, 3), generator=gen, device="cuda",
                              dtype=torch.uint8)
    predict512(images512)
    det512, launches["ssd512_float_bs64"] = counted(lambda: predict512(images512))
    check(launches["ssd512_float_bs64"] == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"SSD-512 float bs=64 launches {launches['ssd512_float_bs64']}")
    check(det512.boxes.shape == (64, cfg512.eval.max_detections, 4)
          and bool(torch.isfinite(det512.boxes).all()) and bool(torch.isfinite(det512.scores).all())
          and bool(det512.valid.any()), "SSD-512 float bs=64 detections are not finite or empty")
    rows512, _ = hold_path(torch, nms_kernel, normalize, model512, images512, anchors512, cfg512)
    check(tuple(rows512["scores"].shape) == (64 * 80, 512),
          f"SSD-512 NMS rows {tuple(rows512['scores'].shape)}")
    max_abs_err = max(max_abs_err, rows512["max_abs_err"])
    # The NMS kernel at SSD-512's 5120 rows beside its bound from these rows.
    nms512 = nms_timing(torch, nms_kernel, rows512, 2)
    ms512 = host_ms(torch, lambda: predict512(images512), 10)
    float512_img_per_s = 64 / (statistics.median(ms512) / 1e3)
    print(json.dumps({"phase": "ssd512_predict_bs64", "valid_detections": int(det512.valid.sum()),
                      "launches": launches["ssd512_float_bs64"],
                      "nms_rows": list(rows512["scores"].shape), "nms_timing": nms512,
                      "median_ms": statistics.median(ms512), "img_per_s": float512_img_per_s,
                      **where}))
    print(json.dumps({"phase": "profile_ssd512_bs64",
                      **profile_window(torch, lambda: predict512(images512), 3), **where}))
    del rows512, det512

    # 19. The int8 engine at bs=64 through make_int8_predict_fn.
    calib512 = rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    predict512_8 = make_int8_predict_fn(cfg512, params512, anchors512, calib512, device="cuda")
    torch.cuda.synchronize()
    quantize512_s = time.perf_counter() - t0
    predict512_8(images512)
    det512_8, launches["ssd512_int8_bs64"] = counted(lambda: predict512_8(images512))
    check(launches["ssd512_int8_bs64"] == RESNET_INT8_LAUNCHES,
          f"SSD-512 int8 bs=64 launches {launches['ssd512_int8_bs64']}, "
          f"expected {RESNET_INT8_LAUNCHES}")
    check(det512_8.boxes.shape == (64, cfg512.eval.max_detections, 4)
          and bool(torch.isfinite(det512_8.boxes).all())
          and bool(torch.isfinite(det512_8.scores).all()) and bool(det512_8.valid.any()),
          "SSD-512 int8 bs=64 detections are not finite or are empty")
    held512 = hold_resnet_int8_path(torch, engine, resnet_stem, bottleneck, postprocess,
                                    normalize, predict512_8, images512, anchors512, cfg512)
    check(_same_detections(torch, held512["detections"], det512_8),
          "SSD-512 int8 bs=64: the served detections differ from the same QuantParams' rerun")
    rstem_err = max(rstem_err, held512["stem_err"])
    bott_err = max(bott_err, held512["bottleneck_err"])
    max_abs_err = max(max_abs_err, held512["nms_err"])
    int8_512_ms = host_ms(torch, lambda: predict512_8(images512), 10)
    int8_512_img_per_s = 64 / (statistics.median(int8_512_ms) / 1e3)
    # The same QuantParams on the unfused spec, and on the bottleneck-only spec.
    qp512 = predict512_8.qp
    os.environ["ODT_STEM_KERNEL"] = "0"  # unset before: the path above launched the stem kernel
    try:
        spec_bottleneck_only = engine.build_resnet_ssd_spec(cfg512, fused_bottleneck=True)
        spec_unfused = engine.build_resnet_ssd_spec(cfg512, fused_bottleneck=False)
    finally:
        del os.environ["ODT_STEM_KERNEL"]
    check(not any(isinstance(op, (engine.BottleneckOp, engine.StemPoolPallasOp))
                  for op in spec_unfused), "the unfused spec still holds a kernel op")
    anchors512_t = torch.from_numpy(anchors512).cuda()

    @torch.inference_mode()
    def predict_unfused(images_u8):
        x = normalize(images_u8.float() / 255.0)
        return postprocess(*engine.int8_forward(qp512, spec_unfused, cfg512, x), anchors512_t,
                           cfg512)

    with torch.inference_mode():
        x512 = normalize(images512[:8].float() / 255.0)
        taps_unfused = engine.run_int8(qp512, spec_unfused, x512, dequantize_taps=False)
        taps_bottleneck = engine.run_int8(qp512, spec_bottleneck_only, x512, dequantize_taps=False)
        taps_both = engine.run_int8(qp512, predict512_8.spec, x512, dequantize_taps=False)
    # With the stem kernel on too, the few stem codes that its reciprocal
    # requant moves by one spread through every later conv: the taps then
    # differ in many codes, by little. Each tap's mean difference is held to
    # about twice what an NVIDIA H100 80GB HBM3 gave on these seeded inputs
    # (0.0036, 0.041, 0.082, 0.127, 0.135, 0.242, 0.277 of a code from C3 to
    # the last level; at most 9 codes).
    agree, mean_diff, max_diff = [], [], []
    for (u, _), (k, _), (both, _) in zip(taps_unfused, taps_bottleneck, taps_both):
        check(torch.equal(u, k), f"SSD-512: the bottleneck kernel's spec differs from the unfused "
                                 f"spec at tap {tuple(u.shape)}: {int((u != k).sum())} codes")
        diff = (both.int() - u.int()).abs()
        agree.append(float((diff == 0).float().mean()))
        mean_diff.append(float(diff.float().mean()))
        max_diff.append(int(diff.max()))
    check(len(mean_diff) == len(TAP_MEAN_CODE_DIFF_LIMITS)
          and all(m <= lim for m, lim in zip(mean_diff, TAP_MEAN_CODE_DIFF_LIMITS)),
          f"SSD-512: the kernel spec's taps are {mean_diff} codes from the unfused spec's on "
          f"average, over the limits {TAP_MEAN_CODE_DIFF_LIMITS}")
    det_unfused, launches_unfused = counted(lambda: predict_unfused(images512))
    check(launches_unfused == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"the unfused spec launched {launches_unfused}")
    unfused_ms = host_ms(torch, lambda: predict_unfused(images512), 10)
    unfused_img_per_s = 64 / (statistics.median(unfused_ms) / 1e3)
    print(json.dumps({"phase": "ssd512_int8_predict_bs64", "quantize_s": quantize512_s,
                      "valid_detections": int(det512_8.valid.sum()),
                      "launches": launches["ssd512_int8_bs64"],
                      "kernels_vs_plain_bit_equal": True,
                      "nms_rows": held512["nms_rows"],
                      "stem_input": list(held512["stem_args"][0].shape),
                      "bottleneck_inputs": [list(a[0].shape) for a, _ in held512["block_args"]],
                      "bottleneck_spec_vs_unfused_spec_taps_bit_equal": len(taps_unfused),
                      "kernel_spec_vs_unfused_spec_taps": {
                          "share_equal": agree, "mean_abs_code_diff": mean_diff,
                          "max_abs_code_diff": max_diff},
                      "stem_vs_unfused_chain": held512["stem_vs_chain"],
                      "median_ms": statistics.median(int8_512_ms),
                      "img_per_s": int8_512_img_per_s,
                      "unfused_spec_median_ms": statistics.median(unfused_ms),
                      "unfused_spec_img_per_s": unfused_img_per_s,
                      "unfused_spec_valid_detections": int(det_unfused.valid.sum()),
                      "float_img_per_s": float512_img_per_s, **where}))
    print(json.dumps({"phase": "profile_ssd512_int8_bs64",
                      **profile_window(torch, lambda: predict512_8(images512), 3), **where}))
    print(json.dumps({"phase": "profile_ssd512_int8_bs64_unfused_spec",
                      **profile_window(torch, lambda: predict_unfused(images512), 3), **where}))
    del taps_unfused, taps_bottleneck, taps_both, det_unfused, det512_8, x512

    # 20. The stem kernel and each of the twelve bottleneck launches on the
    # bs=64 path's own inputs (held bit-equal in 19).
    rstem64 = resnet_stem_timing(torch, int8_ops, resnet_stem, qp512, predict512_8.spec[0],
                                 held512["stem_args"], held512["stem_kw"])
    block_ops = [op for op in predict512_8.spec if isinstance(op, engine.BottleneckOp)]
    block_rows = []
    yardstick = {}  # the products as torch._int_mm, once per shape
    for op, (args, kw) in zip(block_ops, held512["block_args"]):
        x_in, cm = args[0], args[1].shape[1]
        chain = unfused_block(int8_ops, qp512, op, x_in, kw["resid_scale"])
        check(torch.equal(chain, bottleneck.fused_bottleneck(*args, **kw)),
              f"{op.base}: the kernel differs from the engine's unfused chain")
        del chain
        b_ms, b_by = bottleneck_bound_ms(x_in, cm)
        if tuple(x_in.shape) not in yardstick:
            gemms = bottleneck_gemms(torch, x_in, args[1], args[4], args[7])
            yardstick[tuple(x_in.shape)] = gemm_yardstick_ms(torch, gemms, 5)
            del gemms
        block_rows.append({
            "block": op.base, "x": list(x_in.shape), "cm": cm,
            "ms": cuda_ms(torch, lambda: bottleneck.fused_bottleneck(*args, **kw), 5),
            "plain_ms": cuda_ms(
                torch, lambda: bottleneck.fused_bottleneck_reference(*args, **kw), 2),
            "unfused_chain_ms": cuda_ms(
                torch, lambda: unfused_block(int8_ops, qp512, op, x_in, kw["resid_scale"]), 3),
            "gemm_yardstick_ms": yardstick[tuple(x_in.shape)],
            "bound_ms": b_ms, "bound_by": b_by,
        })
    timed = ("ms", "plain_ms", "unfused_chain_ms", "gemm_yardstick_ms", "bound_ms")
    block_sum = {k: sum(r[k] for r in block_rows) for k in timed}
    # What bounds the twelve launches together: the kind that holds the larger
    # part of the summed bounds.
    bound_parts = {kind: sum(r["bound_ms"] for r in block_rows if r["bound_by"] == kind)
                   for kind in ("bytes", "operations")}
    block_bound_by = max(bound_parts, key=bound_parts.get)
    by_shape = {}
    for r in block_rows:
        key = "x".join(str(v) for v in r["x"][1:])
        by_shape.setdefault(key, {"launches": 0, **{k: 0.0 for k in timed},
                                  "bound_by": r["bound_by"]})
        by_shape[key]["launches"] += 1
        for k in timed:
            by_shape[key][k] += r[k]
    for v in by_shape.values():  # means per launch of each shape
        for k in timed:
            v[k] /= v["launches"]
    print(json.dumps({"phase": "resnet_kernel_timing", "batch": 64,
                      "stem": rstem64,
                      "bottleneck_per_launch_by_shape": by_shape,
                      "bottleneck_per_forward": block_sum,
                      "bottleneck_per_block": block_rows, **where}))
    del held512, predict512_8, predict_unfused, qp512, images512
    torch.cuda.empty_cache()

    # 21. One image through the Predictor at bs=1, float and int8.
    class_names = [f"class_{i}" for i in range(cfg512.model.num_classes)]
    predictor512 = Predictor(cfg512, params512, class_names, device="cuda")
    dets_f, launches["ssd512_float_bs1"] = counted(
        lambda: predictor512.predict_array(image, score_threshold=0.0))
    check(launches["ssd512_float_bs1"] == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"SSD-512 float bs=1 launches {launches['ssd512_float_bs1']}")
    check(len(dets_f) > 0 and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1 for d in dets_f),
          "the SSD-512 float bs=1 Predictor returned no or bad detections")
    # The NMS kernel against its plain version on the rows the float bs=1 path gave it.
    canvas512 = np.array(Image.fromarray(image).resize((512, 512), Image.BILINEAR), np.uint8)
    rows512_1, _ = hold_path(torch, nms_kernel, normalize, predictor512.model,
                             torch.from_numpy(canvas512[None]).cuda(), anchors512, cfg512)
    check(tuple(rows512_1["scores"].shape) == (cfg512.model.num_classes, 512),
          f"SSD-512 float bs=1 NMS rows {tuple(rows512_1['scores'].shape)}")
    max_abs_err = max(max_abs_err, rows512_1["max_abs_err"])
    nms80 = nms_timing(torch, nms_kernel, rows512_1, 3)
    predictor512_8 = Predictor(cfg512, params512, class_names, device="cuda", int8=True)
    dets512_8, launches["ssd512_int8_bs1"] = counted(
        lambda: predictor512_8.predict_array(image, score_threshold=0.0))
    check(launches["ssd512_int8_bs1"] == RESNET_INT8_LAUNCHES,
          f"SSD-512 int8 bs=1 launches {launches['ssd512_int8_bs1']}, "
          f"expected {RESNET_INT8_LAUNCHES}")
    check(len(dets512_8) > 0
          and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1 for d in dets512_8),
          "the SSD-512 int8 bs=1 Predictor returned no or bad detections")
    held512_1 = hold_resnet_int8_path(torch, engine, resnet_stem, bottleneck, postprocess,
                                      normalize, predictor512_8._predict,
                                      torch.from_numpy(canvas512[None]).cuda(), anchors512, cfg512)
    rstem_err = max(rstem_err, held512_1["stem_err"])
    bott_err = max(bott_err, held512_1["bottleneck_err"])
    max_abs_err = max(max_abs_err, held512_1["nms_err"])
    # B6 at bs=1 on the path's own image, beside the same comparisons as at bs=64.
    rstem1 = resnet_stem_timing(torch, int8_ops, resnet_stem, predictor512_8._predict.qp,
                                predictor512_8._predict.spec[0], held512_1["stem_args"],
                                held512_1["stem_kw"])
    # B7's device time at bs=1: each of the path's twelve launches on its own
    # inputs, summed.
    bott_bs1 = [cuda_ms(torch, lambda a=a, k=k: bottleneck.fused_bottleneck(*a, **k), 20)
                for a, k in held512_1["block_args"]]
    check(served_equal(torch, dets512_8, held512_1["detections"], iw, ih),
          "SSD-512 int8 bs=1: the served detections differ from the plain versions' run on the "
          "same canvas")
    canvas_512 = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    p50_512 = statistics.median(host_ms(torch, lambda: predictor512._predict(canvas_512), 50))
    p50_512_8 = statistics.median(host_ms(torch, lambda: predictor512_8._predict(canvas_512), 50))
    print(json.dumps({"phase": "ssd512_predictor_bs1", "float_detections": len(dets_f),
                      "int8_detections": len(dets512_8),
                      "launches": {"float": launches["ssd512_float_bs1"],
                                   "int8": launches["ssd512_int8_bs1"]},
                      "kernels_vs_plain_bit_equal": True,
                      "nms_rows": {"float": list(rows512_1["scores"].shape),
                                   "int8": held512_1["nms_rows"]},
                      "nms_timing_float_rows": nms80,
                      "bottleneck_inputs": [list(a[0].shape) for a, _ in held512_1["block_args"]],
                      "resnet_stem_bs1": rstem1,
                      "bottleneck_bs1_ms_per_launch": bott_bs1,
                      "bottleneck_bs1_ms_per_forward": sum(bott_bs1),
                      "float_p50_ms": p50_512, "int8_p50_ms": p50_512_8, **where}))
    print(json.dumps({"phase": "profile_ssd512_bs1", **profile_window(
        torch, lambda: predictor512._predict(canvas_512), 10), **where}))
    print(json.dumps({"phase": "profile_ssd512_int8_bs1", **profile_window(
        torch, lambda: predictor512_8._predict(canvas_512), 10), **where}))
    del held512_1, rows512_1, predictor512, predictor512_8, model512, predict512
    torch.cuda.empty_cache()

    # 22. A small ResNet-50 config on the card against the CPU.
    print(json.dumps({"phase": "resnet_reference_check", **resnet_reference_check(
        torch, np, port_config, engine, postprocess, normalize, make_int8_predict_fn, SSDModel,
        init_params, ssd_anchors)}))

    mark_seconds("17 to 22")

    # 23. B4 (all of VGG block 1 in one kernel) against its plain version on
    # synthetic cases.
    stem_fp_err = stem_fp_kernel_cases(torch, stem_fp)

    # 24. int8 SSD-300 at bs=64 with B4 selected (ODT_STEM_FP=1), against the
    # B2 route on the same QuantParams.
    os.environ["ODT_STEM_FP"] = "1"
    calib_fp = np.random.default_rng(24).integers(0, 256, (8, 300, 300, 3), dtype=np.uint8)
    predict_fp = make_int8_predict_fn(cfg64, params, anchors_np, calib_fp, device="cuda")
    predict_fp(images)
    det_fp, launches["int8_bs64_stem_fp"] = counted(lambda: predict_fp(images))
    check(launches["int8_bs64_stem_fp"] == STEM_FP_LAUNCHES,
          f"int8 bs=64 with B4: launches {launches['int8_bs64_stem_fp']}, expected {STEM_FP_LAUNCHES}")
    check(bool(torch.isfinite(det_fp.boxes).all()) and bool(torch.isfinite(det_fp.scores).all())
          and bool(det_fp.valid.any()), "int8 bs=64 with B4: detections not finite or empty")
    held_fp = hold_int8_path(torch, engine, stem, l2norm, postprocess, normalize, predict_fp,
                             images, anchors_np, cfg64, stem_fp=stem_fp)
    check(_same_detections(torch, held_fp["detections"], det_fp),
          "int8 bs=64 with B4: the served detections differ from the same QuantParams' rerun")
    stem_fp_err = max(stem_fp_err, held_fp["stem_err"])
    l2norm_err = max(l2norm_err, held_fp["l2norm_err"])
    max_abs_err = max(max_abs_err, held_fp["nms_err"])
    os.environ["ODT_STEM_FP"] = "0"
    det_b2, launches_b2 = counted(lambda: predict_fp(images))
    check(launches_b2["stem_conv12_pool"] == 1 and launches_b2["stem_fused_producer"] == 0,
          f"the B2 route launched {launches_b2}")
    check(_same_detections(torch, det_b2, det_fp),
          "int8 bs=64: the detections with B4 differ from the B2 route's on the same QuantParams")
    route_ms = {"1": [], "0": []}
    for route in ("1", "0", "0", "1"):  # in turns: B4, B2, B2, B4
        os.environ["ODT_STEM_FP"] = route
        route_ms[route] += host_ms(torch, lambda: predict_fp(images), 10)
    fp_img_per_s = {r: 64 / (statistics.median(v) / 1e3) for r, v in route_ms.items()}
    os.environ["ODT_STEM_FP"] = "1"
    print(json.dumps({"phase": "int8_predict_bs64_stem_fp",
                      "valid_detections": int(det_fp.valid.sum()),
                      "launches": launches["int8_bs64_stem_fp"], "b2_route_launches": launches_b2,
                      "kernels_vs_plain_bit_equal": True, "detections_equal_b2_route": True,
                      "stem_fp_input": list(held_fp["stem_args"][0].shape),
                      "nms_rows": held_fp["nms_rows"],
                      "median_ms": statistics.median(route_ms["1"]),
                      "img_per_s": fp_img_per_s["1"],
                      "b2_route_median_ms": statistics.median(route_ms["0"]),
                      "b2_route_img_per_s": fp_img_per_s["0"], **where}))
    print(json.dumps({"phase": "profile_int8_bs64_stem_fp",
                      **profile_window(torch, lambda: predict_fp(images), 3), **where}))
    # B4 on the path's own input codes beside its bound, its plain version and
    # the chain it replaces (conv1_1 through the engine's int8 conv and
    # requant epilogue, then B2), which must give its codes.
    sa, skw = held_fp["stem_args"], held_fp["stem_kw"]
    qp_fp = predict_fp.qp

    def conv11():
        acc = int8_ops.conv_int8(sa[0], qp_fp.w_int8["backbone/conv1_1"], 1, "SAME", 1,
                                 operand=qp_fp.gemm_operand("backbone/conv1_1"))
        return int8_ops.requant_epilogue(acc, sa[2], sa[3], qp_fp.scale(sa[4], sa[0].device))

    q1_chain = conv11()
    fp_out = stem_fp.stem_fused_producer(*sa, **skw)
    b2_kw = {"packed": skw["packed"][1]}  # B2 and B4 share conv1_2's packed operand
    check(torch.equal(stem.stem_conv12_pool(q1_chain, *sa[5:], **b2_kw), fp_out),
          "B4 differs from the chain it replaces on the bs=64 path's codes")
    # B4 and B2 (which runs B4's conv1_2 stage on conv1_1's codes from
    # device memory) side by side, by CUDA-graph replay.
    stem_fp_ms = graph_ms(torch, lambda: stem_fp.stem_fused_producer(*sa, **skw), 10)
    stem_fp_plain_ms = cuda_ms(torch, lambda: stem_fp.stem_fused_producer_reference(*sa), 3)
    conv11_ms = cuda_ms(torch, conv11, 5)
    b2_on_path_ms = graph_ms(torch, lambda: stem.stem_conv12_pool(q1_chain, *sa[5:], **b2_kw), 10)
    chain_ms = cuda_ms(torch, lambda: stem.stem_conv12_pool(conv11(), *sa[5:], **b2_kw), 5)
    stem_fp_bound, stem_fp_bound_by = stem_fp_bound_ms(sa[0], fp_out)
    gemms = stem_fp_gemms(torch, sa[0], sa[1], sa[5])
    stem_fp_yardstick_ms = gemm_yardstick_ms(torch, gemms, 5)
    del gemms
    print(json.dumps({"phase": "stem_fp_timing", "input": list(sa[0].shape), "ms": stem_fp_ms,
                      "gemm_yardstick_ms": stem_fp_yardstick_ms,
                      "plain_ms": stem_fp_plain_ms, "bound_ms": stem_fp_bound,
                      "bound_by": stem_fp_bound_by, "replaced_chain_ms": chain_ms,
                      "chain_conv11_ms": conv11_ms, "chain_b2_ms": b2_on_path_ms, **where}))
    del held_fp, det_fp, det_b2, q1_chain, fp_out

    # 25. One image through Predictor(int8=True) with B4 selected, bs=1.
    predictor_fp = Predictor(cfg1, params, VOC_CLASSES, device="cuda", int8=True)
    dets_fp1, launches["int8_bs1_stem_fp"] = counted(
        lambda: predictor_fp.predict_array(image, score_threshold=0.0))
    check(launches["int8_bs1_stem_fp"] == STEM_FP_LAUNCHES,
          f"int8 bs=1 with B4: launches {launches['int8_bs1_stem_fp']}, expected {STEM_FP_LAUNCHES}")
    check(len(dets_fp1) > 0 and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1
                                    for d in dets_fp1),
          "the int8 bs=1 Predictor with B4 returned no or bad detections")
    held_fp1 = hold_int8_path(torch, engine, stem, l2norm, postprocess, normalize,
                              predictor_fp._predict, torch.from_numpy(canvas1[None]).cuda(),
                              anchors_np, cfg1, stem_fp=stem_fp)
    stem_fp_err = max(stem_fp_err, held_fp1["stem_err"])
    l2norm_err = max(l2norm_err, held_fp1["l2norm_err"])
    max_abs_err = max(max_abs_err, held_fp1["nms_err"])
    os.environ["ODT_STEM_FP"] = "0"
    dets_b2_1 = predictor_fp.predict_array(image, score_threshold=0.0)
    key = lambda d: (d.score, d.class_id, tuple(float(v) for v in d.box))  # noqa: E731
    check([key(d) for d in dets_b2_1] == [key(d) for d in dets_fp1],
          "int8 bs=1: the served detections with B4 differ from the B2 route's")
    p50_route = {"1": [], "0": []}
    for route in ("1", "0", "0", "1"):
        os.environ["ODT_STEM_FP"] = route
        p50_route[route] += host_ms(torch, lambda: predictor_fp._predict(canvas), 25)
    os.environ["ODT_STEM_FP"] = "1"
    print(json.dumps({"phase": "int8_predictor_bs1_stem_fp", "detections": len(dets_fp1),
                      "launches": launches["int8_bs1_stem_fp"],
                      "kernels_vs_plain_bit_equal": True, "detections_equal_b2_route": True,
                      "stem_fp_input": list(held_fp1["stem_args"][0].shape),
                      "p50_ms": statistics.median(p50_route["1"]),
                      "b2_route_p50_ms": statistics.median(p50_route["0"]), **where}))
    print(json.dumps({"phase": "profile_int8_bs1_stem_fp",
                      **profile_window(torch, lambda: predictor_fp._predict(canvas), 10), **where}))
    del held_fp1, predictor_fp, predict_fp

    # 26. evaluate through the CLI's main, in-process, on phase 12's
    # checkpoint trained on (resumed) for EVAL_TRAIN_STEPS more steps at phase
    # 14's rate without warmup, crops or expansion, so that the detections
    # find the boxes of the set it learned: int8 with B4, int8 on the B2
    # route, float.
    resume_cfg = train_cfg.override({
        "train.warmup_steps": 0, "train.base_lr": OVERFIT_LR, "train.num_steps": 10**6,
        "train.log_every": EVAL_TRAIN_STEPS, "data.augment.crop_prob": 0.0,
        "data.augment.expand_prob": 0.0})
    t0 = time.perf_counter()
    state = train(resume_cfg, dataset, num_steps=train_steps + EVAL_TRAIN_STEPS, resume=True,
                  checkpoint_dir=ckpt_dir, device="cuda")
    resume_s = time.perf_counter() - t0
    check(state.step == train_steps + EVAL_TRAIN_STEPS, f"the resumed run ended at {state.step}")
    trained = {k: v.detach() for k, v in state.params.items()}
    del state
    eval_argv = ["evaluate", "--preset", "ssd300_vgg16_voc", "--set", "data.dataset=synthetic",
                 "--set", f"eval.batch_size={EVAL_BATCH}", "--checkpoint", ckpt_dir]
    evals = {}
    for name, route, extra in (("evaluate_int8_stem_fp", "1", ["--int8"]),
                               ("evaluate_int8_b2", "0", ["--int8"]),
                               ("evaluate_float", "1", [])):
        os.environ["ODT_STEM_FP"] = route
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, launches[name] = counted(lambda: cli_main(eval_argv + extra))
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name}: main returned {rc}")
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        check("mAP" in result and all(k == "mAP" or k.startswith("ap/class_") for k in result)
              and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in result.values()),
              f"{name}: not a voc07 mAP dict of finite values: {result}")
        evals[name] = {"result": result, "launches": launches[name], "seconds": seconds,
                       "img_per_s": EVAL_IMAGES / seconds}
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    want_fp = {**{k: 0 for k in wrappers}, "stem_fused_producer": batches,
               "l2norm_requant": batches, "nms_rows": batches}
    check(launches["evaluate_int8_stem_fp"] == want_fp,
          f"evaluate --int8 with B4 launched {launches['evaluate_int8_stem_fp']}, expected {want_fp}")
    check(launches["evaluate_int8_b2"] == {**want_fp, "stem_fused_producer": 0,
                                           "stem_conv12_pool": batches},
          f"evaluate --int8 on the B2 route launched {launches['evaluate_int8_b2']}")
    check(launches["evaluate_float"] == {**{k: 0 for k in wrappers}, "nms_rows": batches},
          f"float evaluate launched {launches['evaluate_float']}")
    check(evals["evaluate_int8_b2"]["result"] == evals["evaluate_int8_stem_fp"]["result"],
          "evaluate --int8: the mAP dict with B4 differs from the B2 route's")
    check(set(evals["evaluate_float"]["result"]) == set(evals["evaluate_int8_stem_fp"]["result"]),
          "the float and int8 evaluate dicts have different keys")
    check(evals["evaluate_int8_stem_fp"]["result"]["mAP"] > 0.0,
          "evaluate --int8 found no box of the set the checkpoint was trained on")
    # The sweep alone: evaluate_dataset on a built cache (calibration
    # included), int8 with B4, on the weights the checkpoint holds: the
    # same dict as the command's.
    eval_cfg = cfg1.override({"data.dataset": "synthetic", "eval.batch_size": EVAL_BATCH})
    eval_set = make_synthetic_dataset(num_images=EVAL_IMAGES, image_size=300)
    eval_cache = DecodedCache(eval_set, 300, eval_cfg.data.max_boxes, 4)
    sweep_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep_result, sweep_launches = counted(lambda: evaluate_dataset(
            eval_cfg, trained, eval_set, cache=eval_cache, int8=True, device="cuda"))
        sweep_s.append(time.perf_counter() - t0)
    check(sweep_launches == want_fp, f"evaluate_dataset with B4 launched {sweep_launches}")
    check(sweep_result == evals["evaluate_int8_stem_fp"]["result"],
          "evaluate_dataset on the trained weights differs from the evaluate command's dict")
    print(json.dumps({"phase": "evaluate", "images": EVAL_IMAGES, "batch": EVAL_BATCH,
                      "checkpoint_steps": train_steps + EVAL_TRAIN_STEPS,
                      "resumed_training_seconds": resume_s, **evals,
                      "sweep_on_built_cache_seconds": sweep_s,
                      "sweep_on_built_cache_img_per_s": EVAL_IMAGES / statistics.median(sweep_s),
                      **where}))
    del os.environ["ODT_STEM_FP"], trained
    work.cleanup()

    mark_seconds("23 to 26")

    # 27 to 30. RetinaNet/FPN (retinanet_fpn_coco) in float and int8.
    rn_mods = types.SimpleNamespace(
        engine=engine, nms_kernel=nms_kernel, resnet_stem=resnet_stem, bottleneck=bottleneck,
        normalize=normalize, postprocess=postprocess, Predictor=Predictor,
        make_predict_fn=make_predict_fn, make_int8_predict_fn=make_int8_predict_fn,
        evaluate_dataset=evaluate_dataset, init_params=init_params, get_config=get_config,
        build_model=build_model, retinanet_anchors=retinanet_anchors, port_config=port_config,
        make_synthetic_dataset=make_synthetic_dataset)
    rn = retinanet_phases(torch, np, rn_mods, counted, wrappers, launches, gen, rng, image, where)
    rstem_err = max(rstem_err, rn["stem_err"])
    bott_err = max(bott_err, rn["bottleneck_err"])
    max_abs_err = max(max_abs_err, rn["nms_err"])

    mark_seconds("27 to 30")

    # 31 to 35. Training both ResNet-50 families, serving what was trained.
    from object_detector_tpu_torch.cli.main import _load_config, _restore_variables, build_parser
    from object_detector_tpu_torch.losses.detection import detection_loss
    from object_detector_tpu_torch.models.resnet import BatchNorm
    from object_detector_tpu_torch.train.state import create_train_state
    from object_detector_tpu_torch.train.step import encode_batch_targets

    rn_mods.__dict__.update(
        train=train, init_model_state=init_model_state, make_train_step=make_train_step,
        create_train_state=create_train_state, DecodedCache=DecodedCache, make_place=make_place,
        anchors_for_model=anchors_for_model, cli_main=cli_main, load_config=_load_config,
        restore_variables=_restore_variables, build_parser=build_parser, BatchNorm=BatchNorm,
        detection_loss=detection_loss, encode_batch_targets=encode_batch_targets)
    rt = resnet_train_phases(torch, np, rn_mods, counted, wrappers, launches, where)
    rstem_err = max(rstem_err, rt["stem_err"])
    bott_err = max(bott_err, rt["bottleneck_err"])
    max_abs_err = max(max_abs_err, rt["nms_err"])

    mark_seconds("31 to 35")

    # 36 to 38. Data-parallel training over torch.distributed.
    rn_mods.__dict__.update(counted=counted, wrappers=wrappers)
    dp = data_parallel_phases(torch, np, rn_mods, launches, where)
    pool_err = max(pool_err, dp["pool_err"])
    max_abs_err = max(max_abs_err, dp["nms_err"])

    mark_seconds("36 to 38")

    # 39 to 41. The serving knobs of the B1 path, and remat_block1.
    nms_bf16_err = nms_bf16_phase(torch, np, nms_kernel, where)
    rn_mods.__dict__.update(stem=stem, l2norm=l2norm, stem_fp=stem_fp)
    kn = knob_phases(torch, np, rn_mods, counted, launches, where)
    max_abs_err = max(max_abs_err, kn["nms_err"])
    nms_bf16_err = max(nms_bf16_err, kn["nms_bf16_err"])
    stem_fp_err = max(stem_fp_err, kn["stem_fp_err"])
    l2norm_err = max(l2norm_err, kn["l2norm_err"])
    rstem_err = max(rstem_err, kn["stem_err"])
    bott_err = max(bott_err, kn["bottleneck_err"])
    remat_phase(torch, np, rn_mods, counted, launches, where)

    mark_seconds("39 to 41")

    # 42 to 44. Converted torchvision backbones, profiling, the decoded cache.
    surface = converted_backbone_phase(torch, np, rn_mods, counted, launches, where)
    max_abs_err = max(max_abs_err, surface["nms_err"])
    stem_fp_err = max(stem_fp_err, surface["stem_fp_err"])
    l2norm_err = max(l2norm_err, surface["l2norm_err"])
    rstem_err = max(rstem_err, surface["stem_err"])
    bott_err = max(bott_err, surface["bottleneck_err"])
    mark_seconds("42")
    profiling_phase(torch, np, rn_mods, counted, launches, where, surface)
    del surface
    torch.cuda.empty_cache()
    mark_seconds("43")
    cache_phase(torch, np, where)
    mark_seconds("44")
    bf16_at = {preset: {name: t[name] for name in ("default", "coord_bf16", "all")}
               for preset, t in kn["timing"].items()}
    bf16_300 = kn["timing"]["ssd300_infer_bs64"]["coord_bf16"]

    def counts(name: str) -> dict:
        return {"launches": sum(c[name] for c in launches.values()),
                "launches_by_path": {path: c[name] for path, c in launches.items()}}

    print(json.dumps({"kernels": [
        {
            "name": "nms_rows",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/nms.cu",
            "replaces": "object_detector_tpu/kernels/nms_pallas.py:61",
            **counts("nms_rows"),
            "max_abs_err": max_abs_err,
            "ms": nms1280["ms"],
            "plain_ms": nms1280["plain_ms"],
            "bound_ms": nms1280["bound_ms"],
            "bound_by": nms1280["bound_by"],
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes a greedy NMS scan",
            "times_are": "at the SSD-300 bs=64 path's 1280 rows; at_rows: each serving "
                         "shape's own rows (retinanet_*: RetinaNet's float bs=64 and bs=1 "
                         "rows and its int8 bs=64 rows); kernel ms by CUDA graph replay",
            "at_rows": {"20": nms20, "80": nms80, "1280": nms1280, "5120": nms512,
                        "retinanet_5120": rn["nms_5120"], "retinanet_5120_int8": rn["nms_5120_int8"],
                        "retinanet_80": rn["nms_80"]},
            "class_top_k_rows": {preset: {name: t[name] for name in ("class_top_k_256",
                                                                    "class_top_k_128")}
                                 for preset, t in kn["timing"].items()},
        },
        {
            "name": "nms_rows_bf16",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/nms.cu",
            "replaces": "object_detector_tpu/kernels/nms_pallas.py:61",
            **counts("nms_rows_bf16"),
            "max_abs_err": nms_bf16_err,
            "ms": bf16_300["ms"],
            "plain_ms": bf16_300["plain_ms"],
            "bound_ms": bf16_300["bound_ms"],
            "bound_by": bf16_300["bound_by"],
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes a greedy NMS scan, in "
                                    "bfloat16 coordinates or any other type (torchvision's nms "
                                    "is another package, suppresses one float box set at a "
                                    "time and has no emit cap)",
            "times_are": "the bfloat16-coordinate instantiation of the scan (coord_bf16) on the "
                         "int8 SSD-300 bs=64 path's own 1280 rows of 512 columns; at_rows: each "
                         "phase-40 preset's float32 default, coord_bf16 and all-knobs rows "
                         "(128 columns); kernel ms by CUDA graph replay",
            "at_rows": bf16_at,
        },
        {
            "name": "stem_conv12_pool",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/stem.cu",
            "replaces": "object_detector_tpu/kernels/stem_pallas.py:209",
            **counts("stem_conv12_pool"),
            "max_abs_err": stem_err,
            "ms": stem64["ms"],
            "plain_ms": stem64["plain_ms"],
            "bound_ms": stem64["bound_ms"],
            "bound_by": stem64["bound_by"],
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes an int8 conv with a "
                                    "requant epilogue and a max pool",
            "gemm_yardstick_ms": stem64["gemm_yardstick_ms"],
            "bs1": {k: stem1[k] for k in ("ms", "plain_ms", "gemm_yardstick_ms", "bound_ms",
                                           "bound_by")},
            "stem_fused_producer_ms": stem_fp_ms,
            "times_are": "at the int8 SSD-300 bs=64 path's conv1_1 codes on the B2 route "
                         "(bs1: the bs=1 path's); kernel and yardstick ms by CUDA graph "
                         "replay; stem_fused_producer_ms: B4, which shares its conv1_2 stage, "
                         "on the B4 route's bs=64 input codes",
        },
        {
            "name": "l2norm_requant",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/l2norm.cu",
            "replaces": "object_detector_tpu/kernels/l2norm_pallas.py:35",
            **counts("l2norm_requant"),
            "max_abs_err": l2norm_err,
            "ms": l2norm64["ms"],
            "plain_ms": l2norm64["plain_ms"],
            "bound_ms": l2norm64["bound_ms"],
            "bound_by": l2norm64["bound_by"],
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes an L2 norm over int8 codes "
                                    "with a scale and a requant",
            "bs1": {k: l2norm1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "times_are": "at the int8 SSD-300 bs=64 path's tap (bs1: the bs=1 path's); kernel "
                         "ms by CUDA graph replay",
        },
        {
            "name": "max_pool_bwd",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/pool_bwd.cu",
            "replaces": "object_detector_tpu/ops/pooling.py:76",
            **counts("max_pool_bwd"),
            "max_abs_err": pool_err,
            "ms": pool_sum["ms"],
            "plain_ms": pool_sum["plain_ms"],
            "bound_ms": pool_sum["bound_ms"],
            "bound_by": pool_rows[0]["bound_by"],
            "library_ms": pool_sum["aten_backward_ms"],
            "times_are": "sums over the four pools of one bs=32 training step",
        },
        {
            "name": "resnet_stem",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/resnet_stem.cu",
            "replaces": "object_detector_tpu/kernels/resnet_stem_pallas.py:160",
            **counts("resnet_stem"),
            "max_abs_err": rstem_err,
            "ms": rstem64["ms"],
            "plain_ms": rstem64["plain_ms"],
            "bound_ms": rstem64["bound_ms"],
            "bound_by": rstem64["bound_by"],
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes an input quantize, an int8 "
                                    "conv with a requant epilogue and a max pool",
            "unfused_chain_ms": rstem64["unfused_chain_ms"],
            "gemm_yardstick_ms": rstem64["gemm_yardstick_ms"],
            "bs1": {k: rstem1[k] for k in ("ms", "plain_ms", "unfused_chain_ms",
                                           "gemm_yardstick_ms", "bound_ms", "bound_by")},
            "retinanet_bs64": rn["resnet_stem"],
            "times_are": "at the int8 SSD-512 bs=64 path's images (bs1: the bs=1 path's image; "
                         "retinanet_bs64: the int8 RetinaNet bs=64 path's); kernel and yardstick "
                         "ms by CUDA graph replay",
        },
        {
            "name": "fused_bottleneck",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/bottleneck.cu",
            "replaces": "object_detector_tpu/kernels/bottleneck_pallas.py:75",
            **counts("fused_bottleneck"),
            "max_abs_err": bott_err,
            "ms": block_sum["ms"],
            "plain_ms": block_sum["plain_ms"],
            "bound_ms": block_sum["bound_ms"],
            "bound_by": block_bound_by,
            "bound_by_shape": {k: v["bound_by"] for k, v in by_shape.items()},
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes three int8 convs with "
                                    "requant epilogues and a residual",
            "unfused_chain_ms": block_sum["unfused_chain_ms"],
            "gemm_yardstick_ms": block_sum["gemm_yardstick_ms"],
            "ms_by_shape": {k: v["ms"] for k, v in by_shape.items()},
            "launches_by_shape": {k: v["launches"] for k, v in by_shape.items()},
            "bs1_ms": sum(bott_bs1),
            "retinanet_bs64": rn["bottleneck"],
            "times_are": "sums over the twelve launches of one bs=64 int8 SSD-512 forward "
                         "(ms_by_shape: a launch; bs1_ms: the twelve of a bs=1 forward; "
                         "retinanet_bs64: the twelve of a bs=64 int8 RetinaNet forward, by "
                         "CUDA events)",
        },
        {
            "name": "stem_fused_producer",
            "route": "cuda",
            "source": "object_detector_tpu_torch/csrc/stem_fp.cu",
            "replaces": "object_detector_tpu/kernels/stem_pallas.py:514",
            **counts("stem_fused_producer"),
            "max_abs_err": stem_fp_err,
            "ms": stem_fp_ms,
            "plain_ms": stem_fp_plain_ms,
            "bound_ms": stem_fp_bound,
            "bound_by": stem_fp_bound_by,
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes two int8 convs with "
                                    "requant epilogues and a max pool",
            "gemm_yardstick_ms": stem_fp_yardstick_ms,
            "replaced_chain_ms": chain_ms,
            "replaced_chain": "conv1_1 as the engine's int8 conv and requant epilogue, then "
                              "stem_conv12_pool",
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def hold_path(torch, nms_kernel, normalize, model, images, anchors_np, cfg):
    """Runs the float path's forward and decode + NMS on ``images`` (uint8,
    on the card), capturing the rows that reach the NMS kernel. Holds the
    kernel bit-equal to nms_rows_reference on those rows, and the detections
    through the kernel equal to those through the plain version. Returns
    the captured rows (with the kernel's scores, the largest score
    difference and the head's outputs) and the detections."""
    with torch.inference_mode():
        cls_logits, box_offsets = model(normalize(images.float() / 255.0))
    return hold_nms(torch, nms_kernel, cls_logits, box_offsets, anchors_np, cfg,
                    f"bs={images.shape[0]}")


def hold_nms(torch, nms_kernel, cls_logits, box_offsets, anchors_np, cfg, label):
    """Runs decode + NMS on a head's outputs (on the card), capturing the
    rows that reach the NMS kernel. Holds the kernel bit-equal to
    nms_rows_reference on those rows, and the detections through the kernel
    equal to those through the plain version. Returns the captured rows
    (with the kernel's scores, the largest score difference and the head's
    outputs) and the detections."""
    captured = {}

    def capture(coords, scores, **kwargs):
        captured.update(coords=coords, scores=scores, kwargs=kwargs)
        return nms_kernel.nms_rows(coords, scores, **kwargs)

    with torch.inference_mode():
        anchors = torch.from_numpy(anchors_np).cuda()
        det_k = nms_kernel.decode_nms(cls_logits, box_offsets, anchors, rows_fn=capture,
                                      **_decode_kwargs(cfg))
        det_p = nms_kernel.decode_nms(cls_logits, box_offsets, anchors,
                                      rows_fn=nms_kernel.nms_rows_reference,
                                      **_decode_kwargs(cfg))
        coords, scores, kwargs = captured["coords"], captured["scores"], captured["kwargs"]
        got_s, got_c = nms_kernel.nms_rows(coords, scores, **kwargs)
        want_s, want_c = nms_kernel.nms_rows_reference(coords, scores, **kwargs)
    err = (got_s - want_s).abs().max().item()
    check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
          f"{label}: nms kernel differs from nms_rows_reference on the path's rows "
          f"{tuple(scores.shape)}: max_abs_err {err}, "
          f"{int((got_c != want_c).sum())} columns differ")
    check(_same_detections(torch, det_k, det_p),
          f"{label}: detections through the kernel differ from the plain path")
    captured.update(kernel_scores=got_s, max_abs_err=err, head=(cls_logits, box_offsets))
    return captured, det_k


def hold_int8_path(torch, engine, stem, l2norm, postprocess, normalize, predict8, images,
                   anchors_np, cfg, stem_fp=None):
    """Runs the int8 path of ``predict8`` (a `make_int8_predict_fn` result)
    on ``images`` (uint8, on the card) with its QuantParams, capturing the
    stem's and the L2Norm's inputs. Holds the detections through the kernels
    equal to those of the same QuantParams with the plain versions of both
    kernels, each kernel bit-equal to its plain version on the captured
    inputs, and the NMS kernel bit-equal to its plain version on the rows
    the int8 logits give it. The stem is B2 (conv1_2 + pool, on conv1_1's
    codes); with ``stem_fp``, the kernels.stem_fp module, it is B4 (all of
    block 1, on the input codes), for which the caller sets ODT_STEM_FP=1.
    Returns the captured inputs, the largest code differences, the NMS rows'
    shape and the detections through the kernels."""
    from object_detector_tpu_torch.kernels import nms as nms_kernel

    captured = {}

    def capture(name, fn):
        def run(*args, **kw):
            captured[name] = (args, kw)
            return fn(*args, **kw)
        return run

    if stem_fp is None:
        key, kernel, plain, channels = ("stem_fn", stem.stem_conv12_pool,
                                        stem.stem_conv12_pool_reference, 64)
    else:
        key, kernel, plain, channels = ("stem_fp_fn", stem_fp.stem_fused_producer,
                                        stem_fp.stem_fused_producer_reference, 3)
    qp, spec = predict8.qp, predict8.spec
    anchors = torch.from_numpy(anchors_np).cuda()
    with torch.inference_mode():
        x = normalize(images.float() / 255.0)
        head_k = engine.int8_forward(qp, spec, cfg, x, **{key: capture("stem", kernel)},
                                     l2norm_fn=capture("l2norm", l2norm.l2norm_requant))
        det_k = postprocess(*head_k, anchors, cfg)
        det_p = postprocess(*engine.int8_forward(
            qp, spec, cfg, x, **{key: plain}, l2norm_fn=l2norm.l2norm_requant_reference),
            anchors, cfg)
        check("stem" in captured, f"the path never called its {key}")
        (sa, skw), (la, _) = captured["stem"], captured["l2norm"]
        stem_k, stem_p = kernel(*sa, **skw), plain(*sa, **skw)
        l2_k, l2_p = l2norm.l2norm_requant(*la), l2norm.l2norm_requant_reference(*la)
    torch.cuda.synchronize()
    b, s, f0 = images.shape[0], cfg.model.image_size, cfg.anchors.feature_sizes[0]
    check(tuple(sa[0].shape) == (b, s, s, channels),
          f"bs={b}: the stem's input is {tuple(sa[0].shape)}")
    check(tuple(la[0].shape) == (b, f0, f0, 512),
          f"bs={b}: the L2Norm's input is {tuple(la[0].shape)}")
    check(torch.equal(stem_k, stem_p), f"int8 bs={b}: the stem kernel differs from its plain "
          f"version on the path's codes: {int((stem_k != stem_p).sum())}")
    check(torch.equal(l2_k, l2_p), f"int8 bs={b}: the L2Norm kernel differs from its plain "
          f"version on the path's tap: {int((l2_k != l2_p).sum())}")
    check(_same_detections(torch, det_k, det_p), f"int8 bs={b}: detections through the kernels "
                                                 "differ from the plain versions'")
    # The NMS kernel against its plain version on the rows this path's logits gave it.
    nms_rows, det_n = hold_nms(torch, nms_kernel, head_k[0], head_k[1].float(), anchors_np, cfg,
                               f"int8 bs={b}")
    check(nms_rows["scores"].shape[0] == b * cfg.model.num_classes,
          f"int8 bs={b}: NMS rows {tuple(nms_rows['scores'].shape)}")
    check(_same_detections(torch, det_n, det_k),
          f"int8 bs={b}: postprocess() and decode_nms() disagree on the int8 logits")
    return {"stem_args": sa, "stem_kw": skw, "l2norm_args": la, "detections": det_k,
            "stem_err": int((stem_k.int() - stem_p.int()).abs().max()),
            "l2norm_err": int((l2_k.int() - l2_p.int()).abs().max()),
            "nms_rows": list(nms_rows["scores"].shape), "nms_err": nms_rows["max_abs_err"]}


def int8_reference_check(torch, np, engine, postprocess, normalize, make_int8_predict_fn,
                         predictor8, tiny, tiny_params, tiny_anchors, tiny_images, full, rng):
    """The int8 engine on the card against the CPU on the same QuantParams:
    tap codes equal (tiny_test, and full-width SSD-300 at bs=1 with the int8
    Predictor's QuantParams), the tiny config's logits equal and its
    detections equal in valid and classes, scores and boxes within 1e-5 (the
    postprocess' sigmoid and decode may round an ulp apart)."""
    predict_cpu = make_int8_predict_fn(tiny, tiny_params, tiny_anchors, tiny_images,
                                       use_pallas=True, device="cpu")
    qp_cpu, spec = predict_cpu.qp, predict_cpu.spec
    qp_gpu = qp_cpu.to("cuda")
    x = normalize(torch.from_numpy(tiny_images).float() / 255.0)
    with torch.inference_mode():
        taps = {dev: engine.run_int8(qp, spec, x.to(dev), dequantize_taps=False)
                for dev, qp in (("cuda", qp_gpu), ("cpu", qp_cpu))}
        heads = {dev: engine.int8_forward(qp, spec, tiny, x.to(dev))
                 for dev, qp in (("cuda", qp_gpu), ("cpu", qp_cpu))}
        dets = {dev: postprocess(*heads[dev], torch.from_numpy(tiny_anchors).to(dev), tiny,
                                 use_pallas=True) for dev in ("cuda", "cpu")}
    for (g, _), (c, _) in zip(taps["cuda"], taps["cpu"]):
        check(torch.equal(g.cpu(), c), "tiny_test int8 tap codes on the card differ from the CPU")
    for g, c in zip(heads["cuda"], heads["cpu"]):
        check(torch.equal(g.cpu(), c), "tiny_test int8 logits on the card differ from the CPU")
    g, c = dets["cuda"], dets["cpu"]
    gv, cv = g.valid.cpu(), c.valid
    check(bool(gv.any()) and torch.equal(gv, cv) and torch.equal(g.classes.cpu()[gv], c.classes[cv])
          and torch.allclose(g.scores.cpu()[gv], c.scores[cv], rtol=0, atol=1e-5)
          and torch.allclose(g.boxes.cpu()[gv], c.boxes[cv], rtol=0, atol=1e-5),
          "tiny_test int8 detections on the card differ from the CPU")
    qp_full = predictor8._predict.qp
    xf = normalize(torch.from_numpy(rng.integers(0, 256, (1, 300, 300, 3), dtype=np.uint8))
                   .float() / 255.0)
    spec_full = engine.build_spec(full)
    with torch.inference_mode():
        full_gpu = engine.run_int8(qp_full, spec_full, xf.cuda(), dequantize_taps=False)
        full_cpu = engine.run_int8(qp_full.to("cpu"), spec_full, xf, dequantize_taps=False)
    for (g, _), (c, _) in zip(full_gpu, full_cpu):
        check(torch.equal(g.cpu(), c),
              f"full-width int8 tap {tuple(c.shape)} on the card differs from the CPU: "
              f"{int((g.cpu() != c).sum())} codes")
    return {"int8_tiny_taps_equal": True, "int8_tiny_logits_equal": True,
            "int8_tiny_valid": int(gv.sum()), "int8_full_width_taps_equal": len(full_cpu)}


def pool_case(torch, kind: str, shape, dtype, seed: int):
    """(x, y, g) on the card for one pool-backward case: (B, C, H, W) tensors,
    channels-last in memory, from ``shape`` = (B, H, W, C)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape
    x = torch.randn(shape, generator=gen, device="cuda")
    coin = torch.rand(shape, generator=gen, device="cuda")
    if kind == "ties":  # post-ReLU: most windows all zero, the rest often tied at 0
        x = x.clamp_min(0.0) * (coin > 0.6)
    elif kind == "zeros":
        x = torch.zeros_like(x)
    elif kind == "negative_zero":  # -0 equals +0: every window ties
        x = torch.where(coin > 0.5, 0.0, -0.0)
    elif kind == "levels":  # three values: the maximum ties at any pair of positions
        x = torch.floor(coin * 3.0) - 1.0
    x = x.to(dtype).permute(0, 3, 1, 2)
    g = torch.randn((b, h // 2, w // 2, c), generator=gen, device="cuda").to(dtype)
    g = g.permute(0, 3, 1, 2)
    return x, torch.nn.functional.max_pool2d(x, 2, 2), g


def pool_kernel_cases(torch, np, pool_bwd):
    """Holds the pool-backward kernel bit-equal to max_pool_bwd_reference on
    synthetic cases at the SSD-300 bs=32 shapes. Returns the largest absolute
    difference (0.0) and whether ATen's max-pool backward was bit-equal too
    on every case (a finding, not a condition)."""
    cases = [(kind, (TRAIN_BATCH, *hwc), torch.bfloat16)
             for hwc in POOL_SHAPES for kind in ("random", "ties", "levels", "zeros")]
    cases += [(kind, (TRAIN_BATCH, *POOL_SHAPES[2]), torch.float32)
              for kind in ("random", "ties", "levels", "zeros")]
    cases += [("negative_zero", (TRAIN_BATCH, *POOL_SHAPES[3]), torch.bfloat16),
              ("levels", (1, 6, 10, 3), torch.bfloat16), ("levels", (1, 6, 10, 3), torch.float32)]
    worst, aten_equal = 0.0, True
    for i, (kind, shape, dtype) in enumerate(cases):
        x, y, g = pool_case(torch, kind, shape, dtype, seed=100 + i)
        got = pool_bwd.max_pool_bwd(x, y, g)
        torch.cuda.synchronize()
        want = pool_bwd.max_pool_bwd_reference(x, y, g)
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        check(got.dtype == dtype and torch.equal(got.view(bits), want.view(bits)),
              f"pool kernel differs from its plain version ({kind}, {shape}, {dtype}): "
              f"max_abs_err {err}, {int((got != want).sum())} elements")
        if kind in ("zeros", "negative_zero"):  # every window ties: all goes to (0, 0)
            check(torch.equal(got[:, :, 0::2, 0::2], g) and not bool(got[:, :, 1::2].any())
                  and not bool(got[:, :, :, 1::2].any()),
                  f"pool kernel ({kind}): a tied window did not give all to (0, 0)")
        leaf = x.detach().clone().requires_grad_(True)
        aten, = torch.autograd.grad(torch.nn.functional.max_pool2d(leaf, 2, 2), leaf, g)
        same = torch.equal(aten.view(bits), got.view(bits))
        aten_equal = aten_equal and same
        print(json.dumps({"phase": "pool_bwd_kernel_vs_plain", "case": kind, "shape": list(shape),
                          "dtype": str(dtype), "bit_equal": True, "aten_bit_equal": same,
                          "share_nonzero": float((got != 0).float().mean())}))
        del x, y, g, got, want, leaf, aten
    return worst, aten_equal


def hold_train_path(torch, pool_bwd, pooling, init_model_state, make_train_step, cfg, anchors,
                    batch):
    """Runs one training step's forward and backward on ``batch`` (augmented,
    seeded) three times: through the kernel while capturing what the four
    pool backwards were given, through the kernel again, and through the
    plain version. Holds the kernel bit-equal to the plain version on the
    captured inputs, and the gradients through the kernel equal to those
    through the plain version (bit for bit if the rerun is; cuDNN is asked
    for deterministic algorithms meanwhile)."""
    model, state = init_model_state(cfg, seed=0, device="cuda")
    step_fn = make_train_step(cfg, model, anchors, device="cuda", augment=True)
    captured = []

    def capture(x, y, g):
        captured.append((x, y, g))
        return pool_bwd.max_pool_bwd(x, y, g)

    def grads(backward):
        pooling.max_pool_bwd = backward
        try:
            total, _, _ = step_fn.loss_fn(state.params, state.batch_stats, batch, 12345)
            return torch.autograd.grad(total, list(state.params.values()))
        finally:
            pooling.max_pool_bwd = pool_bwd.max_pool_bwd

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        through_kernel = grads(capture)
        rerun = grads(pool_bwd.max_pool_bwd)
        through_plain = grads(pool_bwd.max_pool_bwd_reference)
    finally:
        torch.backends.cudnn.deterministic = was
    torch.cuda.synchronize()

    b = batch["image"].shape[0]
    want_shapes = [(b, c, h, w) for h, w, c in reversed(POOL_SHAPES)]  # backward order
    check([tuple(x.shape) for x, _, _ in captured] == want_shapes,
          f"the pool backwards saw {[tuple(x.shape) for x, _, _ in captured]}, "
          f"expected {want_shapes}")
    pool_err = 0.0
    for x, y, g in captured:
        check(x.dtype == torch.bfloat16 and x.is_contiguous(memory_format=torch.channels_last),
              f"the path's pool input {tuple(x.shape)} is {x.dtype}, strides {x.stride()}")
        got, want = pool_bwd.max_pool_bwd(x, y, g), pool_bwd.max_pool_bwd_reference(x, y, g)
        pool_err = max(pool_err, (got.float() - want.float()).abs().max().item())
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"pool kernel differs from its plain version on the path's {tuple(x.shape)}: "
              f"{int((got != want).sum())} elements")
    diff = lambda a, b: max((p - q).abs().max().item() for p, q in zip(a, b))  # noqa: E731
    rerun_diff, plain_diff = diff(through_kernel, rerun), diff(through_kernel, through_plain)
    check(all(bool(torch.isfinite(t).all()) for t in through_kernel), "gradients are not finite")
    check(plain_diff == 0.0 if rerun_diff == 0.0 else plain_diff <= 4.0 * rerun_diff,
          f"one step's gradients through the kernel differ from the plain version's by "
          f"{plain_diff}; a rerun of the kernel differs by {rerun_diff}")
    return {
        "inputs": captured[::-1], "pool_err": pool_err,
        "shapes": [{"x": list(x.shape), "cotangent_channels_last":
                    g.is_contiguous(memory_format=torch.channels_last)} for x, _, g in captured[::-1]],
        "gradients": {"leaves": len(through_kernel), "kernel_vs_plain_max_abs_diff": plain_diff,
                      "kernel_rerun_max_abs_diff": rerun_diff,
                      "bit_equal": plain_diff == 0.0},
    }


def train_step_reference_check(torch, np, init_model_state, make_train_step, DecodedCache,
                               make_synthetic_dataset, tiny, tiny_anchors):
    """One training step's loss and gradients on the card against the CPU:
    tiny_test with the pool kernel on, float32, TF32 off, the same seeded
    weights and batch. The images are seeded noise under the dataset's boxes
    (a flat region makes pool windows tie up to rounding, and which element
    then takes the gradient differs between two devices' convolutions).
    Tolerances: the loss within 1e-5 relative; each gradient within 1e-4
    absolute plus 1e-3 relative (float32 sums in another order)."""
    cfg = tiny.override({"model.pool_grad_kernel": True})
    cache = DecodedCache(make_synthetic_dataset(num_images=8, image_size=cfg.model.image_size),
                         cfg.model.image_size, cfg.data.max_boxes, 1)
    batch = cache.gather(np.arange(8))
    batch["image"] = np.random.default_rng(0).integers(0, 256, batch["image"].shape, dtype=np.uint8)
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for device in ("cuda", "cpu"):
            model, state = init_model_state(cfg, seed=1, device=device)
            fn = make_train_step(cfg, model, tiny_anchors, device=device, augment=False)
            on_device = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            total, _, _ = fn.loss_fn(state.params, state.batch_stats, on_device, 0)
            grads = torch.autograd.grad(total, list(state.params.values()))
            out[device] = (float(total.detach()), dict(zip(state.params, (g.cpu() for g in grads))))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = out["cuda"], out["cpu"]
    check(abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu),
          f"tiny_test training loss on the card {loss_gpu} differs from the CPU's {loss_cpu}")
    worst = 0.0
    for name, want in grads_cpu.items():
        got = grads_gpu[name]
        worst = max(worst, (got - want).abs().max().item())
        check(torch.allclose(got, want, rtol=1e-3, atol=1e-4),
              f"gradient of {name} on the card differs from the CPU's by "
              f"{(got - want).abs().max().item()}")
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu, "leaves": len(grads_cpu),
            "grad_max_abs_err": worst,
            "grad_max_abs": max(g.abs().max().item() for g in grads_cpu.values())}



def resnet_kernel_cases(torch, resnet_stem, bottleneck):
    """Holds the fused ResNet stem and the fused bottleneck kernels bit-equal
    to their plain versions on synthetic cases. Returns the largest code
    differences (0, 0)."""
    gen = torch.Generator(device="cuda").manual_seed(17)

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device="cuda").to(torch.int8)

    stem_err = 0
    for kind, (b, h, w) in (("random", (2, 128, 128)), ("edge", (2, 64, 64)),
                            ("ragged_tile", (3, 40, 52)), ("ties_input", (2, 64, 72)),
                            ("ties_requant", (2, 48, 64)), ("bs1_full_width", (1, 512, 512))):
        if kind == "edge":  # saturated inputs, extreme weights and biases
            levels = torch.tensor([-2.6, -0.02, 0.0, 0.02, 2.6], device="cuda")
            images = levels[torch.randint(0, 5, (b, h, w, 3), generator=gen, device="cuda")]
            w_levels = torch.tensor([-127, -1, 0, 1, 127], device="cuda", dtype=torch.int8)
            w_q = w_levels[torch.randint(0, 5, (7, 7, 3, 64), generator=gen, device="cuda")]
            deq = torch.full((64,), 0.02 * 0.01, device="cuda")
            bias = torch.randn(64, generator=gen, device="cuda") * 3.0
            scales = (0.02, 0.05)
        elif kind == "ties_input":  # pixels at (n + 1/2) * in_scale and one ulp either side
            s_in = torch.tensor(0.0173, device="cuda")
            half = (torch.randint(-135, 135, (b, h, w, 3), generator=gen, device="cuda") + 0.5) * s_in
            side = torch.randint(0, 3, half.shape, generator=gen, device="cuda")
            images = torch.where(side == 0, half, torch.nextafter(
                half, torch.where(side == 1, -torch.inf, torch.inf)))
            w_q = randint(-127, 128, (7, 7, 3, 64))
            deq = float(s_in) * (torch.rand(64, generator=gen, device="cuda") * 0.015 + 0.005)
            bias = torch.randn(64, generator=gen, device="cuda") * 0.5
            scales = (float(s_in), 0.4)
        elif kind == "ties_requant":  # deq = out_scale / 2: y / out_scale at half-integers
            images = torch.randint(-1, 2, (b, h, w, 3), generator=gen, device="cuda") * 0.02
            w_q = randint(-1, 2, (7, 7, 3, 64))
            deq = torch.full((64,), float(torch.tensor(0.37)) / 2, device="cuda")
            bias = torch.zeros(64, device="cuda")
            scales = (0.02, 0.37)
        else:
            images = torch.randn((b, h, w, 3), generator=gen, device="cuda") * 1.2
            w_q = randint(-127, 128, (7, 7, 3, 64))
            deq = 0.02 * (torch.rand(64, generator=gen, device="cuda") * 0.015 + 0.005)
            bias = torch.randn(64, generator=gen, device="cuda") * 0.5
            scales = (0.02, 0.07)
        got = resnet_stem.resnet_stem(images, w_q, deq, bias, *scales)
        torch.cuda.synchronize()
        want = resnet_stem.resnet_stem_reference(images, w_q, deq, bias, *scales)
        stem_err = max(stem_err, int((got.int() - want.int()).abs().max()))
        check(got.shape == (b, h // 4, w // 4, 64) and torch.equal(got, want),
              f"resnet stem kernel differs from its plain version ({kind}): "
              f"{int((got != want).sum())} codes")
        print(json.dumps({"phase": "resnet_stem_kernel_vs_plain", "case": kind, "bit_equal": True,
                          "shape": list(images.shape),
                          "share_positive": float((want > 0).float().mean()),
                          "share_at_127": float((want == 127).float().mean())}))

    bott_err = 0
    cases = [(f"{h}x{h}x{c}", (2, h, h, c, cm)) for c, cm, h, _ in RESNET_BLOCKS]
    cases += [("ragged", (2, 13, 19, 256, 64)), ("large_b1", (2, 12, 20, 128, 64)),
              ("zero_input", (1, 16, 16, 256, 64)), ("narrow", (2, 12, 16, 64, 64)),
              ("wide_odd", (1, 9, 10, 448, 320)), ("ties", (2, 16, 16, 256, 64))]
    for kind, (b, h, w, c, cm) in cases:
        xlim, lim = (4, 1) if kind == "ties" else (128, 40)
        x = randint(-xlim + 1, xlim, (b, h, w, c))
        if kind == "zero_input":
            x.zero_()

        def deq(k, n):  # keeps each conv's output spread over the codes
            return (torch.rand(n, generator=gen, device="cuda") + 0.5) * 40.0 / (lim * 127 * k ** 0.5)

        def bias(n, shift=0.0):
            return torch.randn(n, generator=gen, device="cuda") * 5.0 + shift

        ops = (x, randint(-lim, lim + 1, (c, cm)), deq(c, cm),
               bias(cm, 60.0 if kind == "large_b1" else 0.0),
               randint(-lim, lim + 1, (3, 3, cm, cm)), deq(9 * cm, cm), bias(cm),
               randint(-lim, lim + 1, (cm, c)), deq(cm, c), bias(c))
        scales = dict(s1=0.43, s2=0.51, s3=0.37, resid_scale=0.29)
        if kind == "ties":  # deq = s / 2 on small codes: quotients at half-integers
            half = lambda v, n: torch.full((n,), v / 2, device="cuda")  # noqa: E731
            zero = lambda n: torch.zeros(n, device="cuda")  # noqa: E731
            ops = (x, ops[1], half(0.43, cm), zero(cm), ops[4], half(0.51, cm), zero(cm), ops[7],
                   half(0.37, c), zero(c))
            scales["resid_scale"] = float(torch.tensor(0.37) / 2)
        got = bottleneck.fused_bottleneck(*ops, **scales)
        torch.cuda.synchronize()
        want = bottleneck.fused_bottleneck_reference(*ops, **scales)
        bott_err = max(bott_err, int((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"bottleneck kernel differs from its plain version ({kind}): "
                                      f"{int((got != want).sum())} codes")
        print(json.dumps({"phase": "bottleneck_kernel_vs_plain", "case": kind, "bit_equal": True,
                          "shape": list(x.shape), "cm": cm,
                          "share_positive": float((want > 0).float().mean())}))
    return stem_err, bott_err


def stem_kernel_cases(torch, stem, gen):
    """Holds B2 bit-equal to its plain version on synthetic cases:
    saturating codes, all-negative biases, a size whose pooled tiles are
    partial, one full-width image (bs=1), quotients y / s at or next to
    half-integers (deq = s / 8). Returns the largest code difference (0)."""
    w2 = torch.randint(-127, 128, (3, 3, 64, 64), generator=gen, device="cuda", dtype=torch.int8)
    worst = 0
    for case, shape in (("saturating", (4, 300, 300, 64)), ("negative_bias", (4, 300, 300, 64)),
                        ("ragged_tile", (3, 22, 36, 64)), ("random", (3, 44, 60, 64)),
                        ("bs1", (1, 300, 300, 64)), ("ties", (2, 300, 300, 64))):
        low, high = {"negative_bias": (-127, 1), "ties": (-1, 2)}.get(case, (-127, 128))
        q1 = torch.randint(low, high, shape, generator=gen, device="cuda", dtype=torch.int8)
        w = {"negative_bias": w2.abs(), "ties": w2.clamp(-1, 1)}.get(case, w2)
        deq = torch.full((64,), {"saturating": 2e-3, "negative_bias": 1e-4,
                                 "ties": float(torch.tensor(0.021)) / 8}.get(case, 1e-5),
                         device="cuda")
        bias = torch.full((64,), {"negative_bias": -1.0, "ties": 0.0}.get(case, 0.1),
                          device="cuda")
        got = stem.stem_conv12_pool(q1, w, deq, bias, 0.021)
        torch.cuda.synchronize()
        want = stem.stem_conv12_pool_reference(q1, w, deq, bias, 0.021)
        worst = max(worst, int((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"stem kernel differs from its plain version ({case}): "
                                      f"{int((got != want).sum())} codes differ")
        print(json.dumps({"phase": "stem_kernel_vs_plain", "case": case, "bit_equal": True,
                          "shape": list(q1.shape),
                          "share_at_127": float((want == 127).float().mean()),
                          "share_zero": float((want == 0).float().mean())}))
    return worst


def l2norm_ties(np, torch, s: float, c: int):
    """(q0, gamma) pairs with C = c whose L2Norm values y sit at (n + 1/2) *
    s for n from -140 to 139, one ulp either side, and at n * s (1120
    targets, c at a time): pixel i holds +1, pixel c + i holds -1 at channel
    i, so y = +-gamma exactly, then 16 zero pixels."""
    n = np.arange(-140, 140, dtype=np.float32)
    half = (n + np.float32(0.5)) * np.float32(s)
    targets = np.concatenate([half, np.nextafter(half, -np.inf), np.nextafter(half, np.inf),
                              n * np.float32(s)]).astype(np.float32)
    q0 = np.zeros((2 * c + 16, c), np.int8)
    q0[np.arange(c), np.arange(c)] = 1
    q0[c + np.arange(c), np.arange(c)] = -1
    q0 = torch.from_numpy(q0.reshape(1, 1, -1, c)).cuda()
    gammas = np.resize(targets, (-(-targets.size // c), c)).astype(np.float32)
    return [(q0, torch.from_numpy(g).cuda()) for g in gammas]


def l2norm_kernel_cases(torch, np, l2norm, gen):
    """Holds B3 bit-equal to its plain version on synthetic cases: zero
    pixels at the SSD-300 width; C = 16 (one lane's chunk) and C = 2048 (four
    a lane); a pixel count that leaves the persistent grid's last round
    partial; quotients y / s at and next to half-integers, signed and past
    the clip. Returns the largest code difference (0)."""
    cases = []
    q0 = torch.randint(-127, 128, (8, 38, 38, 512), generator=gen, device="cuda", dtype=torch.int8)
    q0[:, ::3] = 0  # all-zero pixels
    cases.append(("zero_pixels", q0, torch.rand(512, generator=gen, device="cuda") * 20.0, 0.137))
    for c, shape in ((16, (4, 38, 38, 16)), (2048, (2, 19, 19, 2048)), (512, (3, 101, 97, 512))):
        q0 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        q0[0, 0] = 0
        cases.append((f"c{c}" if c != 512 else "off_the_grid", q0,
                      torch.randn(c, generator=gen, device="cuda") * 10.0, 0.093))
    for s in (0.02, 0.0173, 1.0 / 3.0, 3.7e-3):
        cases += [("ties", q0, gamma, s) for q0, gamma in l2norm_ties(np, torch, s, 512)]
    worst = 0
    for case, q0, gamma, s in cases:
        got = l2norm.l2norm_requant(q0, gamma, s)
        torch.cuda.synchronize()
        want = l2norm.l2norm_requant_reference(q0, gamma, s)
        worst = max(worst, int((got.int() - want.int()).abs().max()))
        zero = (q0 == 0).all(dim=-1)
        check(torch.equal(got, want) and not got[zero].any(),
              f"l2norm kernel differs from its plain version ({case}, C = {q0.shape[-1]}): "
              f"{int((got != want).sum())} codes")
        print(json.dumps({"phase": "l2norm_kernel_vs_plain", "case": case, "bit_equal": True,
                          "shape": list(q0.shape), "out_scale": s,
                          "share_at_127": float((want.abs() == 127).float().mean())}))
    return worst


def stem_fp_kernel_cases(torch, stem_fp):
    """Holds B4 bit-equal to its plain version on synthetic cases: saturating
    codes, all-negative biases, a zero input, a large positive conv1_1 bias
    (a conv1_1 halo pixel outside the image that was not zeroed would show),
    a size whose pooled tiles are partial, and bs=1. Returns the largest code
    difference (0)."""
    gen = torch.Generator(device="cuda").manual_seed(23)

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device="cuda").to(torch.int8)

    worst = 0
    for kind, (b, h, w) in (("saturating", (4, 300, 300)), ("negative_bias", (4, 300, 300)),
                            ("zero_input", (2, 300, 300)), ("large_bias1", (2, 300, 300)),
                            ("ragged_tile", (3, 44, 60)), ("bs1", (1, 300, 300)),
                            ("ties", (2, 300, 300))):
        lim = {"saturating": 128, "ties": 2}.get(kind, 10)
        x_q = randint(-lim + 1, lim, (b, h, w, 3))
        if kind == "zero_input":
            x_q.zero_()
        w1, w2 = randint(-lim + 1, lim, (3, 3, 3, 64)), randint(-lim + 1, lim, (3, 3, 64, 64))
        scale = 0.2 if kind == "saturating" else 1e-2
        deq1, deq2 = ((torch.rand(64, generator=gen, device="cuda") + 0.5) * scale
                      for _ in range(2))
        bias1, bias2 = (torch.randn(64, generator=gen, device="cuda") * 0.1 for _ in range(2))
        if kind == "negative_bias":
            bias1, bias2 = -bias1.abs() - 100.0, -bias2.abs() - 100.0
        elif kind == "large_bias1":
            bias1 = bias1.abs() + 3.0
        elif kind == "ties":  # deq = s / 2 and s / 8: quotients at half-integers
            deq1 = torch.full((64,), float(torch.tensor(0.043)) / 2, device="cuda")
            deq2 = torch.full((64,), float(torch.tensor(0.021)) / 8, device="cuda")
            bias1, bias2 = torch.zeros(64, device="cuda"), torch.zeros(64, device="cuda")
        args = (x_q, w1, deq1, bias1, 0.043, w2, deq2, bias2, 0.021)
        got = stem_fp.stem_fused_producer(*args)
        torch.cuda.synchronize()
        want = stem_fp.stem_fused_producer_reference(*args)
        worst = max(worst, int((got.int() - want.int()).abs().max()))
        check(got.shape == (b, h // 2, w // 2, 64) and torch.equal(got, want),
              f"B4 differs from its plain version ({kind}): {int((got != want).sum())} codes")
        print(json.dumps({"phase": "stem_fp_kernel_vs_plain", "case": kind, "bit_equal": True,
                          "shape": list(x_q.shape),
                          "share_positive": float((want > 0).float().mean()),
                          "share_at_127": float((want == 127).float().mean())}))
    return worst


def unfused_stem(int8_ops, qp, op, images):
    """The engine's unfused chain for the ResNet stem on the QuantParams'
    laid-out constants: input quantize, int8 conv, requant epilogue, pool."""
    dev = images.device
    s_in = qp.act_scale["__input__"]
    x = int8_ops.quantize(images.clone(), qp.scale(s_in, dev))
    acc = int8_ops.conv_int8(x, qp.w_int8[op.path], 2, 3, 1, operand=qp.gemm_operand(op.path))
    q = int8_ops.requant_epilogue(acc, qp.deq(op.path, s_in, dev), qp.bias[op.path],
                                  qp.scale(qp.act_scale[op.path], dev))
    return int8_ops.max_pool(q, 3, 2, explicit_pad=1)


def unfused_block(int8_ops, qp, op, x, in_scale):
    """The engine's unfused chain for one bottleneck block on the
    QuantParams' laid-out constants, as `run_int8` runs the expanded op."""
    dev = x.device
    resid, cur = x, in_scale
    for i, path in enumerate(op.conv_paths):
        acc = int8_ops.conv_int8(x, qp.w_int8[path], 1, "SAME", 1, operand=qp.gemm_operand(path))
        last = i == 2
        x = int8_ops.requant_epilogue(
            acc, qp.deq(path, cur, dev), qp.bias[path], qp.scale(qp.act_scale[path], dev), True,
            resid if last else None, qp.scale(in_scale, dev) if last else None)
        cur = qp.act_scale[path]
    return x


def hold_resnet_int8_path(torch, engine, resnet_stem, bottleneck, postprocess, normalize,
                          predict8, images, anchors_np, cfg):
    """Runs the int8 ResNet-50 path (SSD-512 or RetinaNet) of ``predict8`` (a
    `make_int8_predict_fn` result) on ``images`` (uint8, on the card) with its QuantParams,
    capturing what the stem and the twelve bottleneck launches were given.
    Holds the detections through the kernels equal to those of the same
    QuantParams with the plain versions of both kernels, each kernel
    bit-equal to its plain version on the captured inputs, and the NMS
    kernel bit-equal to its plain version on the rows the int8 logits give
    it. Returns the captured inputs, the largest code differences, the
    detections through the kernels, the NMS rows (captured, and their shape)
    and how far the stem is from the engine's unfused chain."""
    from object_detector_tpu_torch.kernels import nms as nms_kernel
    from object_detector_tpu_torch.ops import int8 as int8_ops

    captured = {"blocks": []}

    def stem_capture(*args, **kw):
        captured["stem"] = (args, kw)
        return resnet_stem.resnet_stem(*args, **kw)

    def block_capture(*args, **kw):
        captured["blocks"].append((args, kw))
        return bottleneck.fused_bottleneck(*args, **kw)

    qp, spec = predict8.qp, predict8.spec
    forward = engine.retinanet_int8_forward if cfg.model.family == "retinanet" else \
        engine.int8_forward
    anchors = torch.from_numpy(anchors_np).cuda()
    with torch.inference_mode():
        x = normalize(images.float() / 255.0)
        head_k = forward(qp, spec, cfg, x, resnet_stem_fn=stem_capture,
                         bottleneck_fn=block_capture)
        det_k = postprocess(*head_k, anchors, cfg)
        det_p = postprocess(*forward(
            qp, spec, cfg, x, resnet_stem_fn=resnet_stem.resnet_stem_reference,
            bottleneck_fn=bottleneck.fused_bottleneck_reference), anchors, cfg)
        b, s = images.shape[0], cfg.model.image_size
        stem_args, stem_kw = captured["stem"]
        check(tuple(stem_args[0].shape) == (b, s, s, 3) and stem_args[0].dtype == torch.float32,
              f"bs={b}: the resnet stem's input is {tuple(stem_args[0].shape)}")
        want_shapes = [(b, h, h, c) for c, _, h, n in RESNET_BLOCKS for _ in range(n)]
        got_shapes = [tuple(args[0].shape) for args, _ in captured["blocks"]]
        check(got_shapes == want_shapes, f"bs={b}: the bottleneck launches saw {got_shapes}")
        stem_k = resnet_stem.resnet_stem(*stem_args, **stem_kw)
        stem_p = resnet_stem.resnet_stem_reference(*stem_args)
        check(torch.equal(stem_k, stem_p), f"int8 bs={b}: the resnet stem kernel differs from its "
              f"plain version on the path's images: {int((stem_k != stem_p).sum())} codes")
        chain = unfused_stem(int8_ops, qp, spec[0], stem_args[0])
        diff = (stem_k.int() - chain.int()).abs()
        stem_vs_chain = {"max_code_diff": int(diff.max()),
                         "share_differing": float((diff > 0).float().mean())}
        check(stem_vs_chain["max_code_diff"] <= 1 and stem_vs_chain["share_differing"] <= 1e-4,
              f"int8 bs={b}: the resnet stem is further from the unfused chain than one code on "
              f"1e-4 of the elements: {stem_vs_chain}")
        bott_err = 0
        for i, (args, kw) in enumerate(captured["blocks"]):
            k_out = bottleneck.fused_bottleneck(*args, **kw)
            p_out = bottleneck.fused_bottleneck_reference(*args, **kw)
            bott_err = max(bott_err, int((k_out.int() - p_out.int()).abs().max()))
            check(torch.equal(k_out, p_out), f"int8 bs={b}: the bottleneck kernel differs from its "
                  f"plain version on the input of block {i} {got_shapes[i]}: "
                  f"{int((k_out != p_out).sum())} codes")
            del k_out, p_out
    torch.cuda.synchronize()
    check(_same_detections(torch, det_k, det_p), f"int8 bs={b}: {cfg.name} detections through "
                                                 "the kernels differ from the plain versions'")
    # The NMS kernel against its plain version on the rows this path's logits gave it.
    nms_rows, det_n = hold_nms(torch, nms_kernel, head_k[0], head_k[1].float(), anchors_np, cfg,
                               f"int8 bs={b}")
    check(tuple(nms_rows["scores"].shape) == (b * cfg.model.num_classes, 512),
          f"int8 bs={b}: {cfg.name} NMS rows {tuple(nms_rows['scores'].shape)}")
    check(_same_detections(torch, det_n, det_k),
          f"int8 bs={b}: postprocess() and decode_nms() disagree on the int8 logits")
    return {"stem_args": stem_args, "stem_kw": stem_kw, "block_args": captured["blocks"],
            "detections": det_k, "stem_err": int((stem_k.int() - stem_p.int()).abs().max()),
            "bottleneck_err": bott_err, "stem_vs_chain": stem_vs_chain, "nms_held": nms_rows,
            "nms_rows": list(nms_rows["scores"].shape), "nms_err": nms_rows["max_abs_err"]}


def ssd64_resnet_config(port_config):
    """SSD/ResNet-50 at 64 px: ResNet-50's depth and widths, taps of 8, 4 and
    2 cells, float32 (tests/test_torch_resnet.py's small config)."""
    return port_config.DetectorConfig(
        name="ssd64_resnet_smoke",
        model=port_config.ModelConfig(family="ssd", backbone="resnet50", image_size=64,
                                      num_classes=4, compute_dtype="float32"),
        anchors=port_config.AnchorConfig(
            feature_sizes=(8, 4, 2, 1, 1),
            sizes=((8., 16.), (16., 28.), (28., 40.), (40., 52.), (52., 62.)),
            aspect_ratios=((2.0,),) * 5),
        eval=port_config.EvalConfig(pre_nms_top_k=64, max_detections=16),
    )


def resnet_reference_check(torch, np, port_config, engine, postprocess, normalize,
                           make_int8_predict_fn, SSDModel, init_params, ssd_anchors):
    """A small SSD/ResNet-50 (ResNet-50's depth and widths at 64 px, seeded
    weights and BatchNorm statistics) on the card against the CPU: float32
    logits with TF32 off within 1e-3; on the CPU's QuantParams the int8 tap
    codes and logits equal (the card runs the two kernels, the CPU their
    plain versions) and the detections equal in valid and classes, scores
    and boxes within 1e-5. Reports how far bfloat16 on the card is from the
    CPU's float32."""
    size = 64
    cfg = ssd64_resnet_config(port_config)
    params = init_params(SSDModel(cfg), seed=3, random_batch_stats=True).state_dict()
    anchors = ssd_anchors(cfg.anchors, size)
    rng = np.random.default_rng(22)
    images = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(images).float() / 255.0)
    logits = {}
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, c, device in (("cuda", cfg, "cuda"), ("cpu", cfg, "cpu"),
                                ("cuda_bf16", cfg.override({"model.compute_dtype": "bfloat16"}),
                                 "cuda")):
            m = SSDModel(c)
            m.load_state_dict(params)
            with torch.inference_mode():
                logits[name] = [t.float().cpu() for t in m.to(device).eval()(x.to(device))]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    err_f32 = max((a - b).abs().max().item() for a, b in zip(logits["cuda"], logits["cpu"]))
    err_bf16 = max((a - b).abs().max().item() for a, b in zip(logits["cuda_bf16"], logits["cpu"]))
    mean_bf16 = max((a - b).abs().mean().item() for a, b in zip(logits["cuda_bf16"], logits["cpu"]))
    check(err_f32 <= 1e-3, f"small ResNet float32 logits on the card differ from the CPU by "
                           f"{err_f32}")
    predict_cpu = make_int8_predict_fn(cfg, params, anchors, images, use_pallas=True, device="cpu")
    qp_cpu, spec = predict_cpu.qp, predict_cpu.spec
    check(isinstance(spec[0], engine.StemPoolPallasOp)
          and sum(isinstance(op, engine.BottleneckOp) for op in spec) == 12,
          "the small ResNet spec does not select both kernels")
    qp_gpu = qp_cpu.to("cuda")
    with torch.inference_mode():
        taps = {dev: engine.run_int8(qp, spec, x.to(dev), dequantize_taps=False)
                for dev, qp in (("cuda", qp_gpu), ("cpu", qp_cpu))}
        heads = {dev: engine.int8_forward(qp, spec, cfg, x.to(dev))
                 for dev, qp in (("cuda", qp_gpu), ("cpu", qp_cpu))}
        dets = {dev: postprocess(*heads[dev], torch.from_numpy(anchors).to(dev), cfg,
                                 use_pallas=True) for dev in ("cuda", "cpu")}
    for (g, _), (c, _) in zip(taps["cuda"], taps["cpu"]):
        check(torch.equal(g.cpu(), c), f"small ResNet int8 tap {tuple(c.shape)} on the card "
                                       f"differs from the CPU: {int((g.cpu() != c).sum())} codes")
    for g, c in zip(heads["cuda"], heads["cpu"]):
        check(torch.equal(g.cpu(), c), "small ResNet int8 logits on the card differ from the CPU")
    g, c = dets["cuda"], dets["cpu"]
    gv, cv = g.valid.cpu(), c.valid
    check(bool(gv.any()) and torch.equal(gv, cv) and torch.equal(g.classes.cpu()[gv], c.classes[cv])
          and torch.allclose(g.scores.cpu()[gv], c.scores[cv], rtol=0, atol=1e-5)
          and torch.allclose(g.boxes.cpu()[gv], c.boxes[cv], rtol=0, atol=1e-5),
          "small ResNet int8 detections on the card differ from the CPU")
    return {"f32_logits_max_abs_err": err_f32, "bf16_card_vs_f32_cpu_max_abs_err": err_bf16,
            "bf16_card_vs_f32_cpu_mean_abs_err": mean_bf16,
            "logits_max_abs": max(t.abs().max().item() for t in logits["cpu"]),
            "int8_taps_equal": len(taps["cpu"]), "int8_logits_equal": True,
            "int8_valid": int(gv.sum())}


def stage_profile(torch, stages: dict, iters: int) -> dict:
    """The device time of each stage of a call, each stage profiled on its
    own (``profile_window``) on the inputs the stage before gave it, under
    inference mode: busy ms and ms by kernel group per call."""
    out = {}
    for name, fn in stages.items():
        def run(fn=fn):
            with torch.inference_mode():
                return fn()
        prof = profile_window(torch, run, iters)
        out[name] = {"device_busy_ms": prof.get("device_busy_ms_per_call", "not measured"),
                     "by_group": prof.get("device_ms_per_call_by_group", "not measured")}
    return out


def served_equal(torch, dets, det1, iw: int, ih: int) -> bool:
    """The Predictor's detections (pixel boxes of an iw x ih image) against
    row 0 of batch-stacked detections on the card (normalized boxes)."""
    v = det1.valid[0]
    served = torch.tensor([[d.score, d.class_id, *d.box] for d in dets], dtype=torch.float32)
    want = torch.cat([det1.scores[0][v, None], det1.classes[0][v, None].float(),
                      det1.boxes[0][v] * torch.tensor([iw, ih, iw, ih], dtype=torch.float32,
                                                      device=det1.boxes.device)], dim=1).cpu()
    return torch.equal(served, want)


def retinanet_codes(engine, qp, spec, cfg, x) -> dict:
    """The int8 codes of RetinaNet's three trunk taps (C3, C4, C5) and of
    every requant point of its FPN and heads, on one spec."""
    taps = engine.run_int8(qp, spec, x, dequantize_taps=False)
    codes = {f"C{i + 3}": q for i, (q, _) in enumerate(taps)}
    engine.run_int8_fpn_heads(qp, cfg, taps, codes=codes)
    return codes


def retinanet_phases(torch, np, m, counted, wrappers, launches, gen, rng, image, where) -> dict:
    """Phases 27 to 30: full-width retinanet_fpn_coco (seeded random weights,
    seeded non-trivial BatchNorm statistics) in float and int8 at bs=64 and
    bs=1, then tiny_retinanet_config on the card against the CPU. Returns
    the kernels' largest differences and the timings the kernels line takes."""
    from PIL import Image

    engine, nms_kernel, normalize, postprocess = m.engine, m.nms_kernel, m.normalize, m.postprocess
    resnet_stem, bottleneck = m.resnet_stem, m.bottleneck
    cfg = m.get_config("retinanet_fpn_coco")
    check(cfg.model.family == "retinanet" and cfg.model.compute_dtype == "bfloat16"
          and cfg.eval.int8_logits_bf16 and not cfg.eval.nms_exact_prefilter
          and (cfg.model.fpn_channels, cfg.model.head_depth) == (256, 4),
          "the RetinaNet preset is not the reference's")
    params = m.init_params(m.build_model(cfg), seed=0, random_batch_stats=True).state_dict()
    anchors_np = m.retinanet_anchors(cfg.model.image_size)
    check(anchors_np.shape == (49104, 4), f"RetinaNet anchors {anchors_np.shape}")
    anchors = torch.from_numpy(anchors_np).cuda()
    out = {"stem_err": 0, "bottleneck_err": 0, "nms_err": 0.0}

    # 27. Float at bs=64 through make_predict_fn.
    model = m.build_model(cfg)
    model.load_state_dict(params)
    predict = m.make_predict_fn(cfg, model, anchors_np, device="cuda")
    images = torch.randint(0, 256, (64, 512, 512, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    predict(images)
    det, launches["retinanet_float_bs64"] = counted(lambda: predict(images))
    check(launches["retinanet_float_bs64"] == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"RetinaNet float bs=64 launches {launches['retinanet_float_bs64']}")
    check(det.boxes.shape == (64, cfg.eval.max_detections, 4)
          and bool(torch.isfinite(det.boxes).all()) and bool(torch.isfinite(det.scores).all())
          and bool(det.valid.any()), "RetinaNet float bs=64 detections are not finite or empty")
    rows, _ = hold_path(torch, nms_kernel, normalize, model, images, anchors_np, cfg)
    check(tuple(rows["scores"].shape) == (64 * 80, 512),
          f"RetinaNet float bs=64 NMS rows {tuple(rows['scores'].shape)}")
    out["nms_err"] = max(out["nms_err"], rows["max_abs_err"])
    out["nms_5120"] = nms_timing(torch, nms_kernel, rows, 2)
    del rows
    float_ms = host_ms(torch, lambda: predict(images), 10)
    float_img_per_s = 64 / (statistics.median(float_ms) / 1e3)
    print(json.dumps({"phase": "retinanet_predict_bs64", "valid_detections": int(det.valid.sum()),
                      "launches": launches["retinanet_float_bs64"],
                      "nms_timing": out["nms_5120"], "median_ms": statistics.median(float_ms),
                      "img_per_s": float_img_per_s, **where}))
    with torch.inference_mode():
        x = normalize(images.float() / 255.0)
        xc = x.permute(0, 3, 1, 2).to(model.compute_dtype)
        feats = model.backbone(xc)
        pyramid = model.fpn(feats)

        def heads():
            return (torch.cat([model.cls_head(p).float() for p in pyramid], dim=1),
                    torch.cat([model.box_head(p).float() for p in pyramid], dim=1))

        cls, box = heads()
    float_split = stage_profile(torch, {
        "normalize": lambda: normalize(images.float() / 255.0),
        "trunk": lambda: model.backbone(xc), "fpn": lambda: model.fpn(feats), "heads": heads,
        "postprocess": lambda: postprocess(cls, box, anchors, cfg)}, 3)
    print(json.dumps({"phase": "profile_retinanet_bs64",
                      **profile_window(torch, lambda: predict(images), 3),
                      "by_stage": float_split, **where}))
    del det, x, xc, feats, pyramid, cls, box

    # 28. Int8 at bs=64 through make_int8_predict_fn (calibrated on 8 seeded images).
    calib = rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    predict8 = m.make_int8_predict_fn(cfg, params, anchors_np, calib, device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    qp, spec = predict8.qp, predict8.spec
    check("fpn/lateral3" in qp.w_int8 and "cls_head/conv3@P7" in qp.act_scale,
          "the RetinaNet QuantParams hold no int8 FPN and heads")
    predict8(images)
    det8, launches["retinanet_int8_bs64"] = counted(lambda: predict8(images))
    check(launches["retinanet_int8_bs64"] == RESNET_INT8_LAUNCHES,
          f"RetinaNet int8 bs=64 launches {launches['retinanet_int8_bs64']}, "
          f"expected {RESNET_INT8_LAUNCHES}")
    check(det8.boxes.shape == (64, cfg.eval.max_detections, 4)
          and bool(torch.isfinite(det8.boxes).all()) and bool(torch.isfinite(det8.scores).all())
          and bool(det8.valid.any()), "RetinaNet int8 bs=64 detections are not finite or empty")
    held = hold_resnet_int8_path(torch, engine, resnet_stem, bottleneck, postprocess, normalize,
                                 predict8, images, anchors_np, cfg)
    check(_same_detections(torch, held["detections"], det8),
          "RetinaNet int8 bs=64: the served detections differ from the same QuantParams' rerun")
    out["stem_err"] = max(out["stem_err"], held["stem_err"])
    out["bottleneck_err"] = max(out["bottleneck_err"], held["bottleneck_err"])
    out["nms_err"] = max(out["nms_err"], held["nms_err"])
    out["nms_5120_int8"] = nms_timing(torch, nms_kernel, held["nms_held"], 2)
    int8_ms = host_ms(torch, lambda: predict8(images), 10)
    int8_img_per_s = 64 / (statistics.median(int8_ms) / 1e3)
    # B6 and the twelve B7 launches on this path's inputs, beside their bounds.
    stem_args, stem_kw = held["stem_args"], held["stem_kw"]
    stem_out = resnet_stem.resnet_stem(*stem_args, **stem_kw)
    b_ms, b_by = resnet_stem_bound_ms(stem_args[0], stem_out)
    out["resnet_stem"] = {"ms": graph_ms(torch, lambda: resnet_stem.resnet_stem(
        *stem_args, **stem_kw), 20), "bound_ms": b_ms, "bound_by": b_by}
    del stem_out
    out["bottleneck"] = {
        "ms": sum(cuda_ms(torch, lambda a=a, k=k: bottleneck.fused_bottleneck(*a, **k), 5)
                  for a, k in held["block_args"]),
        "bound_ms": sum(bottleneck_bound_ms(a[0], a[1].shape[1])[0] for a, _ in held["block_args"])}
    # The same QuantParams on the unfused spec and on the bottleneck-only spec.
    os.environ["ODT_STEM_KERNEL"] = "0"  # unset before: the path above launched the stem kernel
    try:
        spec_bottleneck_only = engine.build_resnet_trunk_spec(fused_bottleneck=True)
        spec_unfused = engine.build_resnet_trunk_spec(fused_bottleneck=False)
    finally:
        del os.environ["ODT_STEM_KERNEL"]

    @torch.inference_mode()
    def predict_unfused(images_u8):
        x = normalize(images_u8.float() / 255.0)
        return postprocess(*engine.retinanet_int8_forward(qp, spec_unfused, cfg, x), anchors, cfg)

    with torch.inference_mode():
        x8 = normalize(images[:8].float() / 255.0)
        codes = {name: retinanet_codes(engine, qp, s, cfg, x8) for name, s in (
            ("unfused", spec_unfused), ("bottleneck", spec_bottleneck_only), ("both", spec))}
    check(len(codes["unfused"]) == 3 + 8 + 2 * 4 * 5,
          f"RetinaNet requant points: {len(codes['unfused'])}")
    mean_diff, max_diff = {}, {}
    for key, u in codes["unfused"].items():
        check(torch.equal(u, codes["bottleneck"][key]),
              f"RetinaNet: the bottleneck kernel's spec differs from the unfused spec at {key}: "
              f"{int((u != codes['bottleneck'][key]).sum())} codes")
        diff = (codes["both"][key].int() - u.int()).abs()
        mean_diff[key], max_diff[key] = float(diff.float().mean()), int(diff.max())
    alarm = {k: mean_diff[k] for k in RETINANET_MEAN_CODE_DIFF_LIMITS}
    check(all(alarm[k] <= lim for k, lim in RETINANET_MEAN_CODE_DIFF_LIMITS.items()),
          f"RetinaNet: the kernel spec is {alarm} codes from the unfused spec on average, over "
          f"the limits {RETINANET_MEAN_CODE_DIFF_LIMITS}")
    del codes
    det_unfused, launches_unfused = counted(lambda: predict_unfused(images))
    check(launches_unfused == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"the RetinaNet unfused spec launched {launches_unfused}")
    unfused_ms = host_ms(torch, lambda: predict_unfused(images), 10)
    print(json.dumps({"phase": "retinanet_int8_predict_bs64", "quantize_s": quantize_s,
                      "valid_detections": int(det8.valid.sum()),
                      "launches": launches["retinanet_int8_bs64"],
                      "kernels_vs_plain_bit_equal": True, "nms_rows": held["nms_rows"],
                      "nms_timing": out["nms_5120_int8"],
                      "stem_input": list(stem_args[0].shape),
                      "bottleneck_inputs": [list(a[0].shape) for a, _ in held["block_args"]],
                      "resnet_stem_timing": out["resnet_stem"],
                      "bottleneck_timing_per_forward": out["bottleneck"],
                      "bottleneck_spec_vs_unfused_spec_bit_equal_at": len(mean_diff),
                      "kernel_spec_vs_unfused_spec": {
                          "mean_abs_code_diff": mean_diff, "max_abs_code_diff": max_diff,
                          "limits": RETINANET_MEAN_CODE_DIFF_LIMITS},
                      "stem_vs_unfused_chain": held["stem_vs_chain"],
                      "median_ms": statistics.median(int8_ms), "img_per_s": int8_img_per_s,
                      "unfused_spec_median_ms": statistics.median(unfused_ms),
                      "unfused_spec_img_per_s": 64 / (statistics.median(unfused_ms) / 1e3),
                      "unfused_spec_valid_detections": int(det_unfused.valid.sum()),
                      "float_img_per_s": float_img_per_s, **where}))
    del held, det8, det_unfused, stem_args, stem_kw
    with torch.inference_mode():
        x = normalize(images.float() / 255.0)
        taps_q = engine.run_int8(qp, spec, x, dequantize_taps=False)
        pyr_q = engine.run_int8_fpn(qp, taps_q)
        cls8, box8 = engine.run_int8_heads(qp, cfg, pyr_q, torch.bfloat16)
    int8_split = stage_profile(torch, {
        "normalize": lambda: normalize(images.float() / 255.0),
        "trunk": lambda: engine.run_int8(qp, spec, x, dequantize_taps=False),
        "fpn": lambda: engine.run_int8_fpn(qp, taps_q),
        "heads": lambda: engine.run_int8_heads(qp, cfg, pyr_q, torch.bfloat16),
        "postprocess": lambda: postprocess(cls8, box8, anchors, cfg)}, 3)
    print(json.dumps({"phase": "profile_retinanet_int8_bs64",
                      **profile_window(torch, lambda: predict8(images), 3),
                      "by_stage": int8_split, **where}))
    print(json.dumps({"phase": "profile_retinanet_int8_bs64_unfused_spec",
                      **profile_window(torch, lambda: predict_unfused(images), 3), **where}))
    del taps_q, pyr_q, cls8, box8, predict8, predict_unfused, x, x8, images, predict, model
    torch.cuda.empty_cache()

    # 29. One image through the Predictor at bs=1, float and int8.
    class_names = [f"class_{i}" for i in range(cfg.model.num_classes)]
    ih, iw = image.shape[:2]
    canvas = torch.from_numpy(np.array(
        Image.fromarray(image).resize((512, 512), Image.BILINEAR), np.uint8)[None]).cuda()
    predictor = m.Predictor(cfg, params, class_names, device="cuda")
    dets_f, launches["retinanet_float_bs1"] = counted(
        lambda: predictor.predict_array(image, score_threshold=0.0))
    check(launches["retinanet_float_bs1"] == {**{k: 0 for k in wrappers}, "nms_rows": 1},
          f"RetinaNet float bs=1 launches {launches['retinanet_float_bs1']}")
    check(len(dets_f) > 0 and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1 for d in dets_f),
          "the RetinaNet float bs=1 Predictor returned no or bad detections")
    rows1, det_f1 = hold_path(torch, nms_kernel, normalize, predictor.model, canvas, anchors_np,
                              cfg)
    check(tuple(rows1["scores"].shape) == (cfg.model.num_classes, 512),
          f"RetinaNet float bs=1 NMS rows {tuple(rows1['scores'].shape)}")
    check(served_equal(torch, dets_f, det_f1, iw, ih),
          "RetinaNet float bs=1: the served detections differ from the plain version's run")
    out["nms_err"] = max(out["nms_err"], rows1["max_abs_err"])
    out["nms_80"] = nms_timing(torch, nms_kernel, rows1, 3)
    predictor8 = m.Predictor(cfg, params, class_names, device="cuda", int8=True)
    dets8, launches["retinanet_int8_bs1"] = counted(
        lambda: predictor8.predict_array(image, score_threshold=0.0))
    check(launches["retinanet_int8_bs1"] == RESNET_INT8_LAUNCHES,
          f"RetinaNet int8 bs=1 launches {launches['retinanet_int8_bs1']}, "
          f"expected {RESNET_INT8_LAUNCHES}")
    check(len(dets8) > 0 and all(np.all(np.isfinite(d.box)) and 0 < d.score <= 1 for d in dets8),
          "the RetinaNet int8 bs=1 Predictor returned no or bad detections")
    held1 = hold_resnet_int8_path(torch, engine, resnet_stem, bottleneck, postprocess, normalize,
                                  predictor8._predict, canvas, anchors_np, cfg)
    check(served_equal(torch, dets8, held1["detections"], iw, ih),
          "RetinaNet int8 bs=1: the served detections differ from the plain versions' run")
    out["stem_err"] = max(out["stem_err"], held1["stem_err"])
    out["bottleneck_err"] = max(out["bottleneck_err"], held1["bottleneck_err"])
    out["nms_err"] = max(out["nms_err"], held1["nms_err"])
    one = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    p50 = {"float": statistics.median(host_ms(torch, lambda: predictor._predict(one), 50)),
           "int8": statistics.median(host_ms(torch, lambda: predictor8._predict(one), 50))}
    prof1 = {"float": profile_window(torch, lambda: predictor._predict(one), 10),
             "int8": profile_window(torch, lambda: predictor8._predict(one), 10)}
    print(json.dumps({"phase": "retinanet_predictor_bs1", "float_detections": len(dets_f),
                      "int8_detections": len(dets8),
                      "launches": {"float": launches["retinanet_float_bs1"],
                                   "int8": launches["retinanet_int8_bs1"]},
                      "kernels_vs_plain_bit_equal": True, "served_equal_plain_run": True,
                      "nms_rows": {"float": list(rows1["scores"].shape),
                                   "int8": held1["nms_rows"]},
                      "nms_timing_float_rows": out["nms_80"],
                      "float_p50_ms": p50["float"], "int8_p50_ms": p50["int8"],
                      "float_device_busy_ms": prof1["float"].get("device_busy_ms_per_call"),
                      "int8_device_busy_ms": prof1["int8"].get("device_busy_ms_per_call"),
                      **where}))
    print(json.dumps({"phase": "profile_retinanet_bs1", **prof1["float"], **where}))
    print(json.dumps({"phase": "profile_retinanet_int8_bs1", **prof1["int8"], **where}))
    del held1, rows1, det_f1, predictor, predictor8
    torch.cuda.empty_cache()

    # 30. tiny_retinanet_config on the card against the CPU.
    print(json.dumps({"phase": "retinanet_reference_check",
                      **retinanet_reference_check(torch, np, m, counted, wrappers, launches)}))
    return out


def retinanet_reference_check(torch, np, m, counted, wrappers, launches) -> dict:
    """tiny_retinanet_config (ResNet-50's depth and widths at 128 px, FPN and
    heads of 32 channels; seeded weights and BatchNorm statistics) on the
    card against the CPU: float32 logits with TF32 off within 1e-3; on the
    CPU's QuantParams the int8 trunk taps, the codes at every FPN and head
    requant point and the logits equal (the card runs the two ResNet kernels,
    the CPU their plain versions) and the detections equal in valid and
    classes, scores and boxes within 1e-5; then `evaluate_dataset` in float
    and int8 on the card over 12 synthetic images: a COCO dict of finite
    values."""
    engine, normalize, postprocess = m.engine, m.normalize, m.postprocess
    cfg = m.port_config.tiny_retinanet_config().override(
        {"eval.map_style": "coco", "eval.use_pallas_nms": True})
    params = m.init_params(m.build_model(cfg), seed=3, random_batch_stats=True).state_dict()
    anchors = m.retinanet_anchors(cfg.model.image_size)
    images = np.random.default_rng(30).integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(images).float() / 255.0)
    logits = {}
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            model = m.build_model(cfg)
            model.load_state_dict(params)
            with torch.inference_mode():
                logits[device] = [t.cpu() for t in model.to(device).eval()(x.to(device))]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    err_f32 = max((a - b).abs().max().item() for a, b in zip(logits["cuda"], logits["cpu"]))
    check(err_f32 <= 1e-3, f"tiny RetinaNet float32 logits on the card differ from the CPU by "
                           f"{err_f32}")
    predict_cpu = m.make_int8_predict_fn(cfg, params, anchors, images, device="cpu")
    qp_cpu, spec = predict_cpu.qp, predict_cpu.spec
    check(isinstance(spec[0], engine.StemPoolPallasOp)
          and sum(isinstance(op, engine.BottleneckOp) for op in spec) == 12,
          "the tiny RetinaNet spec does not select both kernels")
    qp_gpu = qp_cpu.to("cuda")
    codes, heads, dets = {}, {}, {}
    with torch.inference_mode():
        for dev, qp in (("cuda", qp_gpu), ("cpu", qp_cpu)):
            codes[dev] = retinanet_codes(engine, qp, spec, cfg, x.to(dev))
            heads[dev] = engine.retinanet_int8_forward(qp, spec, cfg, x.to(dev))
            dets[dev] = postprocess(*heads[dev], torch.from_numpy(anchors).to(dev), cfg)
    check(list(codes["cuda"]) == list(codes["cpu"]) and len(codes["cpu"]) == 3 + 8 + 2 * 5,
          f"tiny RetinaNet requant points {list(codes['cpu'])}")
    for key, c in codes["cpu"].items():
        check(torch.equal(codes["cuda"][key].cpu(), c),
              f"tiny RetinaNet int8 codes at {key} on the card differ from the CPU: "
              f"{int((codes['cuda'][key].cpu() != c).sum())} codes")
    for g, c in zip(heads["cuda"], heads["cpu"]):
        check(torch.equal(g.cpu(), c), "tiny RetinaNet int8 logits on the card differ from the CPU")
    g, c = dets["cuda"], dets["cpu"]
    gv, cv = g.valid.cpu(), c.valid
    check(bool(gv.any()) and torch.equal(gv, cv) and torch.equal(g.classes.cpu()[gv], c.classes[cv])
          and torch.allclose(g.scores.cpu()[gv], c.scores[cv], rtol=0, atol=1e-5)
          and torch.allclose(g.boxes.cpu()[gv], c.boxes[cv], rtol=0, atol=1e-5),
          "tiny RetinaNet int8 detections on the card differ from the CPU")
    dataset = m.make_synthetic_dataset(num_images=12, image_size=128, seed=5)
    results = {}
    for name, int8 in (("evaluate_retinanet_float", False), ("evaluate_retinanet_int8", True)):
        results[name], launches[name] = counted(
            lambda: m.evaluate_dataset(cfg, params, dataset, int8=int8, device="cuda"))
        result = results[name]
        check({"mAP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100"} <= set(result)
              and all(np.isfinite(v) for v in result.values()),
              f"{name}: not a COCO dict of finite values: {result}")
    check(set(results["evaluate_retinanet_float"]) == set(results["evaluate_retinanet_int8"]),
          "the float and int8 RetinaNet evaluate dicts have different keys")
    batches = 2  # 12 images at eval.batch_size=8, the second batch overlapping the first
    check(launches["evaluate_retinanet_float"] == {**{k: 0 for k in wrappers}, "nms_rows": batches}
          and launches["evaluate_retinanet_int8"] == {
              **{k: 0 for k in wrappers}, "nms_rows": batches, "resnet_stem": batches,
              "fused_bottleneck": 12 * batches},
          f"RetinaNet evaluate launched {launches['evaluate_retinanet_float']} (float), "
          f"{launches['evaluate_retinanet_int8']} (int8)")
    return {"f32_logits_max_abs_err": err_f32,
            "logits_max_abs": max(t.abs().max().item() for t in logits["cpu"]),
            "int8_codes_equal_at": len(codes["cpu"]), "int8_logits_equal": True,
            "int8_valid": int(gv.sum()), "evaluate": results}


def resnet_train_phases(torch, np, m, counted, wrappers, launches, where) -> dict:
    """Phases 31 to 35: train both ResNet-50 families at full width through
    train(), serve each checkpoint through the CLI's main in float and
    int8 (the int8 kernels held on the trained model's own inputs), one step
    of each on the card against the CPU, and the int8-against-float mAP of
    a trained tiny_test. Returns the kernels' largest differences."""
    out = {"stem_err": 0, "bottleneck_err": 0, "nms_err": 0.0}
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_")
    try:
        # 31, 32. Train each family through train(), then time its step.
        checkpoints = {preset: train_resnet_family(torch, np, m, counted, wrappers, launches,
                                                   preset, f"{work.name}/{preset}", where)
                       for preset in ("ssd512_resnet50_coco", "retinanet_fpn_coco")}
        # 33. Serve each trained checkpoint through the CLI's main.
        for preset, ck in checkpoints.items():
            serve_trained(torch, np, m, counted, wrappers, launches, preset, ck, work.name, out,
                          where)
        # 34. One step of each family on the card against the CPU.
        print(json.dumps({"phase": "resnet_train_card_vs_cpu",
                          **resnet_train_card_vs_cpu(torch, np, m)}))
        # 35. The int8 engine's mAP against the float model's on a trained tiny_test.
        print(json.dumps({"phase": "int8_map_parity",
                          **int8_map_parity(torch, np, m, counted, launches, work.name), **where}))
    finally:
        work.cleanup()
    return out


def resnet_train_cfg(m, preset: str):
    """The preset at full width on the synthetic set, bs=32, logging every
    step; RetinaNet's data-parallel 16 cut to the one card."""
    extra = {"mesh.data_parallel": 1} if preset == "retinanet_fpn_coco" else {}
    return m.get_config(preset).override({"data.dataset": "synthetic",
                                          "train.batch_size": TRAIN_BATCH,
                                          "train.log_every": 1, **extra})


def train_resnet_family(torch, np, m, counted, wrappers, launches, preset: str, ck: str,
                        where) -> str:
    """Phase 31 (SSD-512) or 32 (RetinaNet): RESNET_TRAIN_STEPS steps of
    train() at full width in bfloat16 with a checkpoint; every metric finite
    with a positive anchor, every running statistic moved from its init,
    finite, variances >= 0, no kernel launched. Then the step on one batch
    with augmentation: median ms over RESNET_TIMED_STEPS after warm-up,
    img/s, peak memory, a profile window, and its BatchNorm passes and loss
    each profiled alone. Returns the checkpoint directory."""
    cfg = resnet_train_cfg(m, preset)
    family = cfg.model.family
    anchors = m.anchors_for_model(family, cfg.anchors, cfg.model.image_size)
    check(cfg.model.compute_dtype == "bfloat16" and cfg.model.image_size == 512
          and cfg.model.num_classes == 80
          and anchors.shape == ({"ssd": 24564, "retinanet": 49104}[family], 4),
          f"{preset} is not at the reference's full width: {cfg.model}, {anchors.shape}")
    dataset = m.make_synthetic_dataset(num_images=64, image_size=cfg.model.image_size)
    name = f"train_{preset}"
    t0 = time.perf_counter()
    state, launches[name] = counted(lambda: m.train(
        cfg, dataset, num_steps=RESNET_TRAIN_STEPS, metrics_path=f"{ck}.jsonl",
        checkpoint_dir=ck, device="cuda"))
    train_s = time.perf_counter() - t0
    with open(f"{ck}.jsonl") as f:
        rows = [json.loads(line) for line in f]
    check(state.step == RESNET_TRAIN_STEPS
          and [r["step"] for r in rows] == list(range(1, RESNET_TRAIN_STEPS + 1)),
          f"{preset}: train() logged steps {[r['step'] for r in rows]}")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in ("loss", "cls_loss", "box_loss", "grad_norm"))
              and r["num_positives"] >= 1, f"{preset}: bad training metrics {r}")
    check(launches[name] == {k: 0 for k in wrappers},
          f"{preset}: training launched {launches[name]}; its path holds no kernel")
    stats = state.batch_stats
    check(len(stats) == 106, f"{preset}: {len(stats)} running statistics, expected 106")
    for k, v in stats.items():
        init = 1.0 if k.endswith("running_var") else 0.0
        check(bool(torch.isfinite(v).all()) and bool((v != init).all())
              and (init == 0.0 or bool((v >= 0).all())),
              f"{preset}: running statistic {k} did not move from {init} or is not finite")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
          f"{preset}: parameters are not finite after training")
    check(sorted(os.listdir(ck)) == [f"step_{RESNET_TRAIN_STEPS}.pt"],
          f"{preset}: train() left checkpoints {sorted(os.listdir(ck))}")
    del state

    model, st = m.init_model_state(cfg, seed=0, device="cuda")
    step_fn = m.make_train_step(cfg, model, anchors, device="cuda", augment=True)
    cache = m.DecodedCache(dataset, cfg.model.image_size, cfg.data.max_boxes, 4)
    batch = m.make_place(torch.device("cuda"))(cache.gather(np.arange(TRAIN_BATCH)))
    torch.cuda.current_stream().wait_event(batch.pop("_ready"))
    gen = torch.Generator().manual_seed(0)

    def one_step():
        step_fn(st, batch, gen)

    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(torch, one_step, RESNET_TIMED_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_window(torch, one_step, 3)
    parts = resnet_step_parts(torch, m, cfg, model, st, batch, anchors)
    print(json.dumps({"phase": name, "steps": RESNET_TRAIN_STEPS, "seconds": train_s,
                      "batch": TRAIN_BATCH, "launches": launches[name],
                      "losses": [r["loss"] for r in rows],
                      "num_positives": [r["num_positives"] for r in rows],
                      "grad_norms": [r["grad_norm"] for r in rows],
                      "running_statistics_moved": len(stats),
                      "median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
                      "max_ms": max(step_ms),
                      "img_per_s": TRAIN_BATCH / (statistics.median(step_ms) / 1e3),
                      "peak_memory_gib": peak_gib, "profile": prof, "parts": parts, **where}))
    del model, st, step_fn, batch, cache
    torch.cuda.empty_cache()
    return ck


def resnet_step_parts(torch, m, cfg, model, state, batch, anchors) -> dict:
    """Device ms of two parts of a step, each profiled alone on the step's
    own tensors: every BatchNorm's training forward and backward (batch
    statistics, normalization, running update) on the input the forward
    gave it, with that input as the cotangent; and the loss's forward and
    backward on the logits and targets of the (unaugmented) batch."""
    captured = []
    hooks = [bn.register_forward_pre_hook(lambda mod, args: captured.append((mod, args[0].detach())))
             for bn in model.modules() if isinstance(bn, m.BatchNorm)]
    images = m.normalize(batch["image"].float() / 255.0)
    params = {k: v.detach() for k, v in state.params.items()}
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    was = model.training
    try:
        model.train()
        with torch.no_grad():
            cls, box = torch.func.functional_call(model, {**params, **stats}, (images,))
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    model.train()
    inputs = [(bn, x.requires_grad_(True)) for bn, x in captured]

    def batchnorm_passes():
        for bn, x in inputs:
            torch.autograd.grad(bn(x), (x, bn.weight, bn.bias), x)

    targets = m.encode_batch_targets(batch["boxes"], batch["labels"], batch["valid"],
                                     torch.as_tensor(anchors, device="cuda"), cfg)
    cls, box = cls.detach().requires_grad_(True), box.detach().requires_grad_(True)
    t = cfg.train

    def loss_pass():
        total, _ = m.detection_loss(
            cls, box, targets.cls, targets.box, use_focal=t.use_focal,
            focal_alpha=t.focal_alpha, focal_gamma=t.focal_gamma,
            smooth_l1_beta=t.smooth_l1_beta, box_loss_weight=t.box_loss_weight,
            negatives_per_positive=t.negatives_per_positive)
        torch.autograd.grad(total, (cls, box))

    bn_prof = profile_window(torch, batchnorm_passes, 2)
    loss_prof = profile_window(torch, loss_pass, 3)
    model.train(was)
    return {"batchnorm_layers": len(inputs),
            "batchnorm_passes_device_ms": bn_prof.get("device_busy_ms_per_call"),
            "batchnorm_passes_device_ops": bn_prof.get("device_ops_per_call"),
            "loss_device_ms": loss_prof.get("device_busy_ms_per_call"),
            "loss_device_ops": loss_prof.get("device_ops_per_call"),
            "logits": list(cls.shape)}


def serve_trained(torch, np, m, counted, wrappers, launches, preset: str, ck: str, work_dir: str,
                  out: dict, where) -> None:
    """Phase 33 for one family: `predict --checkpoint` through the CLI's
    main, in-process, in float and with --int8, each giving the detections
    of a Predictor on the restored state_dict (EMA or params, with the
    running statistics) and the launch counts of one forward (int8: B6
    once, B7 twelve times, B1 once); the int8 path's kernels held bit-equal
    to their plain versions on its own inputs (trained weights and
    statistics) and the served detections equal to the plain versions' run
    on the same QuantParams; then `evaluate --checkpoint` in float and
    int8 over the 64-image synthetic set: COCO dicts of finite values."""
    from PIL import Image

    flags = ["--preset", preset, "--set", "data.dataset=synthetic", "--checkpoint", ck]
    if preset == "retinanet_fpn_coco":
        flags += ["--set", "mesh.data_parallel=1"]
    cfg = m.load_config(m.build_parser().parse_args(["evaluate", *flags]))
    served = m.restore_variables(cfg, ck)
    anchors = m.anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    image = np.random.default_rng(33).integers(0, 80, (375, 500, 3), dtype=np.uint8)
    image[100:300, 150:400] = (200, 60, 40)
    path = f"{work_dir}/{preset}.png"
    Image.fromarray(image).save(path)
    ih, iw = image.shape[:2]
    s = cfg.model.image_size
    canvas = torch.from_numpy(np.array(
        Image.fromarray(image).resize((s, s), Image.BILINEAR), np.uint8)[None]).cuda()
    report = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "float"
        name = f"predict_checkpoint_{preset}_{kind}"
        buf = io.StringIO()
        argv = ["predict", *flags, "--image", path, "--score-threshold", "0.0"]
        with contextlib.redirect_stdout(buf):
            rc, launches[name] = counted(lambda: m.cli_main(argv + (["--int8"] if int8 else [])))
        check(rc == 0, f"{name}: main returned {rc}")
        want = RESNET_INT8_LAUNCHES if int8 else {**{k: 0 for k in wrappers}, "nms_rows": 1}
        check(launches[name] == want, f"{name} launched {launches[name]}, expected {want}")
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        predictor = m.Predictor(cfg, served, device="cuda", int8=int8)
        dets = predictor.predict_array(image, score_threshold=0.0)
        check(len(lines) == len(dets) > 0
              and [d["score"] for d in lines] == [round(d.score, 4) for d in dets]
              and [d["class"] for d in lines] == [d.class_name for d in dets],
              f"{name}: the command's detections differ from a Predictor's on the restored "
              f"state_dict ({len(lines)} against {len(dets)})")
        if int8:
            held = hold_resnet_int8_path(torch, m.engine, m.resnet_stem, m.bottleneck,
                                         m.postprocess, m.normalize, predictor._predict, canvas,
                                         anchors, cfg)
            det1 = held["detections"]
            out["stem_err"] = max(out["stem_err"], held["stem_err"])
            out["bottleneck_err"] = max(out["bottleneck_err"], held["bottleneck_err"])
            out["nms_err"] = max(out["nms_err"], held["nms_err"])
            nms_rows = held["nms_rows"]
            del held
        else:
            rows, det1 = hold_path(torch, m.nms_kernel, m.normalize, predictor.model, canvas,
                                   anchors, cfg)
            out["nms_err"] = max(out["nms_err"], rows["max_abs_err"])
            nms_rows = list(rows["scores"].shape)
            del rows
        check(served_equal(torch, dets, det1, iw, ih),
              f"{name}: the served detections differ from the plain versions' run")
        report[name] = {"detections": len(dets), "launches": launches[name],
                        "nms_rows": nms_rows, "kernels_vs_plain_bit_equal": True,
                        "served_equal_plain_run": True, "top_score": dets[0].score}
        del predictor
    batches = -(-64 // cfg.eval.batch_size)
    for int8 in (False, True):
        name = f"evaluate_checkpoint_{preset}_{'int8' if int8 else 'float'}"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, launches[name] = counted(lambda: m.cli_main(
                ["evaluate", *flags] + (["--int8"] if int8 else [])))
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name}: main returned {rc}")
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        check({"mAP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100"} <= set(result)
              and all(np.isfinite(v) for v in result.values()),
              f"{name}: not a COCO dict of finite values: {result}")
        per_batch = RESNET_INT8_LAUNCHES if int8 else {**{k: 0 for k in wrappers}, "nms_rows": 1}
        want = {k: v * batches for k, v in per_batch.items()}
        check(launches[name] == want, f"{name} launched {launches[name]}, expected {want}")
        report[name] = {"result": result, "launches": launches[name], "seconds": seconds}
    torch.cuda.empty_cache()
    print(json.dumps({"phase": f"serve_trained_{preset}", "checkpoint_steps": RESNET_TRAIN_STEPS,
                      **report, **where}))


def resnet_train_card_vs_cpu(torch, np, m) -> dict:
    """One step (sgd, momentum, weight decay, clipping, the EMA at 0.9, lr
    1e-2, no warmup) of the 64 px SSD/ResNet-50 config and of
    tiny_retinanet_config on the card against the CPU: the same seeded
    weights and BatchNorm statistics, two images of seeded noise under the
    synthetic set's boxes (from the pixel values whose normalization the
    two devices round alike, below). In float64 compute (float32 parameters and loss):
    the loss within 1e-5 relative, every gradient within rtol 1e-4 and atol
    1e-4, the updated params and EMA within rtol 1e-5 and atol 2e-6, the
    running statistics within 1e-4 (the CPU tests' bounds against the
    reference). In float32 with TF32 off, where fifty training-mode
    BatchNorms amplify the rounding of two devices' sums: the loss within
    1e-4 relative, every gradient within 5e-2 of the model's largest
    gradient (the CPU's own float32 stem gradient is 1e-2 of it from its
    float64 one), the params and EMA within 1e-4 and the statistics within
    1e-3, relative and absolute."""
    # The card divides the uint8 images by 255 as a multiply by the float32
    # reciprocal (a scalar divisor), the CPU divides: one ulp apart on 126
    # of the 256 values. These steps amplify an ulp of their input (it moves
    # the logits by about 6e-5 and some gradients by 10%: at 64 and 128 px,
    # C5's BatchNorms see 8 and 32 values a channel), so the pixels are
    # drawn from the 130 values on which both give the same input.
    v = np.arange(256, dtype=np.float32)
    exact_pixels = np.flatnonzero(v / np.float32(255) == v * (np.float32(1) / np.float32(255)))
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    report = {"pixel_values": len(exact_pixels)}
    try:
        for family, base in (("ssd64_resnet", ssd64_resnet_config(m.port_config)),
                             ("tiny_retinanet", m.port_config.tiny_retinanet_config())):
            base = base.override({"train.warmup_steps": 0, "train.base_lr": 1e-2,
                                  "train.ema_decay": 0.9, "train.optimizer": "sgd"})
            s = base.model.image_size
            weights = m.init_params(m.build_model(base), seed=3,
                                    random_batch_stats=True).state_dict()
            cache = m.DecodedCache(m.make_synthetic_dataset(num_images=2, image_size=s), s,
                                   base.data.max_boxes, 1)
            batch = cache.gather(np.arange(2))
            batch["image"] = np.random.default_rng(0).choice(
                exact_pixels, batch["image"].shape).astype(np.uint8)
            anchors = m.anchors_for_model(base.model.family, base.anchors, s)
            for dtype in ("float64", "float32"):
                cfg = base.override({"model.compute_dtype": dtype})
                got = {dev: train_step_on(torch, m, cfg, weights, batch, anchors, dev)
                       for dev in ("cuda", "cpu")}
                report[f"{family}_{dtype}"] = compare_steps(torch, got["cuda"], got["cpu"], dtype,
                                                            f"{family} {dtype}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    return report


def train_step_on(torch, m, cfg, weights, batch, anchors, device) -> dict:
    """One step of the port on ``device``: loss, gradients (from loss_fn),
    updated params, EMA and running statistics, on the CPU."""
    st = m.create_train_state(cfg.train, {k: v.to(device) for k, v in weights.items()})
    fn = m.make_train_step(cfg, m.build_model(cfg), anchors, device=device, augment=False)
    on_device = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    total, _, _ = fn.loss_fn(st.params, st.batch_stats, on_device, 0)
    grads = torch.autograd.grad(total, list(st.params.values()))
    st, _ = fn(st, on_device, torch.Generator().manual_seed(0))
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    return {"loss": float(total.detach()), "grads": dict(zip(st.params, (g.cpu() for g in grads))),
            "params": cpu(st.params), "ema": cpu(st.ema_params), "stats": cpu(st.batch_stats)}


def compare_steps(torch, card, cpu, dtype: str, label: str) -> dict:
    """Holds one step on the card against the CPU's with the bounds of
    `resnet_train_card_vs_cpu`; returns the largest differences."""
    f64 = dtype == "float64"
    check(abs(card["loss"] - cpu["loss"]) <= (1e-5 if f64 else 1e-4) * abs(cpu["loss"]),
          f"{label}: the step's loss on the card {card['loss']} differs from the CPU's "
          f"{cpu['loss']}")
    scale = max(float(g.abs().max()) for g in cpu["grads"].values())
    worst = {}
    for part, (rtol, atol) in (("grads", (1e-4, 1e-4) if f64 else (0.0, 5e-2 * scale)),
                               ("params", (1e-5, 2e-6) if f64 else (1e-4, 1e-4)),
                               ("ema", (1e-5, 2e-6) if f64 else (1e-4, 1e-4)),
                               ("stats", (1e-4, 1e-4) if f64 else (1e-3, 1e-3))):
        check(set(card[part]) == set(cpu[part]) and len(cpu[part]) > 0,
              f"{label}: the card's {part} leaves differ from the CPU's")
        worst[part] = 0.0
        for k, want in cpu[part].items():
            got = card[part][k]
            worst[part] = max(worst[part], float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"{label}: {part} {k} on the card differs from the CPU's by "
                  f"{float((got - want).abs().max())}")
    return {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "largest_gradient": scale,
            "leaves": len(cpu["grads"]), "statistics": len(cpu["stats"]),
            "max_abs_diff": worst}


def int8_map_parity(torch, np, m, counted, launches, work_dir: str) -> dict:
    """Phase 35, the counterpart of tests/test_e2e.py:76: tiny_test trained
    E2E_STEPS steps at E2E_LR on E2E_IMAGES synthetic images (crop and
    expand off) through train() on the card, then evaluate_dataset on the
    card over the same images: |float mAP - int8 mAP| < E2E_MAX_GAP and
    int8 mAP > E2E_MIN_INT8, the reference's bounds."""
    cfg = m.get_config("tiny_test").override({
        "train.num_steps": E2E_STEPS, "train.base_lr": E2E_LR, "train.checkpoint_every": 30,
        "data.augment.crop_prob": 0.0, "data.augment.expand_prob": 0.0})
    dataset = m.make_synthetic_dataset(num_images=E2E_IMAGES, image_size=cfg.model.image_size)
    t0 = time.perf_counter()
    state = m.train(cfg, dataset, metrics_path=f"{work_dir}/e2e.jsonl",
                    checkpoint_dir=f"{work_dir}/e2e", device="cuda")
    train_s = time.perf_counter() - t0
    with open(f"{work_dir}/e2e.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    check(state.step == E2E_STEPS and losses[-1] < losses[0],
          f"tiny_test: {state.step} steps, losses {losses}")
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    maps = {}
    for kind, int8 in (("float", False), ("int8", True)):
        result, launches[f"e2e_evaluate_{kind}"] = counted(
            lambda: m.evaluate_dataset(cfg, params, dataset, int8=int8, device="cuda"))
        maps[kind] = result["mAP"]
    gap = abs(maps["float"] - maps["int8"])
    check(np.isfinite(maps["float"]) and np.isfinite(maps["int8"]) and gap < E2E_MAX_GAP
          and maps["int8"] > E2E_MIN_INT8,
          f"tiny_test trained {E2E_STEPS} steps: float mAP {maps['float']}, int8 mAP "
          f"{maps['int8']}; the bounds are |gap| < {E2E_MAX_GAP} and int8 > {E2E_MIN_INT8}")
    return {"steps": E2E_STEPS, "train_seconds": train_s, "losses_first_last": [losses[0],
            losses[-1]], "float_mAP": maps["float"], "int8_mAP": maps["int8"], "gap": gap,
            "launches": {k: launches[f"e2e_evaluate_{k}"] for k in maps}}


# ---------------------------------------------------------------------------
# Phases 36 to 38: data-parallel training (parallel/mesh.py).
# ---------------------------------------------------------------------------

# Steps each rank times in bfloat16 after the checked step (phases 36, 37),
# and the NCCL-against-plain step timings of phase 38, each in turns.
DP_TIMED_STEPS, NCCL_TIMED_STEPS = 5, 8
# The one-step comparison's overrides: a full rate from the first step and an
# EMA to compare (the presets warm up from a rate of 0 and keep no EMA).
DP_STEP_OVERRIDES = {"train.warmup_steps": 0, "train.ema_decay": 0.9}
# Phase 37 steps with sgd at 1e-2, as phase 34: AdamW's first update is
# about lr * sign(g), where a gradient near 0 may flip its sign.
DP_RESNET_OVERRIDES = {"train.warmup_steps": 0, "train.base_lr": 1e-2, "train.ema_decay": 0.9,
                       "train.optimizer": "sgd"}
# Phase 37's float64 bounds against one process (the float64 class of
# tests/test_torch_resnet_train.py): loss relative; (rtol, atol) by part.
DP_F64_LOSS_RTOL = 1e-5
DP_F64_TOL = {"params": (1e-5, 2e-6), "ema": (1e-5, 2e-6), "stats": (1e-4, 1e-4)}


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches (the NMS
    scan's two instantiations apart)."""
    from object_detector_tpu_torch.kernels import (
        bottleneck, l2norm, nms, pool_bwd, resnet_stem, stem, stem_fp,
    )

    return {"nms_rows": nms.nms_rows, "nms_rows_bf16": nms.nms_rows.bf16,
            "stem_conv12_pool": stem.stem_conv12_pool,
            "l2norm_requant": l2norm.l2norm_requant, "max_pool_bwd": pool_bwd.max_pool_bwd,
            "resnet_stem": resnet_stem.resnet_stem, "fused_bottleneck": bottleneck.fused_bottleneck,
            "stem_fused_producer": stem_fp.stem_fused_producer}


def dp_spawn(torch, world: int, fn_name: str, args: tuple, work_dir: str) -> list:
    """Runs this script's ``fn_name(torch, rank, world, *args)`` in ``world``
    processes (the spawn start method) over a gloo group, every rank on
    cuda:0 (NCCL refuses two ranks on one device); returns each rank's
    result. A rank that raises ends the others and the phase."""
    import torch.multiprocessing as mp

    os.makedirs(work_dir)
    mp.spawn(_dp_entry, args=(world, work_dir, fn_name, args), nprocs=world, join=True)
    return [torch.load(f"{work_dir}/rank{r}.pt", weights_only=False) for r in range(world)]


def _dp_entry(rank: int, world: int, work_dir: str, fn_name: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work_dir}/rendezvous", rank=rank,
                            world_size=world)
    try:
        torch.save(globals()[fn_name](torch, rank, world, *args), f"{work_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_cfg(get_config, preset: str, batch: int, dtype: str, overrides: dict):
    return get_config(preset).override({
        "data.dataset": "synthetic", "train.batch_size": batch, "mesh.data_parallel": 2,
        "model.compute_dtype": dtype, "model.pool_grad_kernel": preset.startswith("ssd300"),
        **overrides})


def dp_rank_state(torch, mesh, st) -> dict:
    """Whether every rank holds rank 0's params, EMA and statistics (each
    tensor broadcast from rank 0 and compared), and rank 0's on the CPU."""
    tensors = [*st.params.values(), *st.ema_params.values(), *st.batch_stats.values()]
    differ = 0
    for t in tensors:
        theirs = t.detach().clone()
        mesh.broadcast_(theirs)
        differ += int(not torch.equal(theirs, t))
    differ = int(mesh.all_reduce_(torch.tensor([differ], device=mesh.device)).item())
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    return {"ranks_bit_equal": differ == 0, "tensors": len(tensors),
            **({"params": cpu(st.params), "ema": cpu(st.ema_params),
                "stats": cpu(st.batch_stats)} if mesh.rank == 0 else {})}


def dp_timing(torch, mesh, cfg, model_state, make_train_step, anchors, rows) -> dict:
    """Host ms of DP_TIMED_STEPS steps (after warm-up, ranks aligned by a
    barrier), the gradient all-reduce alone (host ms of all_reduce_buckets
    on tensors of the gradients' shapes, median of 5) and, from a profile
    window of two steps, the host time a step of each op whose name holds
    "all_reduce" or "allreduce" (nested ops each count their children)."""
    from torch.profiler import ProfilerActivity, profile

    model, st = model_state
    fn = make_train_step(cfg, model, anchors, mesh=mesh, augment=True)
    gen = torch.Generator().manual_seed(1)
    mesh.barrier()
    step_ms = host_ms(torch, lambda: fn(st, rows, gen), DP_TIMED_STEPS)
    grads = [torch.ones_like(p) for p in st.params.values()]
    mesh.barrier()
    reduce_ms = host_ms(torch, lambda: mesh.all_reduce_buckets(grads), 5)
    mesh.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn(st, rows, gen)
        torch.cuda.synchronize()
    ops = {e.key: e.cpu_time_total / 2e3 for e in prof.key_averages()
           if "allreduce" in e.key.lower() or "all_reduce" in e.key.lower()}
    return {"step_median_ms": statistics.median(step_ms), "step_ms": step_ms,
            "gradient_all_reduce_median_ms": statistics.median(reduce_ms),
            "gradient_bytes": sum(g.numel() * 4 for g in grads),
            "profile_all_reduce_ops_host_ms_per_step": ops or "not measured"}


def dp_ssd300_rank(torch, rank: int, world: int, batch_np) -> dict:
    """Phase 36 on one rank: one float32 step (TF32 off, augmentation on)
    of its rows through make_train_step(mesh=...), capturing what the four
    pool backwards were given and holding the kernel bit-equal to its plain
    version on them; then DP_TIMED_STEPS bfloat16 steps timed."""
    import numpy as np
    import torch.distributed as dist

    from object_detector_tpu_torch.anchors.priors import anchors_for_model
    from object_detector_tpu_torch.core.config import get_config
    from object_detector_tpu_torch.kernels import pool_bwd
    from object_detector_tpu_torch.ops import pooling
    from object_detector_tpu_torch.parallel.mesh import Mesh, shard_batch
    from object_detector_tpu_torch.train.loop import init_model_state
    from object_detector_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(dist.group.WORLD, rank, world, torch.device("cuda", 0))
    cfg = dp_cfg(get_config, "ssd300_voc_train_dp8", len(batch_np["image"]), "float32",
                 DP_STEP_OVERRIDES)
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    model, st = init_model_state(cfg, 0, mesh.device)
    fn = make_train_step(cfg, model, anchors, mesh=mesh, augment=True)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in shard_batch(mesh, batch_np).items()}
    captured = []

    def capture(x, y, g):
        captured.append((x, y, g))
        return pool_bwd.max_pool_bwd(x, y, g)

    pooling.max_pool_bwd = capture
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    before = mesh.bytes_reduced
    try:
        st, metrics = fn(st, rows, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    finally:
        pooling.max_pool_bwd = pool_bwd.max_pool_bwd
    launches = {name: w.launches for name, w in wrappers.items()}
    bytes_a_step = mesh.bytes_reduced - before
    pool_err, pool_equal = 0.0, True
    for x, y, g in captured:
        got, want = pool_bwd.max_pool_bwd(x, y, g), pool_bwd.max_pool_bwd_reference(x, y, g)
        pool_err = max(pool_err, (got - want).abs().max().item())
        pool_equal &= torch.equal(got.view(torch.int32), want.view(torch.int32))
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches,
           "pool_inputs": [list(x.shape) for x, _, _ in captured], "pool_err": pool_err,
           "pool_bit_equal": pool_equal, "bytes_all_reduced_a_step": bytes_a_step,
           **dp_rank_state(torch, mesh, st)}
    del st, model, fn, captured
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    bf16 = dp_cfg(get_config, "ssd300_voc_train_dp8", len(batch_np["image"]), "bfloat16", {})
    out["bf16"] = dp_timing(torch, mesh, bf16, init_model_state(bf16, 0, mesh.device),
                            make_train_step, anchors, rows)
    return out


def dp_retinanet_rank(torch, rank: int, world: int, batch_np) -> dict:
    """Phase 37 on one rank: one step of its two images without augmentation
    in float64 and in float32 (TF32 off) with BatchNorm on the global
    batch's moments, and in float64 with each BatchNorm on its rank's images
    only (the step's reduction dropped); then DP_TIMED_STEPS bfloat16 steps
    timed (augmentation on)."""
    import numpy as np
    import torch.distributed as dist

    from object_detector_tpu_torch.anchors.priors import anchors_for_model
    from object_detector_tpu_torch.core.config import get_config
    from object_detector_tpu_torch.models.resnet import BatchNorm
    from object_detector_tpu_torch.parallel.mesh import Mesh, shard_batch
    from object_detector_tpu_torch.train.loop import init_model_state
    from object_detector_tpu_torch.train.step import make_train_step

    class PerRank(BatchNorm):
        all_reduce = property(lambda self: None, lambda self, value: None)

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(dist.group.WORLD, rank, world, torch.device("cuda", 0))
    total = len(batch_np["image"])
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in shard_batch(mesh, batch_np).items()}
    out = {}
    wrappers = kernel_wrappers()
    for name, dtype, per_rank in (("float64", "float64", False), ("float32", "float32", False),
                                  ("float64_per_rank", "float64", True)):
        cfg = dp_cfg(get_config, "retinanet_fpn_coco", total, dtype, DP_RESNET_OVERRIDES)
        anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
        model, st = init_model_state(cfg, 0, mesh.device)
        if per_rank:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.__class__ = PerRank
        fn = make_train_step(cfg, model, anchors, mesh=mesh, augment=False)
        for w in wrappers.values():
            w.launches = 0
        before = mesh.bytes_reduced
        st, metrics = fn(st, rows, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "launches": {k: w.launches for k, w in wrappers.items()},
                     "bytes_all_reduced_a_step": mesh.bytes_reduced - before,
                     **dp_rank_state(torch, mesh, st)}
        del model, st, fn
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    bf16 = dp_cfg(get_config, "retinanet_fpn_coco", total, "bfloat16", {})
    out["bf16"] = dp_timing(torch, mesh, bf16, init_model_state(bf16, 0, mesh.device),
                            make_train_step, anchors_for_model("retinanet", bf16.anchors, 512),
                            rows)
    return out


def one_process_step(torch, np, m, cfg, batch_np, augment: bool) -> dict:
    """One step of cfg on the whole batch in this process (no mesh), from
    the seed-0 state: metrics, and params, EMA and statistics on the CPU."""
    anchors = m.anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    model, st = m.init_model_state(cfg, seed=0, device="cuda")
    fn = m.make_train_step(cfg, model, anchors, device="cuda", augment=augment)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    st, metrics = fn(st, batch, torch.Generator().manual_seed(0))
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "params": cpu(st.params),
           "ema": cpu(st.ema_params), "stats": cpu(st.batch_stats)}
    del model, st, fn, batch
    torch.cuda.empty_cache()
    return out


def dp_diff(torch, got: dict, want: dict) -> dict:
    """Largest absolute difference by part, and the loss's relative one."""
    out = {"loss_rel": abs(got["metrics"]["loss"] - want["metrics"]["loss"])
           / abs(want["metrics"]["loss"])}
    for part in ("params", "ema", "stats"):
        check(set(got[part]) == set(want[part]), f"DP and one-process {part} leaves differ")
        out[part] = max((float((got[part][k] - want[part][k]).abs().max())
                         for k in want[part]), default=0.0)
    return out


def dp_within(torch, got: dict, want: dict, tol: dict) -> bool:
    return all(torch.allclose(got[part][k], want[part][k], rtol=rtol, atol=atol)
               for part, (rtol, atol) in tol.items() for k in want[part])


def data_parallel_phases(torch, np, m, launches, where) -> dict:
    """Phases 36 to 38. Returns the pool kernel's largest difference from
    its plain version on the ranks' inputs and the NMS kernel's on the
    served checkpoint."""
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    try:
        out = dp_ssd300_phase(torch, np, m, launches, f"{work.name}/36", where)
        dp_retinanet_phase(torch, np, m, launches, f"{work.name}/37", where)
        out["nms_err"] = nccl_launch_phase(torch, np, m, launches, f"{work.name}/38", where)
    finally:
        work.cleanup()
    return out


def dp_ssd300_phase(torch, np, m, launches, work_dir: str, where) -> dict:
    """Phase 36: ssd300_voc_train_dp8 at full width over two gloo ranks on
    the card, 32 images a rank (the preset's 256 / 8), against one process
    at bs=64 from the same state and batch: loss within 1e-4 relative,
    params and EMA within 2e-5 (the reference's dp8 bounds), the ranks
    bit-equal, the pool kernel launched 4 times a step on each rank and
    bit-equal to its plain version on the rank's inputs."""
    cfg = dp_cfg(m.get_config, "ssd300_voc_train_dp8", 64, "float32", DP_STEP_OVERRIDES)
    check(cfg.model.image_size == 300 and cfg.model.family == "ssd"
          and cfg.model.backbone == "vgg16", f"ssd300_voc_train_dp8 is not SSD-300: {cfg.model}")
    cache = m.DecodedCache(m.make_synthetic_dataset(num_images=64, image_size=300), 300,
                           cfg.data.max_boxes, 4)
    batch = cache.gather(np.arange(64))
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = one_process_step(torch, np, m, cfg.override({"mesh.data_parallel": 1}), batch,
                               augment=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    t0 = time.perf_counter()
    ranks = dp_spawn(torch, 2, "dp_ssd300_rank", (batch,), work_dir)
    seconds = time.perf_counter() - t0
    got = ranks[0]
    want_launches = {**{k: 0 for k in m.wrappers}, "max_pool_bwd": 4}
    for r, rank in enumerate(ranks):
        launches[f"dp2_ssd300_rank{r}"] = rank["launches"]
        check(rank["launches"] == want_launches, f"rank {r} launched {rank['launches']} in "
              f"one step, expected {want_launches}")
        check(rank["pool_bit_equal"], f"rank {r}: the pool kernel differs from its plain "
              f"version on the rank's inputs by {rank['pool_err']}")
        check(rank["ranks_bit_equal"], f"rank {r}: the ranks' params or EMA differ")
        check(rank["metrics"] == got["metrics"], f"rank {r}'s metrics differ from rank 0's")
    diff = dp_diff(torch, got, one)
    check(diff["loss_rel"] <= 1e-4, f"DP-2 loss {got['metrics']['loss']} against one "
          f"process's {one['metrics']['loss']}")
    check(got["metrics"]["num_positives"] == one["metrics"]["num_positives"],
          "DP-2 counts other positives than one process")
    check(dp_within(torch, got, one, {"params": (0.0, 2e-5), "ema": (0.0, 2e-5)}),
          f"DP-2 params or EMA differ from one process's by {diff}")
    n_params = sum(v.numel() for v in one["params"].values())
    check(got["bytes_all_reduced_a_step"] == 4 * n_params + 8 + 12,
          f"{got['bytes_all_reduced_a_step']} bytes all-reduced a step, expected the "
          f"gradients' {4 * n_params} and 20 of metrics")
    print(json.dumps({"phase": "dp2_ssd300_voc_train_dp8", "ranks": 2, "backend": "gloo",
                      "images_a_rank": 32, "seconds_with_spawn": seconds,
                      "metrics_dp2": got["metrics"], "metrics_one_process": one["metrics"],
                      "max_abs_diff": diff, "launches_by_rank": [r["launches"] for r in ranks],
                      "pool_inputs": got["pool_inputs"], "pool_kernel_bit_equal": True,
                      "ranks_bit_equal": True, "bytes_all_reduced_a_step":
                      got["bytes_all_reduced_a_step"],
                      "bf16_timing_by_rank": [r["bf16"] for r in ranks], **where}))
    return {"pool_err": max(r["pool_err"] for r in ranks)}


def dp_retinanet_phase(torch, np, m, launches, work_dir: str, where) -> None:
    """Phase 37: retinanet_fpn_coco at full width (512 px) over two gloo
    ranks on the card, 2 images a rank (the preset's 32 / 16), BatchNorm
    on the global batch's moments, against one process at bs=4 from the
    same state and batch (no augmentation, sgd at 1e-2). In float64: loss
    within DP_F64_LOSS_RTOL, params, EMA and the 106 running statistics
    within DP_F64_TOL, the ranks bit-equal; float32 (TF32 off) recorded
    beside it. The float64 step with each BatchNorm on its rank's images
    lands outside DP_F64_TOL: the reduction is needed."""
    base = dp_cfg(m.get_config, "retinanet_fpn_coco", 4, "float64", DP_RESNET_OVERRIDES)
    check(base.model.image_size == 512 and base.model.family == "retinanet",
          f"retinanet_fpn_coco is not at full width: {base.model}")
    cache = m.DecodedCache(m.make_synthetic_dataset(num_images=4, image_size=512), 512,
                           base.data.max_boxes, 4)
    batch = cache.gather(np.arange(4))
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = {dtype: one_process_step(torch, np, m, base.override({
            "model.compute_dtype": dtype, "mesh.data_parallel": 1}), batch, augment=False)
            for dtype in ("float64", "float32")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    ranks = dp_spawn(torch, 2, "dp_retinanet_rank", (batch,), work_dir)
    report = {}
    for name in ("float64", "float32", "float64_per_rank"):
        got = ranks[0][name]
        want = one[name.split("_")[0]]
        check(len(want["stats"]) == 106, f"{len(want['stats'])} running statistics")
        report[name] = {"max_abs_diff": dp_diff(torch, got, want),
                        "ranks_bit_equal": all(r[name]["ranks_bit_equal"] for r in ranks),
                        "bytes_all_reduced_a_step": got["bytes_all_reduced_a_step"],
                        "loss_dp2": got["metrics"]["loss"], "loss_one": want["metrics"]["loss"]}
        for k, v in got["metrics"].items():
            check(np.isfinite(v), f"{name}: metric {k} is {v}")
    f64 = report["float64"]
    check(f64["ranks_bit_equal"] and report["float32"]["ranks_bit_equal"],
          "the ranks' params, EMA or running statistics differ")
    check(f64["max_abs_diff"]["loss_rel"] <= DP_F64_LOSS_RTOL
          and dp_within(torch, ranks[0]["float64"], one["float64"], DP_F64_TOL),
          f"float64 DP-2 step against one process: {f64['max_abs_diff']}")
    check(not dp_within(torch, ranks[0]["float64_per_rank"], one["float64"],
                        {"stats": DP_F64_TOL["stats"]}),
          "per-rank BatchNorm statistics land within the bound: the check cannot tell")
    for r, rank in enumerate(ranks):
        launches[f"dp2_retinanet_rank{r}"] = rank["float64"]["launches"]
        check(all(rank[name]["launches"] == {k: 0 for k in m.wrappers} for name in report),
              f"rank {r}: RetinaNet training launched a kernel; its path holds none")
    print(json.dumps({"phase": "dp2_retinanet_fpn_coco", "ranks": 2, "backend": "gloo",
                      "images_a_rank": 2, "running_statistics": 106, **report,
                      "bf16_timing_by_rank": [r["bf16"] for r in ranks], **where}))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_launch_phase(torch, np, m, launches, work_dir: str, where) -> float:
    """Phase 38: `train` under the real launcher on the real backend:
    torch.distributed.run with one process, NCCL, ssd300_voc_train_dp8 at
    mesh.data_parallel=-1 and bs=32 with the pool kernel on the synthetic
    set, a checkpoint and metrics; its checkpoint served by `predict
    --checkpoint` in-process (B1 once); the preset unmodified refused with
    the reference's error on this host's cards; then the step through an
    NCCL group of one in this process timed against the step without a mesh
    at the same bs=32, in turns. Returns the NMS kernel's largest
    difference from its plain version on the served rows."""
    from PIL import Image

    os.makedirs(work_dir)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")])}
    steps = 4
    flags = ["--preset", "ssd300_voc_train_dp8", "--set", "mesh.data_parallel=-1",
             "--set", "train.batch_size=32", "--set", "model.pool_grad_kernel=True",
             "--set", "data.dataset=synthetic", "--set", "train.log_every=1"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--nnodes", "1", "--master_addr", "localhost", "--master_port", str(free_port()),
           "-m", "object_detector_tpu_torch", "train", *flags, "--steps", str(steps),
           "--checkpoint", f"{work_dir}/ck", "--metrics", f"{work_dir}/train.jsonl"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    launch_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun train exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    check("1 rank(s), backend nccl" in proc.stderr,
          f"torchrun train made no NCCL group of one:\n{proc.stderr[-2000:]}")
    with open(f"{work_dir}/train.jsonl") as f:
        rows = [json.loads(line) for line in f]
    check([r["step"] for r in rows] == list(range(1, steps + 1)), f"logged steps {rows}")
    for r in rows:
        check(r["imgs_per_sec_chip"] == r["imgs_per_sec"] / 1 and np.isfinite(r["loss"]),
              f"torchrun train logged {r}")
    check(os.listdir(f"{work_dir}/ck") == [f"step_{steps}.pt"],
          f"torchrun train left {os.listdir(f'{work_dir}/ck')}")

    image = np.random.default_rng(38).integers(0, 80, (375, 500, 3), dtype=np.uint8)
    image[100:300, 150:400] = (200, 60, 40)
    Image.fromarray(image).save(f"{work_dir}/image.png")
    buf = io.StringIO()
    argv = ["predict", *flags, "--checkpoint", f"{work_dir}/ck", "--image",
            f"{work_dir}/image.png", "--score-threshold", "0.0"]
    with contextlib.redirect_stdout(buf):
        rc, launches["predict_checkpoint_nccl_trained"] = m.counted(lambda: m.cli_main(argv))
    served = [json.loads(line) for line in buf.getvalue().splitlines()]
    check(rc == 0 and len(served) > 0, f"predict --checkpoint of the torchrun checkpoint: rc "
          f"{rc}, {len(served)} detections")
    want = {**{k: 0 for k in m.wrappers}, "nms_rows": 1}
    check(launches["predict_checkpoint_nccl_trained"] == want,
          f"predict --checkpoint launched {launches['predict_checkpoint_nccl_trained']}")
    cfg = m.load_config(m.build_parser().parse_args(["predict", *flags, "--image", "x"]))
    predictor = m.Predictor(cfg, m.restore_variables(cfg, f"{work_dir}/ck"), device="cuda")
    canvas = torch.from_numpy(np.array(Image.fromarray(image).resize(
        (300, 300), Image.BILINEAR), np.uint8)[None]).cuda()
    held, _ = hold_path(torch, m.nms_kernel, m.normalize, predictor.model, canvas,
                        m.anchors_for_model("ssd", cfg.anchors, 300), cfg)
    del predictor

    refused = subprocess.run(
        [sys.executable, "-m", "object_detector_tpu_torch", "train", "--preset",
         "ssd300_voc_train_dp8"], capture_output=True, text=True, timeout=300, env=env)
    message = (f"requested 8-way data parallelism but only {torch.cuda.device_count()} "
               "devices")
    check(refused.returncode != 0 and message in refused.stderr,
          f"train --preset ssd300_voc_train_dp8 exited {refused.returncode} without "
          f"{message!r}:\n{refused.stderr[-2000:]}")

    nccl = nccl_step_timing(torch, np, m, cfg, work_dir)
    print(json.dumps({"phase": "nccl_launch", "launcher": "torch.distributed.run",
                      "backend": "nccl", "ranks": 1, "steps": steps, "seconds": launch_s,
                      "losses": [r["loss"] for r in rows],
                      "imgs_per_sec": [r["imgs_per_sec"] for r in rows],
                      "imgs_per_sec_chip": [r["imgs_per_sec_chip"] for r in rows],
                      "served_detections": len(served),
                      "served_launches": launches["predict_checkpoint_nccl_trained"],
                      "refused_with": message, **nccl, **where}))
    return held["max_abs_err"]


def nccl_step_timing(torch, np, m, cfg, work_dir: str) -> dict:
    """The bs=32 bfloat16 step through an NCCL process group of one in this
    process against the step without a mesh, same state, batch and draws,
    NCCL_TIMED_STEPS host-clock steps each in the order plain, NCCL, NCCL,
    plain; the difference is the cost of the collectives on one card."""
    import torch.distributed as dist

    from object_detector_tpu_torch.parallel.mesh import Mesh, shard_batch

    cfg = cfg.override({"train.batch_size": TRAIN_BATCH})
    dist.init_process_group("nccl", init_method=f"file://{work_dir}/nccl_rendezvous", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(dist.group.WORLD, 0, 1, torch.device("cuda", 0))
        anchors = m.anchors_for_model("ssd", cfg.anchors, 300)
        cache = m.DecodedCache(m.make_synthetic_dataset(num_images=TRAIN_BATCH, image_size=300),
                               300, cfg.data.max_boxes, 4)
        host = cache.gather(np.arange(TRAIN_BATCH))
        model, st = m.init_model_state(cfg, seed=0, device="cuda")
        steps = {
            "plain": (m.make_train_step(cfg, model, anchors, device="cuda"),
                      {k: torch.from_numpy(v).cuda() for k, v in host.items()}),
            "nccl": (m.make_train_step(cfg, model, anchors, mesh=mesh),
                     {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                      for k, v in shard_batch(mesh, host).items()}),
        }
        gen = torch.Generator().manual_seed(0)
        times = {"plain": [], "nccl": []}
        before = mesh.bytes_reduced
        for kind in ("plain", "nccl", "nccl", "plain"):
            fn, batch = steps[kind]
            times[kind] += host_ms(torch, lambda: fn(st, batch, gen), NCCL_TIMED_STEPS)
        bytes_a_step = (mesh.bytes_reduced - before) / (2 * (NCCL_TIMED_STEPS + 3))
    finally:
        dist.destroy_process_group()
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"nccl_group_of_one_step_median_ms": med["nccl"],
            "no_mesh_step_median_ms": med["plain"],
            "collectives_cost_ms": med["nccl"] - med["plain"],
            "nccl_step_ms": times["nccl"], "no_mesh_step_ms": times["plain"],
            "nccl_bytes_all_reduced_a_step": bytes_a_step, "batch": TRAIN_BATCH}


# ---------------------------------------------------------------------------
# Phases 39 to 41: the serving knobs of the B1 path, and remat_block1.
# ---------------------------------------------------------------------------

# An IoU threshold whose bfloat16 t / (1 + t) is rounded through float32 (as
# the reference's ml_dtypes scalar is) to 0.125, where double -> bfloat16
# would give 0.1259765625.
IOU_DOUBLE_ROUNDING = 0.1434952540480179
# Phase 40's serving configurations (int8, bs=64, B4 for SSD-300) and the
# knobs, each alone and all together; "default" is the presets' own path.
KNOB_PRESETS = ("ssd512_resnet50_coco", "retinanet_fpn_coco", "ssd300_infer_bs64")
KNOB_VARIANTS = (
    ("default", {}),
    ("per_level_heads", {"eval.per_level_heads": True}),
    ("class_top_k_256", {"eval.nms_class_top_k": 256}),
    ("class_top_k_128", {"eval.nms_class_top_k": 128}),
    ("packed_sort", {"eval.nms_packed_sort": True}),
    ("coord_bf16", {"eval.nms_coord_bf16": True}),
    ("all", {"eval.per_level_heads": True, "eval.nms_class_top_k": 128,
             "eval.nms_packed_sort": True, "eval.nms_coord_bf16": True}),
)
# Phase 41: training steps compared with and without remat_block1, and the
# steps timed in each of four turns.
REMAT_STEPS, REMAT_TIMED_STEPS = 3, 10


def nms_bf16_phase(torch, np, nms_kernel, where) -> float:
    """Phase 39: the scan's bfloat16-coordinate instantiation bit-equal to
    its plain version (the same emit loop in bfloat16 on the card) at the
    serving paths' shapes: SSD-300 bs=64's 1280 rows and SSD-512's and
    RetinaNet's 5120, of 512 columns, and at class_top_k's 256 and 128; the
    bs=1 paths' 20 and 80 rows; k = 1; a threshold whose bfloat16 t rounds
    through float32; and the block route (rows of 896) through
    per_class_nms_batched at pre_nms_top_k=400 on SSD-300's 8732 anchors.
    The paths' own rows are held in phase 40. Returns the largest score
    difference (0.0)."""
    err = 0.0
    cases = [("dense", R, K, 0.45), ("sparse", R, K, 0.45), ("ties", R, K, 0.45),
             ("negative", R, K, 0.45), ("dense", 5120, K, 0.45), ("dense", 5120, 256, 0.5),
             ("dense", 5120, 128, 0.45), ("dense", 20, K, 0.45), ("dense", 80, K, 0.45),
             ("dense", 64, 1, 0.45), ("dense", 256, 256, IOU_DOUBLE_ROUNDING)]
    for i, (kind, rows, k, iou) in enumerate(cases):
        coords, scores = rows_case(np, torch, kind, seed=390 + i, rows=rows, k=k)
        coords = coords.to(torch.bfloat16)
        kw = dict(max_out=min(MAX_OUT, k), iou_threshold=iou, score_threshold=0.01)
        got_s, got_c = nms_kernel.nms_rows(coords, scores, **kw)
        torch.cuda.synchronize()
        want_s, want_c = nms_kernel.nms_rows_reference(coords, scores, **kw)
        e = (got_s - want_s).abs().max().item()
        err = max(err, e)
        check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
              f"the bf16 nms kernel differs from its plain version ({kind}, {rows} x {k}, iou "
              f"{iou}): max_abs_err {e}, {int((got_c != want_c).sum())} columns differ")
        print(json.dumps({"phase": "nms_bf16_kernel_vs_plain", "case": kind, "rows": rows, "k": k,
                          "iou_threshold": iou, "route": "warp", "bit_equal": True,
                          "emitted": int((got_s > 0).sum()), **where}))
    # The block route, on the rows per_class_nms_batched gives the scan.
    gen = torch.Generator(device="cuda").manual_seed(39)
    xy = torch.rand((4, 8732, 2), generator=gen, device="cuda") * 0.9
    boxes = torch.cat([xy, (xy + 0.05 + 0.25 * torch.rand((4, 8732, 2), generator=gen,
                                                           device="cuda")).clamp(max=1.0)], -1)
    scores = torch.rand((4, 8732, 20), generator=gen, device="cuda") ** 6
    captured = {}

    def capture(coords, scores, **kwargs):
        captured.update(coords=coords, scores=scores, kwargs=kwargs)
        return nms_kernel.nms_rows(coords, scores, **kwargs)

    kw = dict(pre_nms_top_k=400, coord_bf16=True, max_detections=200, max_per_class=100)
    det_k = nms_kernel.per_class_nms_batched(boxes, scores, rows_fn=capture, **kw)
    det_p = nms_kernel.per_class_nms_batched(boxes, scores,
                                             rows_fn=nms_kernel.nms_rows_reference, **kw)
    coords, rows_scores = captured["coords"], captured["scores"]
    check(coords.dtype == torch.bfloat16 and tuple(rows_scores.shape) == (80, 896),
          f"per_class_nms_batched gave the scan {coords.dtype} rows {tuple(rows_scores.shape)}")
    got_s, got_c = nms_kernel.nms_rows(coords, rows_scores, **captured["kwargs"])
    want_s, want_c = nms_kernel.nms_rows_reference(coords, rows_scores, **captured["kwargs"])
    torch.cuda.synchronize()
    check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c) and
          _same_detections(torch, det_k, det_p),
          "the bf16 nms kernel's block route differs from its plain version on "
          "per_class_nms_batched's rows")
    print(json.dumps({"phase": "nms_bf16_kernel_vs_plain", "case": "per_class_nms_batched",
                      "rows": 80, "k": 896, "route": "block", "bit_equal": True,
                      "detections": int(det_k.valid.sum()), **where}))
    return err


def hold_knob_nms(torch, m, predict8, cfg, images, anchors_np, label):
    """A knob path's heads on ``images`` through the same QuantParams as
    ``predict8`` (concatenated, or per level with eval.per_level_heads), and
    its decode + NMS (`decode_nms` or `decode_nms_levels`) with the settings
    of ``cfg``, capturing the rows that reach the scan. Holds the kernel
    bit-equal to its plain version on those rows and the detections through
    the kernel equal to those through the plain version. Returns the
    captured rows with the kernel's scores, the largest score difference and
    the detections."""
    nms_kernel = m.nms_kernel
    per_level = cfg.eval.per_level_heads
    forward = (m.engine.retinanet_int8_forward if cfg.model.family == "retinanet"
               else m.engine.int8_forward)
    captured = {}

    def capture(coords, scores, **kwargs):
        captured.update(coords=coords, scores=scores, kwargs=kwargs)
        return nms_kernel.nms_rows(coords, scores, **kwargs)

    with torch.inference_mode():
        x = m.normalize(images.float() / 255.0)
        cls, box = forward(predict8.qp, predict8.spec, cfg, x, concat_heads=not per_level)
        anchors = torch.from_numpy(anchors_np).cuda()
        kw = _decode_kwargs(cfg)
        if per_level:
            levels = (cls, [t.float() for t in box], anchors, tuple(cfg.anchors.anchors_per_level))
            det_k = nms_kernel.decode_nms_levels(*levels, rows_fn=capture, **kw)
            det_p = nms_kernel.decode_nms_levels(*levels, rows_fn=nms_kernel.nms_rows_reference,
                                                 **kw)
        else:
            det_k = nms_kernel.decode_nms(cls, box.float(), anchors, rows_fn=capture, **kw)
            det_p = nms_kernel.decode_nms(cls, box.float(), anchors,
                                          rows_fn=nms_kernel.nms_rows_reference, **kw)
        coords, scores, kwargs = captured["coords"], captured["scores"], captured["kwargs"]
        got_s, got_c = nms_kernel.nms_rows(coords, scores, **kwargs)
        want_s, want_c = nms_kernel.nms_rows_reference(coords, scores, **kwargs)
    torch.cuda.synchronize()
    err = (got_s - want_s).abs().max().item()
    check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
          f"{label}: the {coords.dtype} nms kernel differs from its plain version on the path's "
          f"rows {tuple(scores.shape)}: max_abs_err {err}, {int((got_c != want_c).sum())} "
          "columns differ")
    check(_same_detections(torch, det_k, det_p),
          f"{label}: detections through the kernel differ from the plain path")
    captured.update(kernel_scores=got_s, max_abs_err=err, detections=det_k)
    return captured


def _detection_set(det) -> set:
    """(image, class, score, box) of every valid detection."""
    valid = det.valid.cpu().numpy()
    classes, scores = det.classes.cpu().numpy(), det.scores.cpu().numpy()
    boxes = det.boxes.cpu().numpy()
    return {(int(b), int(classes[b, i]), float(scores[b, i]), tuple(boxes[b, i].tolist()))
            for b, i in zip(*valid.nonzero())}


def _jaccard(a: set, b: set) -> float:
    return len(a & b) / max(len(a | b), 1)


def knob_phases(torch, np, m, counted, launches, where) -> dict:
    """Phase 40: each serving knob alone and all together on int8
    ssd512_resnet50_coco, retinanet_fpn_coco and ssd300_infer_bs64 (B4) at
    bs=64, through make_int8_predict_fn: one scan launch of the instantiation
    the coordinates' dtype picks and the trunk's kernels a forward; the scan
    held bit-equal to its plain version on each path's own rows (512, 256 or
    128 columns, float32 or bfloat16) with the detections through it equal
    to the plain path's; per_level_heads' detection set equal to the concat
    path's; the Jaccard index of each knob's set against the default's;
    B6 and B7 (ResNet) or B4 and B3 (SSD-300) held on the path's inputs with
    the knobs on; img/s of each knob in turns with the default path; the scan
    timed on each path's rows (both instantiations at 512 columns, and at
    class_top_k's widths). Returns the scan's largest differences by dtype
    and its timings."""
    out = {"nms_err": 0.0, "nms_bf16_err": 0.0, "timing": {}, "stem_fp_err": 0, "l2norm_err": 0,
           "stem_err": 0, "bottleneck_err": 0}
    rng = np.random.default_rng(40)
    for preset in KNOB_PRESETS:
        t0 = time.perf_counter()
        cfg0 = m.get_config(preset)
        resnet = cfg0.model.backbone == "resnet50"
        params = m.init_params(m.build_model(cfg0), seed=0, random_batch_stats=resnet).state_dict()
        size = cfg0.model.image_size
        calib = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
        images = torch.from_numpy(rng.integers(0, 256, (64, size, size, 3), dtype=np.uint8)).cuda()
        anchors_np = m.anchors_for_model(cfg0.model.family, cfg0.anchors, size)
        want_base = RESNET_INT8_LAUNCHES if resnet else STEM_FP_LAUNCHES
        report, dets, paths = {}, {}, {}
        for name, overrides in KNOB_VARIANTS:
            cfg = cfg0.override(overrides)
            predict = m.make_int8_predict_fn(cfg, params, anchors_np, calib, device="cuda")
            det, got = counted(lambda: predict(images))
            bf16 = cfg.eval.nms_coord_bf16
            want = {**want_base, "nms_rows": int(not bf16), "nms_rows_bf16": int(bf16)}
            path = f"knobs_{preset}_{name}"
            launches[path] = got
            check(got == want, f"{path} launched {got}, expected {want}")
            held = hold_knob_nms(torch, m, predict, cfg, images, anchors_np, path)
            check(_same_detections(torch, det, held["detections"]),
                  f"{path}: the served detections differ from the held decode's")
            key = "nms_bf16_err" if bf16 else "nms_err"
            out[key] = max(out[key], held["max_abs_err"])
            dets[name] = _detection_set(det)
            paths[name] = (predict, cfg, held)
            report[name] = {"launches": got, "scan_rows": list(held["scores"].shape),
                            "coords": str(held["coords"].dtype), "detections": len(dets[name]),
                            "kernel_vs_plain_bit_equal": True}
        check(dets["per_level_heads"] == dets["default"],
              f"{preset}: the per-level path's detection set differs from the concat path's")
        for name in report:
            report[name]["jaccard_vs_default"] = _jaccard(dets[name], dets["default"])
        # The trunk's kernels on this path's inputs with the knobs on.
        if resnet:
            predict, cfg, _ = paths["coord_bf16"]
            trunk = hold_resnet_int8_path(torch, m.engine, m.resnet_stem, m.bottleneck,
                                          m.postprocess, m.normalize, predict, images,
                                          anchors_np, cfg)
            out["stem_err"] = max(out["stem_err"], trunk["stem_err"])
            out["bottleneck_err"] = max(out["bottleneck_err"], trunk["bottleneck_err"])
        else:
            predict, cfg, _ = paths["all"]
            trunk = hold_int8_path(torch, m.engine, m.stem, m.l2norm, m.postprocess, m.normalize,
                                   predict, images, anchors_np, cfg, stem_fp=m.stem_fp)
            out["stem_fp_err"] = max(out["stem_fp_err"], trunk["stem_err"])
            out["l2norm_err"] = max(out["l2norm_err"], trunk["l2norm_err"])
        out["nms_bf16_err"] = max(out["nms_bf16_err"], trunk["nms_err"])
        # img/s of each knob in turns with the default path.
        default = paths["default"][0]
        for name, (predict, _, _) in paths.items():
            if name == "default":
                continue
            turns = [host_ms(torch, lambda f=f: f(images), 5)
                     for f in (default, predict, predict, default)]
            report[name]["img_per_s"] = 64e3 / statistics.median(turns[1] + turns[2])
            report[name]["default_img_per_s"] = 64e3 / statistics.median(turns[0] + turns[3])
        # The scan on this path's own rows: both instantiations at 512
        # columns, then class_top_k's widths.
        timing = {}
        for name in ("default", "coord_bf16", "class_top_k_256", "class_top_k_128", "all"):
            timing[name] = nms_timing(torch, m.nms_kernel, paths[name][2], 1)
        out["timing"][preset] = timing
        print(json.dumps({"phase": "knobs", "preset": preset, "batch": 64, "variants": report,
                          "scan_timing": timing, "seconds": time.perf_counter() - t0, **where}))
        del paths, params, images
        torch.cuda.empty_cache()
    return out


def remat_phase(torch, np, m, counted, launches, where) -> dict:
    """Phase 41: model.remat_block1 on the ssd300_vgg16_voc bs=32 training step
    (bf16, augmentation on, model.pool_grad_kernel=True), with and without
    the flag from the same weights, seed and batch: REMAT_STEPS steps each
    with cuDNN deterministic, the losses and the parameters against the flag
    off, beside a second run without it (the step's own run-to-run spread);
    B5 launches a step; the memory the forward leaves live for the backward
    (memory_allocated after the loss, less before), the peak memory of a
    step (max_memory_allocated after a reset) and the step ms (median of
    REMAT_TIMED_STEPS), in turns."""
    base = m.get_config("ssd300_vgg16_voc").override({
        "model.pool_grad_kernel": True, "data.dataset": "synthetic",
        "train.batch_size": TRAIN_BATCH})
    size = base.model.image_size
    dataset = m.make_synthetic_dataset(num_images=TRAIN_BATCH, image_size=size)
    cache = m.DecodedCache(dataset, size, base.data.max_boxes, 4)
    batch = m.make_place(torch.device("cuda"))(cache.gather(np.arange(TRAIN_BATCH)))
    torch.cuda.current_stream().wait_event(batch.pop("_ready"))
    anchors = m.anchors_for_model(base.model.family, base.anchors, size)
    model0, _ = m.init_model_state(base, seed=0, device="cuda")
    weights = {k: v.detach().clone() for k, v in model0.state_dict().items()}
    del model0

    def setup(remat: bool):
        cfg = base.override({"model.remat_block1": remat})
        model = m.build_model(cfg).cuda()
        model.load_state_dict(weights)
        step_fn = m.make_train_step(cfg, model, anchors, device="cuda", augment=True)
        return step_fn, m.create_train_state(cfg.train, weights)

    def run(remat: bool):
        step_fn, state = setup(remat)
        gen = torch.Generator().manual_seed(41)
        losses, counts = [], []
        for _ in range(REMAT_STEPS):
            (state, metrics), got = counted(lambda: step_fn(state, batch, gen))
            losses.append(float(metrics["loss"]))
            counts.append(got)
        return losses, state.params, counts

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        off, on, off2 = run(False), run(True), run(False)
    finally:
        torch.backends.cudnn.deterministic = was

    def diff(a, b):
        return {"loss": max(abs(x - y) for x, y in zip(a[0], b[0])),
                "params": max((a[1][k].float() - b[1][k].float()).abs().max().item()
                              for k in a[1])}

    remat_diff, spread = diff(on, off), diff(off2, off)
    # Each step launches B5 four times, with the flag or without, and no
    # other kernel.
    want = {**{k: 0 for k in m.wrappers}, "max_pool_bwd": 4}
    check(all(got == want for got in off[2] + on[2] + off2[2]),
          f"kernel launches a step: {off[2]} without remat_block1, {on[2]} with it")
    check(all(np.isfinite(on[0])), f"remat_block1 losses {on[0]}")
    # Bound: no further from the plain steps than the plain steps are from
    # themselves (0 where the step is deterministic).
    check(remat_diff["loss"] <= spread["loss"] and remat_diff["params"] <= spread["params"],
          f"remat_block1 moved the steps {remat_diff}, beyond their own spread {spread}")
    launches["remat_block1_step"] = on[2][-1]
    # Peak memory of a step and step ms, in turns.
    peaks, times, live = {False: [], True: []}, {False: [], True: []}, {False: [], True: []}
    for remat in (False, True, True, False):
        step_fn, state = setup(remat)
        gen = torch.Generator().manual_seed(41)
        state, _ = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = step_fn.loss_fn(state.params, state.batch_stats, batch, 0)[0]
        torch.cuda.synchronize()
        live[remat].append((torch.cuda.memory_allocated() - before) / 2**30)
        del loss
        torch.cuda.reset_peak_memory_stats()
        state, _ = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        peaks[remat].append(torch.cuda.max_memory_allocated() / 2**30)
        for _ in range(REMAT_TIMED_STEPS):
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            times[remat].append((time.perf_counter() - t0) * 1e3)
        del step_fn, state
    report = {"phase": "remat_block1", "batch": TRAIN_BATCH, "steps_compared": REMAT_STEPS,
              "losses_off": off[0], "losses_on": on[0], "max_abs_diff_on_vs_off": remat_diff,
              "max_abs_diff_off_vs_off": spread,
              "pool_launches_per_step": [got["max_pool_bwd"] for got in on[2]],
              "forward_live_gib_off": live[False], "forward_live_gib_on": live[True],
              "peak_gib_off": peaks[False], "peak_gib_on": peaks[True],
              "step_ms_off": statistics.median(times[False]),
              "step_ms_on": statistics.median(times[True]), **where}
    print(json.dumps(report))
    return report


# Phases 42 to 44: converted backbones served and fine-tuned, the profiling
# utilities, the decoded cache filled by the native pool and shared.
FINE_TUNE_STEPS, TIMER_STEPS = 3, 20
# Calls in phase 43's trace window: the first may lose its first kernel
# records after earlier profiler sessions; the second is whole.
TRACED_CALLS = 2
# StepTimer's median lap against CUDA events on the same steps.
TIMER_AGREEMENT = 0.05
CACHE_IMAGES, CACHE_SIZE = 512, 300
# The reference's bound between the native pool and PIL on smooth content
# (tests/test_native_decode.py:56): area and bilinear resampling differ.
NATIVE_VS_PIL_MEAN_LIMIT = 8.0


def he_scaled_torchvision(torch, shapes: dict, seed: int) -> dict:
    """A torchvision-layout state_dict from the key and shape inventory whose
    activations stay finite through the whole backbone: He-scaled weights,
    biases and BatchNorm shifts with stddev 0.05, BatchNorm scales in
    [0.5, 1) and running variances in [0.5, 2)."""
    import math

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(100)
        elif key.endswith("running_var"):
            out[key] = torch.rand(shape, generator=gen) * 1.5 + 0.5
        elif len(shape) == 1 and key.endswith(".weight"):  # a BatchNorm's scale
            out[key] = torch.rand(shape, generator=gen) * 0.5 + 0.5
        elif len(shape) == 1:  # biases, BatchNorm shifts and running means
            out[key] = torch.randn(shape, generator=gen) * 0.05
        else:
            out[key] = torch.randn(shape, generator=gen) * math.sqrt(2.0 / math.prod(shape[1:]))
    return out


def converted_backbone_phase(torch, np, m, counted, launches, where) -> dict:
    """Phase 42: full-width torchvision VGG16 (its classifier too) and
    ResNet-50 dicts from the inventory, saved as .pth, converted by the
    port's CLI in a subprocess, read by load_backbone_npz and grafted by
    inject_backbone into ssd300_infer_bs64 and ssd512_resnet50_coco. Each
    served at bs=64 in float (B1 once, held on its rows) and int8 (B4, B3
    and B1, or B6, B7 twelve times and B1, each held bit-equal to its plain
    version on the path's inputs), img/s recorded; then FINE_TUNE_STEPS
    bs=32 steps of ssd300_vgg16_voc from the converted VGG16 with the pool
    kernel: 4 B5 launches and no other a step, finite losses. Returns the
    kernels' largest differences and what phase 43 runs."""
    from object_detector_tpu_torch.cli.convert_weights import load_backbone_npz
    from object_detector_tpu_torch.utils.weights import (
        inject_backbone, torchvision_state_dict_shapes,
    )

    out = {"nms_err": 0.0, "stem_fp_err": 0, "l2norm_err": 0, "stem_err": 0, "bottleneck_err": 0}
    zeros = {k: 0 for k in m.wrappers}
    rng = np.random.default_rng(42)
    work = tempfile.TemporaryDirectory(prefix="odt_weights_")
    repo = os.path.dirname(os.path.abspath(__file__))
    for arch, preset in (("vgg16", "ssd300_infer_bs64"), ("resnet50", "ssd512_resnet50_coco")):
        t0 = time.perf_counter()
        src, npz = f"{work.name}/{arch}.pth", f"{work.name}/{arch}.npz"
        torch.save(he_scaled_torchvision(torch, torchvision_state_dict_shapes(arch), 42), src)
        proc = subprocess.run(
            [sys.executable, "-m", "object_detector_tpu_torch.cli.convert_weights", "--backbone",
             arch, "--src", src, "--dst", npz], capture_output=True, text=True, timeout=300,
            cwd=repo)
        check(proc.returncode == 0,
              f"convert_weights --backbone {arch} failed: {proc.stderr[-2000:]}")
        convert_s = time.perf_counter() - t0
        cfg = m.get_config(preset)
        init = m.init_params(m.build_model(cfg), seed=0).state_dict()
        backbone = load_backbone_npz(npz)
        state = inject_backbone(init, backbone)
        moved = [k for k in init if not torch.equal(state[k], init[k])]
        check(sorted(moved) == sorted(f"backbone.{k}" for k in backbone)
              and len(moved) == {"vgg16": 30, "resnet50": 265}[arch],
              f"{arch}: the graft moved {len(moved)} entries of {len(backbone)}")
        size = cfg.model.image_size
        anchors_np = m.anchors_for_model(cfg.model.family, cfg.anchors, size)
        images = torch.from_numpy(rng.integers(0, 256, (64, size, size, 3), dtype=np.uint8)).cuda()
        calib = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
        resnet = arch == "resnet50"

        model = m.build_model(cfg)
        model.load_state_dict(state)
        predict = m.make_predict_fn(cfg, model, anchors_np, device="cuda")
        predict(images)
        det, got = counted(lambda: predict(images))
        launches[f"converted_{arch}_float_bs64"] = got
        check(got == {**zeros, "nms_rows": 1}, f"converted {arch} float bs=64 launched {got}")
        check(bool(torch.isfinite(det.scores).all()) and bool(torch.isfinite(det.boxes).all())
              and bool(det.valid.any()), f"converted {arch} float: detections not finite or empty")
        rows, _ = hold_path(torch, m.nms_kernel, m.normalize, model, images, anchors_np, cfg)
        out["nms_err"] = max(out["nms_err"], rows["max_abs_err"])
        float_ms = host_ms(torch, lambda: predict(images), 5)
        del rows

        predict8 = m.make_int8_predict_fn(cfg, state, anchors_np, calib, device="cuda")
        predict8(images)
        det8, got8 = counted(lambda: predict8(images))
        launches[f"converted_{arch}_int8_bs64"] = got8
        want8 = RESNET_INT8_LAUNCHES if resnet else STEM_FP_LAUNCHES
        check(got8 == want8, f"converted {arch} int8 bs=64 launched {got8}, expected {want8}")
        check(bool(torch.isfinite(det8.scores).all()) and bool(det8.valid.any()),
              f"converted {arch} int8: detections not finite or empty")
        if resnet:
            held = hold_resnet_int8_path(torch, m.engine, m.resnet_stem, m.bottleneck,
                                         m.postprocess, m.normalize, predict8, images,
                                         anchors_np, cfg)
            out["stem_err"] = max(out["stem_err"], held["stem_err"])
            out["bottleneck_err"] = max(out["bottleneck_err"], held["bottleneck_err"])
        else:
            held = hold_int8_path(torch, m.engine, m.stem, m.l2norm, m.postprocess, m.normalize,
                                  predict8, images, anchors_np, cfg, stem_fp=m.stem_fp)
            out["stem_fp_err"] = max(out["stem_fp_err"], held["stem_err"])
            out["l2norm_err"] = max(out["l2norm_err"], held["l2norm_err"])
        out["nms_err"] = max(out["nms_err"], held["nms_err"])
        check(_same_detections(torch, held["detections"], det8),
              f"converted {arch} int8: the served detections differ from the held rerun")
        int8_ms = host_ms(torch, lambda: predict8(images), 5)
        print(json.dumps({
            "phase": "converted_backbone", "arch": arch, "preset": preset, "batch": 64,
            "converted_entries": len(backbone), "pth_to_npz_seconds": convert_s,
            "float_launches": got, "int8_launches": got8, "kernels_vs_plain_bit_equal": True,
            "nms_rows": held["nms_rows"], "float_valid_detections": int(det.valid.sum()),
            "int8_valid_detections": int(det8.valid.sum()),
            "float_img_per_s": 64e3 / statistics.median(float_ms),
            "int8_img_per_s": 64e3 / statistics.median(int8_ms),
            "seconds": time.perf_counter() - t0, **where}))
        if not resnet:
            out.update(predict8=predict8, images=images, float_model=model, vgg_state=state)
        del held, det, det8
    work.cleanup()

    # Fine-tuning from the converted VGG16, with the pool kernel.
    cfg = m.get_config("ssd300_vgg16_voc").override({
        "model.pool_grad_kernel": True, "data.dataset": "synthetic",
        "train.batch_size": TRAIN_BATCH})
    model = m.build_model(cfg).cuda()
    model.load_state_dict(out.pop("vgg_state"))
    size = cfg.model.image_size
    anchors = m.anchors_for_model(cfg.model.family, cfg.anchors, size)
    step_fn = m.make_train_step(cfg, model, anchors, device="cuda", augment=True)
    state = m.create_train_state(cfg.train, model.state_dict())
    cache = m.DecodedCache(m.make_synthetic_dataset(num_images=TRAIN_BATCH, image_size=size),
                           size, cfg.data.max_boxes, 4)
    batch = m.make_place(torch.device("cuda"))(cache.gather(np.arange(TRAIN_BATCH)))
    torch.cuda.current_stream().wait_event(batch.pop("_ready"))
    gen = torch.Generator().manual_seed(42)
    losses = []
    for i in range(FINE_TUNE_STEPS):
        (state, metrics), got = counted(lambda: step_fn(state, batch, gen))
        launches[f"converted_vgg16_fine_tune_step{i + 1}"] = got
        check(got == {**zeros, "max_pool_bwd": 4},
              f"fine-tuning step {i + 1} from the converted VGG16 launched {got}")
        losses.append(float(metrics["loss"]))
    check(all(np.isfinite(losses)), f"fine-tuning losses {losses}")
    print(json.dumps({"phase": "converted_vgg16_fine_tune", "batch": TRAIN_BATCH,
                      "steps": FINE_TUNE_STEPS, "losses": losses,
                      "pool_launches_per_step": [4] * FINE_TUNE_STEPS, **where}))
    out["train"] = (step_fn, state, batch, gen)
    return out


def profiling_phase(torch, np, m, counted, launches, where, surface) -> None:
    """Phase 43: utils.profiling on the card. `trace` around TRACED_CALLS
    int8 SSD-300 bs=64 calls of the converted model writes a Chrome trace
    whose kernel events name B4, B3 and B1 (the count of each is printed:
    after earlier profiler sessions a window's first kernel records, B4's
    among them, were seen missing); `StepTimer` laps over TIMER_STEPS
    bs=32 fine-tuning steps agree with CUDA events on the same steps within
    TIMER_AGREEMENT (medians); `enable_debug_checks` raises
    FloatingPointError on a NaN pixel in a forward of the converted float
    model, is silent on the clean one, and its handle undoes it."""
    import glob

    from object_detector_tpu_torch.utils import profiling

    predict8, images = surface["predict8"], surface["images"]
    with tempfile.TemporaryDirectory(prefix="odt_trace_") as trace_dir:
        with profiling.trace(trace_dir):
            _, got = counted(lambda: [predict8(images) for _ in range(TRACED_CALLS)])
        launches["traced_int8_bs64"] = got
        check(got == {k: TRACED_CALLS * v for k, v in STEM_FP_LAUNCHES.items()},
              f"the traced int8 calls launched {got}")
        files = glob.glob(f"{trace_dir}/*.pt.trace.json")
        check(len(files) == 1, f"trace() wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    names = [kernel_name(e["name"]) for e in events if e.get("cat") == "kernel"]
    named = {kernel: sum(fragment in n for n in names) for kernel, fragment in (
        ("stem_fused_producer", "stem_fp_kernel"), ("l2norm_requant", "l2norm_requant_kernel"),
        ("nms_rows", "nms_rows_kernel"))}
    check(all(named.values()),
          f"the trace does not name every kernel: {named}; it has {sorted(set(names))}")

    step_fn, state, batch, gen = surface["train"]
    for _ in range(2):
        state, _ = step_fn(state, batch, gen)
    torch.cuda.synchronize()
    timer, laps, marks = profiling.StepTimer(), [], []
    for _ in range(TIMER_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch, gen)
        end.record()
        laps.append(timer.lap(metrics) * 1e3)
        marks.append((start, end))
    torch.cuda.synchronize()
    events_ms = [s.elapsed_time(e) for s, e in marks]
    lap_med, event_med = statistics.median(laps), statistics.median(events_ms)
    check(abs(lap_med - event_med) <= TIMER_AGREEMENT * event_med,
          f"StepTimer's median lap {lap_med} ms against CUDA events' {event_med} ms")

    model = surface["float_model"]
    x = m.normalize(images[:2].float() / 255.0)
    bad = x.clone()
    bad[0, 10, 10, 0] = float("nan")
    raised = None
    with profiling.enable_debug_checks():
        with torch.inference_mode():
            model(x)  # clean: silent
            try:
                model(bad)
            except FloatingPointError as exc:
                raised = str(exc)
    check(raised is not None, "enable_debug_checks let a NaN through a forward on the card")
    check(not torch.is_anomaly_enabled() and not torch.nn.modules.module._global_forward_hooks,
          "the debug checks' handle left global state behind")
    print(json.dumps({"phase": "profiling", "traced_calls": TRACED_CALLS,
                      "trace_kernel_events_by_kernel": named,
                      "trace_kernel_events": len(names), "traced_launches": got,
                      "step_timer_median_ms": lap_med, "cuda_events_median_ms": event_med,
                      "step_timer_vs_events": lap_med / event_med - 1.0, "steps": TIMER_STEPS,
                      "debug_checks_raised": raised, **where}))


def host_cpu() -> str:
    """The host CPU's model name from /proc/cpuinfo, with its vendor, family
    and model numbers (which name it where the model name is "unknown")."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    if "model name" not in fields:
        return f"{platform.machine()} (no model name in /proc/cpuinfo)"
    return (f"{fields['model name']} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")


def write_jpegs(np, directory: str, n: int, seed: int) -> list:
    """n seeded smooth JPEGs (a sinusoid a channel, noise of stddev 2) at
    VOC's 500x375 and 375x500; returns (path, width, height) each."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    specs = [((500, 375) if i % 2 == 0 else (375, 500), rng.uniform(0.5, 2.0, (3, 2)),
              rng.uniform(60, 190, 3), int(rng.integers(2**31))) for i in range(n)]

    def write(i):
        (w, h), freq, base, noise_seed = specs[i]
        x = np.sin(np.arange(w, dtype=np.float32)[None, :, None] * freq[:, 0] * 2 * np.pi / w)
        y = np.sin(np.arange(h, dtype=np.float32)[:, None, None] * freq[:, 1] * 2 * np.pi / h)
        noise = np.random.default_rng(noise_seed).normal(0, 2, (h, w, 3))
        img = np.clip(base + 35 * x + 35 * y + noise, 0, 255).astype(np.uint8)
        path = os.path.join(directory, f"{i:05d}.jpg")
        Image.fromarray(img).save(path, quality=90)
        return path, w, h

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(write, range(n)))


def jpeg_dataset(np, files):
    from object_detector_tpu_torch.data.types import Dataset, ImageRecord

    box = np.array([[0.1, 0.2, 0.6, 0.7]], np.float32)
    records = [ImageRecord(image_id=os.path.basename(p), path=p, width=w, height=h, boxes=box,
                           labels=np.ones(1, np.int32), difficult=np.zeros(1, bool))
               for p, w, h in files]
    return Dataset("jpeg_smoke", ["object"], records)


def _digest(np, images) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(images).tobytes()).hexdigest()


def cache_rank(torch, rank: int, world: int, files: list, spill_dir: str) -> dict:
    """Phase 44 on one rank: DecodedCache of the JPEGs spilled to a shared
    directory under a mesh of the gloo group."""
    import numpy as np
    import torch.distributed as dist

    from object_detector_tpu_torch.data.pipeline import DecodedCache
    from object_detector_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(dist.group.WORLD, rank, world, torch.device("cuda", 0))
    t0 = time.perf_counter()
    cache = DecodedCache(jpeg_dataset(np, files), CACHE_SIZE, 100, max(1, os.cpu_count() // world),
                         max_ram_bytes=0, spill_dir=spill_dir, mesh=mesh)
    return {"rank": rank, "reused": cache.reused, "decoder": cache.decoder,
            "seconds": time.perf_counter() - t0, "file": os.path.basename(cache.memmap_path),
            "digest": _digest(np, cache.images)}


def cache_phase(torch, np, where) -> None:
    """Phase 44 (host work): CACHE_IMAGES seeded JPEGs decoded into a
    DecodedCache at CACHE_SIZE px by the native pool and by PIL (forced),
    each's images/s and thread count beside the host's CPU; the two within
    the reference's bound on smooth content; then two gloo ranks on the card
    sharing one spill directory: both finish, with the same images as the
    in-process cache, and exactly one decoded. Where the pool cannot be
    built, prints why and the PIL numbers only."""
    import ctypes.util

    from object_detector_tpu_torch.data import native_decode
    from object_detector_tpu_torch.data.pipeline import DecodedCache

    work = tempfile.TemporaryDirectory(prefix="odt_jpegs_")
    t0 = time.perf_counter()
    files = write_jpegs(np, work.name, CACHE_IMAGES, seed=44)
    write_s = time.perf_counter() - t0
    ds = jpeg_dataset(np, files)
    threads = os.cpu_count() or 1
    # A libjpeg to link against: a library of the pool built elsewhere (the
    # reference's prebuilt one) loads on this host only where there is one.
    report = {"phase": "decode_cache", "images": CACHE_IMAGES, "size": CACHE_SIZE,
              "threads": threads, "host_cpu": host_cpu(), "host_cores": os.cpu_count(),
              "libjpeg": ctypes.util.find_library("jpeg"),
              "jpeg_write_seconds": write_s, "measured_on": "host"}
    real = native_decode.decode_batch
    native_decode.decode_batch = lambda *args, **kwargs: None  # PIL decodes everything
    try:
        t0 = time.perf_counter()
        pil = DecodedCache(ds, CACHE_SIZE, 100, threads)
        pil_s = time.perf_counter() - t0
    finally:
        native_decode.decode_batch = real
    check(pil.decoder == "pil", f"the forced PIL cache says {pil.decoder}")
    report["pil_images_per_s"] = CACHE_IMAGES / pil_s
    t0 = time.perf_counter()
    cache = DecodedCache(ds, CACHE_SIZE, 100, threads)
    cache_s = time.perf_counter() - t0
    reason = native_decode.load_error()
    report["decoder"] = cache.decoder
    if reason is None:
        check(cache.decoder == "native", f"the library loaded but the cache says {cache.decoder}")
        diff = np.abs(cache.images.astype(np.int16) - pil.images.astype(np.int16))
        per_image = diff.reshape(CACHE_IMAGES, -1).mean(axis=1)
        check(per_image.max() < NATIVE_VS_PIL_MEAN_LIMIT,
              f"native against PIL: mean absolute difference {per_image.max()} on an image")
        report.update(native_images_per_s=CACHE_IMAGES / cache_s,
                      native_vs_pil_mean_abs_max=float(per_image.max()),
                      native_vs_pil_mean_abs=float(per_image.mean()))
    else:
        check(cache.decoder == "pil", f"no library ({reason}) but the cache says {cache.decoder}")
        report["native_unavailable"] = reason
    ranks = dp_spawn(torch, 2, "cache_rank", (files, f"{work.name}/spill"), f"{work.name}/ranks")
    check([r["reused"] for r in ranks] == [False, True],
          f"the ranks sharing a spill: {[(r['rank'], r['reused']) for r in ranks]}")
    check({r["digest"] for r in ranks} == {_digest(np, cache.images)},
          "the ranks sharing a spill hold other images than the in-process cache")
    report["shared_spill_ranks"] = [{k: r[k] for k in ("rank", "reused", "decoder", "seconds")}
                                    for r in ranks]
    print(json.dumps({**report, **where}))
    work.cleanup()


def _same_detections(torch, a, b) -> bool:
    return (torch.equal(a.valid, b.valid) and torch.equal(a.classes, b.classes)
            and torch.equal(a.scores, b.scores) and torch.equal(a.boxes, b.boxes))


def _decode_kwargs(cfg) -> dict:
    """The kernel path's settings from ``cfg``, the serving knobs included."""
    from object_detector_tpu_torch.ops.postprocess import nms_kwargs

    return nms_kwargs(cfg)


if __name__ == "__main__":
    sys.exit(main())
