#!/usr/bin/env python3
"""GPU smoke test of pytorchcv_tpu_torch: int8 ResNet-50 classification,
int8 DANet (ResNet-D50b) Cityscapes segmentation serving, ProPainter
recurrent flow completion (RFC) streaming, bf16 EfficientNet-B0
classification, ProPainter's generator (image propagation, the sparse
window transformer, the mask blend) streaming, int8 WRN-50-2
classification, int8 SE-ResNeXt-50, ResNeXt-50 and SENet-16
classification, video inpainting from raw frames through
``ProPainterIterator`` (RAFT flow, RFC, image propagation, the generator,
the blend), int8 MobileNet v1 / v2 and bf16 MobileNetV3
classification, int8 PSPNet, DeepLabv3 and FCN-8s(d) (ResNet(D)-101b) VOC
segmentation, SimplePose, AlphaPose and CenterNet on the int8 plain
ResNet trunk, and int8 VGG-16, DarkNet-53 and PreResNet-50 /
SE-PreResNet-50 classification, on the port's hand-written CUDA kernels,
with the int8 7x7 stem and the window-sum probe on their own entry
points.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from ``csrc/`` at first
use (one nvcc per source, in parallel). Phases, each ending in
``torch.cuda.synchronize()``:

1. device and build: the card (nvidia-smi name and power limit), torch and
   CUDA versions, the kernel build time;
2. ResNet-50 kernels vs their plain PyTorch versions, on the inputs one
   batch-32 forward (256x256 frames, crop 224) gives them: preprocess (K1)
   within 1 bf16 ulp, every distinct int8 conv (K2) bit-exact, the 7x7
   stem conv (K3) with at most 0.1 % of elements off by 1, ``maxpool_i8``
   bit-exact, every distinct bottleneck chain (K8) bit-exact;
3. the ResNet-50 slice: ``make_serving_fn("resnet50", (256, 256),
   device="cuda")`` on seeded random weights (BN statistics randomized by
   an explicit generator); one batch with launch counts K1 = 1, K3 = 1,
   ``maxpool_i8`` = 1, K2 = 19, K8 = 11 (the 11 stride-1 units in 4
   chains, one launch a unit), finite (B, 1000) logits, cosine >= 0.99
   against the f32 reference forward (no TF32);
4. ResNet-50 timing with CUDA events at batch 128: serving images/s, each
   kernel beside its plain version and its library call (K1 beside the
   einsum of its two products; K2 beside ``torch._int_mm``, cuBLASLt's
   int8 product without epilogue, on the operands of its 1x1 stride-1
   convs only), K1's registers, spills and shared memory
   (``cudaFuncGetAttributes``), K2 at each distinct conv (k, stride,
   dilation, Cin, Cout, H, residual mode) with its ms, TOP/s, bound, the
   plan's tile and the instance's registers, spills (any fails the run)
   and shared memory, K3's rows a tile and resources (a spill fails),
   ``maxpool_i8``'s plan (channel-vector bytes, output rows a thread) and
   its instance's registers and spills (a spill fails), K8 per chain with its plan's tile
   (rows x columns of one image) and its registers, spills and shared memory,
   and the chained units replayed on K2 from the K2-only plan
   (``prepare_int8_resnet(..., chains=False)``, whose logits must equal
   the chained plan's);
5. DANet kernels vs their plain versions, on the inputs one batch-2
   forward of 1024x2048 frames (resized to 480x480) gives them, and on
   calibration's f32 attention: K1 within 1 bf16 ulp, every distinct K2
   conv bit-exact (dilated ones included, and one stage-3 tail conv again
   with the bend output, which DANet's head does not read), the 3x3 K3
   with at most 0.1 % of elements off by 1, ``maxpool_i8`` bit-exact, flash
   attention (K4) within 1 bf16 ulp (bf16) and 1e-4 relative (f32), also
   with the path's q scaled so that the softmax spreads, and at an L no
   tile divides;
6. the DANet slice: ``make_serving_fn("danet_resnetd50b_cityscapes",
   (1024, 2048), task="segmentation", device="cuda")`` on seed-0 weights,
   BN and every ScaleBlock alpha randomized from seed 1 (alpha's zero init
   would make both attention branches the identity); launch counts
   K1 = 1, K3 = 1, maxpool_i8 = 1, K2 = 54, K4 = 1; three finite
   (B, 19, 480, 480) maps; main map cosine >= 0.99 and per-pixel argmax
   agreement >= 0.97 against the f32 reference forward (no TF32);
7. DANet timing at batch 8: serving images/s, each kernel beside its plain
   version and its library call (SDPA beside K4, ``torch._int_mm`` beside
   K2 as in phase 4), K1's and both K4 instances' registers, spills and
   shared memory, K2 at each distinct conv, K3 and ``maxpool_i8`` as in
   phase 4, and the cuDNN bf16 head convs (recorded through the closure's ``head``);
8. the RFC slice: ``get_model("propainter_rfc", device="cuda")`` on seed-0
   weights completes the flows of a synthetic 160-frame 240x432 clip
   (smooth sinusoidal flows up to 10 px, a moving ellipse masking ~10 % of
   each frame) through ``ProPainterRFCSequencer`` (window 80, padding 5:
   two windows, printed); launch counts K5 = sum over windows of
   4 (T_w - 1) and no other kernel; finite (159, 4, 240, 432) flows, equal
   to the input outside the masks;
9. K5 (deformable sampling) against its plain version at every distinct
   shape of the path (f32, within 1e-5 of max|x|) and at the flow-guided
   shape (1, 128, 60, 108), G 16, residue bound 3, centers of std 6
   (f32 as above, bf16 within 1 bf16 ulp at the tensor's scale), with x
   NCHW (transposed in the launch) and channels-last (read as it lies);
10. end to end: the completed flows against the same model with
   ``deform_conv2d`` patched here to its general route, max |delta| <= 1e-3
   of max |flow| (f32, no TF32); and the card against a CPU copy of the
   model (plain sampler) on the clip's first 3 flows, within 1e-4 of max
   |flow| (on random weights the recurrence grows over the clip: the
   window's flows reach ~6e11, and the JAX model grows alike);
11. RFC timing with CUDA events: completed-flow frames/s over the clip and
   per window, K5 a call (back to back, and on the device by the
   profiler) beside its plain version and ``F.grid_sample`` times the
   mask, K5's registers, spills (any fails the run) and shared memory, and
   one RFC call split into its 3-D and 2-D convs and K5;
12. K6 (depthwise conv + folded BN + activation) against its plain
   version on the calls of phase 13's run (every depthwise call of one
   batch-32 ``efficientnet_b0`` bf16 serving batch), in bf16 as run and
   again in f32, on the calls with asymmetric pads of an
   ``efficientnet_b0b`` forward (TF-SAME), and at one shape with each of
   the 7 activations and with k = 7: f32 bit-exact for the
   piecewise-linear activations and within 1e-6 of max |plain| for
   sigmoid and swish, bf16 within 1 bf16 ulp; K1 on the path within 1 bf16
   ulp; the f32 model under ``torch.autocast("cuda", torch.bfloat16)``
   at batch 32: K6 launched 16 times, logits cosine >= 0.999 against the
   same model in ``unfused_depthwise`` under the same autocast; each
   distinct call's plan, registers, spills (any fails the run) and shared
   memory;
13. the EfficientNet slice: ``make_serving_fn("efficientnet_b0", (256,
   256), device="cuda")`` in mode auto (the bf16 route) on seed-0 weights,
   BN randomized from seed 1; one batch of 32, recorded for phase 12, with
   launch counts K1 = 1, K6 = 16 and no other kernel, finite (32, 1000)
   bf16 logits, cosine >= 0.99 against the f32 reference forward (no
   TF32, depthwise blocks unfused: K6 0), top-1 agreement printed;
14. EfficientNet timing at batch 128: serving images/s, K6 per forward
   beside its plain version, cuDNN's depthwise conv with the affine and
   swish in bf16 and its bound; each distinct K6 call on the device (the
   mean over the launches the profiler recorded, ``_launch_ms``) and back
   to back beside its bytes bound, cuDNN's depthwise conv alone and
   with the affine and swish, and its plan; K1 beside its plain version,
   the einsum and its bound (and its resources), cuDNN's other convs, the
   SE blocks and the BN fold replayed alone, and the device's busy time
   and idle share (``torch.profiler``);
15. the generator slice: ``get_model("propainter", device="cuda")`` on
   seed-0 weights (two draws scaled down, as in the CPU parity test, see
   ``_tame_propainter``) through ``ProPainterIMSequencer(ProPainterITSequencer(
   ProPainterIPSequencer(frames, masks, comp_flows), masks, comp_flows,
   pp_model=model), frames, masks)`` over a synthetic 80-frame 240x432 clip
   (seeded uint8 frames as f32 in [-1, 1], ``_rfc_video``'s moving ellipse
   masks and its smooth flows, through ``TensorSequencer``, as the
   completed flows; the middle window reaches t = 18, 11 local frames):
   launch counts per generator call K7 = 16 and K5 = 2 (l_t - 1), nothing
   else; finite (80, 3, 240, 432) frames, equal to the input outside the
   masks; the same chain with K7 swapped for its plain version and K5 for
   ``deform_conv2d``'s general route within 1e-4 of max |out|; the first
   generator call against a CPU copy of the model within 1e-4 (its CPU
   seconds printed);
16. K7 against its plain version at every distinct (n, Lq, Lk, D) of
   phase 15's run, full and local paths, at B8's own test shapes with a
   mask, at D = 128 with mask entries of -1e9 and at n > 65,535 (within
   2e-5 of max |plain|); K5 on the generator's first calls (phase 9's f32
   tolerance);
17. generator timing with CUDA events: frames/s over the clip, each
   generator call and IP window; K7 per call, full and local at t = 18,
   beside its plain version, f32 SDPA and its bounds (f32 on the CUDA
   cores, the one in the JSON record; 3xTF32 on the tensor cores), with
   its registers, spills and shared memory; one generator call at
   t = 18 split into encoder, feature propagation (K5 within it), soft
   split, the 8 blocks (attention against FFN), soft composite and
   decoder; the device's busy time and idle share; K5 at the generator's
   shape back to back and on the device, with its registers, spills (any
   fails the run) and shared memory.

18. K8 against its plain version, bit-exact, on every distinct chain call
   of the batch-32 resnet50 and wrn50_2 forwards and at the JAX test's
   shape (h 4, w 8, C 128, M 128, 2 units, batch 2);
19. the WRN-50-2 slice: ``make_serving_fn("wrn50_2", (256, 256),
   device="cuda")`` on seed-0 weights, conv biases from seed 1 (zero
   biases would leave the BN-less fold untested), with phase 2's checks
   and phase 3's launch counts (K1, K3, ``maxpool_i8`` 1, K2 19, K8 11,
   nothing else) and cosine >= 0.99 against the f32 reference forward;
20. WRN-50-2 timing at batch 128, as phase 4;
21. K9 (the int8 7x7 stem, ``kernels.stem_conv.stem_conv7x7_s2``) against
   its plain version, bit-exact, on the resnet50 and wrn50_2 stems at
   batch 128 (the preprocess output as NHWC f32, ``s_img`` the stem conv's
   calibrated scale, ``s_out`` stage 1's input scale); its prepared entry
   (``stem_conv7x7_s2_prepared`` on ``prepare_stem``'s weights) equal to
   the call, timed as the kernel, with the whole call (weights prepared
   inside) beside it, K3 and cuDNN's f32 conv of the same image; its plan's
   rows a tile and its
   registers, spills (any fails the run) and shared memory; its agreement
   with K3's int8 output printed for information (the input quantization
   differs);
22. K10 (the window-sum probe, ``kernels.patch_probe.patch_window_sum``)
   against its plain version at the probe tool's shapes (H 60, W 128, C
   128, n 6480, numpy seed 0), within 1e-5 of max |plain| and bit-equal
   to the fixed-order sum, 2 launches (the table of 714 distinct windows
   and the gather), back to back and on the device (each kernel's mean
   over the launches the profiler recorded), with its bound (the
   map read once against 240 adds per distinct window at the f32 add
   rate);
23. the SE-ResNeXt-50 slice: ``make_serving_fn("seresnext50_32x4d", (256,
   256), device="cuda")`` on seed-0 weights (BN from seed 1, the SE
   gates' biases from seed 2, their second product at a tenth:
   ``_tame_se_gates``): every dense and grouped K2 conv, ``maxpool_i8``
   and every K11 call bit-exact, K1 and K3 as in phase 2, launches K1 /
   K3 / ``maxpool_i8`` 1, K2 36 dense + 16 grouped, K11 16, K8 0; cosine
   >= 0.99 against the f32 reference forward; img/s at batch 128 and the
   device's idle share, each kernel beside its plain version and bound,
   the grouped K2 (int8 tensor cores over block-diagonal tiles) per
   distinct conv: device ms launched again and again and after a write
   that evicts L2, useful TOP/s, the tensor-core operations issued with
   the block-diagonal zeros, bound, cuDNN's bf16 grouped conv as a
   yardstick, the plan's tiles, registers, spills (any fails the run),
   shared memory and blocks an SM; and the 16 grouped convs four ways: in
   the forward under the profiler, replayed back to back (device time and
   CUDA events), and conv by conv hot and after the flush;
24. the ResNeXt-50 slice (``resnext50_32x4d``), as phase 23: K2 36 + 16,
   K11 0, the unit tails in K2;
25. the SENet-16 slice (``senet16``: the deep stem on K3 3x3 and two K2
   convs, cg = og / 2, 3x3 identity convs), as phase 23 at batch 32: K2
   14 + 4, K11 4;
26. the pipeline slice: ``ProPainterIterator(TensorSequencer(frames),
   TensorSequencer(masks), raft, rfc, generator)`` on the card over a
   30-frame 240x432 clip from raw frames (``_pipe_clip``: seeded uint8
   frames in [-1, 1] that move 1-3 px a frame, ``_rfc_video``'s moving
   ellipse masks), chunks of 10; ``raft_things`` (``in_normalize=False``,
   20 refinements, windows of 12; ``_tame_raft``), ``propainter_rfc``
   (window 80; ``_tame_rfc``) and ``propainter`` (``_tame_propainter``),
   all seed 0: launch counts K5 = sum over RFC windows of 4 (T_w - 1) plus
   2 (l_t - 1) per generator call, K7 16 per generator call, nothing else
   (RAFT none); finite (30, 3, 240, 432) frames, equal to the input
   outside the masks; the chunks against the same stages run one after
   another without trimming, and a ``host_buffers=True`` run, within 1e-6
   of max |out| (bit-equality printed); the largest length of each stage's
   buffer; max |flow| after RAFT and after RFC; RAFT on the first 2 pairs
   against a CPU copy within 1e-4 of max |flow| (its CPU seconds printed);
   ``lookup_corr`` against ``lookup_corr_gather`` at the path's shapes
   (a RAFT window's last refinement) within 1e-5 of max |corr|; K5 and K7
   against their plain versions on every distinct call of the run;
27. pipeline timing with CUDA events after the warm passes above:
   inpainted frames/s end to end, each stage's ms and share (RAFT, RFC,
   IP, IT, IM and the engine), RAFT in pairs/s, one RAFT window split
   into the two encoders, the pyramid, the lookups and the update blocks
   (x 20) and the upsampling, ``lookup_corr`` against
   ``lookup_corr_gather`` a call, the device's busy time and idle share
   over a pass (``torch.profiler``) with the share of K5 and K7 launches
   it recorded, K5's and K7's ms inside the pipeline; for the record, K5
   at RFC's first call and K7 on a transformer block's two calls at the
   largest t, each beside its plain version, library call and bound;
28. the int8 MobileNet slices, ``make_serving_fn("mobilenetv2_w1")`` and
   ``("mobilenet_w1")`` on seed-0 weights, BN randomized from seed 1, one
   batch of 32: K1 within 1 bf16 ulp, K3 (ReLU6 on v2) at most 0.1 % of
   elements off by 1, every distinct K12 (the int8 depthwise conv) and K2
   call bit-exact, launch counts K1 1 / K3 1 / K12 17 / K2 35 and 1 / 1 /
   13 / 13 and nothing else, finite logits at cosine >= 0.99 against the
   f32 oracle (no K6, no TF32);
29. their timing at batch 128: img/s beside the same model's bf16 route
   (K6 with ReLU6 / ReLU, its ms a forward on the device beside cuDNN's
   bf16 depthwise conv with the affine and the activation, its library
   call), each kernel's ms a forward beside its plain version, bound and
   library call (K12's on the device, from a CUDA graph of its calls:
   through its wrappers they time the host), K12 at each distinct call
   on the device (a CUDA graph of 20 launches) and its wrapper's host
   time a call beside its bytes bound, its plan
   and cuDNN's bf16 depthwise conv (a yardstick: not the same function),
   its instances' registers and spills (a spill fails), K2 at each
   distinct conv as in phase 4, the host time to enqueue a forward and
   K12's and K2's wrappers' share of it, the device's idle share
   (profiler);
30. ``mobilenetv3_large_w1`` in bf16 (its route in auto): K6 at every
   distinct call (ReLU and the dividing hswish, 3x3 and 5x5, stride 1 and
   2) in bf16 within 1 bf16 ulp and in f32 bit-exact, launches K1 1 / K6
   15, cosine >= 0.99; img/s, K6 a forward and a call on the device
   beside its bound and its library call, the idle share;
31. ``mobilenetv2_w3d4`` (18-channel maps that ``prepare`` pads to 20) at
   batch 32 with phase 28's checks and gates;
32. the segmentation heads: ``make_serving_fn(name, (375, 500),
   task="segmentation")`` for ``pspnet_resnetd101b_voc``,
   ``deeplabv3_resnetd101b_voc`` and ``fcn8sd_resnetd101b_voc`` (aux, 21
   classes, 480x480) in mode auto, each on the first weight draw w
   (``get_model(rng=w)``, BN from seed w + 1, w < 12) whose f32 main and
   aux maps on the check frames keep >= 95 % of their pixels decisive (f32
   top-2 class margin > 2 % of the largest |logit|), so that the flips of
   the near-ties fit in the agreement gate's budget (the choice looks at
   the f32 model alone; each draw's shares printed; with none, the run
   fails); on one batch-2
   forward each: K1 within 1 bf16 ulp (scaled), every distinct
   K2 conv bit-exact (the stage-3 bend output included, as the route
   launches it), K3 (3x3) with at most 0.1 % of elements off by 1,
   ``maxpool_i8`` bit-exact; launches K1 / K3 / ``maxpool_i8`` 1, K2 105,
   nothing else; main and aux maps finite, each at cosine >= 0.99 and
   per-pixel argmax agreement >= 0.97 against the f32 reference forward
   (no TF32), the gate of tests/test_quant.py:399-400, on every map (the
   agreement on the pixels whose f32 top-2 class margin is decisive, > 2 %
   of the largest |logit|, printed beside it). A map below the gate fails
   the run, after the remaining phases have run (``_gate``);
   ``chip_seg_agreement.py`` breaks the agreement down (weight draws,
   frames, margins, the trunk's error, an f32 head, the CPU's route);
33. each of them in mode bf16 (a bf16 copy, K1 only): cosine >= 0.99 on
   both maps, the agreement printed; PSPNet's img/s at batch 8;
34. pose and detection on the plain_trunk route: ``simplepose_resnet50b_
   coco`` and ``alphapose_fastseresnet101b_coco`` (256x192 from 320x240
   crops, batch 32), ``centernet_resnet50b_coco`` (512x512 from 480x640
   frames, batch 2), seed-0 weights, BN from seed 1: every kernel against its plain
   version as in phase 32 (K3 7x7; AlphaPose's K11 calls bit-exact);
   launches K1 / K3 / ``maxpool_i8`` 1 and K2 52, K2 103 + K11 4, K2 52;
   the decoded output (keypoints (B, 17, 3), boxes (B, 40, 6)) finite and
   equal to the decode of the same tensor on the CPU; with
   ``return_heatmap`` the pre-decode tensor at cosine >= 0.99 against the
   f32 reference forward;
35. timing with CUDA events after warm-up, the seg routes at batch 8, the
   pose routes at 128, CenterNet at 8: img/s, the device's idle share
   (profiler), each kernel beside its plain version, bound and library
   call (K2 beside ``torch._int_mm`` on its 1x1 stride-1 convs, K3 beside
   cuDNN's f32 conv), K2 at each distinct conv not measured on an earlier
   dense path (device ms, TOP/s, bound, tile, registers; a spill fails),
   the bf16 head replayed on the recorded features (NCHW views of the
   trunk's NHWC output, as served) and on contiguous copies of them, and
   the decode alone;
36. the remaining int8 classification routes: ``make_serving_fn(name,
   (256, 256))`` in mode auto for ``vgg16`` and ``bn_vgg16`` (route
   "vgg"), ``darknet53`` ("darknet"), ``preresnet50`` and
   ``sepreresnet50`` ("preresnet") on seed-0 weights, BN from seed 1, conv
   biases from seed 2, SE gates tamed as in phase 23; one batch of 32: K1
   within 1 bf16 ulp, K3 (3x3 at stride 1 with ReLU or the leaky ReLU;
   PreResNet's 7x7/s2 with its gain and bf16 output) within its tolerance
   and bit-exact on exact operands at the path's shape, every distinct K2
   conv (the leaky act, the act-then-residual, the pre-activation
   epilogue, VGG's fc layers as 1x1 convs), every 2x2 ``maxpool_i8`` and
   every distinct K13 call (the stream step: with and without gate, add
   and pre-activation) bit-exact; launches K1 / K3 1 and K2 15 +
   ``maxpool_i8`` 5, K2 51, K2 52 + K13 17, nothing else; finite logits at
   cosine >= 0.99 against the f32 reference forward;
37. their timing at batch 128: img/s beside the same model's bf16 route,
   the device's idle share, each kernel's ms a forward beside its plain
   version, bound and library call (K3 beside cuDNN's f32 conv, K2 beside
   ``torch._int_mm`` on its 1x1 stride-1 convs: the fc layers and 1x1
   convs; K13 none), K2 at each distinct conv not measured before, K3's,
   the pool's and K13's resources, PreResNet's bf16 stem pool
   (``F.max_pool2d``) alone.

The generator's CPU tests are ``tests/test_torch_port_propainter.py`` (the
port against the JAX package at 96x176). To rehearse phases 15-17 without
a card: exec a copy of this file with "cuda" replaced by "cpu",
``torch.cpu.Event`` faked with a host clock, the launch wrappers
(``kernels.attention.fused_window_attention``, also bound in
``models.propainter``, and ``nn.deform.deform_sample``) wrapped to count
launches, ``models.propainter_ip_stream.resolve_device`` returning the
CPU, ``PP_FRAMES`` 16, ``PP_HW`` (96, 176) and ``ATTN_BIG_N`` 100, then
call ``_propainter``.

The pipeline's CPU tests are ``tests/test_torch_port_raft.py``. To rehearse
phases 26-27 without a card, exec a copy of this file as for phases 15-17
(also ``models.propainter_stream.resolve_device`` returning the CPU, and
``ProfilerActivity.CUDA``/``DeviceType.CUDA`` read as the CPU's) with
``PIPE_FRAMES`` 14, ``PIPE_HW`` (128, 176) (RFC's 1/8 map at least K5's
window of 14, the pyramid's last level at least 2x2) and
``PIPE_RAFT_ITERS`` 3, then call ``_pipeline``.

Any failure raises; a failed gate on a measured value (``_gate``: the seg
maps' cosine and agreement) raises after the last phase. The last lines
are the card, the kernels' JSON record (one entry per kernel and path) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import torch

BATCH_CHECK = 32
BATCH_TIME = 128
SOURCE_HW = (256, 256)
STEM_TOLERANCE = 1e-3          # share of int8 elements allowed off by 1
# The int8 ResNet route's launches in one forward (resnet50 and wrn50_2):
# K8 takes the 11 stride-1 units (one launch each), K2 the other 19 convs.
INT8_LAUNCHES = {"preprocess": 1, "stem": 1, "maxpool_i8": 1, "int8_conv": 19,
                 "fused_bottleneck": 11}
PROBE_TOL = 1e-5               # K10: max |err| / max |plain|
# The SE and grouped int8 routes (phases 23-25): launches in one forward
# beside K1, K3 and maxpool_i8 1 each (K2 dense + grouped: 52, 52, 18),
# and the batch each is timed at.
SE_GROUP_ROUTES = {
    "seresnext50_32x4d": ({"int8_conv": 36, "int8_gconv": 16,
                           "se_tail": 16}, BATCH_TIME),
    "resnext50_32x4d": ({"int8_conv": 36, "int8_gconv": 16}, BATCH_TIME),
    "senet16": ({"int8_conv": 14, "int8_gconv": 4, "se_tail": 4},
                BATCH_CHECK)}

SEG_NAME = "danet_resnetd50b_cityscapes"
SEG_SOURCE_HW = (1024, 2048)   # native Cityscapes frames
SEG_BATCH_CHECK = 2
SEG_BATCH_TIME = 8
SEG_LAUNCHES = {"preprocess": 1, "stem": 1, "maxpool_i8": 1, "int8_conv": 54,
                "flash_attention": 1, "deform_sample": 0, "dwconv": 0,
                "window_attention": 0, "fused_bottleneck": 0, "stem_int8": 0,
                "patch_window_sum": 0, "int8_gconv": 0,
                "se_tail": 0, "dwconv_i8": 0, "preact": 0}
ATTN_F32_RTOL = 1e-4           # K4 f32: max |err| / max |plain|

RFC_HW = (240, 432)            # ProPainter's default input
RFC_FRAMES = 160               # two windows of 80 frames
RFC_WINDOW, RFC_PADDING = 80, 5
RFC_FLOW_GUIDED = ((1, 128, 60, 108), 16, 3.0)   # x shape, G, residue bound
RFC_F32_TOL = 1e-5             # K5 f32: max |err| / max |x|
RFC_E2E_TOL = 1e-3             # completed flows: max |delta| / max |flow|
RFC_SHORT = 3                  # flows of the card-vs-CPU check
RFC_CPU_TOL = 1e-4             # its max |delta| / max |flow|

EFF_NAME = "efficientnet_b0"
EFF_TF_NAME = "efficientnet_b0b"   # TF-SAME: asymmetric depthwise pads
EFF_LAUNCHES = {"preprocess": 1, "stem": 0, "maxpool_i8": 0, "int8_conv": 0,
                "flash_attention": 0, "deform_sample": 0, "dwconv": 16,
                "window_attention": 0, "fused_bottleneck": 0, "stem_int8": 0,
                "patch_window_sum": 0, "int8_gconv": 0,
                "se_tail": 0, "dwconv_i8": 0, "preact": 0}
DW_EXACT_ACTS = ("none", "relu", "relu6", "hswish", "hsigmoid",
                 "hswish_div")
DW_F32_RTOL = 1e-6             # K6 f32 sigmoid/swish: max |err| / max |plain|

PP_FRAMES = 80                 # the middle windows reach t = 18 (11 local)
PP_HW = (240, 432)             # ProPainter's default input
PP_E2E_TOL = 1e-4              # generated frames: max |delta| / max |out|
PP_K5_CHECKED = 10             # K5 calls held against the plain version
# Back-to-back calls a timing of K5 and of its library call: both are
# host-bound (~20-30 us of Python and launches a call), and 50 calls
# (~1.5 ms) let one host stall move the mean by a third.
K5_REPS = 500
ATTN_WIN_TOL = 2e-5            # K7: max |err| / max |plain|
ATTN_BIG_N = 65600             # problems of K7's check beyond 65,535

# The int8 MobileNet routes (phases 28-29, 31): K3, K12 and K2 launches in
# one forward beside K1's 1, each read from the model (v2: 17 expansion
# convs, 17 projections and the final block on K2; v2's w3d4 carries
# 18-channel maps that prepare pads to 20), and the bf16 MobileNetV3 route
# (phase 30): K6 once per depthwise block. The int8 names' bf16 routes
# (phase 29): K6 once per depthwise block, with ReLU6 (v2) or ReLU (v1).
MOB_INT8 = {"mobilenetv2_w1": {"stem": 1, "dwconv_i8": 17, "int8_conv": 35},
            "mobilenet_w1": {"stem": 1, "dwconv_i8": 13, "int8_conv": 13}}
MOB_BF16_K6 = {"mobilenetv2_w1": (17, "relu6"), "mobilenet_w1": (13, "relu")}
MOB_PAD_NAME = "mobilenetv2_w3d4"
MOB_V3_NAME = "mobilenetv3_large_w1"
MOB_V3_K6 = 15

# The dense-prediction routes (phases 32-35): the int8 trunks' launches in
# one forward beside K1, K3 and maxpool_i8 1 each, read from the trees.
# resnetd101b: 2 deep-stem convs + 33 units x 3 + 4 identity convs; the
# plain trunks: 50b 16 x 3 + 4, 101b 33 x 3 + 4; AlphaPose's SE units (unit
# 1 of each stage) run their tails on K11.
DENSE_SEG = ("pspnet_resnetd101b_voc", "deeplabv3_resnetd101b_voc",
             "fcn8sd_resnetd101b_voc")
DENSE_SEG_SOURCE_HW = (375, 500)   # a VOC frame
DENSE_SEG_LAUNCHES = {"int8_conv": 105}
# Phase 32's weights: the first draw w < SEG_DRAWS (``_dense_model(name,
# w)``) whose f32 main and aux maps on the check frames keep at least
# SEG_DECISIVE of their pixels decisive (``_decisive``). Random weights
# leave pixels near a tie, whose argmax any rounding may flip, a tied one
# about half the time: at 5 % of the pixels such flips fit in the
# agreement gate's budget of 3 %. The choice looks at the f32 model alone.
SEG_DRAWS = 12
SEG_DECISIVE = 0.95
DENSE_POSE_SOURCE_HW = (320, 240)  # a person crop
DENSE_DET_SOURCE_HW = (480, 640)   # a COCO frame
# name: (task, source frame, check batch, timing batch, launches)
DENSE_TRUNKS = {
    "simplepose_resnet50b_coco": ("pose", DENSE_POSE_SOURCE_HW, 32, 128,
                                  {"int8_conv": 52}),
    "alphapose_fastseresnet101b_coco": ("pose", DENSE_POSE_SOURCE_HW, 32, 128,
                                        {"int8_conv": 103, "se_tail": 4}),
    "centernet_resnet50b_coco": ("detection", DENSE_DET_SOURCE_HW, 2, 8,
                                 {"int8_conv": 52})}

# The remaining int8 classification routes (phases 36-37): each name's
# route and its launches in one forward beside K1's 1, read from the trees.
# vgg16: conv1_1 on K3, 12 convs and the 3 fc layers on K2, the 5 stage
# ends on maxpool_i8's 2x2 window; darknet53: the init block on K3, 5
# downsample convs and 23 units x 2 on K2; preresnet50, sepreresnet50: the
# stem on K3 (its bf16 pool is F.max_pool2d), 16 units x 3 + 4 identity
# convs on K2, K13 once a unit and once before unit 1.
CLASSIC = {
    "vgg16": ("vgg", {"stem": 1, "int8_conv": 15, "maxpool_i8": 5}),
    "bn_vgg16": ("vgg", {"stem": 1, "int8_conv": 15, "maxpool_i8": 5}),
    "darknet53": ("darknet", {"stem": 1, "int8_conv": 51}),
    "preresnet50": ("preresnet", {"stem": 1, "int8_conv": 52,
                                  "preact": 17}),
    "sepreresnet50": ("preresnet", {"stem": 1, "int8_conv": 52,
                                    "preact": 17})}

PIPE_FRAMES = 30               # 3 chunks: the first, a middle, the last
PIPE_HW = (240, 432)           # ProPainter's default input
PIPE_RAFT_ITERS = 20           # RAFTSequencer's default refinements
PIPE_ITER_TOL = 1e-6           # iterator vs the stages: of max |out|
PIPE_LOOKUP_TOL = 1e-5         # lookup_corr vs the gather: of max |corr|
PIPE_RAFT_CPU_PAIRS = 2        # RAFT card-vs-CPU frame pairs
PIPE_RAFT_CPU_TOL = 1e-4       # its max |delta| / max |flow|

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM bytes/s and
# operations/s by operand type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12,
              "f32": 67e12}
# f32 adds alone: 67 T/s counts an FMA as two operations; an FADD issues
# at the FMA's instruction rate, so adds peak at half of it.
PEAK_OPS_S["f32_add"] = PEAK_OPS_S["f32"] / 2
SRC = "pytorchcv_tpu_torch/csrc/"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _require(ok: bool, msg) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


GATES_FAILED = []


def _gate(ok: bool, msg) -> None:
    """A gate on a measured value whose failure leaves the later phases
    runnable: it is printed now, and ``main`` fails the run after the last
    phase, without the result line."""
    if not ok:
        GATES_FAILED.append(str(msg))
        print(f"chip_smoke: GATE FAILED: {msg}", flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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


def _randomize_bn(model: torch.nn.Module, seed: int) -> None:
    """BN scale/bias/mean/var from an explicit generator: channel-constant
    statistics would hide a per-channel fault in the folding. The same
    generator then draws every ScaleBlock alpha as +-U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=g))
                m.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=g))
                m.running_mean.copy_(
                    torch.empty(c).normal_(0.0, 0.5, generator=g))
                m.running_var.copy_(
                    torch.empty(c).uniform_(0.5, 2.0, generator=g))
        for m in model.modules():
            if hasattr(m, "alpha"):
                mag = torch.empty(1).uniform_(0.5, 1.5, generator=g)
                sign = 1.0 if float(torch.rand(1, generator=g)) < 0.5 else -1.0
                m.alpha.copy_(mag * sign)


def _raw_batch(n: int, seed: int, hw=SOURCE_HW) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=g,
                         dtype=torch.uint8).cuda()


@contextlib.contextmanager
def _recording(targets):
    """Record every call (args, kwargs, output) of the wrappers named in
    ``targets`` ((module, attribute, key) triples), by key."""
    calls = {key: [] for _, _, key in targets}
    saved = []
    for mod, attr, key in targets:
        orig = getattr(mod, attr)
        saved.append((mod, attr, orig))

        def rec(*a, _orig=orig, _key=key, **k):
            out = _orig(*a, **k)
            calls[_key].append((a, k, out))
            return out
        setattr(mod, attr, rec)
    try:
        yield calls
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _resnet_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    return [(pre_mod, "preprocess", "preprocess"),
            (rq, "int8_conv", "int8_conv"),
            (rq, "stem_conv", "stem"),
            (rq, "maxpool_i8", "maxpool_i8"),
            (rq, "fused_bottleneck_chain", "fused_bottleneck")]


def _seg_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.models.danet as danet_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    import pytorchcv_tpu_torch.quant.seg_backbone_int8 as sq
    return [(pre_mod, "preprocess", "preprocess"),
            (rq, "int8_conv", "int8_conv"),
            (sq, "stem_conv", "stem"),
            (sq, "maxpool_i8", "maxpool_i8"),
            (danet_mod, "flash_attention", "flash_attention")]


def _conv_key(a, k):
    x, w = a[0], a[1]
    res = k.get("residual")
    groups = k.get("groups", 1)
    mode = ("int8" if k.get("q") is not None else
            "f32" if k.get("out_f32") else "bf16",
            k.get("act", "relu") or "linear",
            "no-res" if res is None else
            f"res-{str(res.dtype)[6:]}{'-bf16round' if k.get('round_res') else ''}"
            f"{'-linear' if k.get('linear_res') else ''}"
            f"{'-after-act' if k.get('res_after_act') else ''}")
    if k.get("pre_gain") is not None:
        mode += ("pre-activation",)
    if k.get("bend"):
        mode += ("bend",)
    if groups > 1:
        mode += (f"groups-{groups}",)
    return (w.shape[1], k["stride"], k.get("dilation", 1), x.shape[3],
            w.shape[0], x.shape[1], "/".join(mode))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _plain_kw(k):
    """A recorded K1 call's keywords for its plain version: the band tables
    are the kernel's view of r and ct, which the plain version reads."""
    return {key: val for key, val in k.items() if key != "bands"}


def _print_info(card, what, info):
    """A kernel's registers, spills and shared memory
    (``cudaFuncGetAttributes``, and the launch's dynamic shared memory)."""
    print(f"[{card}] {what}: {info['registers']} registers a thread, "
          f"{info['spill_bytes']} bytes spilled (local), shared memory "
          f"{info['static_smem']} static + {info['dynamic_smem']} dynamic "
          f"bytes a block")


def _preprocess_times(card, tag, a, k, out):
    """Phases 4, 7 and 14: K1 beside its plain version, the one einsum call
    that computes the same products, and its bound; its resources."""
    from pytorchcv_tpu_torch.kernels.preprocess import (kernel_info,
                                                        preprocess,
                                                        preprocess_reference)
    r, ct = a[1], a[2]
    x32 = a[0].permute(0, 3, 1, 2).float()
    times = (_cuda_ms(lambda: preprocess(*a, **k), 20),
             _cuda_ms(lambda: preprocess_reference(*a, **_plain_kw(k)), 20),
             _cuda_ms(lambda: torch.einsum("oh,bchw,wp->bcop", r, x32, ct),
                      20), _work_preprocess(a, out))
    _print_info(card, f"{tag} K1 preprocess", kernel_info(
        k["bands"], a[0].shape[3]))
    return times


def _work_preprocess(a, out):
    """R X C^T needs only the non-zero taps of the banded resize matrices,
    multiplied in the cheaper of the two orders."""
    images, r, ct = a[0], a[1], a[2]
    bsz, h, w, c = images.shape
    oh, ow = r.shape[0], ct.shape[1]
    nr, nc = int(torch.count_nonzero(r)), int(torch.count_nonzero(ct))
    macs = min(nr * w + nc * oh, nc * h + nr * ow)
    return _bound(_nbytes(*a[:5], out), 2 * bsz * c * macs, "f32")


def _work_stem(a, k, out):
    x, kf = a[0], a[1]
    ks = kf.shape[1]
    ops = 2 * out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3] * \
        3 * ks * ks
    return _bound(_nbytes(x, kf, a[2], k.get("gain"), out), ops, "bf16")


def _work_pool(calls):
    """Each map read once, each pooled map written; a max a window tap."""
    nbytes = ops = 0
    for a, _, out in calls:
        window = a[1] if len(a) > 1 else 3
        nbytes += _nbytes(a[0], out)
        ops += window * window * out.numel()
    return _bound(nbytes, ops, "int8")


def _pool_info(card, tag, x):
    """``maxpool_i8``'s plan (vector bytes, output rows a thread) at a
    recorded call and its instance's registers and spills (a spill fails
    the run)."""
    from pytorchcv_tpu_torch.kernels.stem import maxpool_info, maxpool_plan
    vb, run = maxpool_plan(*x.shape, 16 if x.data_ptr() % 16 == 0 else 1)
    info = maxpool_info(vb)
    print(f"[{card}] {tag} maxpool_i8 {vb}-byte channel vectors, {run} "
          f"output rows a thread: {info['registers']} registers a thread, "
          f"{info['spill_bytes']} bytes spilled (local)")
    _require(info["spill_bytes"] == 0, f"{tag} maxpool_i8 spills")


def _work_convs(calls):
    nbytes = ops = 0
    for a, k, out in calls:
        x, w = a[0], a[1]
        outs = out if isinstance(out, tuple) else (out,)
        nbytes += _nbytes(x, w, a[2], a[3], k.get("residual"),
                          k.get("pre_gain"), *outs)
        o = outs[0]
        ops += 2 * o.shape[0] * o.shape[1] * o.shape[2] * o.shape[3] * \
            w.shape[1] * w.shape[2] * w.shape[3]
    return _bound(nbytes, ops, "int8")


def _work_attention(a, out):
    q, k, v = a[:3]
    n = q.numel() // (q.shape[-2] * q.shape[-1])
    ops = 2 * n * q.shape[-2] * k.shape[-2] * (q.shape[-1] + v.shape[-1])
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return _bound(_nbytes(q, k, v, out), ops, kind)


def _check_preprocess(calls, max_err, tag, scaled=False):
    """K1 within 1 bf16 ulp of its plain version: per element, or with
    ``scaled`` the ulp taken no finer than at 1/256 of the largest value
    (``bf16_ulp_error``: the normalization's affine cancels to near zero
    on some pixels, where the two f32 summation orders round apart)."""
    from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                        bf16_ulp_error,
                                                        preprocess_reference)
    (a, k, out), = calls
    ref = preprocess_reference(*a, **_plain_kw(k))
    per_elem = int(bf16_ulp_distance(out, ref).max())
    ulp = float(bf16_ulp_error(out, ref).max()) if scaled else per_elem
    max_err["preprocess"] = float((out.float() - ref.float()).abs().max())
    print(f"{tag} K1 preprocess {tuple(a[0].shape)} -> {tuple(out.shape)} "
          f"{out.dtype}: max {ulp} bf16 ulp{' (scaled)' if scaled else ''}, "
          f"per element {per_elem}, max abs err {max_err['preprocess']}")
    _require(ulp <= 1, f"{tag} K1 differs by {ulp} bf16 ulp")


def _check_stem(calls, max_err, tag):
    """K3 against its plain version: at most STEM_TOLERANCE of the int8
    elements off by 1, or of the bf16 ones (PreResNet's stem) by 1 bf16
    ulp (``bf16_ulp_error``: the ulp no finer than at 1/256 of the largest
    value, as K1's scaled check: where y * g + b cancels to near zero the
    order of the f32 sums exceeds an ulp of the tiny result); the f32 sums
    run in another order."""
    from pytorchcv_tpu_torch.kernels.preprocess import bf16_ulp_error
    from pytorchcv_tpu_torch.kernels.stem import stem_conv_reference
    (a, k, out), = calls
    ref = stem_conv_reference(*a, **k)
    if out.dtype == torch.bfloat16:
        diff = bf16_ulp_error(out, ref).ceil()
        unit = "bf16 ulp (scaled)"
        max_err["stem"] = float((out.float() - ref.float()).abs().max())
    else:
        diff = (out.int() - ref.int()).abs()
        unit = "int8 step"
        max_err["stem"] = float(diff.max())
    share = float((diff != 0).float().mean())
    print(f"{tag} K3 stem {tuple(a[1].shape[1:3])} s {k.get('stride', 2)} "
          f"{tuple(a[0].shape)} -> {tuple(out.shape)} {out.dtype}: "
          f"{share:.6f} of elements differ, by at most {int(diff.max())} "
          f"{unit}")
    _require(int(diff.max()) <= 1 and share <= STEM_TOLERANCE,
             f"{tag} K3 off by {int(diff.max())} {unit} on a share {share}")


def _check_pool(calls, max_err, tag):
    """``maxpool_i8`` bit-exact at every distinct call."""
    from pytorchcv_tpu_torch.kernels.stem import maxpool_i8_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault((tuple(a[0].shape), a[1:]), (a, k, out))
    max_err["maxpool_i8"] = 0.0
    for key, (a, k, out) in sorted(seen.items()):
        ref = maxpool_i8_reference(*a, **k)
        max_err["maxpool_i8"] = max(max_err["maxpool_i8"], float(
            (out.float() - ref.float()).abs().max()))
        print(f"{tag} maxpool_i8 {key[0]} window {a[1] if len(a) > 1 else 3}"
              f" -> {tuple(out.shape)}: "
              f"{'bit-exact' if torch.equal(out, ref) else 'DIFFERS'}")
        _require(torch.equal(out, ref), f"{tag} maxpool_i8 not bit-exact")


def _check_convs(calls, max_err, tag):
    from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault(_conv_key(a, k), (a, k, out))
    max_err["int8_conv"] = 0.0
    for key, (a, k, out) in sorted(seen.items()):
        ref = int8_conv_reference(*a, **k)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        for o, r in zip(outs, refs):
            max_err["int8_conv"] = max(max_err["int8_conv"], float(
                (o.float() - r.float()).abs().max()))
        print(f"{tag} K2 k={key[0]} s={key[1]} d={key[2]} cin={key[3]} "
              f"cout={key[4]} h={key[5]} {key[6]}: "
              f"{'bit-exact' if same else 'DIFFERS'}")
        _require(same, f"{tag} K2 not bit-exact at {key}")
    print(f"{tag} K2: {len(seen)} distinct convs of {len(calls)} bit-exact")


def _check_bend(calls, max_err):
    """K2's bend output at the path's shapes: the last stage-3 tail conv
    (1x1 to 1024 channels, int8 residual) launched again with ``bend``. Its
    int8 output equals the path's, and both outputs their plain versions."""
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    a, k, out = [c for c in calls if c[1].get("round_res")
                 and c[0][1].shape[0] == 1024][-1]
    kb = dict(k, bend=True)
    got, ref = int8_conv(*a, **kb), int8_conv_reference(*a, **kb)
    same = torch.equal(got[0], out) and all(
        torch.equal(g, r) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        max_err["int8_conv"] = max(max_err["int8_conv"], float(
            (g.float() - r.float()).abs().max()))
    print(f"danet K2 bend x {tuple(a[0].shape)} -> int8 "
          f"{tuple(got[0].shape)}, bf16 {tuple(got[1].shape)}: "
          f"{'bit-exact' if same else 'DIFFERS'}")
    _require(same, "danet K2 bend output not bit-exact")


def _check_attention(q, k, v, out, what):
    """K4 against its plain version: bf16 within 1 ulp (``bf16_ulp_error``:
    outputs that average to near zero round apart in f32), f32 within
    ATTN_F32_RTOL of the largest plain value. Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.flash_attention import \
        flash_attention_reference
    from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                        bf16_ulp_error)
    ref = flash_attention_reference(q, k, v, 1.0)
    err = float((out.float() - ref.float()).abs().max())
    if q.dtype == torch.bfloat16:
        ulp = float(bf16_ulp_error(out, ref).max())
        print(f"K4 {what} bf16 q {tuple(q.shape)} v {tuple(v.shape)}: max "
              f"{ulp} bf16 ulp (scaled), per element "
              f"{int(bf16_ulp_distance(out, ref).max())}, max abs err {err}")
        _require(ulp <= 1, f"K4 {what} differs by {ulp} bf16 ulp")
    else:
        rel = err / float(ref.abs().max())
        print(f"K4 {what} f32 q {tuple(q.shape)} v {tuple(v.shape)}: max "
              f"rel err {rel:.3e}, max abs err {err}")
        _require(rel <= ATTN_F32_RTOL, f"K4 {what} f32 rel err {rel}")
    return err


def _record_entry(name, path, source, replaces, launches, max_err, ms,
                  plain_ms, bound, library_ms):
    return {"name": name, "path": path, "route": "cuda",
            "source": SRC + source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _randomize_biases(model: torch.nn.Module, seed: int) -> None:
    """Conv biases N(0, 0.1) from an explicit generator: the init's zero
    biases would leave a BN-less fold untested."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).normal_(
                    0.0, 0.1, generator=g))


def _int8_model(name: str):
    """Seed-0 weights; ResNet-50's BN statistics, or WRN-50-2's conv
    biases, from seed 1."""
    import pytorchcv_tpu_torch as pt
    model = pt.get_model(name, rng=0, device="cuda")
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        _randomize_bn(model, seed=1)
    else:
        _randomize_biases(model, seed=1)
    return model


def _chain_key(a):
    x, packed = a[0], a[1]
    n, m, c = packed["w1"].shape
    return (tuple(x.shape), n, m)


def _check_chains(calls, max_err, tag):
    """K8 against its plain version on every distinct chain call."""
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import \
        fused_bottleneck_chain_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault(_chain_key(a), (a, k, out))
    err = max_err.get("fused_bottleneck", 0.0)
    for key, (a, k, out) in sorted(seen.items()):
        ref = fused_bottleneck_chain_reference(*a, **k)
        same = torch.equal(out, ref)
        err = max(err, float((out.float() - ref.float()).abs().max()))
        print(f"{tag} K8 chain x {key[0]}, {key[1]} unit(s), M {key[2]}: "
              f"{'bit-exact' if same else 'DIFFERS'}, "
              f"{float((ref != 0).float().mean()):.3f} of outputs nonzero")
        _require(same, f"{tag} K8 not bit-exact at {key}")
    max_err["fused_bottleneck"] = err
    print(f"{tag} K8: {len(seen)} distinct chain calls of {len(calls)} "
          f"bit-exact")


def _work_chains(calls):
    """Per unit: 2 B H W (2 C M + 9 M^2) int8 operations; bytes: its x read,
    its output written and its weights read once."""
    nbytes = ops = 0
    for a, _, _ in calls:
        x, packed = a[0], a[1]
        n, m, c = packed["w1"].shape
        bsz, h, w, _ = x.shape
        ops += n * 2 * bsz * h * w * (2 * c * m + 9 * m * m)
        nbytes += n * 2 * _nbytes(x) + _nbytes(
            *(packed[f] for f in ("w1", "w2", "w3", "a1", "b1", "a2", "b2",
                                  "a3", "b3")))
    return _bound(nbytes, ops, "int8")


def _int8_max_pool_library(card, name, x, out, window=3):
    """The one PyTorch call for ``maxpool_i8``'s function, if torch has it:
    ``F.max_pool2d`` (3x3, stride 2, padding 1; or 2x2, stride 2) on the
    int8 map as an NCHW view. Its ms where it runs and equals the kernel's
    output; else None, with torch's refusal printed."""
    import torch.nn.functional as F
    xn = x.permute(0, 3, 1, 2)
    pad = 1 if window == 3 else 0
    try:
        y = F.max_pool2d(xn, window, 2, pad)
    except RuntimeError as err:
        print(f"[{card}] {name} F.max_pool2d on an int8 CUDA tensor: "
              f"refused ({str(err).splitlines()[0]}): no library call")
        return None
    _require(torch.equal(y.permute(0, 2, 3, 1), out),
             f"{name} F.max_pool2d differs from maxpool_i8")
    ms = _cuda_ms(lambda: F.max_pool2d(xn, window, 2, pad), 20)
    print(f"[{card}] {name} F.max_pool2d on the int8 CUDA tensor: equal to "
          f"maxpool_i8's output, {ms:.4f} ms")
    return ms


def _int_mm_library(a):
    """``torch._int_mm`` (cuBLASLt's int8 tensor cores, int32 out, no
    epilogue) on a 1x1 stride-1 conv's int8 operands: x as (M, Cin) times
    w as (Cin, Cout). Its ms, or None with torch's refusal printed."""
    x, w = a[0], a[1]
    xa = x.reshape(-1, x.shape[3])
    wb = w.reshape(w.shape[0], -1).t()
    try:
        acc = torch._int_mm(xa, wb)
    except RuntimeError as err:
        print(f"torch._int_mm on x {tuple(xa.shape)}, w {tuple(wb.shape)}: "
              f"refused ({str(err).splitlines()[0]})")
        return None
    _require(acc.dtype == torch.int32, acc.dtype)
    return _cuda_ms(lambda: torch._int_mm(xa, wb), 10)


def _k2_per_shape(card, tag, calls, cache=None):
    """K2 at each distinct conv of a path's recorded calls: its device ms
    (``kernels._parts.launch_ms``: the mean over the launches
    ``torch.profiler`` recorded, with their share of the launches run; a
    short conv's back-to-back calls wait on the wrapper's host time,
    printed beside it), TOP/s, bound and by what, the
    plan's tile and the instance's registers, spills (any fails the run)
    and shared memory; and ``torch._int_mm`` on the operands of every 1x1
    stride-1 conv, summed over the path's calls of those shapes beside
    K2's device time for the same calls. Returns the library sum (None
    where torch refused a shape). ``cache``: {conv: (ms, library ms)} of
    convs measured on an earlier path, taken from it, not measured and
    printed again; the new ones are added to it."""
    from pytorchcv_tpu_torch.kernels._parts import launch_ms
    from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv, kernel_info
    seen = {}
    for a, k, out in calls:
        key = _conv_key(a, k)
        if key not in seen:
            seen[key] = [a, k, out, 0]
        seen[key][3] += 1
    lib_sum, k2_sum, device_sum, reused = 0.0, 0.0, 0.0, 0
    for key, (a, k, out, count) in sorted(seen.items()):
        if cache is not None and key in cache:
            ms, lib = cache[key]
            reused += 1
        else:
            ms, lib = _k2_shape(card, tag, key, a, k, out, count, launch_ms,
                                int8_conv, kernel_info)
            if cache is not None:
                cache[key] = (ms, lib)
        device_sum += count * ms
        if key[0] == 1 and key[1] == 1:
            lib_sum = None if lib is None or lib_sum is None else \
                lib_sum + count * lib
            k2_sum += count * ms
    print(f"[{card}] {tag} K2 on the device, the {len(calls)} convs of a "
          f"forward: {device_sum:.4f} ms ({len(seen)} distinct convs, "
          f"{reused} of them measured on an earlier path)")
    print(f"[{card}] {tag} K2 library (1x1 s1 products only): "
          f"torch._int_mm {'refused' if lib_sum is None else f'{lib_sum:.4f} ms'}"
          f" against K2 {k2_sum:.4f} ms on the same calls (with epilogues)")
    return lib_sum


def _k2_shape(card, tag, key, a, k, out, count, launch_ms, int8_conv,
              kernel_info):
    """One distinct conv of ``_k2_per_shape``: (device ms, library ms or
    None), printed with its TOP/s, bound, tile and resources."""
    x, w = a[0], a[1]
    o = out[0] if isinstance(out, tuple) else out
    m = o.shape[0] * o.shape[1] * o.shape[2]
    ms, share, wall = launch_ms(lambda: int8_conv(*a, **k),
                                "int8_conv_kernel", 1, 10)
    if ms is None:
        print(f"[{card}] {tag} K2: the profiler saw no device time; "
              f"CUDA events instead")
        ms = wall
    bound = _work_convs([(a, k, out)])
    ops = 2 * m * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
    info = kernel_info(m, w.shape[0], x.shape[3], w.shape[1])
    lib = _int_mm_library(a) if key[0] == 1 and key[1] == 1 else None
    print(f"[{card}] {tag} K2 k={key[0]} s={key[1]} d={key[2]} "
          f"cin={key[3]} cout={key[4]} h={key[5]} {key[6]} (x{count}): "
          f"{ms:.4f} ms on the device (the mean of the {100 * share:.0f} "
          f"% of launches the profiler recorded; {wall:.4f} back to "
          f"back), "
          f"{ops / ms / 1e9:.1f} TOP/s, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), tile {info['bm']}x"
          f"{info['bn']}, {info['registers']} registers, "
          f"{info['spill_bytes']} bytes spilled, shared "
          f"{info['static_smem']} + {info['dynamic_smem']} bytes"
          + ("" if lib is None else f"; torch._int_mm {lib:.4f} ms"))
    _require(info["spill_bytes"] == 0, f"{tag} K2 spills at {key}")
    return ms, lib


def _stem_info(card, tag, a, k=None):
    """K3's registers, spills (any fails the run) and shared memory at a
    recorded call's shape, with its plan's rows a tile."""
    from pytorchcv_tpu_torch.kernels.stem import kernel_info
    x, kf = a[0], a[1]
    stride = (k or {}).get("stride", 2)
    info = kernel_info(x.shape[0], x.shape[2], x.shape[3], kf.shape[1],
                       stride)
    print(f"[{card}] {tag} K3 tiles of {info['rows']} output rows")
    _print_info(card, f"{tag} K3 stem", info)
    _require(info["spill_bytes"] == 0, f"{tag} K3 spills")


def _front_times(card, name, calls) -> dict:
    """K1, K3 and ``maxpool_i8`` (where the route launches it) of a
    recorded int8-route forward, each (kernel ms, plain ms, library ms,
    bound): K1 beside its einsum, K3 beside cuDNN's f32 conv of the same
    image, the pools beside ``F.max_pool2d`` where torch takes int8; K3's
    and the pool's plans and resources."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8,
                                                  maxpool_i8_reference,
                                                  stem_conv,
                                                  stem_conv_reference)
    t = {}
    (a, k, out), = calls["preprocess"]
    t["preprocess"] = _preprocess_times(card, name, a, k, out)
    (a, k, out), = calls["stem"]
    xs = a[0].float()
    ws = a[1].permute(3, 0, 1, 2).float()
    stride = k.get("stride", 2)
    t["stem"] = (
        _cuda_ms(lambda: stem_conv(*a, **k), 20),
        _cuda_ms(lambda: stem_conv_reference(*a, **k), 5),
        _cuda_ms(lambda: F.conv2d(xs, ws, stride=stride,
                                  padding=ws.shape[2] // 2), 20),
        _work_stem(a, k, out))
    del xs
    _stem_info(card, name, a, k)
    pools = calls.get("maxpool_i8", [])
    if pools:
        lib = 0.0
        for a, _, out in pools:
            one = _int8_max_pool_library(card, name, a[0], out, *a[1:])
            lib = None if one is None or lib is None else lib + one
        t["maxpool_i8"] = (
            _cuda_ms(lambda: [maxpool_i8(*a, **k) for a, k, _ in pools], 20),
            _cuda_ms(lambda: [maxpool_i8_reference(*a, **k)
                              for a, k, _ in pools], 20),
            lib, _work_pool(pools))
        _pool_info(card, name, pools[0][0][0])
    return t


def _int8_route(card, record, name: str) -> dict:
    """Phases 2-4 (resnet50) and 19-20 (wrn50_2): the int8 ResNet route of
    ``make_serving_fn(name, ...)``. Returns what phases 18 and 21 read."""
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import (
        fused_bottleneck_chain, fused_bottleneck_chain_reference)
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import \
        kernel_info as fb_kernel_info
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)

    # -- 2 / 19. kernels vs plain versions at the main path's shapes
    model = _int8_model(name)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn(name, SOURCE_HW, device="cuda", model=model)
    torch.cuda.synchronize()
    print(f"{name} serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
    _require(serve.route == "resnet", serve.route)
    raw = _raw_batch(BATCH_CHECK, seed=2)
    with _recording(_resnet_targets()) as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, name)
        _check_stem(calls["stem"], max_err, name)
        _check_pool(calls["maxpool_i8"], max_err, name)
        _check_convs(calls["int8_conv"], max_err, name)
        _check_chains(calls["fused_bottleneck"], max_err, name)
    chains32 = calls["fused_bottleneck"]
    del calls
    torch.cuda.synchronize()

    # -- 3 / 19. the slice, with launch counts
    reset_launch_counts()
    logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"{name} launches in one forward: {launches}")
    _require(launches == {k: INT8_LAUNCHES.get(k, 0) for k in LAUNCHES},
             launches)
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000), logits.shape)
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), "non-finite logits")
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"{name} int8 vs f32 reference: cosine {cos:.6f}, top-1 agreement "
          f"{top1}")
    _require(cos >= 0.99, f"{name} cosine {cos} < 0.99")

    # -- 4 / 20. timing at batch 128
    raw128 = _raw_batch(BATCH_TIME, seed=3)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw128), reps=10, warmup=3)
        print(f"[{card}] serving {name} int8 batch {BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{BATCH_TIME * 1000.0 / ms_serve:.1f} img/s")
        with _recording(_resnet_targets()) as calls128:
            logits128 = serve(raw128)
        torch.cuda.synchronize()
        t = _front_times(card, name, calls128)
        x128 = calls128["preprocess"][0][2]
        stem128 = calls128["stem"][0]
        convs = [(a, k) for a, k, _ in calls128["int8_conv"]]
        k2_lib = _k2_per_shape(card, name, calls128["int8_conv"])
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 5),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 2, warmup=1),
            k2_lib, _work_convs(calls128["int8_conv"]))
        chains = [(a, k) for a, k, _ in calls128["fused_bottleneck"]]
        t["fused_bottleneck"] = (
            _cuda_ms(lambda: [fused_bottleneck_chain(*a, **k)
                              for a, k in chains], 5),
            _cuda_ms(lambda: [fused_bottleneck_chain_reference(*a, **k)
                              for a, k in chains], 2, warmup=1),
            None, _work_chains(calls128["fused_bottleneck"]))
        per_chain = [(_chain_key(a), _cuda_ms(
            lambda a=a, k=k: fused_bottleneck_chain(*a, **k), 5),
            _work_chains([(a, k, None)])) for a, k in chains]
        # The K2 launches the chained units took before: the K2-only plan's
        # units at the chains' places, replayed on their own inputs.
        infer, plan = rq.prepare_int8_resnet(model, serve.scales)
        _, plan_k2 = rq.prepare_int8_resnet(model, serve.scales,
                                            chains=False)
        k2_units = iter(plan_k2["units"])
        chained = set()
        for u in plan["units"]:
            for _ in (u["chain"]["q"] if "chain" in u else [None]):
                v = next(k2_units)
                if "chain" in u:
                    chained.add(id(v))
        with _recording([(rq, "_unit", "unit")]) as unit_calls:
            reset_launch_counts()
            logits_k2 = infer(plan_k2, x128)
            k2_launches = LAUNCHES["int8_conv"]
        torch.cuda.synchronize()
        _require(k2_launches == 52 and torch.equal(logits_k2, logits128),
                 f"{name}: the K2-only plan ({k2_launches} K2 launches) "
                 f"differs from the chained plan")
        replay = [a for a, _, _ in unit_calls["unit"] if id(a[0]) in chained]
        del unit_calls
        ms_k2_units = _cuda_ms(lambda: [rq._unit(*a) for a in replay], 5)
        del calls128
    for kname, (ms, plain, lib, bound) in t.items():
        what = {"int8_conv": f"{len(convs)} convs of one forward; library: "
                             f"torch._int_mm, 1x1 s1 products only",
                "fused_bottleneck": f"{len(chains)} chains of one forward"
                }.get(kname, "one call")
        print(f"[{card}] {name} {kname} batch {BATCH_TIME} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
    for key, ms, bound in per_chain:
        bsz, h, w, c = key[0]
        info = fb_kernel_info(bsz, h, w, c, key[2])
        print(f"[{card}] {name} K8 chain x {key[0]}, {key[1]} unit(s), M "
              f"{key[2]}: {ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
              f"tiles of {info['rows']} rows x {info['cols']} columns of one "
              f"image")
        _print_info(card, f"{name} K8 at x {key[0]}, M {key[2]}", info)
    print(f"[{card}] {name} the {len(replay)} chained units on K2 (the "
          f"K2-only plan, {3 * len(replay)} launches, replayed): "
          f"{ms_k2_units:.4f} ms; on K8 ({launches['fused_bottleneck']} "
          f"launches): {t['fused_bottleneck'][0]:.4f} ms")
    replaces = {"preprocess": ("preprocess.cu",
                               "pytorchcv_tpu/kernels/preprocess.py:133"),
                "int8_conv": ("int8_conv.cu",
                              "pytorchcv_tpu/quant/resnet_int8.py:66"),
                "stem": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:253"),
                "maxpool_i8": ("stem.cu",
                               "pytorchcv_tpu/quant/resnet_int8.py:261"),
                "fused_bottleneck": (
                    "fused_bottleneck.cu",
                    "pytorchcv_tpu/kernels/fused_bottleneck.py:176")}
    for kname, (source, rep) in replaces.items():
        ms, plain, lib, bound = t[kname]
        record.append(_record_entry(kname, name, source, rep,
                                    launches[kname], max_err[kname], ms,
                                    plain, bound, lib))
    return {"model": model, "scales": serve.scales, "raw128": raw128,
            "stem128": stem128, "chains32": chains32, "k3_ms": t["stem"][0],
            "cudnn_ms": t["stem"][2]}


def _chains(routes, record) -> None:
    """Phase 18: K8 against its plain version on every distinct chain call
    of the batch-32 resnet50 and wrn50_2 forwards, and at the JAX test's
    shape (h 4, w 8, C 128, M 128, 2 units, batch 2)."""
    import numpy as np
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import (
        fused_bottleneck_chain, pack_units)
    max_err = {}
    for name, state in routes.items():
        _check_chains(state["chains32"], max_err, f"{name} (phase 18)")
    rng = np.random.default_rng(0)
    h, w, c, m, n_units, bsz = 4, 8, 128, 128, 2, 2

    def cell(cin, cout, k):
        kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
        s_w = np.maximum(np.abs(kern).max(axis=(0, 1, 2)), 1e-12) / 127.0
        wq = np.clip(np.round(kern / s_w), -127, 127).astype(np.int8)
        return {"wq": torch.from_numpy(np.ascontiguousarray(
                    wq.transpose(3, 0, 1, 2))).cuda(),
                "gain": torch.from_numpy((s_w * rng.uniform(0.5, 1.5, cout))
                                         .astype(np.float32)).cuda(),
                "bias": torch.from_numpy((rng.standard_normal(cout) * 0.1)
                                         .astype(np.float32)).cuda()}
    units = [{"conv1": cell(c, m, 1), "conv2": cell(m, m, 3),
              "conv3": cell(m, c, 1)} for _ in range(n_units)]
    packed = pack_units(units, [2.5] + [1.8, 2.1, 2.4] * n_units)
    x = torch.from_numpy(rng.integers(-127, 128, (bsz, h, w, c),
                                      dtype=np.int8)).cuda()
    with torch.inference_mode():
        out = fused_bottleneck_chain(x, packed)
        _check_chains([((x, packed), {}, out)], max_err, "JAX test shape")
    for entry in record:
        if entry["name"] == "fused_bottleneck":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max_err["fused_bottleneck"])


def _stem_int8(card, routes, record) -> None:
    """Phase 21: K9 against its plain version, bit-exact, on the resnet50
    and wrn50_2 stems at batch 128 (the preprocess output as NHWC f32,
    s_img the stem conv's calibrated scale, s_out stage 1's input scale);
    its prepared entry (weights from ``prepare_stem``) equal to the call
    and timed as the kernel, the whole call (weights prepared inside)
    beside it, K3 and cuDNN's f32 conv of the same image; agreement with
    K3's int8 output printed (the input quantization differs)."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.preprocess import \
        classification_preprocess
    from pytorchcv_tpu_torch.kernels.stem_conv import (
        prepare_stem, stem_conv7x7_s2, stem_conv7x7_s2_prepared,
        stem_conv7x7_s2_reference)
    from pytorchcv_tpu_torch.kernels.stem_conv import \
        kernel_info as k9_kernel_info
    for name, st in routes.items():
        model, scales = st["model"], st["scales"]
        pre = classification_preprocess(name, SOURCE_HW,
                                        model_in_size=model.in_size,
                                        out_dtype=torch.float32,
                                        layout="nhwc", device="cuda")
        block = model.features.init_block.conv
        k7 = block.conv.weight.detach().permute(2, 3, 1, 0).contiguous()
        if block.bn is not None:
            bn = block.bn
            gain = bn.weight.detach() * torch.rsqrt(bn.running_var + 1e-5)
            bias = (bn.bias.detach() - bn.running_mean * gain).contiguous()
        else:
            gain = torch.ones_like(block.conv.bias)
            bias = block.conv.bias.detach().contiguous()
        s_img = scales["features/init_block/conv/conv"]
        s_out = scales["features/stage1/unit1/body/conv1/conv"]
        with torch.inference_mode():
            x = pre(st["raw128"])
            args = (x, k7, gain, bias, s_img, s_out)
            reset_launch_counts()
            out = stem_conv7x7_s2(*args)
            torch.cuda.synchronize()
            launches = LAUNCHES["stem_int8"]
            _require(launches == 1, f"K9 launches {launches}")
            ref = stem_conv7x7_s2_reference(*args)
            err = float((out.float() - ref.float()).abs().max())
            same = torch.equal(out, ref)
            k3_out = st["stem128"][2]
            agree = float((out == k3_out).float().mean())
            print(f"{name} K9 int8 stem x {tuple(x.shape)} -> "
                  f"{tuple(out.shape)}: {'bit-exact' if same else 'DIFFERS'}"
                  f" (max abs err {err}); {agree:.4f} of elements equal to "
                  f"K3's int8 output (information only: K3 takes the bf16 "
                  f"image, K9 the image quantized at s_img)")
            _require(same, f"{name} K9 not bit-exact")
            # the kernel's time: the prepared entry, as a caller that
            # keeps the weights fixed runs it; the whole call beside it
            _, wq, gq = prepare_stem(k7, gain, bias, s_img, s_out)
            pargs = (x, wq, gq, bias, s_img, s_out)
            reset_launch_counts()
            _require(torch.equal(stem_conv7x7_s2_prepared(*pargs), out) and
                     LAUNCHES["stem_int8"] == 1,
                     f"{name} K9's prepared entry differs from the call")
            ms = _cuda_ms(lambda: stem_conv7x7_s2_prepared(*pargs), 20)
            ms_call = _cuda_ms(lambda: stem_conv7x7_s2(*args), 20)
            plain = _cuda_ms(lambda: stem_conv7x7_s2_reference(*args), 5)
            xn = x.permute(0, 3, 1, 2).contiguous()
            wf = block.conv.weight.detach()
            lib = _cuda_ms(lambda: F.conv2d(xn, wf, stride=2, padding=3), 20)
            bsz, h, w, _ = x.shape
            o = k7.shape[3]
            bound = _bound(_nbytes(x, k7, gain, bias, out),
                           2 * bsz * (h // 2) * (w // 2) * o * 147, "int8")
        info = k9_kernel_info(bsz, h, w)
        print(f"[{card}] {name} K9 tiles of {info['rows']} output rows")
        _print_info(card, f"{name} K9 int8 stem", info)
        _require(info["spill_bytes"] == 0, f"{name} K9 spills")
        print(f"[{card}] {name} K9 int8 stem batch {BATCH_TIME}: kernel "
              f"(prepared entry) {ms:.4f} ms, the whole call (weights "
              f"prepared inside) {ms_call:.4f} ms, plain {plain:.4f} ms, K3 "
              f"(bf16 stem, phase "
              f"4/20) {st['k3_ms']:.4f} ms, cuDNN f32 conv {lib:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]})")
        record.append(_record_entry(
            "stem_int8", f"{name} stem_conv7x7_s2", "stem_int8.cu",
            "pytorchcv_tpu/kernels/stem_conv.py:149", launches, err, ms,
            plain, bound, lib))


def _patch_probe(card, record) -> None:
    """Phase 22: K10 against its plain version at the probe tool's shapes
    (H 60, W 128, C 128, n 6480, numpy seed 0, as the tool draws them),
    within 1e-5 of max |plain| and bit-equal to the fixed-order sum (rows
    outer, columns inner, f32 adds on the card), with its two launches (the
    table of the 714 distinct windows, the gather); back to back and on the
    device beside its plain version and its bound: the map read once and
    the sums written once, against 240 adds per distinct window and
    channel at the add rate (the count per output printed beside it)."""
    import numpy as np
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.patch_probe import (
        PATCH_COLS, PATCH_ROWS, clamped_starts, distinct_windows,
        patch_window_sum, patch_window_sum_reference)
    rs = np.random.RandomState(0)
    h, w, c, n = 60, 128, 128, 6480
    x = torch.from_numpy(rs.randn(h, w, c).astype(np.float32)).cuda().to(
        torch.bfloat16)
    starts = torch.from_numpy(np.stack(
        [rs.randint(0, h - PATCH_ROWS, n), rs.randint(0, w - PATCH_COLS, n)],
        1).astype(np.int32)).cuda()
    with torch.inference_mode():
        reset_launch_counts()
        out = patch_window_sum(x, starts)
        torch.cuda.synchronize()
        launches = LAUNCHES["patch_window_sum"]
        _require(launches == 2, f"K10 launches {launches}")
        ref = patch_window_sum_reference(x, starts)
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        sy, sx = clamped_starts(starts, h, w).unbind(1)
        xf, fixed = x.float(), torch.zeros_like(out)
        for r in range(PATCH_ROWS):
            for q in range(PATCH_COLS):
                fixed = fixed + xf[sy + r, sx + q]
        same = torch.equal(out, fixed)
        print(f"K10 window sums x {tuple(x.shape)}, {n} starts: max abs err "
              f"{err}, {rel:.3e} of max |plain| (gate {PROBE_TOL}); "
              f"{'bit-equal to' if same else 'DIFFERS from'} the fixed-order "
              f"sum")
        _require(rel <= PROBE_TOL, f"K10 rel err {rel}")
        _require(same, "K10 differs from the fixed-order sum")
        ms = _cuda_ms(lambda: patch_window_sum(x, starts), 200)
        device, shares = {}, {}
        for kname in ("window_sum_kernel", "gather_kernel"):
            device[kname], shares[kname], _ = _launch_ms(
                lambda: patch_window_sum(x, starts), kname, reps=50)
        plain = _cuda_ms(lambda: patch_window_sum_reference(x, starts), 5)
    nbytes = _nbytes(x, starts, out)
    windows = distinct_windows(h, w)
    bound = _bound(nbytes, windows * PATCH_ROWS * PATCH_COLS * c, "f32_add")
    per_output = _bound(nbytes, n * PATCH_ROWS * PATCH_COLS * c, "f32_add")
    print(f"[{card}] K10 window sums ({windows} distinct windows, 2 "
          f"launches): kernel {ms:.4f} ms back to back, "
          f"{sum(device.values()):.4f} ms on the device ("
          + ", ".join(f"{k} {v:.4f}, the mean of the "
                      f"{100 * shares[k]:.0f} % of launches recorded"
                      for k, v in sorted(device.items()))
          + f"), plain {plain:.4f} ms, library none, bound "
          f"{bound[0]:.4f} ms ({bound[1]}; 240 adds an output value instead "
          f"of a distinct window: {per_output[0]:.4f} ms, {per_output[1]})")
    record.append(_record_entry(
        "patch_window_sum", "patch_window_sum (probe)", "patch_probe.cu",
        "tools/exp_pallas_patch_probe.py:51", launches, err, ms, plain,
        bound, None))


def _check_se_tail(calls, max_err, tag):
    """K11 against its plain version on every call, handed the same gate:
    bit-exact."""
    from pytorchcv_tpu_torch.kernels.se_tail import se_tail_reference
    err = 0.0
    for a, k, out in calls:
        ref = se_tail_reference(*a, **k)
        err = max(err, float((out.float() - ref.float()).abs().max()))
        _require(torch.equal(out, ref),
                 f"{tag} K11 not bit-exact at t {tuple(a[0].shape)}")
    max_err["se_tail"] = err
    print(f"{tag} K11: {len(calls)} calls bit-exact (t "
          f"{sorted({tuple(a[0].shape) for a, _, _ in calls})})")


def _work_se_tail(calls):
    """Per element: t read, the residual read, the output written, the gate
    read once; 4 f32 operations (product, add, ReLU, scale), none an FMA."""
    nbytes = ops = 0
    for a, k, out in calls:
        nbytes += _nbytes(a[0], a[1], k["residual"], out)
        ops += 4 * out.numel()
    return _bound(nbytes, ops, "f32_add")


def _gconv_args(a, k):
    """A recorded grouped call's ``gconv_plan`` arguments."""
    x, w = a[0], a[1]
    return (*x.shape, w.shape[0], k["groups"], w.shape[1], k["stride"],
            k.get("dilation", 1))


def _gconv_ms(fn, launches: int, reps: int = 10):
    """The grouped kernel's device ms a call of ``fn``, which launches it
    ``launches`` times (``_parts.launch_ms``: the mean of the launches the
    profiler recorded), the share of the launches recorded, and the calls'
    ms by CUDA events."""
    from pytorchcv_tpu_torch.kernels._parts import launch_ms
    return launch_ms(fn, "int8_gconv_kernel", launches, reps)


def _gconv_per_shape(card, tag, calls):
    """The grouped K2 at each distinct grouped conv of a path's recorded
    calls: device ms (``torch.profiler``) launched again and again (its
    input and weights left in L2 by the launch before) and after a 256 MB
    write that evicts L2, useful TOP/s, the tensor-core operations issued
    (zeros included), bound, cuDNN's bf16 grouped conv on the same shape
    (channels-last, a yardstick: bf16 on the tensor cores, not the same
    function), the plan's tiles, the instance's registers, spills (any
    fails the run) and shared memory, and the share of the launches the
    profiler recorded (``_gconv_ms`` averages over those). Returns the
    device sums over the path's calls (hot, after the flush) and
    cuDNN's."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels.int8_conv import (gconv_info,
                                                       gconv_issued_ops,
                                                       gconv_plan, int8_conv)
    seen = {}
    for a, k, out in calls:
        key = _conv_key(a, k)
        if key not in seen:
            seen[key] = [a, k, out, 0]
        seen[key][3] += 1
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    hot_sum = cold_sum = lib_sum = 0.0
    for key, (a, k, out, count) in sorted(seen.items()):
        x, w = a[0], a[1]
        o = out[0] if isinstance(out, tuple) else out
        hot, seen_hot, wall = _gconv_ms(lambda: int8_conv(*a, **k), 1)
        cold, seen_cold, _ = _gconv_ms(
            lambda: (flush.fill_(1), int8_conv(*a, **k)), 1)
        share = min(seen_hot, seen_cold)
        if hot is None or cold is None:
            print(f"[{card}] {tag} grouped K2: the profiler saw no device "
                  f"time; CUDA events instead")
            hot = cold = wall
        ops = 2 * o.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        bound = _work_convs([(a, k, out)])
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib = _cuda_ms(lambda: F.conv2d(xb, wb, stride=k["stride"],
                                        padding=w.shape[1] // 2,
                                        groups=k["groups"]), 10)
        plan = gconv_plan(*_gconv_args(a, k))
        issued = gconv_issued_ops(*_gconv_args(a, k), plan)
        info = gconv_info(plan)
        print(f"[{card}] {tag} grouped K2 k={key[0]} s={key[1]} cin={key[3]} "
              f"cout={key[4]} groups={k['groups']} h={key[5]} {key[6]} "
              f"(x{count}): {hot:.4f} ms on the device launched again and "
              f"again, {cold:.4f} after an L2 flush ({wall:.4f} back to "
              f"back), {ops / cold / 1e9:.1f} useful TOP/s, "
              f"{issued / 1e9:.2f} G "
              f"tensor-core operations issued for {ops / 1e9:.2f} G useful "
              f"({issued / ops:.2f}x), bound {bound[0]:.4f} ms ({bound[1]}); "
              f"cuDNN bf16 grouped conv {lib:.4f} ms (a yardstick, not the "
              f"same function); tile {plan.bm}x{plan.bn} (u {plan.u}), "
              f"spatial {plan.imgs}x{plan.th}x{plan.tw}, {plan.ch} k32 "
              f"chunks, {info['registers']} registers, {info['spill_bytes']} "
              f"bytes spilled, shared {info['static_smem']} static + "
              f"{info['dynamic_smem']} dynamic bytes, "
              f"{info['blocks_per_sm']} blocks an SM; the profiler recorded "
              f">= {100 * share:.0f} % of the launches")
        _require(info["spill_bytes"] == 0, f"{tag} grouped K2 spills at {key}")
        hot_sum += count * hot
        cold_sum += count * cold
        lib_sum += count * lib
    del flush
    print(f"[{card}] {tag} grouped K2 on the device, the {len(calls)} grouped "
          f"convs of a forward conv by conv: {hot_sum:.4f} ms launched again "
          f"and again, {cold_sum:.4f} ms after an L2 flush; cuDNN bf16 on the "
          f"same shapes {lib_sum:.4f} ms")
    return hot_sum, cold_sum, lib_sum


def _tame_se_gates(model: torch.nn.Module) -> None:
    """Every SE gate's second product drawn at a tenth of the init's scale.
    At the init's scale the gates' pre-sigmoid values grow with the
    activations to ~350 in seresnext50_32x4d's last stage (BN randomized
    as here, no BN in the gate), so each gate is a hard 0/1 switch that
    the int8 rounding flips: the JAX package's own int8 pipeline reaches
    cosine 0.964 against its f32 forward on that draw. At a tenth they stay
    below ~17 and the gates keep their slope."""
    from pytorchcv_tpu_torch.nn.att import SEBlock
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SEBlock):
                m.conv2.weight.mul_(0.1)


def _se_group_route(card, record, name: str) -> None:
    """Phases 23-25: ``make_serving_fn(name, (256, 256))`` on the int8
    route at full width on seed-0 weights (BN from seed 1, conv biases, the
    SE gates', from seed 2, the gates' second product at a tenth:
    ``_tame_se_gates``): every kernel against its plain version on a
    batch-32 forward (K1 within 1 bf16 ulp, K3 within its tolerance,
    ``maxpool_i8``, every distinct dense and grouped K2 conv and every K11
    call bit-exact), the launch counts of ``SE_GROUP_ROUTES`` (K8 0),
    cosine >= 0.99 against the f32 reference forward; img/s at the route's
    timing batch and the device's idle share under the profiler, each
    kernel beside its plain version and bound, the grouped K2 per distinct
    conv beside cuDNN's bf16 grouped conv."""
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.se_tail import (se_tail,
                                                     se_tail_reference)
    want, batch_time = SE_GROUP_ROUTES[name]
    targets = _resnet_targets() + [(rq, "se_tail", "se_tail")]
    model = _int8_model(name)
    _randomize_biases(model, seed=2)
    _tame_se_gates(model)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn(name, SOURCE_HW, device="cuda", model=model)
    torch.cuda.synchronize()
    print(f"{name} serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
    _require(serve.route == "resnet", serve.route)
    raw = _raw_batch(BATCH_CHECK, seed=2)
    with _recording(targets) as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, name)
        _check_stem(calls["stem"], max_err, name)
        _check_pool(calls["maxpool_i8"], max_err, name)
        _check_convs([c for c in calls["int8_conv"] if c[1]["groups"] > 1],
                     max_err, name)
        max_err["int8_gconv"] = max_err["int8_conv"]
        _check_convs([c for c in calls["int8_conv"]
                      if c[1]["groups"] == 1], max_err, name)
        if calls["se_tail"]:
            _check_se_tail(calls["se_tail"], max_err, name)
    del calls

    reset_launch_counts()
    logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"{name} launches in one forward: {launches}")
    expected = {k: 0 for k in LAUNCHES}
    expected.update(preprocess=1, stem=1, maxpool_i8=1, **want)
    _require(launches == expected, f"{name} launches {launches}")
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000), logits.shape)
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), f"{name} non-finite logits")
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"{name} int8 vs f32 reference: cosine {cos:.6f}, top-1 agreement "
          f"{top1}")
    _require(cos >= 0.99, f"{name} cosine {cos} < 0.99")

    raw_t = _raw_batch(batch_time, seed=3)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw_t), reps=10, warmup=3)
        print(f"[{card}] serving {name} int8 batch {batch_time}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{batch_time * 1000.0 / ms_serve:.1f} img/s")
        kernels, n_ops, wall, busy = _device_kernels(lambda: serve(raw_t),
                                                     3)
        print(f"[{card}] {name} batch {batch_time} under the profiler: "
              f"{wall:.3f} ms a batch, the device busy {busy:.3f} ms (idle "
              f"{100.0 * (1.0 - busy / wall):.1f} %), {n_ops:.0f} device "
              f"operations a batch; the largest items (ms a batch): "
              + ", ".join(f"{_kernel_name(k)[:60]} {v:.4f}" for k, v in
                          sorted(kernels.items(), key=lambda kv: -kv[1])[:8]))
        with _recording(targets) as calls_t:
            serve(raw_t)
        torch.cuda.synchronize()
        t = _front_times(card, name, calls_t)
        dense = [c for c in calls_t["int8_conv"] if c[1]["groups"] == 1]
        grouped = [c for c in calls_t["int8_conv"] if c[1]["groups"] > 1]
        k2_lib = _k2_per_shape(card, name, dense)
        hot, cold, gconv_lib = _gconv_per_shape(card, name, grouped)
        for kname, cs, lib in (("int8_conv", dense, k2_lib),
                               ("int8_gconv", grouped, gconv_lib)):
            ops = [(a, k) for a, k, _ in cs]
            t[kname] = (
                _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in ops], 5),
                _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                                  for a, k in ops], 1, warmup=1),
                lib, _work_convs(cs))
        gops = [(a, k) for a, k, _ in grouped]
        fwd, seen_fwd, _ = _gconv_ms(lambda: serve(raw_t), len(gops), 3)
        seq, seen_seq, _ = _gconv_ms(
            lambda: [int8_conv(*a, **k) for a, k in gops], len(gops), 3)
        _require(fwd is not None and seq is not None,
                 f"{name}: the profiler recorded no grouped K2 launch")
        print(f"[{card}] {name} grouped K2, the {len(gops)} grouped convs of "
              f"a batch-{batch_time} forward four ways: {fwd:.4f} ms on the "
              f"device in the forward (profiler, {100 * seen_fwd:.0f} % of "
              f"the launches recorded), {seq:.4f} ms on the device replayed "
              f"back to back ({100 * seen_seq:.0f} %; "
              f"{t['int8_gconv'][0]:.4f} ms by CUDA events), conv by conv "
              f"{cold:.4f} ms after an L2 flush and {hot:.4f} ms launched "
              f"again and again (the input and weights the launch before "
              f"left in L2)")
        se_calls = [(a, k) for a, k, _ in calls_t["se_tail"]]
        if se_calls:
            t["se_tail"] = (
                _cuda_ms(lambda: [se_tail(*a, **k) for a, k in se_calls], 10),
                _cuda_ms(lambda: [se_tail_reference(*a, **k)
                                  for a, k in se_calls], 5),
                None, _work_se_tail(calls_t["se_tail"]))
        del calls_t
    what = {"int8_conv": f"{want['int8_conv']} dense convs of one forward; "
                         f"library: torch._int_mm, 1x1 s1 products only",
            "int8_gconv": f"{want['int8_gconv']} grouped convs of one "
                          f"forward; library: cuDNN's bf16 grouped conv, a "
                          f"yardstick",
            "se_tail": f"{want.get('se_tail', 0)} SE tails of one forward"}
    replaces = {"preprocess": ("preprocess.cu",
                               "pytorchcv_tpu/kernels/preprocess.py:133"),
                "stem": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:"
                         + ("237" if name.startswith("senet") else "253")),
                "maxpool_i8": ("stem.cu",
                               "pytorchcv_tpu/quant/resnet_int8.py:261"),
                "int8_conv": ("int8_conv.cu",
                              "pytorchcv_tpu/quant/resnet_int8.py:66"),
                "int8_gconv": ("int8_gconv.cu",
                               "pytorchcv_tpu/quant/resnet_int8.py:58"),
                "se_tail": ("se_tail.cu",
                            "pytorchcv_tpu/quant/resnet_int8.py:359")}
    for kname, (ms, plain, lib, bound) in t.items():
        print(f"[{card}] {name} {kname} batch {batch_time} "
              f"({what.get(kname, 'one call')}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        source, rep = replaces[kname]
        record.append(_record_entry(kname, name, source, rep,
                                    launches[kname], max_err[kname], ms,
                                    plain, bound, lib))


def _danet(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from pytorchcv_tpu_torch.kernels.flash_attention import \
        kernel_info as fa_kernel_info
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8,
                                                  maxpool_i8_reference,
                                                  stem_conv,
                                                  stem_conv_reference)

    # -- 5. kernels vs plain versions at the DANet path's shapes
    model = pt.get_model(SEG_NAME, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    t0 = time.perf_counter()
    with _recording(_seg_targets()) as build_calls:
        serve = pt.make_serving_fn(SEG_NAME, SEG_SOURCE_HW,
                                   task="segmentation", device="cuda",
                                   model=model)
    torch.cuda.synchronize()
    print(f"danet serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s")
    (a32, _, out32), = build_calls["flash_attention"]
    del build_calls
    raw = _raw_batch(SEG_BATCH_CHECK, seed=2, hw=SEG_SOURCE_HW)
    with _recording(_seg_targets()) as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, "danet", scaled=True)
        _check_stem(calls["stem"], max_err, "danet")
        _check_pool(calls["maxpool_i8"], max_err, "danet")
        _check_convs(calls["int8_conv"], max_err, "danet")
        _check_bend(calls["int8_conv"], max_err)
        (a, k, out), = calls["flash_attention"]
        errs = [_check_attention(*a[:3], out, "path"),
                _check_attention(*a32[:3], out32, "calibration")]
        # The random model's q.k logits saturate the softmax (one key a
        # row, checked exactly above); the path's q scaled to logits of
        # std ~2 makes every key count.
        q, kk, v = a[:3]
        s = 2.0 / (q.shape[-1] ** 0.5 * float(q.float().std())
                   * float(kk.float().std()))
        q = (q.float() * s).to(q.dtype)
        errs.append(_check_attention(q, kk, v, flash_attention(q, kk, v),
                                     "path, q scaled"))
        g = torch.Generator().manual_seed(4)
        for dtype in (torch.bfloat16, torch.float32):
            q, kk = (torch.randn((2, 3601, 64), generator=g).mul_(0.3)
                     .to(dtype).cuda() for _ in range(2))
            v = torch.randn((2, 3601, 512), generator=g).to(dtype).cuda()
            errs.append(_check_attention(q, kk, v, flash_attention(q, kk, v),
                                         "ragged L=3601"))
        max_err["flash_attention"] = max(errs)
    del calls, a32, out32
    torch.cuda.synchronize()

    # -- 6. the slice, with launch counts
    reset_launch_counts()
    maps = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"danet launches in one forward: {launches}")
    _require(launches == SEG_LAUNCHES, launches)
    _require(len(maps) == 3, f"{len(maps)} maps")
    for m in maps:
        _require(tuple(m.shape) == (SEG_BATCH_CHECK, 19, 480, 480), m.shape)
        _require(bool(torch.isfinite(m.float()).all()), "non-finite map")
    ref = serve.make_reference_forward()(raw)
    torch.cuda.synchronize()
    for i, (m, r) in enumerate(zip(maps, ref)):
        y, yf = m.float(), r.float()
        cos = float((y * yf).sum() / (y.norm() * yf.norm()))
        agree = float((y.argmax(1) == yf.argmax(1)).float().mean())
        print(f"danet map {i} int8 vs f32 reference: cosine {cos:.6f}, "
              f"argmax agreement {agree:.6f}")
        if i == 0:
            _require(cos >= 0.99, f"danet cosine {cos} < 0.99")
            _require(agree >= 0.97, f"danet argmax agreement {agree} < 0.97")
    del maps, ref

    # -- 7. timing at batch 8
    raw8 = _raw_batch(SEG_BATCH_TIME, seed=3, hw=SEG_SOURCE_HW)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw8), reps=5, warmup=2)
        print(f"[{card}] serving {SEG_NAME} int8 batch {SEG_BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{SEG_BATCH_TIME * 1000.0 / ms_serve:.2f} img/s")
        head_convs = []
        hooks = [mod.register_forward_pre_hook(
                     lambda m_, a_: head_convs.append((m_, a_[0])))
                 for mod in serve.head.modules()
                 if isinstance(mod, torch.nn.Conv2d)]
        with _recording(_seg_targets()) as calls8:
            serve(raw8)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        t = {}
        (a, k, out), = calls8["preprocess"]
        t["preprocess"] = _preprocess_times(card, "danet", a, k, out)
        (a, k, out), = calls8["stem"]
        xs = a[0].float()
        ws = a[1].permute(3, 0, 1, 2).float()
        t["stem"] = (
            _cuda_ms(lambda: stem_conv(*a, **k), 20),
            _cuda_ms(lambda: stem_conv_reference(*a, **k), 5),
            _cuda_ms(lambda: F.conv2d(xs, ws, stride=2, padding=1), 20),
            _work_stem(a, k, out))
        del xs
        _stem_info(card, "danet", a)
        (a, k, out), = calls8["maxpool_i8"]
        t["maxpool_i8"] = (
            _cuda_ms(lambda: maxpool_i8(*a, **k), 20),
            _cuda_ms(lambda: maxpool_i8_reference(*a, **k), 20), None,
            _work_pool(calls8["maxpool_i8"]))
        _pool_info(card, "danet", a[0])
        (a, k, out), = calls8["flash_attention"]
        qa, ka, va = a[:3]
        t["flash_attention"] = (
            _cuda_ms(lambda: flash_attention(*a, **k), 5),
            _cuda_ms(lambda: flash_attention_reference(*a, **k), 3),
            _cuda_ms(lambda: F.scaled_dot_product_attention(
                qa, ka, va, scale=1.0), 10),
            _work_attention(a, out))
        for dt in (torch.bfloat16, torch.float32):
            _print_info(card, f"danet K4 flash attention d {qa.shape[-1]} "
                        f"{str(dt)[6:]}", fa_kernel_info(qa.shape[-1], dt))
        convs = [(a, k) for a, k, _ in calls8["int8_conv"]]
        conv_bound = _work_convs(calls8["int8_conv"])
        k2_lib = _k2_per_shape(card, "danet", calls8["int8_conv"])
        del calls8
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 3),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 1, warmup=1),
            k2_lib, conv_bound)
        del convs
        ms_head = _cuda_ms(lambda: [m_(x_) for m_, x_ in head_convs], 3)
        n_head = len(head_convs)
        del head_convs
    for name, (ms, plain, lib, bound) in t.items():
        what = ("54 convs of one forward; library: torch._int_mm, 1x1 s1 "
                "products only") if name == "int8_conv" else "one call"
        print(f"[{card}] danet {name} batch {SEG_BATCH_TIME} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), share of the batch "
              f"{100.0 * ms / ms_serve:.1f} %")
    rest = ms_serve - ms_head - sum(v[0] for v in t.values())
    print(f"[{card}] danet cuDNN bf16 head convs ({n_head} calls) batch "
          f"{SEG_BATCH_TIME}: {ms_head:.4f} ms, share "
          f"{100.0 * ms_head / ms_serve:.1f} %; the rest of the batch "
          f"(channel attention, upsampling, BN, host gaps): {rest:.4f} ms")
    replaces = {
        "preprocess": ("preprocess.cu",
                       "pytorchcv_tpu/kernels/preprocess.py:133"),
        "stem": ("stem.cu", "pytorchcv_tpu/quant/seg_backbone_int8.py:85"),
        "maxpool_i8": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:112"),
        "int8_conv": ("int8_conv.cu", "pytorchcv_tpu/quant/resnet_int8.py:66"),
        "flash_attention": ("flash_attention.cu",
                            "pytorchcv_tpu/kernels/flash_attention.py:110")}
    for name, (source, rep) in replaces.items():
        ms, plain, lib, bound = t[name]
        record.append(_record_entry(name, SEG_NAME, source, rep,
                                    launches[name], max_err[name], ms, plain,
                                    bound, lib))


def _rfc_video(seed: int, frames: int = RFC_FRAMES, hw=RFC_HW):
    """A synthetic clip of ``frames`` frames at ``hw`` on the card: forward
    and backward flows (T-1, 4, H, W), each component a sum of four
    low-frequency sinusoids drifting in time (|flow| <= 10 px), and masks
    (T, 1, H, W) of an ellipse covering ~10 % of the frame that moves
    across it."""
    g = torch.Generator().manual_seed(seed)
    (h, w), t = hw, frames
    ys = torch.linspace(0.0, 1.0, h, device="cuda")[:, None]
    xs = torch.linspace(0.0, 1.0, w, device="cuda")[None, :]
    tt = torch.arange(t - 1, device="cuda", dtype=torch.float32)[:, None,
                                                                  None]
    comps = []
    for _ in range(4):
        field = torch.zeros(t - 1, h, w, device="cuda")
        for _ in range(4):
            fy, fx = torch.randint(0, 4, (2,), generator=g).tolist()
            amp, phase, drift = (torch.rand(3, generator=g)
                                 * torch.tensor([1.5, 6.2832, 0.1])).tolist()
            field += (amp + 1.0) * torch.sin(
                6.2832 * (fy * ys + fx * xs) + phase + drift * tt)
        comps.append(field)
    flows = torch.stack(comps, dim=1)
    ft = torch.arange(t, device="cuda", dtype=torch.float32)[:, None, None]
    cy = 0.5 + 0.25 * torch.cos(6.2832 * ft / t)
    cx = 0.5 + 0.3 * torch.sin(6.2832 * ft / t)
    inside = ((xs - cx) / 0.2) ** 2 + ((ys - cy) / 0.16) ** 2 <= 1.0
    return flows, inside.to(torch.float32)[:, None]


@contextlib.contextmanager
def _first_calls(mod, attr):
    """Count the calls of ``mod.attr`` and keep (args, kwargs, output) of
    its first call at each distinct input shape."""
    seen, count = {}, [0]
    orig = getattr(mod, attr)

    def rec(*a, **k):
        out = orig(*a, **k)
        count[0] += 1
        seen.setdefault(tuple(tuple(x.shape) for x in a[:3]) + (a[3],),
                        (a, k, out))
        return out
    setattr(mod, attr, rec)
    try:
        yield seen, count
    finally:
        setattr(mod, attr, orig)


def _deform_case(shape, groups, rb, dtype, seed):
    """K5 inputs at ``shape`` with offsets = center + U(-rb, rb), centers
    of std 6 (windows across the borders), masks U(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    _, c, h, w = shape
    x = torch.randn(shape, generator=g).to(dtype).cuda()
    center = torch.randn((1, 1, 1, 2, h, w), generator=g) * 6.0
    resid = (torch.rand((1, groups, 9, 2, h, w), generator=g) * 2 - 1) * rb
    offset = (center + resid).reshape(1, 18 * groups, h, w).cuda()
    mask = torch.rand((1, 9 * groups, h, w), generator=g).cuda()
    return x, offset, mask


def _check_deform(a, out, what) -> float:
    """K5 against its plain version: f32 within RFC_F32_TOL of max|x|, bf16
    within 1 bf16 ulp at the tensor's scale. Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.deform_patch import \
        deform_sample_reference
    from pytorchcv_tpu_torch.kernels.preprocess import bf16_ulp_error
    x, offset, mask, groups = a[:4]
    ref = deform_sample_reference(x, offset, mask, groups)
    err = float((out.float() - ref.float()).abs().max())
    if x.dtype == torch.bfloat16:
        ulp = float(bf16_ulp_error(out, ref).max())
        print(f"K5 {what} bf16 x {tuple(x.shape)} G {groups}: max {ulp} bf16 "
              f"ulp (scaled), max abs err {err}")
        _require(ulp <= 1, f"K5 {what} differs by {ulp} bf16 ulp")
    else:
        rel = err / float(x.abs().max())
        print(f"K5 {what} f32 x {tuple(x.shape)} G {groups}: max abs err "
              f"{err}, {rel:.3e} of max|x|")
        _require(rel <= RFC_F32_TOL, f"K5 {what} f32 error {rel} of max|x|")
    return err


def _work_deform(a, out):
    """Bytes: x, offsets, mask read once and the taps written once.
    Operations: 10 f32 a tap element (three lerps, the mask)."""
    return _bound(_nbytes(*a[:3], out), 10 * out.numel(), "f32")


def _k5_info(card, tag, x, groups) -> None:
    """K5's registers, spills (any fails the run) and shared memory for the
    instance ``x`` launches (its type, C/G's vector, its layout)."""
    from pytorchcv_tpu_torch.kernels.deform_patch import kernel_info
    nhwc = x.is_contiguous(memory_format=torch.channels_last)
    info = kernel_info(x.shape[1], groups, x.dtype, nhwc)
    print(f"[{card}] {tag} K5 instance: {x.dtype}, "
          f"{'channels-last' if nhwc else 'NCHW (transposed in the launch)'}"
          f" x, {info['vec']} channels a vector")
    _print_info(card, f"{tag} K5", info)
    _require(info["spill_bytes"] == 0, f"{tag} K5 spills")


def _k5_device_ms(fn, tries: int = 3):
    """K5's device ms a call by the profiler from the first of ``tries``
    windows in which it saw exactly one device operation a call (one K5
    launch: it has been seen to lose most of a window's launches), or
    None."""
    for _ in range(tries):
        dev, n_ops = _device_kernels(fn, 20)[:2]
        k5 = [v for n_, v in dev.items() if "deform_sample" in n_]
        if k5 and n_ops == 1:
            return sum(k5)
    return None


def _deform_library(a, out):
    """K5's library yardstick: ``F.grid_sample`` over x as (G, C/G, H, W)
    at the same (y, x) positions (align_corners=True, zeros), times the
    mask. Returns its ms a call and its max |diff| to K5's output."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels.deform_patch import tap_positions
    x, offset, mask, groups = a[:4]
    _, c, h, w = x.shape
    py, px, m = tap_positions(offset, mask, groups, (3, 3), 1, 1, x.dtype)
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1],
                       dim=-1)[0].permute(2, 0, 1, 3).contiguous()
    xg = x.view(groups, c // groups, h, w)
    mg = m[0].permute(2, 0, 1)[:, None]
    ms = _cuda_ms(lambda: F.grid_sample(
        xg, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True) * mg, K5_REPS)
    err = float((F.grid_sample(xg, grid, align_corners=True) * mg
                 - out.view(h * w, 9, groups, c // groups)
                 .permute(2, 3, 0, 1)).abs().max())
    return ms, err


def _kernel_name(key: str) -> str:
    """A profiler kernel key without its namespace and argument list."""
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def _device_kernels(fn, reps: int):
    """Device time a call of every kernel ``fn`` launches, by name (ms),
    the number of device operations (kernels, copies) a call, from
    ``torch.profiler``'s CUDA activity after one warm-up call (empty and 0
    when the profiler sees no device activity), the profiled calls' own
    ms a call (CUDA events), and the ms a call in which some device
    operation ran (the union of their intervals: operations that overlap
    count once)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    covered, reach = 0.0, float("-inf")
    for start, end in spans:
        covered += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return ({e.key: e.self_device_time_total / 1e3 / reps for e in events},
            sum(e.count for e in events) / reps,
            ev[0].elapsed_time(ev[1]) / reps, covered / 1e3 / reps)


def _launch_ms(fn, name: str, launches: int = 1, reps: int = 10):
    """(ms, share, events ms) of ``fn``'s launches of the kernels whose name
    holds ``name``: ``kernels._parts.launch_ms``'s mean over the launches
    ``torch.profiler`` recorded, times ``launches``, and the share of the
    launches run it recorded (a sum divided by the launches run reads low:
    the profiler may record part of a short window's launches); CUDA
    events over the profiled calls where it recorded none (share 0)."""
    from pytorchcv_tpu_torch.kernels._parts import launch_ms
    ms, share, wall = launch_ms(fn, name, launches, reps)
    return (wall if ms is None else ms), share, wall


def _rfc(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.models.propainter_rfc as rfc_mod
    import pytorchcv_tpu_torch.nn.deform as deform_mod
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.deform_patch import (
        deform_sample, deform_sample_reference)
    from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
        ProPainterRFCSequencer

    # -- 8. the RFC slice through the streaming engine, with launch counts
    model = pt.get_model("propainter_rfc", rng=0, device="cuda")
    flows, masks = _rfc_video(seed=5)
    n_out = RFC_FRAMES - 1

    def stream():
        return ProPainterRFCSequencer(flows, masks, model,
                                      window_size=RFC_WINDOW,
                                      padding=RFC_PADDING)
    seq = stream()
    per_window = [4 * (m.sources[0].stop - m.sources[0].start - 1)
                  for m in seq.window_index]
    print(f"rfc windows (target:offset <- flows/masks): {seq.window_index}, "
          f"K5 launches per window {per_window}")
    torch.cuda.synchronize()
    with _first_calls(deform_mod, "deform_sample") as (seen, _):
        reset_launch_counts()
        comp = seq[0:n_out]
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"rfc launches over {RFC_FRAMES} frames: {launches}")
    _require(launches == {k: sum(per_window) if k == "deform_sample" else 0
                          for k in LAUNCHES}, launches)
    _require(tuple(comp.shape) == (n_out, 4, *RFC_HW), comp.shape)
    _require(bool(torch.isfinite(comp).all()), "non-finite completed flows")
    # combine_flows: outside the masks the input flows come back unchanged
    known = torch.cat([masks[:-1], masks[1:]], dim=1).repeat_interleave(
        2, dim=1) == 0
    _require(torch.equal(comp[known], flows[known]),
             "flows outside the masks changed")
    max_flow = float(comp.abs().max())
    print(f"rfc completed flows {tuple(comp.shape)}: finite, max |flow| "
          f"{max_flow:.4f} (input {float(flows.abs().max()):.4f}), "
          f"{float(masks.mean()):.4f} of pixels masked")
    torch.cuda.synchronize()

    # -- 9. K5 against its plain version
    errs = []
    with torch.inference_mode():
        for key, (a, k, out) in sorted(seen.items()):
            errs.append(_check_deform(a, out, "path"))
        fg_shape, fg_groups, fg_rb = RFC_FLOW_GUIDED
        for dtype in (torch.float32, torch.bfloat16):
            a = (*_deform_case(fg_shape, fg_groups, fg_rb, dtype, 6),
                 fg_groups, fg_rb)
            errs.append(_check_deform(a, deform_sample(*a),
                                      "flow-guided, centers std 6"))
            a = (a[0].contiguous(memory_format=torch.channels_last),
                 *a[1:])
            errs.append(_check_deform(a, deform_sample(*a),
                                      "flow-guided, channels-last x"))
    torch.cuda.synchronize()

    # -- 10. end to end: the same model with deform_conv2d routed to its
    # general formulation (no center), patched here and only here
    def general(*a, **k):
        k.pop("center", None)
        return deform_mod.deform_conv2d(*a, **k)
    rfc_mod.deform_conv2d = general
    try:
        reset_launch_counts()
        comp_general = stream()[0:n_out]
        torch.cuda.synchronize()
        _require(LAUNCHES["deform_sample"] == 0, "general route launched K5")
    finally:
        rfc_mod.deform_conv2d = deform_mod.deform_conv2d
    delta = float((comp - comp_general).abs().max())
    print(f"rfc K5 vs the general route: max |delta| {delta} = "
          f"{delta / max_flow:.3e} of max |flow| (gate {RFC_E2E_TOL})")
    _require(delta <= RFC_E2E_TOL * max_flow,
             f"rfc end to end delta {delta} > {RFC_E2E_TOL} * {max_flow}")
    del comp_general
    # the card against the CPU (the plain sampler, CPU convs) on the clip's
    # first RFC_SHORT flows, before the random recurrence has grown
    fm = torch.cat([masks[:-1], masks[1:]], dim=1)[:RFC_SHORT]
    with torch.inference_mode():
        card_f, _ = rfc_mod.calc_bidirectional_opt_flow_completion_by_pprfc(
            model, flows[:RFC_SHORT], fm)
        cpu_f, _ = rfc_mod.calc_bidirectional_opt_flow_completion_by_pprfc(
            copy.deepcopy(model).cpu(), flows[:RFC_SHORT].cpu(), fm.cpu())
    rel = float((card_f.cpu() - cpu_f).abs().max() / cpu_f.abs().max())
    print(f"rfc card vs CPU on {RFC_SHORT} flows: max |delta| {rel:.3e} of "
          f"max |flow| {float(cpu_f.abs().max()):.4f} (gate {RFC_CPU_TOL})")
    _require(rel <= RFC_CPU_TOL, f"rfc card vs CPU: {rel} of max |flow|")

    # -- 11. timing: one pass over the clip after the passes above
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    seq = stream()
    first_stop = seq.window_index[0].target.stop
    ev[0].record()
    seq[0:first_stop]
    ev[1].record()
    seq[first_stop:n_out]
    ev[2].record()
    torch.cuda.synchronize()
    win_ms = [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
    ms_pass = sum(win_ms)
    print(f"[{card}] rfc {RFC_FRAMES} frames at {RFC_HW[0]}x{RFC_HW[1]}, "
          f"window {RFC_WINDOW}, padding {RFC_PADDING} (f32, no TF32): "
          f"{ms_pass:.3f} ms, {n_out * 1000.0 / ms_pass:.2f} completed-flow "
          f"frames/s; windows {win_ms[0]:.3f} and {win_ms[1]:.3f} ms")
    (key, (a, k, out)), = seen.items()
    x, groups = a[0], a[3]
    with torch.inference_mode():
        ms = _cuda_ms(lambda: deform_sample(*a, **k), K5_REPS)
        plain = _cuda_ms(lambda: deform_sample_reference(*a[:4]), 20)
        lib, lib_err = _deform_library(a, out)
        bound = _work_deform(a, out)
        # the 3-D encoder and every 2-D conv of one RFC call (one direction
        # of the first window), replayed
        t_w = seq.window_index[0].sources[0]
        f1 = flows[t_w.start:t_w.stop, :2][None]
        m1 = masks[t_w.start:t_w.stop][None]
        ms_call = _cuda_ms(lambda: model(f1, m1), 3, warmup=1)
        convs = []
        hooks = [mod.register_forward_pre_hook(
                     lambda m_, a_: convs.append((m_, a_[0])))
                 for mod in model.modules()
                 if type(mod) in (torch.nn.Conv2d, torch.nn.Conv3d)]
        model(f1, m1)
        for hk in hooks:
            hk.remove()
        conv3 = [c_ for c_ in convs if isinstance(c_[0], torch.nn.Conv3d)]
        conv2 = [c_ for c_ in convs if not isinstance(c_[0], torch.nn.Conv3d)]
        prop = {id(m_) for m_ in
                model.hg.skip_seq.skip4.feat_prop_module.modules()}
        conv2r = [c_ for c_ in conv2 if id(c_[0]) in prop]
        conv2d = [c_ for c_ in conv2 if id(c_[0]) not in prop]
        ms3 = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv3], 3, warmup=1)
        ms2r = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv2r], 3, warmup=1)
        ms2d = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv2d], 3, warmup=1)
        n_conv = (len(conv3), len(conv2r), len(conv2d))
        del convs, conv3, conv2, conv2r, conv2d
        # device time (profiler): K5's kernel alone, and every kernel of
        # one RFC call against its wall time
        k5_dev = _k5_device_ms(lambda: deform_sample(*a, **k))
        call_dev = _device_kernels(lambda: model(f1, m1), 1)[0]
    n_k5 = per_window[0] // 2
    print(f"[{card}] rfc K5 at x {tuple(x.shape)} G {groups}: wrapper "
          f"{ms:.4f} ms a call (CUDA events, back to back; the kernel alone "
          f"on the device: "
          f"{'not measured' if k5_dev is None else f'{k5_dev:.4f} ms'}, "
          f"profiler), plain {plain:.4f} ms, "
          f"grid_sample x mask {lib:.4f} ms (max |diff| to K5 "
          f"{lib_err:.2e}), bound {bound[0]:.4f} ms ({bound[1]}); per "
          f"window {per_window[0]} x {ms:.4f} = {per_window[0] * ms:.3f} ms")
    _k5_info(card, "rfc", x, groups)
    print(f"[{card}] rfc one call (T = {t_w.stop - t_w.start}, one "
          f"direction): {ms_call:.3f} ms; replayed alone: 3-D convs "
          f"({n_conv[0]}) {ms3:.3f} ms ({100.0 * ms3 / ms_call:.1f} %), "
          f"2-D convs of the propagation ({n_conv[1]}) {ms2r:.3f} ms "
          f"({100.0 * ms2r / ms_call:.1f} %), other 2-D convs "
          f"({n_conv[2]}) {ms2d:.3f} ms ({100.0 * ms2d / ms_call:.1f} %), "
          f"K5 {n_k5} x {ms:.4f} = {n_k5 * ms:.3f} ms "
          f"({100.0 * n_k5 * ms / ms_call:.1f} %)")
    if call_dev:
        busy = sum(call_dev.values())
        top = sorted(call_dev.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{card}] rfc one call on the device (profiler): kernels busy "
              f"{busy:.3f} ms of {ms_call:.3f} ms wall, idle share "
              f"{100.0 * (1 - busy / ms_call):.1f} %; largest: " + "; ".join(
                  f"{n_[:60]} {v:.3f} ms" for n_, v in top))
    else:
        print(f"[{card}] rfc device busy and idle share: not measured (the "
              f"profiler saw no device activity)")
    record.append(_record_entry(
        "deform_sample", "propainter_rfc", "deform_sample.cu",
        "pytorchcv_tpu/kernels/deform_patch.py:81",
        launches["deform_sample"], max(errs), ms, plain, bound, lib))


def _dw_key(a):
    x, w = a[0], a[1]
    return (tuple(x.shape), w.shape[-1], a[4], a[5], a[6], str(x.dtype)[6:])


def _check_dwconv(a, out, what) -> float:
    """K6 against its plain version: f32 bit-exact for the piecewise-linear
    activations and within DW_F32_RTOL of max |plain| for sigmoid and
    swish (``expf``'s ulps); bf16 within 1 bf16 ulp (``bf16_ulp_error``).
    Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.dwconv import dwconv2d_bn_act_reference
    from pytorchcv_tpu_torch.kernels.preprocess import bf16_ulp_error
    x, w, _, _, stride, pad, act = a
    ref = dwconv2d_bn_act_reference(*a)
    err = float((out.float() - ref.float()).abs().max())
    head = (f"K6 {what} {str(x.dtype)[6:]} x {tuple(x.shape)} k "
            f"{w.shape[-1]} s {stride} pad {pad} {act}")
    if x.dtype == torch.bfloat16:
        ulp = float(bf16_ulp_error(out, ref).max())
        print(f"{head}: max {ulp} bf16 ulp (scaled), max abs err {err}")
        _require(ulp <= 1, f"{head} differs by {ulp} bf16 ulp")
    elif act in DW_EXACT_ACTS:
        print(f"{head}: {'bit-exact' if torch.equal(out, ref) else 'DIFFERS'}")
        _require(torch.equal(out, ref), f"{head} not bit-exact")
    else:
        rel = err / float(ref.abs().max())
        print(f"{head}: max abs err {err}, {rel:.3e} of max |plain|")
        _require(rel <= DW_F32_RTOL, f"{head}: {rel} of max |plain|")
    return err


def _work_dwconv(calls):
    """Bytes: x, w, scale, shift read once and the output written once.
    Operations: 2 k*k f32 a output element (the taps), 2 for the affine
    and 4 for swish (exp, add, divide, multiply)."""
    nbytes = ops = 0
    for a, k, out in calls:
        nbytes += _nbytes(*a[:4], out)
        ops += out.numel() * (2 * a[1].shape[-1] ** 2 + 2 + 4)
    return _bound(nbytes, ops, "f32")


@contextlib.contextmanager
def _module_calls(types):
    """(module, input) of every call of a module of ``types``, through a
    global forward pre-hook."""
    seen = []
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: seen.append((m, a[0])) if isinstance(m, types) else None)
    try:
        yield seen
    finally:
        handle.remove()


def _effnet(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.dwconv import (dwconv2d_bn_act,
                                                    dwconv2d_bn_act_reference,
                                                    dwconv_plan)
    from pytorchcv_tpu_torch.kernels.dwconv import \
        kernel_info as dw_kernel_info
    from pytorchcv_tpu_torch.nn import (SEBlock, fold_batchnorm,
                                        unfused_depthwise)
    from pytorchcv_tpu_torch.serve import as_bfloat16
    targets = [(pre_mod, "preprocess", "preprocess"),
               (conv_mod, "dwconv2d_bn_act", "dwconv")]

    # -- 12. K6 vs its plain version, on the calls of the slice's run (13)
    model = pt.get_model(EFF_NAME, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    serve = pt.make_serving_fn(EFF_NAME, SOURCE_HW, device="cuda",
                               model=model)
    _require(serve.route == "bf16", f"{EFF_NAME} route {serve.route}")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    reset_launch_counts()
    with _recording(targets) as calls:
        logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    # TF-SAME's asymmetric pads come from a B0b forward of its own
    tf_model = pt.get_model(EFF_TF_NAME, rng=0, device="cuda")
    _randomize_bn(tf_model, seed=1)
    tf_bf = as_bfloat16(tf_model)
    g = torch.Generator().manual_seed(5)
    with _recording(targets[1:]) as tf_calls, torch.inference_mode():
        tf_bf(torch.randn((BATCH_CHECK, 3, 224, 224), generator=g)
              .to(torch.bfloat16).cuda())
    torch.cuda.synchronize()
    del tf_bf, tf_model
    tf_asym = [c for c in tf_calls["dwconv"]
               if any(lo != hi for lo, hi in c[0][5])]
    max_err = {}
    errs = []
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, EFF_NAME)
        seen = {}
        for tag, cs in ((EFF_NAME, calls["dwconv"]), (EFF_TF_NAME, tf_asym)):
            for a, _, out in cs:
                seen.setdefault(_dw_key(a), (tag, a, out))
        for key, (tag, a, out) in sorted(seen.items()):
            errs.append(_check_dwconv(a, out, tag))
            a32 = (a[0].float(), a[1].float(), *a[2:])
            errs.append(_check_dwconv(a32, dwconv2d_bn_act(*a32), tag))
        print(f"K6: {len(seen)} distinct calls: the {len(calls['dwconv'])} "
              f"of the slice's batch-{BATCH_CHECK} run ({EFF_NAME}) and "
              f"{len(tf_asym)} with asymmetric pads ({EFF_TF_NAME}), in bf16 "
              f"as run and again in f32")
        x, w, scale, shift, _, pad, _ = calls["dwconv"][0][0]
        for act in ("none", "relu", "relu6", "hswish", "hsigmoid", "swish",
                    "sigmoid"):
            for dt in (torch.bfloat16, torch.float32):
                a = (x.to(dt), w.to(dt), scale, shift, 1, pad, act)
                errs.append(_check_dwconv(a, dwconv2d_bn_act(*a),
                                          "activation"))
        c = x.shape[1]
        w7 = (torch.randn((c, 1, 7, 7), generator=g) * 0.1).cuda()
        for stride in (1, 2):
            for dt in (torch.bfloat16, torch.float32):
                a = (x.to(dt), w7.to(dt), scale, shift, stride,
                     ((3, 3), (3, 3)), "swish")
                errs.append(_check_dwconv(a, dwconv2d_bn_act(*a), "k=7"))
        # the f32 model under bf16 autocast: K6 in its 16 depthwise blocks
        # on autocast's bf16 x and weight, against the same model unfused
        # under the same autocast
        xa = torch.randn((BATCH_CHECK, 3, 224, 224), generator=g).cuda()
        model.eval()
        with torch.autocast("cuda", torch.bfloat16):
            reset_launch_counts()
            ya = model(xa).float()
            k6_autocast = LAUNCHES["dwconv"]
            with unfused_depthwise(model):
                ya_ref = model(xa).float()
        torch.cuda.synchronize()
        cos_autocast = float((ya * ya_ref).sum() /
                             (ya.norm() * ya_ref.norm()))
        print(f"{EFF_NAME} f32 under bf16 autocast, batch {BATCH_CHECK}: K6 "
              f"launches {k6_autocast}, logits cosine {cos_autocast:.6f} "
              f"against the unfused route under the same autocast")
        _require(k6_autocast == 16, f"autocast K6 launches {k6_autocast}")
        _require(cos_autocast >= 0.999,
                 f"autocast cosine {cos_autocast} < 0.999")
        del xa, ya, ya_ref
        # each distinct call's plan, registers, spills and shared memory
        for key, (tag, a, out) in sorted(seen.items()):
            xk = a[0]
            info = dw_kernel_info(*xk.shape, a[1].shape[-1], a[4], a[5],
                                  xk.dtype)
            p_ = info["plan"]
            _print_info(card, f"{tag} K6 x {tuple(xk.shape)} k "
                        f"{a[1].shape[-1]} s {a[4]} {str(xk.dtype)[6:]}, "
                        f"plan v {p_.v}, {p_.planes} planes x {p_.rows} "
                        f"rows, {p_.threads} threads", info)
            _require(info["spill_bytes"] == 0, f"K6 spills at {key}")
    max_err["dwconv"] = max(errs)
    del calls, tf_calls, tf_asym, seen
    torch.cuda.synchronize()

    # -- 13. the slice: the run above, its launch counts and its logits
    print(f"{EFF_NAME} launches in one forward: {launches}")
    _require(launches == EFF_LAUNCHES, launches)
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000) and
             logits.dtype == torch.bfloat16, (logits.shape, logits.dtype))
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), "non-finite logits")
    reset_launch_counts()
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    _require(LAUNCHES["dwconv"] == 0, f"the f32 oracle ran K6 "
             f"{LAUNCHES['dwconv']} times")
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"{EFF_NAME} bf16 vs f32 reference (depthwise blocks unfused, no "
          f"K6): cosine {cos:.6f}, top-1 agreement {top1}")
    _require(cos >= 0.99, f"{EFF_NAME} cosine {cos} < 0.99")

    # -- 14. timing at batch 128
    raw128 = _raw_batch(BATCH_TIME, seed=3)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw128), reps=10, warmup=3)
        print(f"[{card}] serving {EFF_NAME} bf16 batch {BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{BATCH_TIME * 1000.0 / ms_serve:.1f} img/s")
        with _recording(targets) as calls128, _module_calls(
                (torch.nn.Conv2d, SEBlock, conv_mod.ConvBlock)) as mods:
            serve(raw128)
        torch.cuda.synchronize()
        dws = [(a, k) for a, k, _ in calls128["dwconv"]]
        dw_bound = _work_dwconv(calls128["dwconv"])
        (pa, pk, pout), = calls128["preprocess"]
        se = [(m, x) for m, x in mods if isinstance(m, SEBlock)]
        se_convs = {id(c_) for m, _ in se for c_ in (m.conv1, m.conv2)}
        convs = [(m, x) for m, x in mods if isinstance(m, torch.nn.Conv2d)
                 and id(m) not in se_convs]
        bns = [m.bn for m, _ in mods
               if isinstance(m, conv_mod.ConvBlock) and m.fused_dw]
        del mods

        def cudnn_dw(a, affine=True):
            x, w, scale, shift, stride, pad, act = a
            yl = F.conv2d(x, w, None, stride, (pad[0][0], pad[1][0]), 1,
                          x.shape[1])
            if affine:
                s_, b_ = (v.to(x.dtype).view(1, -1, 1, 1)
                          for v in (scale, shift))
                yl = yl * s_ + b_
                yl * torch.sigmoid(yl)

        def library_dw():
            for a, _ in dws:
                cudnn_dw(a)

        def device_ms(fn):
            kernels, _, wall, _ = _device_kernels(fn, 10)
            ms = sum(kernels.values())
            return ms if ms else wall

        ms_dw = _cuda_ms(lambda: [dwconv2d_bn_act(*a, **k) for a, k in dws],
                         20)
        # each distinct call: K6 back to back and on the device, its plan,
        # its bytes bound, cuDNN's depthwise conv alone and with the affine
        # and swish (device time of all their kernels)
        per_call = {}
        for a, k, out in calls128["dwconv"]:
            key = _dw_key(a)
            if key in per_call:
                per_call[key]["count"] += 1
                continue
            x_ = a[0]
            dev, share, _ = _launch_ms(lambda: dwconv2d_bn_act(*a, **k),
                                       "dwconv_kernel")
            per_call[key] = dict(
                a=a, count=1, share=share,
                ms=_cuda_ms(lambda: dwconv2d_bn_act(*a, **k), 20), dev=dev,
                bound=_work_dwconv([(a, k, out)])[0],
                conv=device_ms(lambda: cudnn_dw(a, affine=False)),
                full=device_ms(lambda: cudnn_dw(a)),
                plan=dwconv_plan(*x_.shape, a[1].shape[-1], a[4], a[5],
                                 x_.dtype))
        plain_dw = _cuda_ms(lambda: [dwconv2d_bn_act_reference(*a, **k)
                                     for a, k in dws], 3, warmup=1)
        lib_dw = _cuda_ms(library_dw, 20)
        ms_pre, plain_pre, lib_pre, pre_bound = _preprocess_times(
            card, EFF_NAME, pa, pk, pout)
        del pout
        ms_conv = _cuda_ms(lambda: [m(x) for m, x in convs], 10)
        ms_se = _cuda_ms(lambda: [m(x) for m, x in se], 10)
        ms_fold = _cuda_ms(lambda: [fold_batchnorm(b) for b in bns], 20)
        dev, n_ops, _, _ = _device_kernels(lambda: serve(raw128), 1)
        k6_dev, k6_share, _ = _launch_ms(lambda: serve(raw128),
                                         "dwconv_kernel", launches["dwconv"],
                                         reps=3)
        n_conv, n_se, n_fold = len(convs), len(se), len(bns)
        del dws, convs, se, bns, calls128
    print(f"[{card}] {EFF_NAME} K6 batch {BATCH_TIME} ({launches['dwconv']} "
          f"calls of one forward): kernel {ms_dw:.4f} ms "
          f"({ms_dw / launches['dwconv']:.4f} ms a call; on the device "
          f"{k6_dev:.4f} ms, the mean of the {100 * k6_share:.0f} % of "
          f"launches the profiler recorded, times {launches['dwconv']}), "
          f"plain {plain_dw:.4f} ms, library (cuDNN depthwise conv, affine, "
          f"swish in bf16) {lib_dw:.4f} ms, bound {dw_bound[0]:.4f} ms "
          f"({dw_bound[1]}), share of the batch "
          f"{100.0 * ms_dw / ms_serve:.1f} %")
    for i, e in enumerate(per_call.values()):
        a, p_ = e["a"], e["plan"]
        print(f"[{card}] {EFF_NAME} K6 call {i + 1} (x{e['count']} a "
              f"forward) x {tuple(a[0].shape)} k {a[1].shape[-1]} s {a[4]}: "
              f"{e['dev']:.4f} ms on the device (the mean of the "
              f"{100 * e['share']:.0f} % of launches the profiler recorded; "
              f"{e['ms']:.4f} back to back), bound {e['bound']:.4f} ms "
              f"({e['dev'] / e['bound']:.1f}x); cuDNN depthwise conv alone "
              f"{e['conv']:.4f} ms, with affine and swish {e['full']:.4f} "
              f"ms; plan v {p_.v}, {p_.planes} planes x {p_.rows} rows, "
              f"{p_.threads} threads")
    dev_sum = sum(e["count"] * e["dev"] for e in per_call.values())
    print(f"[{card}] {EFF_NAME} K6 per forward from the distinct calls on "
          f"the device: {dev_sum:.4f} ms; cuDNN depthwise conv alone "
          f"{sum(e['count'] * e['conv'] for e in per_call.values()):.4f} "
          f"ms, with affine and swish "
          f"{sum(e['count'] * e['full'] for e in per_call.values()):.4f} ms")
    rest = ms_serve - ms_dw - ms_pre - ms_conv - ms_se - ms_fold
    print(f"[{card}] {EFF_NAME} batch {BATCH_TIME}, replayed alone: K1 "
          f"{ms_pre:.4f} ms ({100.0 * ms_pre / ms_serve:.1f} %), cuDNN bf16 "
          f"convs ({n_conv}) {ms_conv:.4f} ms "
          f"({100.0 * ms_conv / ms_serve:.1f} %), SE blocks ({n_se}) "
          f"{ms_se:.4f} ms ({100.0 * ms_se / ms_serve:.1f} %), BN fold "
          f"({n_fold}) {ms_fold:.4f} ms ({100.0 * ms_fold / ms_serve:.2f} %"
          f"{', above 2 %' if ms_fold > 0.02 * ms_serve else ''}); the rest "
          f"(BN and swish of the other blocks, residual adds, pooling, fc, "
          f"host gaps) {rest:.4f} ms")
    if dev:
        busy = sum(dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{card}] {EFF_NAME} one batch on the device (profiler): "
              f"kernels busy {busy:.3f} ms of {ms_serve:.3f} ms, idle share "
              f"{100.0 * (1 - busy / ms_serve):.1f} %, {n_ops:.0f} device "
              f"operations ({1e3 * ms_serve / n_ops:.1f} us of the batch "
              f"each); largest: " +
              "; ".join(f"{n_[:60]} {v:.3f} ms" for n_, v in top))
    else:
        print(f"[{card}] {EFF_NAME} device busy and idle share: not measured "
              f"(the profiler saw no device activity)")
    print(f"[{card}] {EFF_NAME} K1 preprocess batch {BATCH_TIME} (one call): "
          f"kernel {ms_pre:.4f} ms, plain {plain_pre:.4f} ms, library "
          f"(einsum) {lib_pre:.4f} ms, bound {pre_bound[0]:.4f} ms "
          f"({pre_bound[1]})")
    record.append(_record_entry(
        "dwconv", EFF_NAME, "dwconv.cu", "pytorchcv_tpu/kernels/dwconv.py:124",
        launches["dwconv"], max_err["dwconv"], ms_dw, plain_dw, dw_bound,
        lib_dw))
    record.append(_record_entry(
        "preprocess", EFF_NAME, "preprocess.cu",
        "pytorchcv_tpu/kernels/preprocess.py:133", launches["preprocess"],
        max_err["preprocess"], ms_pre, plain_pre, pre_bound, lib_pre))


def _pp_clip(seed: int):
    """The generator's clip on the card: PP_FRAMES seeded uint8 frames at
    PP_HW cast to f32 and scaled to [-1, 1] (the reference's input range),
    and ``_rfc_video``'s moving ellipse masks and smooth flows, which take
    the place of completed flows."""
    flows, masks = _rfc_video(seed, PP_FRAMES, PP_HW)
    g = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (PP_FRAMES, 3, *PP_HW), generator=g,
                           dtype=torch.uint8).cuda()
    return frames.to(torch.float32) / 127.5 - 1.0, masks, flows


def _tame_propainter(model) -> None:
    """Scale two random draws down by 100, as the CPU parity test does
    (``tests/test_torch_port_propainter.py``): the last conv of each
    ``conv_offset`` (the reference zero-initializes it) and the last
    decoder conv. At the init's scale the propagation's recurrence is
    chaotic (on the CPU, f32 against f64 drifts to 6e-3 of max |out|
    within 6 local frames at 96x176) and the output tanh saturates; so
    scaled, the drift stays below 5e-7 over 11 local frames. The offsets
    still move each sample by the flow."""
    with torch.no_grad():
        for align in model.feat_prop_module.deform_align.values():
            align.conv_offset.conv4.conv.weight.mul_(0.01)
        model.decoder.unit2.conv2.conv.weight.mul_(0.01)


def _pp_chain(model, frames, masks, flows):
    """Stages 3-5 as ``ProPainterIterator`` wires them: image propagation
    (on the card) -> the generator (``model``) -> the mask blend. Returns
    the three sequencers."""
    from pytorchcv_tpu_torch.models.propainter_stream import (
        ProPainterIMSequencer, ProPainterIPSequencer, ProPainterITSequencer)
    from pytorchcv_tpu_torch.streaming import TensorSequencer
    comp = TensorSequencer(flows)
    ip = ProPainterIPSequencer(frames, masks, comp)
    it = ProPainterITSequencer(ip, masks, comp, pp_model=model)
    return ip, it, ProPainterIMSequencer(it, frames, masks)


@contextlib.contextmanager
def _calls_of(mod, attr, limit: int):
    """(args, kwargs, output) of the first ``limit`` calls of
    ``mod.attr``."""
    calls = []
    orig = getattr(mod, attr)

    def rec(*a, **k):
        out = orig(*a, **k)
        if len(calls) < limit:
            calls.append((a, k, out))
        return out
    setattr(mod, attr, rec)
    try:
        yield calls
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def _timed_modules(named):
    """CUDA events around every call of each (name, module); yields a dict
    that, after ``synchronize()``, ``_event_ms`` turns into ms by name."""
    marks = {name: [] for name, _ in named}
    hooks = []
    for name, mod in named:
        def pre(m, a, _n=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[_n].append([ev])

        def post(m, a, out, _n=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[_n][-1].append(ev)
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    try:
        yield marks
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _timed_calls(mod, attr):
    """CUDA events around every call of ``mod.attr``; yields the list of
    (start, end) event pairs."""
    pairs = []
    orig = getattr(mod, attr)

    def timed(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(*a, **k)
        end.record()
        pairs.append((start, end))
        return out
    setattr(mod, attr, timed)
    try:
        yield pairs
    finally:
        setattr(mod, attr, orig)


def _event_ms(marks, name):
    """ms of each call recorded under ``name`` by ``_timed_modules``."""
    return [a.elapsed_time(b) for a, b in marks[name]]


def _check_window_attention(q, k, v, scale, mask, out, what) -> float:
    """K7 against its plain version: within ATTN_WIN_TOL of the largest
    plain value. Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.attention import \
        fused_window_attention_reference
    if mask is not None:
        mask = mask.expand(*q.shape[:-1], k.shape[-2])
    ref = fused_window_attention_reference(q, k, v, scale, mask)
    err = float((out.float() - ref.float()).abs().max())
    rel = err / float(ref.abs().max())
    n = q.numel() // (q.shape[-2] * q.shape[-1])
    print(f"K7 {what} n {n} Lq {q.shape[-2]} Lk {k.shape[-2]} D "
          f"{q.shape[-1]}{'' if mask is None else ' masked'}: max abs err "
          f"{err:.3e}, {rel:.3e} of max |plain|")
    _require(rel <= ATTN_WIN_TOL, f"K7 {what} error {rel} of max |plain|")
    return err


def _work_window_attention(q, k, v, out):
    """Bytes: q, k, v read once and out written once. Operations: the two
    products, 2 n Lq Lk D each, in f32."""
    n = q.numel() // (q.shape[-2] * q.shape[-1])
    ops = 4 * n * q.shape[-2] * k.shape[-2] * q.shape[-1]
    return _nbytes(q, k, v, out), ops


def _k7_pair(card, tag, k7_seen):
    """K7 on a transformer block's two calls at the largest t of a path's
    recorded calls (``_first_calls``): the full path's and the local
    path's, each beside its plain version, f32 SDPA and its bounds (f32 on
    the CUDA cores; 3xTF32 on the tensor cores), with its registers, spills
    and shared memory. Returns their sums (ms, plain ms, SDPA ms, bytes,
    operations) and the pair's bound as three TF32 products on the tensor
    cores, the fastest way the card computes them in f32 (the record's)."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels.attention import (
        fused_window_attention, fused_window_attention_reference)
    from pytorchcv_tpu_torch.kernels.attention import \
        kernel_info as k7_kernel_info
    full = max((c for c in k7_seen.values() if c[0][0].dim() == 5),
               key=lambda c: (c[0][1].shape[-2], c[0][0].shape[-2]))
    local = max((c for c in k7_seen.values() if c[0][0].dim() == 6),
                key=lambda c: c[0][0].numel())
    t7 = {}
    with torch.inference_mode():
        for name, (a, _, o) in (("full", full), ("local", local)):
            q, kk, v, scale = a[:4]
            n, lq, lk, d = (q.numel() // (q.shape[-2] * q.shape[-1]),
                            q.shape[-2], kk.shape[-2], q.shape[-1])
            ms = _cuda_ms(lambda: fused_window_attention(*a), 10)
            plain = _cuda_ms(lambda: fused_window_attention_reference(*a), 5)
            q3, k3, v3 = (x.reshape(n, -1, d) for x in (q, kk, v))
            lib = _cuda_ms(lambda: F.scaled_dot_product_attention(
                q3, k3, v3, scale=scale), 10)
            lib_err = float((F.scaled_dot_product_attention(
                q3, k3, v3, scale=scale).view_as(o) - o).abs().max())
            nbytes, ops = _work_window_attention(q, kk, v, o)
            bound = _bound(nbytes, ops, "f32")
            # the same work as three TF32 products on the tensor cores
            bound_tc = _bound(nbytes, 3 * ops, "tf32")
            t7[name] = (ms, plain, lib, nbytes, ops)
            print(f"[{card}] {tag} K7 {name} path n {n} Lq {lq} Lk {lk} "
                  f"D {d}: {ms:.4f} ms a call ({ops / ms / 1e9:.2f} TFLOP/s), "
                  f"plain {plain:.4f} ms, SDPA f32 {lib:.4f} ms (max |diff| "
                  f"to K7 {lib_err:.2e}), bound {bound[0]:.4f} ms "
                  f"({bound[1]}, f32 on the CUDA cores; "
                  f"{100.0 * bound[0] / ms:.1f} % of it), 3xTF32 bound "
                  f"{bound_tc[0]:.4f} ms ({bound_tc[1]}, tensor cores at 495 "
                  f"TFLOP/s; {100.0 * bound_tc[0] / ms:.1f} % of it)")
            _print_info(card, f"{tag} K7 {name} path",
                        k7_kernel_info(d, q.dtype, lq))
    pair = [sum(t7[p][i] for p in t7) for i in range(5)]
    return pair, _bound(pair[3], 3 * pair[4], "tf32")


def _propainter(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.models.propainter as pp_mod
    import pytorchcv_tpu_torch.models.propainter_rfc as rfc_mod
    import pytorchcv_tpu_torch.nn.deform as deform_mod
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels._build import no_tf32
    from pytorchcv_tpu_torch.kernels.attention import (
        fused_window_attention, fused_window_attention_reference)
    from pytorchcv_tpu_torch.kernels.deform_patch import (
        deform_sample, deform_sample_reference)

    # -- 15. the generator slice: IP -> IT -> IM through the streaming
    # engine, with launch counts per generator call
    model = pt.get_model("propainter", rng=0, device="cuda")
    _tame_propainter(model)
    k7_per_call = 2 * len(model.transformers.transformer)
    frames, masks, flows = _pp_clip(seed=5)
    it_calls, keep = [], {}

    def pre(m, a):
        it_calls.append([a[4], a[0].shape[1], dict(LAUNCHES)])
        if not keep:
            keep["first"] = a
        if a[0].shape[1] > keep.get("t", 0):
            keep["t"], keep["largest"] = a[0].shape[1], a

    def post(m, a, out):
        it_calls[-1][2] = {k: LAUNCHES[k] - it_calls[-1][2][k]
                           for k in LAUNCHES}
        keep.setdefault("first_out", out)
    hooks = [model.register_forward_pre_hook(pre),
             model.register_forward_hook(post)]
    _, it, im = _pp_chain(model, frames, masks, flows)
    print(f"propainter IT windows (target:offset <- frames/masks/flows): "
          f"{it.window_index}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _first_calls(pp_mod, "fused_window_attention") as (k7_seen, _), \
            _calls_of(deform_mod, "deform_sample", PP_K5_CHECKED) as k5:
        reset_launch_counts()
        out = im[0:PP_FRAMES]
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    s_chain = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    print(f"propainter launches over {PP_FRAMES} frames ({len(it_calls)} "
          f"generator calls, {s_chain:.2f} s with the recording): "
          f"{launches}")
    for i, (l_t, t, d) in enumerate(it_calls):
        want = {k: 0 for k in LAUNCHES}
        want["window_attention"] = k7_per_call
        want["deform_sample"] = 2 * (l_t - 1)
        print(f"propainter IT call {i}: t {t}, l_t {l_t}, K7 "
              f"{d['window_attention']}, K5 {d['deform_sample']}")
        _require(d == want, f"IT call {i} launches {d}, want {want}")
    _require(launches == {k: sum(c[2][k] for c in it_calls)
                          for k in LAUNCHES}, launches)
    _require(tuple(out.shape) == (PP_FRAMES, 3, *PP_HW), out.shape)
    _require(bool(torch.isfinite(out).all()), "non-finite frames")
    known = (masks == 0).expand_as(frames)
    _require(torch.equal(out[known], frames[known]),
             "frames outside the masks changed")
    max_out = float(out.abs().max())
    inside = out[~known]
    print(f"propainter frames {tuple(out.shape)}: finite, equal to the input "
          f"outside the masks ({float(masks.mean()):.4f} of pixels masked), "
          f"inside: mean {float(inside.mean()):.4f}, std "
          f"{float(inside.std()):.4f}, max |out| {max_out:.4f}")

    # the same chain with K7 swapped for its plain version and K5 for
    # deform_conv2d's general route, patched here and only here
    def plain_attention(q, k, v, scale=None, mask=None):
        return fused_window_attention_reference(q, k, v, scale, mask)

    def general(*a, **k):
        k.pop("center", None)
        return deform_mod.deform_conv2d(*a, **k)
    pp_mod.fused_window_attention = plain_attention
    rfc_mod.deform_conv2d = general
    try:
        reset_launch_counts()
        out_plain = _pp_chain(model, frames, masks, flows)[2][0:PP_FRAMES]
        torch.cuda.synchronize()
        _require(not any(LAUNCHES.values()),
                 f"the plain chain launched {dict(LAUNCHES)}")
    finally:
        pp_mod.fused_window_attention = fused_window_attention
        rfc_mod.deform_conv2d = deform_mod.deform_conv2d
    delta = float((out - out_plain).abs().max())
    print(f"propainter K7 and K5 vs their plain routes over the clip: max "
          f"|delta| {delta:.3e} = {delta / max_out:.3e} of max |out| (gate "
          f"{PP_E2E_TOL})")
    _require(delta <= PP_E2E_TOL * max_out,
             f"propainter chain delta {delta} > {PP_E2E_TOL} * {max_out}")
    del out_plain
    # the clip's first generator call on the card against a CPU copy
    args_cpu = [a.cpu() if torch.is_tensor(a) else a for a in keep["first"]]
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode(), no_tf32():
        y_cpu = cpu_model(*args_cpu)
    s_cpu = time.perf_counter() - t0
    del cpu_model
    rel = float((keep["first_out"].cpu() - y_cpu).abs().max()
                / y_cpu.abs().max())
    print(f"propainter first generator call (t {args_cpu[0].shape[1]}, l_t "
          f"{args_cpu[4]}) card vs CPU: max |delta| {rel:.3e} of max |out| "
          f"{float(y_cpu.abs().max()):.4f} (gate {PP_E2E_TOL}); the CPU "
          f"took {s_cpu:.1f} s on {torch.get_num_threads()} threads")
    _require(rel <= PP_E2E_TOL, f"propainter card vs CPU: {rel} of max |out|")
    torch.cuda.synchronize()

    # -- 16. K7 and K5 against their plain versions on phase 15's calls
    errs7, errs5 = [], []
    with torch.inference_mode():
        for key, (a, k, o) in sorted(k7_seen.items()):
            errs7.append(_check_window_attention(*a[:4], None, o, "path"))
        g = torch.Generator(device="cuda").manual_seed(7)
        # B8's own test shapes, and D = 128 at the full path's lengths, each
        # with a mask of 0 and -1e9
        for qs, ks, scale in (((2, 16, 16), (2, 24, 16), 0.25),
                              ((2, 3, 45, 32), (2, 3, 90, 32), 32 ** -0.5),
                              ((4, 810, 128), (4, 2142, 128), 128 ** -0.5)):
            q = torch.randn(qs, device="cuda", generator=g)
            kk, v = (torch.randn(ks, device="cuda", generator=g)
                     for _ in range(2))
            mask = torch.where(torch.rand((*qs[:-1], ks[-2]), device="cuda",
                                          generator=g) > 0.5, 0.0, -1e9)
            errs7.append(_check_window_attention(
                q, kk, v, scale, mask,
                fused_window_attention(q, kk, v, scale, mask), "masked"))
        # more problems than a grid's y or z dimension holds
        q, kk, v = (torch.randn((ATTN_BIG_N, 45, 128), device="cuda",
                                generator=g) for _ in range(3))
        errs7.append(_check_window_attention(
            q, kk, v, 128 ** -0.5, None,
            fused_window_attention(q, kk, v), "n > 65535"))
        del q, kk, v
        for a, k, o in k5:
            errs5.append(_check_deform(a, o, "generator"))
    torch.cuda.synchronize()

    # -- 17. timing: a pass over the clip, the kernels, one call's parts
    ip, it, im = _pp_chain(model, frames, masks, flows)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with _timed_modules([("it", model), ("ip", ip.net)]) as marks:
        ev[0].record()
        im[0:PP_FRAMES]
        ev[1].record()
        torch.cuda.synchronize()
    ms_pass = ev[0].elapsed_time(ev[1])
    it_ms, ip_ms = _event_ms(marks, "it"), _event_ms(marks, "ip")
    print(f"[{card}] propainter {PP_FRAMES} frames at {PP_HW[0]}x{PP_HW[1]} "
          f"(f32, no TF32): {ms_pass:.3f} ms, "
          f"{PP_FRAMES * 1000.0 / ms_pass:.3f} frames/s; IP windows "
          f"{', '.join(f'{x:.3f}' for x in ip_ms)} ms; generator calls "
          f"{', '.join(f'{x:.3f}' for x in it_ms)} ms (sum "
          f"{sum(it_ms):.3f}, {len(it_ms) * 1000.0 / sum(it_ms):.3f} calls/s)")
    pair, pair_bound = _k7_pair(card, "propainter", k7_seen)
    with torch.inference_mode():
        # one generator call at the clip's largest t, split into its parts
        a_big = keep["largest"]
        tf = model.transformers.transformer
        parts = [("encoder", model.encoder),
                 ("propagation", model.feat_prop_module),
                 ("soft split", model.ss), ("soft composite", model.sc),
                 ("decoder", model.decoder), ("call", model)]
        parts += [(f"attention {i}", b.attention) for i, b in enumerate(tf)]
        parts += [(f"ffn {i}", b.mlp) for i, b in enumerate(tf)]
        parts += [(f"block {i}", b) for i, b in enumerate(tf)]
        enc_layers = list(model.encoder.layers)
        parts += [(f"encoder layer {i}", m_) for i, m_ in
                  enumerate(enc_layers)]
        model(*a_big)
        with _timed_modules(parts) as marks, \
                _timed_calls(deform_mod, "deform_sample") as k5_marks:
            model(*a_big)
            torch.cuda.synchronize()
        ms_call = sum(_event_ms(marks, "call"))
        part_ms = {n_: sum(_event_ms(marks, n_)) for n_, _ in parts}
        ms_k5 = sum(a_.elapsed_time(b_) for a_, b_ in k5_marks)
        n_k5 = len(k5_marks)
        att = sum(part_ms[f"attention {i}"] for i in range(len(tf)))
        ffn = sum(part_ms[f"ffn {i}"] for i in range(len(tf)))
        blocks = sum(part_ms[f"block {i}"] for i in range(len(tf)))
        dev, n_ops, ms_prof, covered = _device_kernels(
            lambda: model(*a_big), 1)
        # the encoder again with cuDNN's autotuner on (a diagnostic: the
        # port leaves cudnn.benchmark as the caller set it)
        enc_in = torch.cat([a_big[0], a_big[2], a_big[1]], dim=2).flatten(
            0, 1)
        old_bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            ms_enc_tuned = _cuda_ms(lambda: model.encoder(enc_in), 3,
                                    warmup=2)
        finally:
            torch.backends.cudnn.benchmark = old_bench
        # K5 at the generator's shape
        (a5, k5k, o5) = k5[0]
        ms5 = _cuda_ms(lambda: deform_sample(*a5, **k5k), K5_REPS)
        k5_dev5 = _k5_device_ms(lambda: deform_sample(*a5, **k5k))
        plain5 = _cuda_ms(lambda: deform_sample_reference(*a5[:4]), 20)
        lib5, lib5_err = _deform_library(a5, o5)
        bound5 = _work_deform(a5, o5)
    t_big, l_big = a_big[0].shape[1], a_big[4]
    print(f"[{card}] propainter K7 a transformer block at t {t_big} (full + "
          f"local): {pair[0]:.4f} ms, plain {pair[1]:.4f} ms, SDPA f32 "
          f"{pair[2]:.4f} ms, bound {pair_bound[0]:.4f} ms "
          f"({pair_bound[1]}); per generator call {len(tf)} x "
          f"{pair[0]:.4f} = {len(tf) * pair[0]:.3f} ms")
    rest = ms_call - sum(part_ms[n_] for n_ in (
        "encoder", "propagation", "soft split", "soft composite",
        "decoder")) - blocks
    print(f"[{card}] propainter one generator call (t {t_big}, l_t {l_big}): "
          f"{ms_call:.3f} ms; encoder {part_ms['encoder']:.3f}, feature "
          f"propagation {part_ms['propagation']:.3f} (K5 {n_k5} x "
          f"{ms_k5 / max(n_k5, 1):.4f} = {ms_k5:.3f}), soft split "
          f"{part_ms['soft split']:.3f}, {len(tf)} blocks {blocks:.3f} "
          f"(attention {att:.3f}, FFN {ffn:.3f}, norms and residuals "
          f"{blocks - att - ffn:.3f}), soft composite "
          f"{part_ms['soft composite']:.3f}, decoder "
          f"{part_ms['decoder']:.3f}, the rest (downsampling, mask pool, "
          f"copies) {rest:.3f} ms")
    print(f"[{card}] propainter encoder layers at t {t_big} (batch {t_big}, "
          f"cuDNN f32): " + ", ".join(
              f"{i} {part_ms[f'encoder layer {i}']:.3f}"
              for i in range(len(enc_layers))) + f" ms; the encoder with "
          f"cudnn.benchmark on: {ms_enc_tuned:.3f} ms")
    if dev:
        busy = sum(dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{card}] propainter one generator call on the device "
              f"(profiler): some operation running {covered:.3f} ms of the "
              f"profiled call's {ms_prof:.3f} ms, idle share "
              f"{100.0 * (1 - covered / ms_prof):.1f} %; kernel times summed "
              f"{busy:.3f} ms{' (they overlap)' if busy > covered else ''}, "
              f"{n_ops:.0f} device operations; largest: " + "; ".join(
                  f"{n_[:60]} {v:.3f} ms" for n_, v in top))
    else:
        print(f"[{card}] propainter device busy and idle share: not measured "
              f"(the profiler saw no device activity)")
    print(f"[{card}] propainter K5 at x {tuple(a5[0].shape)} G {a5[3]}: "
          f"{ms5:.4f} ms a call (CUDA events, back to back; the kernel "
          f"alone on the device: "
          f"{'not measured' if k5_dev5 is None else f'{k5_dev5:.4f} ms'}, "
          f"profiler), plain {plain5:.4f} ms, grid_sample x mask "
          f"{lib5:.4f} ms (max |diff| to K5 {lib5_err:.2e}), bound "
          f"{bound5[0]:.4f} ms ({bound5[1]})")
    _k5_info(card, "propainter", a5[0], a5[3])
    record.append(_record_entry(
        "window_attention", "propainter", "window_attention.cu",
        "pytorchcv_tpu/kernels/attention.py:91",
        launches["window_attention"], max(errs7), pair[0], pair[1],
        pair_bound, pair[2]))
    record.append(_record_entry(
        "deform_sample", "propainter", "deform_sample.cu",
        "pytorchcv_tpu/kernels/deform_patch.py:81",
        launches["deform_sample"], max(errs5), ms5, plain5, bound5, lib5))


def _pipe_clip(seed: int):
    """The pipeline's clip on the card: PIPE_FRAMES seeded uint8 frames at
    PIPE_HW scaled to [-1, 1] and ``_rfc_video``'s moving ellipse masks.
    Frame t is a seeded texture (uint8 noise at a quarter of the size,
    upsampled) seen through ``_rfc_video``'s smooth displacement field t
    (|d| <= 10 px, drifting ~1 px a frame) plus a pan of (0.75, 0.25) px a
    frame: consecutive frames move by 1-3 px, so RAFT's flows mean
    something."""
    import torch.nn.functional as F
    t, (h, w), m = PIPE_FRAMES, PIPE_HW, 80
    disp, masks = _rfc_video(seed, t + 1, PIPE_HW)
    g = torch.Generator().manual_seed(seed)
    tex = torch.randint(0, 256, (1, 3, (h + 2 * m) // 4, (w + 2 * m) // 4),
                        generator=g).to(torch.float32).cuda()
    tex = F.interpolate(tex, (h + 2 * m, w + 2 * m), mode="bilinear",
                        align_corners=False)
    ys = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    frames = []
    for i in range(t):
        px = xs + m + disp[i, 0] + 0.75 * i - 30.0
        py = ys + m + disp[i, 1] + 0.25 * i - 10.0
        grid = torch.stack([2.0 * px / (w + 2 * m - 1) - 1.0,
                            2.0 * py / (h + 2 * m - 1) - 1.0], dim=-1)
        frames.append(F.grid_sample(tex, grid[None], align_corners=True)[0])
    u8 = torch.stack(frames).round().clamp(0, 255).to(torch.uint8)
    return u8.to(torch.float32) / 127.5 - 1.0, masks[:t]


def _tame_raft(model) -> None:
    """RAFT's flow head's last conv at a hundredth of the init's scale. At
    the init's scale each of the 20 refinements adds a random delta of tens
    of px: on a 240x432 pair that moves ~2 px, the flows reach ~300 px
    (mean 55) and the recurrence amplifies rounding (the port's f32 forward
    against the same model in f64: 3e-3 of max |flow|; a CPU run). At a
    hundredth the flows stay within ~5 px and the same comparison gives
    1.2e-5."""
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.01)


def _tame_rfc(model) -> None:
    """The last conv of each RFC ``conv_offset`` at a tenth of the init's
    scale, as the CPU parity test draws it (``tests/test_torch_port_rfc.py``;
    the reference zero-initializes it): at the init's scale the offsets
    saturate at +-5 px and the recurrence is chaotic."""
    with torch.no_grad():
        for align in model.hg.skip_seq.skip4.feat_prop_module.deform_align \
                .values():
            align.conv_offset.conv4.conv.weight.mul_(0.1)


@contextlib.contextmanager
def _buffer_peaks(stages):
    """The largest length each stage's buffer reaches, read before every
    trim (the iterator trims each buffer after every chunk)."""
    peaks = dict.fromkeys(stages, 0)
    for name, seq in stages.items():
        def trim(start, _n=name, _s=seq, _trim=seq.trim_buffer_to):
            if _s.buffer is not None:
                peaks[_n] = max(peaks[_n], len(_s.buffer))
            return _trim(start)
        seq.trim_buffer_to = trim
    try:
        yield peaks
    finally:
        for seq in stages.values():
            del seq.trim_buffer_to


@contextlib.contextmanager
def _timed_stages(named):
    """CUDA events around every call of each sequencer's
    ``_calc_data_items``: a stage's own work (the engine reads its sources,
    and so runs the stages before it, first). Yields name -> [(start,
    end)]."""
    marks = {name: [] for name in named}
    for name, seq in named.items():
        def timed(chunks, _n=name, _calc=seq._calc_data_items):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = _calc(chunks)
            end.record()
            marks[_n].append((start, end))
            return out
        seq._calc_data_items = timed
    try:
        yield marks
    finally:
        for seq in named.values():
            del seq._calc_data_items


def _profiled_pass(fn):
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity): its
    ms by CUDA events, the ms in which some device operation ran (the union
    of their intervals; None where the profiler recorded none), and each
    device operation's summed ms and count, by name. It reads the raw
    trace (``kineto_results``): building the profiler's own event tree for
    a pipeline pass (~0.4 M device operations) took 72 s."""
    from torch.profiler import ProfilerActivity, profile
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
    kernels, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        name = _kernel_name(e.name())
        ms, n = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + dur / 1e6, n + 1)
    spans.sort()
    covered, reach = 0, None
    for start, end in spans:
        covered += max(0, end - (start if reach is None else max(start,
                                                                 reach)))
        reach = end if reach is None else max(reach, end)
    return (ev[0].elapsed_time(ev[1]), covered / 1e6 if spans else None,
            kernels)


def _print_device_items(card, tag, kernels, top: int = 8):
    """The largest device items of a ``_profiled_pass``, ms and count."""
    items = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print(f"[{card}] {tag} largest device items (ms, count): " + "; ".join(
        f"{n_[:70]} {v[0]:.3f} ({v[1]})" for n_, v in items))


def _pipeline(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.models.propainter as pp_mod
    import pytorchcv_tpu_torch.models.raft as raft_mod
    import pytorchcv_tpu_torch.nn.deform as deform_mod
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels._build import no_tf32
    from pytorchcv_tpu_torch.kernels.deform_patch import (
        deform_sample, deform_sample_reference)
    from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
        ProPainterRFCSequencer
    from pytorchcv_tpu_torch.models.propainter_stream import (
        ProPainterIterator, TensorSequencer)
    from pytorchcv_tpu_torch.models.raft_stream import RAFTSequencer

    # -- 26. the pipeline slice: ProPainterIterator from raw frames
    t_phase = time.perf_counter()
    raft = pt.get_model("raft_things", rng=0, device="cuda",
                        in_normalize=False, iters=PIPE_RAFT_ITERS)
    _tame_raft(raft)
    rfc = pt.get_model("propainter_rfc", rng=0, device="cuda")
    _tame_rfc(rfc)
    gen = pt.get_model("propainter", rng=0, device="cuda")
    _tame_propainter(gen)
    k7_per_call = 2 * len(gen.transformers.transformer)
    frames, masks = _pipe_clip(seed=7)
    t_clip = PIPE_FRAMES

    def iterator(host=False):
        return ProPainterIterator(TensorSequencer(frames),
                                  TensorSequencer(masks), raft, rfc, gen,
                                  host_buffers=host)
    it = iterator()
    rfc_k5 = [4 * (m.sources[0].stop - m.sources[0].start - 1)
              for m in it.comp_flow_sequencer.window_index]
    print(f"pipeline {t_clip} frames at {PIPE_HW[0]}x{PIPE_HW[1]}, chunks "
          f"of {it.step}; windows (target:offset <- sources): RAFT "
          f"{it.flow_sequencer.window_index}; RFC "
          f"{it.comp_flow_sequencer.window_index} (K5 {rfc_k5}); IP "
          f"{it.prop_framemask_sequencer.window_index}; IT "
          f"{len(it.trans_frame_sequencer.window_index)} windows")
    calls = {"raft": [], "gen": []}

    def pre(name):
        def hook(m, a):
            calls[name].append([a[4] if name == "gen" else a[0].shape[0],
                                dict(LAUNCHES)])
        return hook

    def post(name):
        def hook(m, a, out):
            c = calls[name][-1]
            c[1] = {k: LAUNCHES[k] - c[1][k] for k in LAUNCHES}
        return hook
    hooks = [mod.register_forward_pre_hook(pre(name))
             for name, mod in (("raft", raft), ("gen", gen))]
    hooks += [mod.register_forward_hook(post(name))
              for name, mod in (("raft", raft), ("gen", gen))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages = {"generated frames": it.trans_frame_sequencer,
              "propagated frames": it.prop_framemask_sequencer,
              "completed flows": it.comp_flow_sequencer,
              "flows": it.flow_sequencer, "masks": it.masks,
              "frames": it.frames}
    with _buffer_peaks(stages) as peaks, \
            _first_calls(deform_mod, "deform_sample") as (k5_seen, _), \
            _first_calls(pp_mod, "fused_window_attention") as (k7_seen, _):
        reset_launch_counts()
        chunks = list(it)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    s_iter = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    out = torch.cat(chunks)
    print(f"pipeline launches over {t_clip} frames ({len(chunks)} chunks, "
          f"{len(calls['raft'])} RAFT calls, {len(calls['gen'])} generator "
          f"calls, {s_iter:.2f} s with the recording): {launches}")
    print("pipeline largest buffer of each stage (frames): " + ", ".join(
        f"{n} {v}" for n, v in peaks.items()))
    for i, (pairs, d) in enumerate(calls["raft"]):
        _require(not any(d.values()), f"RAFT call {i} ({pairs} pairs) "
                 f"launched {d}")
    gen_k5 = 0
    for i, (l_t, d) in enumerate(calls["gen"]):
        want = dict.fromkeys(LAUNCHES, 0)
        want.update(window_attention=k7_per_call,
                    deform_sample=2 * (l_t - 1))
        _require(d == want, f"pipeline IT call {i} launches {d}, want {want}")
        gen_k5 += 2 * (l_t - 1)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(window_attention=k7_per_call * len(calls["gen"]),
                deform_sample=sum(rfc_k5) + gen_k5)
    _require(launches == want, f"pipeline launches {launches}, want {want}")
    _require(tuple(out.shape) == (t_clip, 3, *PIPE_HW), out.shape)
    _require(bool(torch.isfinite(out).all()), "non-finite frames")
    known = (masks == 0).expand_as(frames)
    _require(torch.equal(out[known], frames[known]),
             "pipeline frames outside the masks changed")
    max_out = float(out.abs().max())
    print(f"pipeline frames {tuple(out.shape)}: finite, equal to the input "
          f"outside the masks ({float(masks.mean()):.4f} of pixels masked), "
          f"max |out| {max_out:.4f}; K5 {sum(rfc_k5)} on RFC + {gen_k5} on "
          f"the generator, K7 {k7_per_call} x {len(calls['gen'])}, RAFT "
          f"none")

    # the same stages one after another, untrimmed
    flows = RAFTSequencer(frames, raft)[0:t_clip - 1]
    comp = ProPainterRFCSequencer(flows, masks, rfc)[0:t_clip - 1]
    staged = _pp_chain(gen, frames, masks, comp)[2][0:t_clip]
    torch.cuda.synchronize()
    print(f"pipeline max |flow| after RAFT {float(flows.abs().max()):.4f} "
          f"(mean {float(flows.abs().mean()):.4f}), after RFC "
          f"{float(comp.abs().max()):.4f}")
    del flows, comp
    delta = float((out - staged).abs().max())
    print(f"pipeline iterator vs the stages run one after another, "
          f"untrimmed: {'bit-equal' if torch.equal(out, staged) else 'DIFFER'}"
          f", max |delta| {delta:.3e} = {delta / max_out:.3e} of max |out| "
          f"(gate {PIPE_ITER_TOL})")
    _require(delta <= PIPE_ITER_TOL * max_out,
             f"iterator vs stages: {delta} > {PIPE_ITER_TOL} * {max_out}")
    del staged
    host = torch.cat([torch.from_numpy(c) for c in iterator(host=True)])
    hdelta = float((host - out.cpu()).abs().max())
    print(f"pipeline host_buffers=True vs device buffers: "
          f"{'bit-equal' if torch.equal(host, out.cpu()) else 'DIFFER'}, max "
          f"|delta| {hdelta:.3e} = {hdelta / max_out:.3e} of max |out| (gate "
          f"{PIPE_ITER_TOL})")
    _require(hdelta <= PIPE_ITER_TOL * max_out,
             f"host buffers: {hdelta} > {PIPE_ITER_TOL} * {max_out}")
    del host
    # RAFT on the first window's first pairs against a CPU copy
    n_cpu = PIPE_RAFT_CPU_PAIRS
    a, b = frames[:n_cpu], frames[1:n_cpu + 1]
    with torch.inference_mode():
        on_card = raft(a, b)
        cpu_raft = copy.deepcopy(raft).cpu()
        t0 = time.perf_counter()
        on_cpu = cpu_raft(a.cpu(), b.cpu())
        s_cpu = time.perf_counter() - t0
    del cpu_raft
    rel = max(float((x.cpu() - y).abs().max() / y.abs().max())
              for x, y in zip(on_card, on_cpu))
    print(f"pipeline RAFT on {n_cpu} pairs, card vs CPU: max |delta| "
          f"{rel:.3e} of max |flow| {float(on_cpu[1].abs().max()):.4f} (gate "
          f"{PIPE_RAFT_CPU_TOL}); the CPU took {s_cpu:.1f} s on "
          f"{torch.get_num_threads()} threads")
    _require(rel <= PIPE_RAFT_CPU_TOL, f"RAFT card vs CPU: {rel}")
    # the two lookups at the path's shapes: the last refinement's call of
    # one RAFT window
    win = it.flow_sequencer.window_index[0].sources[0]
    a, b = frames[win.start:win.stop - 1], frames[win.start + 1:win.stop]
    with _calls_of(raft_mod, "lookup_corr", PIPE_RAFT_ITERS) as lk, \
            torch.inference_mode():
        raft(a, b)
    (pyramid, coords, radius), _, corr = lk[-1]
    del lk
    with torch.inference_mode(), no_tf32():
        gathered = raft_mod.lookup_corr_gather(pyramid, coords, radius)
    lk_err = float((corr - gathered).abs().max())
    rel = lk_err / float(gathered.abs().max())
    print(f"pipeline lookup_corr vs lookup_corr_gather at corr "
          f"{tuple(pyramid[0].shape)}, coords {tuple(coords.shape)}, radius "
          f"{radius}: max |delta| {lk_err:.3e} = {rel:.3e} of max |corr| "
          f"(gate {PIPE_LOOKUP_TOL})")
    _require(rel <= PIPE_LOOKUP_TOL, f"lookups differ: {rel}")
    # K5 and K7 against their plain versions on the pipeline's calls
    errs5 = [_check_deform(a_, o_, "pipeline")
             for _, (a_, _k, o_) in sorted(k5_seen.items())]
    errs7 = [_check_window_attention(*a_[:4], None, o_, "pipeline")
             for _, (a_, _k, o_) in sorted(k7_seen.items())]
    torch.cuda.synchronize()
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")

    # -- 27. timing: one pass after the passes above, then its parts
    t_phase = time.perf_counter()
    it = iterator()
    named = {"RAFT": it.flow_sequencer, "RFC": it.comp_flow_sequencer,
             "IP": it.prop_framemask_sequencer,
             "IT": it.trans_frame_sequencer, "IM": it.inp_frame_sequencer}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with _timed_stages(named) as marks:
        ev[0].record()
        n_out = sum(len(c) for c in it)
        ev[1].record()
        torch.cuda.synchronize()
    _require(n_out == t_clip, n_out)
    ms_pass = ev[0].elapsed_time(ev[1])
    stage_ms = {n: sum(s_.elapsed_time(e_) for s_, e_ in marks[n])
                for n in named}
    rest = ms_pass - sum(stage_ms.values())
    pairs = t_clip - 1
    print(f"[{card}] pipeline {t_clip} frames at {PIPE_HW[0]}x{PIPE_HW[1]} "
          f"from raw frames (f32, no TF32): {ms_pass:.3f} ms, "
          f"{t_clip * 1000.0 / ms_pass:.3f} inpainted frames/s; " + ", ".join(
              f"{n} {v:.3f} ms ({100.0 * v / ms_pass:.1f} %)"
              for n, v in stage_ms.items()) + f", the engine and the rest "
          f"{rest:.3f} ms ({100.0 * rest / ms_pass:.1f} %)")
    print(f"[{card}] pipeline RAFT: {pairs} frame pairs both ways in "
          f"{stage_ms['RAFT']:.3f} ms, {pairs * 1000.0 / stage_ms['RAFT']:.3f}"
          f" pairs/s, {stage_ms['RAFT'] / (2 * pairs):.3f} ms a pair and "
          f"direction ({len(marks['RAFT'])} windows)")
    parts = [("fnet", raft.fnet), ("cnet", raft.cnet),
             ("update", raft.update_block), ("call", raft)]
    with torch.inference_mode():
        raft(a, b)
        with _timed_modules(parts) as mods, \
                _timed_calls(raft_mod, "lookup_corr") as lk_m, \
                _timed_calls(raft_mod, "build_corr_pyramid") as py_m, \
                _timed_calls(raft_mod, "upsample_flow_using_mask") as up_m:
            raft(a, b)
            torch.cuda.synchronize()
        ms_lk = _cuda_ms(lambda: raft_mod.lookup_corr(pyramid, coords,
                                                      radius), 10)
        ms_gather = _cuda_ms(lambda: raft_mod.lookup_corr_gather(
            pyramid, coords, radius), 10)
    part = {n: sum(_event_ms(mods, n)) for n, _ in parts}
    lk_ms = [s_.elapsed_time(e_) for s_, e_ in lk_m]
    py_ms = sum(s_.elapsed_time(e_) for s_, e_ in py_m)
    up_ms = sum(s_.elapsed_time(e_) for s_, e_ in up_m)
    rest = part["call"] - part["fnet"] - part["cnet"] - part["update"] - \
        py_ms - sum(lk_ms) - up_ms
    print(f"[{card}] pipeline one RAFT call ({a.shape[0]} pairs, "
          f"{PIPE_RAFT_ITERS} refinements): {part['call']:.3f} ms; fnet "
          f"(both frames) {part['fnet']:.3f}, cnet {part['cnet']:.3f}, "
          f"pyramid {py_ms:.3f}, lookups {len(lk_ms)} x "
          f"{sum(lk_ms) / max(len(lk_ms), 1):.3f} = {sum(lk_ms):.3f}, update "
          f"blocks {len(_event_ms(mods, 'update'))} x "
          f"{part['update'] / max(len(_event_ms(mods, 'update')), 1):.3f} = "
          f"{part['update']:.3f}, upsampling {up_ms:.3f}, the rest {rest:.3f}"
          f" ms")
    with torch.inference_mode():
        ms_raft, covered_raft, raft_items = _profiled_pass(lambda: raft(a, b))
    if covered_raft is not None:
        idle = 100.0 * (1 - covered_raft / ms_raft)
        print(f"[{card}] pipeline one RAFT call under the profiler: "
              f"{ms_raft:.3f} ms, some device operation running "
              f"{covered_raft:.3f} ms (idle {idle:.1f} %), "
              f"{sum(v[1] for v in raft_items.values())} device operations")
        _print_device_items(card, "pipeline one RAFT call", raft_items)
    print(f"[{card}] pipeline lookup_corr (banded one-hot products) "
          f"{ms_lk:.4f} ms a call, lookup_corr_gather (grid_sample) "
          f"{ms_gather:.4f} ms, at corr {tuple(pyramid[0].shape)}, radius "
          f"{radius}")
    del pyramid, coords, corr, gathered
    it = iterator()
    reset_launch_counts()
    t0 = time.perf_counter()
    ms_prof, covered, kernels = _profiled_pass(lambda: list(it))
    print(f"pipeline profiled pass and its reading: "
          f"{time.perf_counter() - t0:.1f} s")
    run = dict(LAUNCHES)
    k5_ms, k5_n = (sum(v[i] for k_, v in kernels.items()
                       if "deform_sample_kernel" in k_) for i in range(2))
    k7_ms, k7_n = (sum(v[i] for k_, v in kernels.items()
                       if "window_attention_kernel" in k_) for i in range(2))
    busy = sum(v[0] for v in kernels.values())
    share = (k5_n + k7_n) / max(run["deform_sample"] +
                                run["window_attention"], 1)
    if covered is None:
        print(f"[{card}] pipeline device busy and idle share: not measured "
              f"(the profiler listed no device intervals; kernel times "
              f"summed {busy:.3f} ms of {ms_prof:.3f})")
    else:
        print(f"[{card}] pipeline under the profiler: {ms_prof:.3f} ms a "
              f"pass, some device operation running {covered:.3f} ms, idle "
              f"share {100.0 * (1 - covered / ms_prof):.1f} %; kernel times "
              f"summed {busy:.3f} ms, {sum(v[1] for v in kernels.values())} "
              f"device operations; the profiler recorded {k5_n} of "
              f"{run['deform_sample']} K5 and {k7_n} of "
              f"{run['window_attention']} K7 launches "
              f"({100.0 * share:.0f} %)")
    _print_device_items(card, "pipeline pass", kernels)
    print(f"[{card}] pipeline K5 inside the pipeline: {k5_ms:.3f} ms over "
          f"{k5_n} recorded launches ({k5_ms / max(k5_n, 1):.4f} a launch); "
          f"K7 {k7_ms:.3f} ms over {k7_n} ({k7_ms / max(k7_n, 1):.4f} a "
          f"launch)")
    # the record: K5 at the path's first call (RFC's shape), K7 on a
    # block's two calls at the largest t
    a5, k5k, o5 = next(iter(k5_seen.values()))
    with torch.inference_mode():
        ms5 = _cuda_ms(lambda: deform_sample(*a5, **k5k), K5_REPS)
        plain5 = _cuda_ms(lambda: deform_sample_reference(*a5[:4]), 20)
        lib5, _ = _deform_library(a5, o5)
    print(f"[{card}] pipeline K5 at x {tuple(a5[0].shape)} G {a5[3]}: "
          f"{ms5:.4f} ms a call back to back, plain {plain5:.4f} ms, "
          f"grid_sample x mask {lib5:.4f} ms")
    pair, pair_bound = _k7_pair(card, "pipeline", k7_seen)
    record.append(_record_entry(
        "deform_sample", "propainter_iterator", "deform_sample.cu",
        "pytorchcv_tpu/kernels/deform_patch.py:81",
        launches["deform_sample"], max(errs5), ms5, plain5,
        _work_deform(a5, o5), lib5))
    record.append(_record_entry(
        "window_attention", "propainter_iterator", "window_attention.cu",
        "pytorchcv_tpu/kernels/attention.py:91",
        launches["window_attention"], max(errs7), pair[0], pair[1],
        pair_bound, pair[2]))
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")


def _mobilenet_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.mobilenet_int8 as mq
    return [(pre_mod, "preprocess", "preprocess"),
            (mq, "stem_conv", "stem"), (mq, "dwconv_i8", "dwconv_i8"),
            (mq, "int8_conv", "int8_conv")]


def _i8dw_key(a):
    return (tuple(a[0].shape), a[5], a[6])


def _check_dwconv_i8(calls, max_err, tag):
    """K12 against its plain version, bit-exact, at every distinct call."""
    from pytorchcv_tpu_torch.kernels.dwconv_i8 import dwconv_i8_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault(_i8dw_key(a), (a, k, out))
    max_err["dwconv_i8"] = 0.0
    for key, (a, k, out) in sorted(seen.items()):
        ref = dwconv_i8_reference(*a, **k)
        same = torch.equal(out, ref)
        max_err["dwconv_i8"] = max(max_err["dwconv_i8"], float(
            (out.float() - ref.float()).abs().max()))
        print(f"{tag} K12 x {key[0]} s {key[1]} {key[2]}: "
              f"{'bit-exact' if same else 'DIFFERS'}")
        _require(same, f"{tag} K12 not bit-exact at {key}")
    print(f"{tag} K12: {len(seen)} distinct calls of {len(calls)} bit-exact")


def _work_dwconv_i8(calls):
    """Bytes: x, w, A, B read once and the output written once.
    Operations: 9 multiply-adds an output element (int8)."""
    nbytes = ops = 0
    for a, k, out in calls:
        nbytes += _nbytes(*a[:4], out)
        ops += 18 * out.numel()
    return _bound(nbytes, ops, "int8")


def _mobilenet_check(name: str, gates: dict):
    """Phases 28 and 31: the int8 MobileNet route of ``make_serving_fn(
    name)`` at batch 32 on seed-0 weights, BN randomized from seed 1: K1
    within 1 bf16 ulp, K3 (ReLU6 on v2) at most 0.1 % of elements off by 1,
    every distinct K12 and K2 call bit-exact, the launch counts, finite
    logits at cosine >= 0.99 against the f32 oracle. Returns (serve,
    model, max_err, launches)."""
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    model = pt.get_model(name, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn(name, SOURCE_HW, device="cuda", model=model)
    torch.cuda.synchronize()
    route = "mobilenet_v1" if name.startswith("mobilenet_") else "mobilenetv2"
    print(f"{name} serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
    _require(serve.route == route, f"{name} route {serve.route}")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    reset_launch_counts()
    with _recording(_mobilenet_targets()) as calls:
        logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, name)
        _check_stem(calls["stem"], max_err, name)
        _check_dwconv_i8(calls["dwconv_i8"], max_err, name)
        _check_convs(calls["int8_conv"], max_err, name)
    del calls
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, **gates)
    print(f"{name} launches in one forward: {launches}")
    _require(launches == want, f"{name} launches {launches}, want {want}")
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000) and
             logits.dtype == torch.bfloat16, (logits.shape, logits.dtype))
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), f"{name} non-finite logits")
    reset_launch_counts()
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    _require(all(LAUNCHES[k] == 0 for k in gates) and
             LAUNCHES["dwconv"] == 0,
             f"the f32 oracle launched {dict(LAUNCHES)}")
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"{name} int8 vs f32 reference (no TF32, no K6): cosine "
          f"{cos:.6f}, top-1 agreement {top1}")
    _require(cos >= 0.99, f"{name} cosine {cos} < 0.99")
    return serve, model, max_err, launches


def _mobilenet_bf16_check(name: str, model):
    """Phase 29's check: the ``mode="bf16"`` route of ``name`` at batch 32
    on the same weights: the launch counts (K1 1, K6 ``MOB_BF16_K6``,
    nothing else), K1 within 1 bf16 ulp, every distinct K6 call against
    its plain version in bf16 as run and again in f32 (``_check_dwconv``),
    finite logits at cosine >= 0.99 against the f32 oracle. Returns
    (serve, K6's max abs err, its launches)."""
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.dwconv import dwconv2d_bn_act
    k6_n, act = MOB_BF16_K6[name]
    serve = pt.make_serving_fn(name, SOURCE_HW, mode="bf16", device="cuda",
                               model=model)
    _require(serve.route == "bf16", f"{name} bf16 route {serve.route}")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    targets = [_mobilenet_targets()[0],
               (conv_mod, "dwconv2d_bn_act", "dwconv")]
    reset_launch_counts()
    with _recording(targets) as calls:
        logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, dwconv=k6_n)
    print(f"{name} bf16 launches in one forward: {launches}")
    _require(launches == want, f"{name} bf16 launches {launches}")
    errs = []
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], {}, f"{name} bf16")
        seen = {}
        for a, _, out in calls["dwconv"]:
            seen.setdefault(_dw_key(a), (a, out))
        for key, (a, out) in sorted(seen.items()):
            errs.append(_check_dwconv(a, out, f"{name} bf16"))
            a32 = (a[0].float(), a[1].float(), *a[2:])
            errs.append(_check_dwconv(a32, dwconv2d_bn_act(*a32),
                                      f"{name} bf16"))
    acts = sorted({a[6] for a, _ in seen.values()})
    print(f"{name} bf16 K6: {len(seen)} distinct calls ({acts}) of "
          f"{len(calls['dwconv'])}, bf16 as run and again in f32")
    _require(acts == [act], f"{name} bf16 K6 activations {acts}")
    del calls
    y = logits.float()
    _require(bool(torch.isfinite(y).all()) and tuple(y.shape) ==
             (BATCH_CHECK, 1000), f"{name} bf16 logits")
    reset_launch_counts()
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    _require(LAUNCHES["dwconv"] == 0, "the f32 oracle ran K6")
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    print(f"{name} bf16 vs f32 reference (no K6): cosine {cos:.6f}, top-1 "
          f"agreement {float((y.argmax(1) == yf.argmax(1)).float().mean())}")
    _require(cos >= 0.99, f"{name} bf16 cosine {cos} < 0.99")
    return serve, max(errs), k6_n


def _busy(card, tag, fn, ms_batch):
    """The device's busy time and idle share over one call of ``fn`` that
    takes ``ms_batch`` ms (profiler)."""
    dev, n_ops, _, covered = _device_kernels(fn, 1)
    if not dev:
        print(f"[{card}] {tag} device busy and idle share: not measured "
              f"(the profiler saw no device activity)")
        return
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{card}] {tag} one batch on the device (profiler): busy "
          f"{covered:.3f} ms of {ms_batch:.3f} ms, idle share "
          f"{100.0 * (1 - covered / ms_batch):.1f} %, {n_ops:.0f} device "
          f"operations; largest: " +
          "; ".join(f"{_kernel_name(n_)[:50]} {v:.3f} ms" for n_, v in top))


def _cudnn_dw(a):
    """cuDNN's depthwise conv of the K6 call ``a`` in its type, then the
    affine and the call's activation: the PyTorch call sequence that
    computes K6's function (its library yardstick)."""
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels.dwconv import (ACTIVATIONS,
                                                    MODEL_ACTIVATIONS)
    x, w, scale, shift, stride, pad, act = a
    y = F.conv2d(x, w, None, stride, (pad[0][0], pad[1][0]), 1, x.shape[1])
    s_, b_ = (v.to(x.dtype).view(1, -1, 1, 1) for v in (scale, shift))
    return {**ACTIVATIONS, **MODEL_ACTIVATIONS}[act](y * s_ + b_)


def _host_us(fn, reps: int) -> float:
    """Host time of a call of ``fn`` in us: ``reps`` calls enqueued back to
    back on the host clock (few enough that the launch queue never fills
    and blocks them), then a synchronize outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def _dense_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    import pytorchcv_tpu_torch.quant.seg_backbone_int8 as sq
    return [(pre_mod, "preprocess", "preprocess"),
            (rq, "int8_conv", "int8_conv"),
            (sq, "stem_conv", "stem"),
            (sq, "maxpool_i8", "maxpool_i8"),
            (rq, "se_tail", "se_tail")]


def _dense_launches(want: dict) -> dict:
    """A dense int8 route's launches in one forward: K1, K3 and
    ``maxpool_i8`` once, ``want`` (K2, K11), no other kernel."""
    from pytorchcv_tpu_torch.kernels import LAUNCHES
    expected = {k: 0 for k in LAUNCHES}
    expected.update(preprocess=1, stem=1, maxpool_i8=1, **want)
    return expected


def _dense_model(name: str, draw: int = 0):
    """Weights from seed ``draw``, BN from seed ``draw + 1``
    (``_randomize_bn``)."""
    import pytorchcv_tpu_torch as pt
    model = pt.get_model(name, rng=draw, device="cuda")
    _randomize_bn(model, seed=draw + 1)
    return model


def _cosine(y, yf) -> float:
    y, yf = y.float(), yf.float()
    return float((y * yf).sum() / (y.norm() * yf.norm()))


def _dense_checks(calls, tag) -> dict:
    """Every kernel of a recorded dense forward against its plain version:
    K1 within 1 bf16 ulp (scaled), K3 within its tolerance, ``maxpool_i8``,
    every distinct K2 conv (the bend output included, where the route
    writes it) and every K11 call bit-exact."""
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, tag, scaled=True)
        _check_stem(calls["stem"], max_err, tag)
        _check_pool(calls["maxpool_i8"], max_err, tag)
        _check_convs(calls["int8_conv"], max_err, tag)
        if calls["se_tail"]:
            _check_se_tail(calls["se_tail"], max_err, tag)
    return max_err


_DENSE_REPLACES = {
    "preprocess": ("preprocess.cu", "pytorchcv_tpu/kernels/preprocess.py:133"),
    "maxpool_i8": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:112"),
    "int8_conv": ("int8_conv.cu", "pytorchcv_tpu/quant/resnet_int8.py:66"),
    "se_tail": ("se_tail.cu", "pytorchcv_tpu/quant/seg_backbone_int8.py:144")}


def _dense_times(card, record, name, serve, batch, hw, launches, max_err,
                 k2_cache, task=None) -> None:
    """Phase 35 for one dense route at ``batch``: images/s, the device's
    busy time and idle share, each kernel of the forward beside its plain
    version, bound and library call (K1 beside its einsum, K3 beside
    cuDNN's f32 conv, ``maxpool_i8`` beside ``F.max_pool2d`` where torch
    takes int8, K2 beside ``torch._int_mm`` on its 1x1 stride-1 convs, K11
    none), K2 at each distinct conv not measured on an earlier path, the
    bf16 head (cuDNN convs, upsampling, decode) replayed on the recorded
    features, and the decode of a pose or detection ``task`` alone on its
    recorded input."""
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.se_tail import (se_tail,
                                                     se_tail_reference)
    raw_t = _raw_batch(batch, seed=3, hw=hw)
    head_args = []
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw_t), reps=5, warmup=2)
        print(f"[{card}] serving {name} {serve.route} batch {batch}: "
              f"{ms_serve:.3f} ms/batch, {batch * 1000.0 / ms_serve:.2f} "
              f"img/s")
        _busy(card, f"{name} batch {batch}", lambda: serve(raw_t), ms_serve)
        hook = serve.head.register_forward_pre_hook(
            lambda m_, a_, k_: head_args.append((a_, k_)), with_kwargs=True)
        with _recording(_dense_targets()) as calls, \
                _decode_calls(serve.head, task) as decoded:
            serve(raw_t)
        torch.cuda.synchronize()
        hook.remove()
        t = _front_times(card, name, calls)
        convs = [(a, k) for a, k, _ in calls["int8_conv"]]
        k2_lib = _k2_per_shape(card, name, calls["int8_conv"], k2_cache)
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 3),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 1, warmup=1),
            k2_lib, _work_convs(calls["int8_conv"]))
        del convs
        se_calls = [(a, k) for a, k, _ in calls["se_tail"]]
        if se_calls:
            t["se_tail"] = (
                _cuda_ms(lambda: [se_tail(*a, **k) for a, k in se_calls],
                         10),
                _cuda_ms(lambda: [se_tail_reference(*a, **k)
                                  for a, k in se_calls], 5),
                None, _work_se_tail(calls["se_tail"]))
        del calls, se_calls
        (ha, hk), = head_args
        ms_head = _cuda_ms(lambda: serve.head(*ha, **hk), 5)
        # The features reach the head as NCHW views of the trunk's NHWC
        # output (channels-last strides); beside them, contiguous copies.
        feats = ha[0]
        dense = tuple(None if f is None else f.contiguous() for f in feats) \
            if isinstance(feats, tuple) else feats.contiguous()
        ms_head_nchw = _cuda_ms(lambda: serve.head(dense, **hk), 5)
        del feats, dense
        ms_decode = None
        if task is not None:
            (x, _), = decoded
            ms_decode = _cuda_ms(lambda: _decode(serve.head, task, x), 10)
            del x
        del head_args, ha, hk, decoded
    for kname, (ms, plain, lib, bound) in t.items():
        what = {"int8_conv": f"{launches['int8_conv']} convs of one forward; "
                             f"library: torch._int_mm, 1x1 s1 products only",
                "se_tail": f"{launches['se_tail']} SE tails of one forward"
                }.get(kname, "one call")
        print(f"[{card}] {name} {kname} batch {batch} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), share of the batch "
              f"{100.0 * ms / ms_serve:.1f} %")
        source, rep = _DENSE_REPLACES.get(kname) or (
            "stem.cu", "pytorchcv_tpu/quant/seg_backbone_int8.py:"
            + ("85" if serve.route == "seg_backbone" else "97"))
        record.append(_record_entry(kname, name, source, rep,
                                    launches[kname], max_err[kname], ms,
                                    plain, bound, lib))
    rest = ms_serve - ms_head - sum(v[0] for v in t.values())
    print(f"[{card}] {name} bf16 head (cuDNN convs, upsampling"
          f"{', decode' if task else ''}) replayed on the recorded "
          f"features, batch {batch}: {ms_head:.4f} ms, share "
          f"{100.0 * ms_head / ms_serve:.1f} %"
          + f" (on contiguous NCHW copies of the features {ms_head_nchw:.4f}"
          f" ms)"
          + ("" if ms_decode is None else
             f"; the decode alone {ms_decode:.4f} ms")
          + f"; the batch less these parts timed alone: {rest:.4f} ms")


def _decisive(yf):
    """The pixels of the f32 map ``yf`` whose top-2 class margin is
    decisive: > 2 % of the largest |logit| there (``_agreement`` of
    tests/test_quant.py)."""
    top2 = yf.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > 0.02 * yf.abs().amax(dim=1)


def _agreement(y, yf):
    """Per-pixel argmax agreement of map ``y`` with the f32 map ``yf``: over
    every pixel, and over the pixels ``_decisive`` keeps, with their
    share."""
    same = y.float().argmax(1) == yf.argmax(1)
    decisive = _decisive(yf)
    return (float(same.float().mean()),
            float(same[decisive].float().mean()),
            float(decisive.float().mean()))


def _decisive_draw(name: str, raw):
    """Phase 32's weights for ``name``: the first draw w < ``SEG_DRAWS``
    whose f32 maps, main and aux, on ``raw`` (the f32 preprocess and model
    of ``make_reference_forward``) keep at least ``SEG_DECISIVE`` of their
    pixels ``_decisive``; each draw's shares printed. Returns (w, model);
    with no such draw, a failed gate and draw 0."""
    from pytorchcv_tpu_torch.kernels._build import no_tf32
    from pytorchcv_tpu_torch.kernels.preprocess import \
        segmentation_preprocess
    for w in range(SEG_DRAWS):
        model = _dense_model(name, w)
        pre32 = segmentation_preprocess(
            tuple(model.in_size), DENSE_SEG_SOURCE_HW, layout="nchw",
            device="cuda", out_dtype=torch.float32)
        with torch.inference_mode(), no_tf32():
            shares = [float(_decisive(m).float().mean())
                      for m in model(pre32(raw))]
        print(f"{name} draw {w}: f32 decisive share main "
              f"{100 * shares[0]:.1f} %, aux {100 * shares[1]:.1f} %")
        if min(shares) >= SEG_DECISIVE:
            return w, model
        del model
    _gate(False, f"{name}: no draw of {SEG_DRAWS} keeps "
                 f"{100 * SEG_DECISIVE:.0f} % of its f32 maps decisive")
    return 0, _dense_model(name)


def _dense_seg(card, record, k2_cache) -> None:
    """Phases 32-33 and 35 for the segmentation heads: each of
    ``DENSE_SEG`` on its ``_decisive_draw`` served in mode auto from
    375x500 frames (the seg_backbone route: the int8 dilated ResNet(D)-101b
    with the bend written where the aux head reads it), every kernel against its plain version on a batch-2
    forward, the launch counts, main and aux maps finite with cosine >=
    0.99 and per-pixel argmax agreement >= 0.97 against the f32 reference
    forward (``_gate``; the agreement on the decisive pixels printed beside
    it); the same model in mode bf16 (K1 only) at cosine >= 0.99, its
    agreement printed, timed at batch 8 for the first name; the int8
    route timed at batch 8 for each."""
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    raw = _raw_batch(SEG_BATCH_CHECK, seed=2, hw=DENSE_SEG_SOURCE_HW)
    raw8 = _raw_batch(SEG_BATCH_TIME, seed=3, hw=DENSE_SEG_SOURCE_HW)
    for name in DENSE_SEG:
        t0 = time.perf_counter()
        draw, model = _decisive_draw(name, raw)
        print(f"{name}: draw {draw} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        serve = pt.make_serving_fn(name, DENSE_SEG_SOURCE_HW,
                                   task="segmentation", device="cuda",
                                   model=model)
        torch.cuda.synchronize()
        print(f"{name} serving fn built (calibrate + quantize): "
              f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
        _require(serve.route == "seg_backbone" and model.reads_bend,
                 f"{name}: route {serve.route}")
        with _recording(_dense_targets()) as calls:
            serve(raw)
        torch.cuda.synchronize()
        max_err = _dense_checks(calls, name)
        del calls
        reset_launch_counts()
        maps = serve(raw)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        print(f"{name} launches in one forward: {launches}")
        _require(launches == _dense_launches(DENSE_SEG_LAUNCHES),
                 f"{name} launches {launches}")
        ref = serve.make_reference_forward()(raw)
        torch.cuda.synchronize()
        _require(len(maps) == len(ref) == 2, f"{name}: {len(maps)} maps")
        for what, m, r in zip(("main", "aux"), maps, ref):
            _require(tuple(m.shape) == (SEG_BATCH_CHECK, model.num_classes,
                                        *model.in_size), m.shape)
            _require(bool(torch.isfinite(m.float()).all()),
                     f"{name} non-finite {what} map")
            cos = _cosine(m, r)
            every, decisive, share = _agreement(m, r)
            print(f"{name} {what} map int8 vs f32 reference: cosine "
                  f"{cos:.6f}, argmax agreement {every:.6f} on every pixel"
                  f", {decisive:.6f} on the {100 * share:.1f} % decisive "
                  f"pixels")
            _gate(cos >= 0.99, f"{name} {what} map cosine {cos} < 0.99")
            _gate(every >= 0.97,
                  f"{name} {what} map argmax agreement {every} < 0.97")
        del maps

        # -- 33. the bf16 route of the same model: a bf16 copy, K1 only
        serve_bf = pt.make_serving_fn(name, DENSE_SEG_SOURCE_HW,
                                      mode="bf16", task="segmentation",
                                      device="cuda", model=model)
        _require(serve_bf.route == "bf16", serve_bf.route)
        reset_launch_counts()
        maps = serve_bf(raw)
        torch.cuda.synchronize()
        launches_bf = dict(LAUNCHES)
        _require(launches_bf == {k: int(k == "preprocess") for k in LAUNCHES},
                 f"{name} bf16 launches {launches_bf}")
        for what, m, r in zip(("main", "aux"), maps, ref):
            cos = _cosine(m, r)
            every, decisive, share = _agreement(m, r)
            print(f"{name} bf16 {what} map vs f32 reference: cosine "
                  f"{cos:.6f}, argmax agreement {every:.6f} on every pixel,"
                  f" {decisive:.6f} on the {100 * share:.1f} % decisive "
                  f"pixels")
            _gate(cos >= 0.99, f"{name} bf16 {what} cosine {cos} < 0.99")
        del maps, ref
        if name == DENSE_SEG[0]:
            with torch.inference_mode():
                ms_bf = _cuda_ms(lambda: serve_bf(raw8), reps=5, warmup=2)
            print(f"[{card}] serving {name} bf16 batch {SEG_BATCH_TIME}: "
                  f"{ms_bf:.3f} ms/batch, "
                  f"{SEG_BATCH_TIME * 1000.0 / ms_bf:.2f} img/s")
        del serve_bf

        # -- 35. timing at batch 8
        _dense_times(card, record, name, serve, SEG_BATCH_TIME,
                     DENSE_SEG_SOURCE_HW, launches, max_err, k2_cache)
        del serve, model
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _decode_calls(head, task):
    """Record the decode's (input, output) pairs in the head's forward: the
    keypoint block's (pose) or ``centernet_heatmap_max_det``'s
    (detection)."""
    import pytorchcv_tpu_torch.models.centernet as cn
    seen = []
    if task is None:
        yield seen
        return
    if task == "pose":
        hook = head.heatmap_max_det.register_forward_hook(
            lambda m_, a_, out: seen.append((a_[0], out)))
        try:
            yield seen
        finally:
            hook.remove()
        return
    orig = cn.centernet_heatmap_max_det

    def rec(x, *a, **k):
        out = orig(x, *a, **k)
        seen.append((x, out))
        return out
    cn.centernet_heatmap_max_det = rec
    try:
        yield seen
    finally:
        cn.centernet_heatmap_max_det = orig


def _decode(head, task, x):
    """The route's decode of the pre-decode tensor ``x``, on x's device."""
    from pytorchcv_tpu_torch.models.centernet import \
        centernet_heatmap_max_det
    if task == "pose":
        return head.heatmap_max_det(x)
    return centernet_heatmap_max_det(x, head.topk)


def _dense_trunk(card, record, name, k2_cache) -> None:
    """Phases 34-35 for a pose or detection route of ``DENSE_TRUNKS``:
    ``make_serving_fn(name, frame, task=...)`` in mode auto (the
    plain_trunk route: the int8 plain ResNet trunk, AlphaPose's SE units on
    K11, then the bf16 head and decode); every kernel against its plain
    version on the check batch; the launch counts; the decoded output
    finite and equal to the decode of the same tensor on the CPU
    (keypoints; boxes in order); with ``return_heatmap`` the pre-decode
    tensor at cosine >= 0.99 against the f32 reference forward; timed at
    the route's timing batch."""
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    task, hw, b_check, b_time, want = DENSE_TRUNKS[name]
    model = _dense_model(name)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn(name, hw, task=task, device="cuda",
                               model=model)
    torch.cuda.synchronize()
    print(f"{name} serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
    _require(serve.route == "plain_trunk", f"{name}: route {serve.route}")
    raw = _raw_batch(b_check, seed=2, hw=hw)
    with _recording(_dense_targets()) as calls, \
            _decode_calls(serve.head, task) as decoded:
        out = serve(raw)
    torch.cuda.synchronize()
    max_err = _dense_checks(calls, name)
    del calls
    (x, dec), = decoded
    with torch.inference_mode():
        plain = _decode(serve.head, task, x.cpu())
    same = torch.equal(dec.cpu(), plain) and torch.equal(out, dec)
    print(f"{name} decode of {tuple(x.shape)} {x.dtype} on the card -> "
          f"{tuple(dec.shape)}: {'equal to' if same else 'DIFFERS from'} "
          f"the decode of the same tensor on the CPU")
    _require(same, f"{name} decode on the card differs from the CPU's")
    del decoded, x, dec, plain

    reset_launch_counts()
    out = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"{name} launches in one forward: {launches}")
    _require(launches == _dense_launches(want), f"{name} launches {launches}")
    shape = (b_check, model.num_classes, 3) if task == "pose" else \
        (b_check, model.topk, 6)
    _require(tuple(out.shape) == shape, out.shape)
    _require(bool(torch.isfinite(out.float()).all()), f"{name} non-finite")
    del out
    for m_ in (serve.head, model):
        m_.return_heatmap = True
    try:
        y = serve(raw)
        yf = serve.make_reference_forward()(raw)
        torch.cuda.synchronize()
    finally:
        for m_ in (serve.head, model):
            m_.return_heatmap = False
    cos = _cosine(y, yf)
    print(f"{name} pre-decode {tuple(y.shape)} int8 vs f32 reference: cosine "
          f"{cos:.6f}")
    _require(cos >= 0.99, f"{name} pre-decode cosine {cos} < 0.99")
    del y, yf
    _dense_times(card, record, name, serve, b_time, hw, launches, max_err,
                 k2_cache, task)


def _mobilenet(card, record) -> None:
    """Phases 28-31: the MobileNet family on the card."""
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.dwconv import (dwconv2d_bn_act,
                                                    dwconv2d_bn_act_reference)
    from pytorchcv_tpu_torch.kernels.dwconv_i8 import (dwconv_i8,
                                                       dwconv_i8_plan,
                                                       dwconv_i8_reference)
    from pytorchcv_tpu_torch.kernels.dwconv_i8 import \
        kernel_info as i8dw_info
    from pytorchcv_tpu_torch.kernels._parts import graph_ms
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.stem import (stem_conv,
                                                  stem_conv_reference)
    for name, gates in MOB_INT8.items():
        t_phase = time.perf_counter()
        # -- 28. kernels vs plain versions, launch counts, logits
        serve, model, max_err, launches = _mobilenet_check(name, gates)
        # -- 29. the bf16 route on the same weights (K6 checked at every
        # distinct call), then both timed at batch 128
        serve_bf, k6_err, k6_n = _mobilenet_bf16_check(name, model)
        raw128 = _raw_batch(BATCH_TIME, seed=3)
        with torch.inference_mode():
            ms_serve = _cuda_ms(lambda: serve(raw128), reps=10, warmup=3)
            ms_bf = _cuda_ms(lambda: serve_bf(raw128), reps=10, warmup=3)
            reset_launch_counts()
            with _recording([(conv_mod, "dwconv2d_bn_act", "dwconv")]) as bf:
                serve_bf(raw128)
            torch.cuda.synchronize()
            _require(LAUNCHES["dwconv"] == k6_n,
                     f"{name} bf16 K6 {LAUNCHES['dwconv']} at batch "
                     f"{BATCH_TIME}")
            dws = [(a, k) for a, k, _ in bf["dwconv"]]
            k6_t = (_cuda_ms(lambda: [dwconv2d_bn_act(*a, **k)
                                      for a, k in dws], 10),
                    _cuda_ms(lambda: [dwconv2d_bn_act_reference(*a, **k)
                                      for a, k in dws], 2, warmup=1),
                    _cuda_ms(lambda: [_cudnn_dw(a) for a, _ in dws], 10),
                    _work_dwconv(bf["dwconv"]))
            del bf, dws
            k6_fwd, k6_share, _ = _launch_ms(lambda: serve_bf(raw128),
                                             "dwconv_kernel", k6_n, reps=3)
            print(f"[{card}] serving {name} int8 batch {BATCH_TIME}: "
                  f"{ms_serve:.3f} ms/batch, "
                  f"{BATCH_TIME * 1000.0 / ms_serve:.1f} img/s; the bf16 "
                  f"route (K6 with ReLU{'6' if 'v2' in name else ''}, "
                  f"{k6_n} calls) {ms_bf:.3f} ms/batch, "
                  f"{BATCH_TIME * 1000.0 / ms_bf:.1f} img/s, K6 "
                  f"{k6_fwd:.4f} ms a forward on the device (the mean of "
                  f"the {100 * k6_share:.0f} % of launches recorded), "
                  f"{k6_t[0]:.4f} ms back to back, plain {k6_t[1]:.4f} ms, "
                  f"library (cuDNN bf16 depthwise conv, affine, "
                  f"ReLU{'6' if 'v2' in name else ''}) {k6_t[2]:.4f} ms, "
                  f"bound {k6_t[3][0]:.4f} ms ({k6_t[3][1]})")
            with _recording(_mobilenet_targets()) as calls:
                serve(raw128)
            torch.cuda.synchronize()
            (pa, pk, pout), = calls["preprocess"]
            ms_pre, plain_pre, lib_pre, pre_bound = _preprocess_times(
                card, name, pa, pk, pout)
            (sa, sk, sout), = calls["stem"]
            xs, ws = sa[0].float(), sa[1].permute(3, 0, 1, 2).float()
            stem_t = (_cuda_ms(lambda: stem_conv(*sa, **sk), 20),
                      _cuda_ms(lambda: stem_conv_reference(*sa, **sk), 5),
                      _cuda_ms(lambda: F.conv2d(xs, ws, stride=2,
                                                padding=1), 20),
                      _work_stem(sa, sk, sout))
            del xs
            _stem_info(card, name, sa)
            dws = [(a, k) for a, k, _ in calls["dwconv_i8"]]

            def k12_forward():
                for a, k in dws:
                    dwconv_i8(*a, **k)
            # K12's calls of one forward back to back on the device (a
            # CUDA graph: the wrappers' host time, above most calls'
            # device time, taken out), and through the wrappers
            k12_t = (graph_ms(k12_forward),
                     _cuda_ms(lambda: [dwconv_i8_reference(*a, **k)
                                       for a, k in dws], 2, warmup=1),
                     None, _work_dwconv_i8(calls["dwconv_i8"]))
            k12_wrapped = _cuda_ms(k12_forward, 10)
            # each distinct K12 call on the device beside its bytes bound
            # and cuDNN's bf16 depthwise conv of the same shape (a
            # yardstick: bf16 in and out, no epilogue)
            per = {}
            for a, k, out in calls["dwconv_i8"]:
                key = _i8dw_key(a)
                if key in per:
                    per[key]["count"] += 1
                    continue
                dev = graph_ms(lambda: dwconv_i8(*a, **k), 20)
                host = _host_us(lambda: dwconv_i8(*a, **k), 50)
                xb = a[0].permute(0, 3, 1, 2).to(torch.bfloat16)
                wb = a[1].permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
                c = a[0].shape[3]
                cudnn = _cuda_ms(lambda: F.conv2d(xb, wb, None, a[5], 1, 1,
                                                  c), 20)
                x_ = a[0]
                ptrs = x_.data_ptr() | a[1].data_ptr() | out.data_ptr() | 16
                per[key] = dict(count=1, dev=dev, host=host, cudnn=cudnn,
                                bound=_work_dwconv_i8([(a, k, out)]),
                                plan=dwconv_i8_plan(*x_.shape, a[5],
                                                    ptrs & -ptrs))
                del xb
            for key, e in sorted(per.items()):
                p_ = e["plan"]
                print(f"[{card}] {name} K12 x {key[0]} s {key[1]} (x"
                      f"{e['count']} a forward): {e['dev']:.4f} ms on the "
                      f"device (20 launches in a CUDA graph), its wrapper's "
                      f"host time {e['host']:.1f} us a call, bound "
                      f"{e['bound'][0]:.4f} ms ({e['bound'][1]}, "
                      f"{e['dev'] / e['bound'][0]:.1f}x); cuDNN bf16 "
                      f"depthwise conv {e['cudnn']:.4f} ms; {p_.cpt} "
                      f"channels a thread, {p_.rows} rows a thread")
            for cpt, st_ in sorted({(e["plan"].cpt, key[1])
                                    for key, e in per.items()}):
                info = i8dw_info(cpt, st_)
                print(f"[{card}] {name} K12 instance ({cpt} channels, "
                      f"stride {st_}): {info['registers']} registers a "
                      f"thread, {info['spill_bytes']} bytes spilled")
                _require(info["spill_bytes"] == 0,
                         f"K12 spills at {(cpt, st_)}")
            k12_dev = sum(e["count"] * e["dev"] for e in per.values())
            k12_host = sum(e["count"] * e["host"] for e in per.values())
            k12_cudnn = sum(e["count"] * e["cudnn"] for e in per.values())
            convs = [(a, k) for a, k, _ in calls["int8_conv"]]
            k2_lib = _k2_per_shape(card, name, calls["int8_conv"])
            k2_t = (_cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs],
                             10),
                    _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                                      for a, k in convs], 2, warmup=1),
                    k2_lib, _work_convs(calls["int8_conv"]))
            k2_host = _host_us(lambda: [int8_conv(*a, **k)
                                        for a, k in convs], 5)
            fwd_host = _host_us(lambda: serve(raw128), 3)
            del calls, dws, convs
            _busy(card, f"{name} int8", lambda: serve(raw128), ms_serve)
        print(f"[{card}] {name} int8 host time: {fwd_host / 1e3:.3f} ms to "
              f"enqueue one forward of {ms_serve:.3f} ms a batch; of it "
              f"K12's wrapper {k12_host / 1e3:.3f} ms ({launches['dwconv_i8']}"
              f" calls), K2's {k2_host / 1e3:.3f} ms "
              f"({launches['int8_conv']} calls)")
        print(f"[{card}] {name} K12 per forward: {k12_t[0]:.4f} ms back to "
              f"back on the device (a CUDA graph), {k12_wrapped:.4f} ms "
              f"through the wrappers, {k12_dev:.4f} ms from the distinct "
              f"calls ({k12_host / 1e3:.4f} ms of host time), plain "
              f"{k12_t[1]:.4f} ms, bound {k12_t[3][0]:.4f} ms "
              f"({k12_t[3][1]}), library none (PyTorch's CUDA convolutions "
              f"take no int8; cuDNN's bf16 depthwise conv on the same "
              f"shapes {k12_cudnn:.4f} ms)")
        times = {"preprocess": (ms_pre, plain_pre, lib_pre, pre_bound),
                 "stem": stem_t, "dwconv_i8": k12_t, "int8_conv": k2_t}
        for kname, (ms, plain, lib, bound) in times.items():
            print(f"[{card}] {name} {kname} batch {BATCH_TIME} "
                  f"({launches[kname]} calls a forward): kernel {ms:.4f} ms "
                  f"({100.0 * ms / ms_serve:.1f} % of the batch), plain "
                  f"{plain:.4f} ms, library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
                  f"{bound[0]:.4f} ms ({bound[1]})")
        v1 = name.startswith("mobilenet_")
        replaces = {
            "preprocess": ("preprocess.cu",
                           "pytorchcv_tpu/kernels/preprocess.py:133"),
            "stem": ("stem.cu", "pytorchcv_tpu/quant/mobilenet_int8.py:"
                     + ("211" if v1 else "117")),
            "dwconv_i8": ("dwconv_i8.cu",
                          "pytorchcv_tpu/quant/mobilenet_int8.py:61"),
            "int8_conv": ("int8_conv.cu",
                          "pytorchcv_tpu/quant/mobilenet_int8.py:72")}
        for kname, (source, rep) in replaces.items():
            ms, plain, lib, bound = times[kname]
            record.append(_record_entry(kname, name, source, rep,
                                        launches[kname], max_err[kname], ms,
                                        plain, bound, lib))
        record.append(_record_entry(
            "dwconv", f"{name} bf16", "dwconv.cu",
            "pytorchcv_tpu/kernels/dwconv.py:124", k6_n, k6_err, k6_t[0],
            k6_t[1], k6_t[3], k6_t[2]))
        del serve, serve_bf, model, raw128
        torch.cuda.empty_cache()
        print(f"phases 28-29 ({name}): "
              f"{time.perf_counter() - t_phase:.1f} s")

    # -- 30. MobileNetV3-large, bf16 (auto): K6 with ReLU and hswish_div
    t_phase = time.perf_counter()
    model = pt.get_model(MOB_V3_NAME, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    serve = pt.make_serving_fn(MOB_V3_NAME, SOURCE_HW, device="cuda",
                               model=model)
    _require(serve.route == "bf16", f"{MOB_V3_NAME} route {serve.route}")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    targets = [_mobilenet_targets()[0],
               (conv_mod, "dwconv2d_bn_act", "dwconv")]
    reset_launch_counts()
    with _recording(targets) as calls:
        logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    max_err = {}
    errs = []
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, MOB_V3_NAME)
        seen = {}
        for a, _, out in calls["dwconv"]:
            seen.setdefault(_dw_key(a), (a, out))
        for key, (a, out) in sorted(seen.items()):
            errs.append(_check_dwconv(a, out, MOB_V3_NAME))
            a32 = (a[0].float(), a[1].float(), *a[2:])
            errs.append(_check_dwconv(a32, dwconv2d_bn_act(*a32),
                                      MOB_V3_NAME))
    max_err["dwconv"] = max(errs)
    acts = sorted({a[6] for a, _ in seen.values()})
    print(f"{MOB_V3_NAME} K6: {len(seen)} distinct calls ({acts}) of "
          f"{len(calls['dwconv'])}, bf16 as run and again in f32")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, dwconv=MOB_V3_K6)
    print(f"{MOB_V3_NAME} launches in one forward: {launches}")
    _require(launches == want, f"{MOB_V3_NAME} launches {launches}")
    _require(acts == ["hswish_div", "relu"], acts)
    y = logits.float()
    _require(bool(torch.isfinite(y).all()) and tuple(y.shape) ==
             (BATCH_CHECK, 1000), f"{MOB_V3_NAME} logits")
    reset_launch_counts()
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    _require(LAUNCHES["dwconv"] == 0, "the f32 oracle ran K6")
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    print(f"{MOB_V3_NAME} bf16 vs f32 reference (no K6): cosine {cos:.6f}, "
          f"top-1 agreement "
          f"{float((y.argmax(1) == yf.argmax(1)).float().mean())}")
    _require(cos >= 0.99, f"{MOB_V3_NAME} cosine {cos} < 0.99")
    del calls
    raw128 = _raw_batch(BATCH_TIME, seed=3)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw128), reps=10, warmup=3)
        with _recording(targets) as calls:
            serve(raw128)
        torch.cuda.synchronize()
        dws = [(a, k) for a, k, _ in calls["dwconv"]]
        ms_dw = _cuda_ms(lambda: [dwconv2d_bn_act(*a, **k) for a, k in dws],
                         10)
        plain_dw = _cuda_ms(lambda: [dwconv2d_bn_act_reference(*a, **k)
                                     for a, k in dws], 2, warmup=1)
        lib_dw = _cuda_ms(lambda: [_cudnn_dw(a) for a, _ in dws], 10)
        dw_bound = _work_dwconv(calls["dwconv"])
        k6_fwd, k6_share, _ = _launch_ms(lambda: serve(raw128),
                                         "dwconv_kernel", MOB_V3_K6, reps=3)
        per = {}
        for a, k, out in calls["dwconv"]:
            key = _dw_key(a)
            if key in per:
                per[key]["count"] += 1
                continue
            dev, share, wall = _launch_ms(lambda: dwconv2d_bn_act(*a, **k),
                                          "dwconv_kernel")
            per[key] = dict(count=1, dev=dev, share=share, wall=wall,
                            bound=_work_dwconv([(a, k, out)])[0])
        (pa, pk, pout), = calls["preprocess"]
        ms_pre, plain_pre, lib_pre, pre_bound = _preprocess_times(
            card, MOB_V3_NAME, pa, pk, pout)
        del calls, dws
        _busy(card, f"{MOB_V3_NAME} bf16", lambda: serve(raw128), ms_serve)
    print(f"[{card}] serving {MOB_V3_NAME} bf16 batch {BATCH_TIME}: "
          f"{ms_serve:.3f} ms/batch, {BATCH_TIME * 1000.0 / ms_serve:.1f} "
          f"img/s; K6 ({MOB_V3_K6} calls) {ms_dw:.4f} ms a forward back to "
          f"back, {k6_fwd:.4f} ms on the device (the mean of the "
          f"{100 * k6_share:.0f} % of launches recorded), plain "
          f"{plain_dw:.4f} ms, library (cuDNN bf16 depthwise conv, affine, "
          f"ReLU or hswish) {lib_dw:.4f} ms, bound {dw_bound[0]:.4f} ms "
          f"({dw_bound[1]})")
    for key, e in sorted(per.items()):
        print(f"[{card}] {MOB_V3_NAME} K6 x {key[0]} k {key[1]} s {key[2]} "
              f"{key[4]} (x{e['count']}): {e['dev']:.4f} ms on the device "
              f"(the mean of the {100 * e['share']:.0f} % of launches "
              f"recorded; {e['wall']:.4f} back to back), bound "
              f"{e['bound']:.4f} ms ({e['dev'] / e['bound']:.1f}x)")
    record.append(_record_entry(
        "dwconv", MOB_V3_NAME, "dwconv.cu",
        "pytorchcv_tpu/kernels/dwconv.py:124", launches["dwconv"],
        max_err["dwconv"], ms_dw, plain_dw, dw_bound, lib_dw))
    record.append(_record_entry(
        "preprocess", MOB_V3_NAME, "preprocess.cu",
        "pytorchcv_tpu/kernels/preprocess.py:133", launches["preprocess"],
        max_err["preprocess"], ms_pre, plain_pre, pre_bound, lib_pre))
    del serve, model, raw128
    torch.cuda.empty_cache()
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s")

    # -- 31. the padded-channel route's gates (18-channel maps padded to 20)
    t_phase = time.perf_counter()
    _mobilenet_check(MOB_PAD_NAME, MOB_INT8["mobilenetv2_w1"])
    torch.cuda.empty_cache()
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s")


def _classic_targets(route: str):
    """The wrappers a classic int8 route calls, by kernel: K1, K3, K2, and
    the 2x2 ``maxpool_i8`` (VGG) or K13 (PreResNet)."""
    import importlib
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    mod = importlib.import_module(f"pytorchcv_tpu_torch.quant.{route}_int8")
    targets = [(pre_mod, "preprocess", "preprocess"),
               (mod, "stem_conv", "stem"), (mod, "int8_conv", "int8_conv")]
    if route == "vgg":
        targets.append((mod, "maxpool_i8", "maxpool_i8"))
    if route == "preresnet":
        targets.append((mod, "preact", "preact"))
    return targets


def _classic_model(name: str):
    """Seed-0 weights, BN from seed 1, conv biases from seed 2 (the init's
    zero biases would leave VGG's bias fold untested), SE gates tamed as in
    phase 23 (``_tame_se_gates``)."""
    import pytorchcv_tpu_torch as pt
    model = pt.get_model(name, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    _randomize_biases(model, seed=2)
    _tame_se_gates(model)
    return model


def _preact_key(a, k):
    t, ident = a[0], (a[1] if len(a) > 1 else None)
    gate = a[2] if len(a) > 2 else None
    bn = a[3] if len(a) > 3 else k.get("bn")
    return (tuple(t.shape), str(t.dtype)[6:],
            "no-id" if ident is None else str(ident.dtype)[6:],
            "gate" if gate is not None else "-",
            "pre" if bn is not None else "-")


def _check_preacts(calls, max_err, tag):
    """K13 against its plain version, bit-exact, at every distinct call."""
    from pytorchcv_tpu_torch.kernels.preact import preact_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault(_preact_key(a, k), (a, k, out))
    max_err["preact"] = 0.0
    for key, (a, k, out) in sorted(seen.items()):
        ref = preact_reference(*a, **k)
        same = True
        for o, r in zip(out, ref):
            _require((o is None) == (r is None), f"{tag} K13 outputs {key}")
            if o is not None:
                same = same and torch.equal(o, r)
                max_err["preact"] = max(max_err["preact"], float(
                    (o.float() - r.float()).abs().max()))
        print(f"{tag} K13 t {key[0]} {key[1]}, identity {key[2]}, {key[3]}, "
              f"{key[4]}: {'bit-exact' if same else 'DIFFERS'}")
        _require(same, f"{tag} K13 not bit-exact at {key}")
    print(f"{tag} K13: {len(seen)} distinct calls of {len(calls)} bit-exact")


def _work_preact(calls):
    """Bytes: t, the identity, the gate, g and b read once, r and pre
    written once; at most 6 f32 operations an element."""
    nbytes = ops = 0
    for a, k, out in calls:
        bn = a[3] if len(a) > 3 else k.get("bn")
        nbytes += _nbytes(*a[:3], *(bn or ()), *out)
        ops += 6 * a[0].numel()
    return _bound(nbytes, ops, "f32")


def _check_stem_exact(a, k, tag) -> None:
    """K3 at a recorded call's shape and mode on exact operands (a 1/4-grid
    image, kernel entries k/64: the f32 sums are exact in any order, so the
    kernel and its plain version agree bit for bit)."""
    from pytorchcv_tpu_torch.kernels.stem import stem_conv, stem_conv_reference
    g = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randint(-8, 9, a[0].shape, generator=g, device="cuda") / 4.0
         ).to(torch.bfloat16)
    kf = (torch.randint(-16, 17, a[1].shape, generator=g, device="cuda") /
          64.0).to(torch.bfloat16)
    ae = (x, kf, *a[2:])
    got, ref = stem_conv(*ae, **k), stem_conv_reference(*ae, **k)
    same = torch.equal(got, ref)
    print(f"{tag} K3 stem on exact operands {tuple(x.shape)} -> "
          f"{tuple(got.shape)} {got.dtype}: "
          f"{'bit-exact' if same else 'DIFFERS'}")
    _require(same, f"{tag} K3 not bit-exact on exact operands")


def _classic_check(name: str):
    """Phase 36 for one route: ``make_serving_fn(name)`` at batch 32 on
    ``_classic_model``'s weights: K1 within 1 bf16 ulp, K3 within its
    tolerance and bit-exact on exact operands at the path's shape, every
    distinct K2 conv, ``maxpool_i8`` and K13 call bit-exact, the launch
    counts, finite logits at cosine >= 0.99 against the f32 oracle.
    Returns (serve, model, max_err, launches)."""
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    route, gates = CLASSIC[name]
    model = _classic_model(name)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn(name, SOURCE_HW, device="cuda", model=model)
    torch.cuda.synchronize()
    print(f"{name} serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s, route {serve.route}")
    _require(serve.route == route, f"{name} route {serve.route}")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    reset_launch_counts()
    with _recording(_classic_targets(route)) as calls:
        logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, name)
        _check_stem(calls["stem"], max_err, name)
        (sa, sk, _), = calls["stem"]
        _check_stem_exact(sa, sk, name)
        _check_convs(calls["int8_conv"], max_err, name)
        if "maxpool_i8" in calls:
            _check_pool(calls["maxpool_i8"], max_err, name)
        if "preact" in calls:
            _check_preacts(calls["preact"], max_err, name)
    del calls
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, **gates)
    print(f"{name} launches in one forward: {launches}")
    _require(launches == want, f"{name} launches {launches}, want {want}")
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000) and
             logits.dtype == torch.bfloat16, (logits.shape, logits.dtype))
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), f"{name} non-finite logits")
    reset_launch_counts()
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    _require(all(v == 0 for k, v in LAUNCHES.items() if k != "preprocess"),
             f"the f32 oracle launched {dict(LAUNCHES)}")
    cos = _cosine(y, yf)
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"{name} int8 vs f32 reference (no TF32): cosine {cos:.6f}, top-1 "
          f"agreement {top1}, max |f32 logit| {float(yf.abs().max()):.4g}")
    _require(cos >= 0.99, f"{name} cosine {cos} < 0.99")
    return serve, model, max_err, launches


def _classic_times(card, record, name, serve, model, max_err, launches,
                   k2_cache) -> None:
    """Phase 37 for one route at batch 128: img/s beside the same model's
    bf16 route (K1 only, checked), the device's idle share, each kernel of
    the forward beside its plain version, bound and library call (K1
    beside its einsum, K3 beside cuDNN's f32 conv of the same image, K2
    beside ``torch._int_mm`` on its 1x1 stride-1 convs: the VGG fc layers,
    DarkNet's and the bottlenecks' 1x1 convs; ``maxpool_i8`` beside
    ``F.max_pool2d`` where torch takes int8; K13 none), K2 at each distinct
    conv not measured on an earlier path, K3's, the pool's and K13's
    resources, and PreResNet's bf16 max-pool (``F.max_pool2d``) alone."""
    import pytorchcv_tpu_torch as pt
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.preact import (kernel_info as k13_info,
                                                    preact, preact_reference)
    route = serve.route
    serve_bf = pt.make_serving_fn(name, SOURCE_HW, mode="bf16", device="cuda",
                                  model=model)
    raw128 = _raw_batch(BATCH_TIME, seed=3)
    with torch.inference_mode():
        reset_launch_counts()
        serve_bf(raw128)
        torch.cuda.synchronize()
        _require(LAUNCHES["preprocess"] == 1 and sum(LAUNCHES.values()) == 1,
                 f"{name} bf16 route launched {dict(LAUNCHES)}")
        ms_serve = _cuda_ms(lambda: serve(raw128), reps=5, warmup=2)
        ms_bf = _cuda_ms(lambda: serve_bf(raw128), reps=5, warmup=2)
        print(f"[{card}] serving {name} int8 ({route}) batch {BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, {BATCH_TIME * 1000.0 / ms_serve:.1f}"
              f" img/s; the bf16 route {ms_bf:.3f} ms/batch, "
              f"{BATCH_TIME * 1000.0 / ms_bf:.1f} img/s (int8 / bf16 "
              f"{ms_bf / ms_serve:.3f}x)")
        _busy(card, f"{name} int8", lambda: serve(raw128), ms_serve)
        del serve_bf
        with _recording(_classic_targets(route)) as calls:
            serve(raw128)
        torch.cuda.synchronize()
        t = _front_times(card, name, calls)
        if route == "preresnet":
            (_, _, out), = calls["stem"]
            ms_pool = _cuda_ms(lambda: F.max_pool2d(
                out.permute(0, 3, 1, 2), 3, 2, 1), 20)
            pooled = F.max_pool2d(out.permute(0, 3, 1, 2), 3, 2, 1)
            print(f"[{card}] {name} the stem's bf16 3x3/s2 max-pool "
                  f"(F.max_pool2d on the channels-last map) "
                  f"{tuple(out.shape)}: {ms_pool:.4f} ms, bound "
                  f"{_bound(_nbytes(out, pooled), 0, 'f32')[0]:.4f} ms "
                  f"(bytes)")
            del pooled
        convs = [(a, k) for a, k, _ in calls["int8_conv"]]
        k2_lib = _k2_per_shape(card, name, calls["int8_conv"], k2_cache)
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 3),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 1, warmup=1),
            k2_lib, _work_convs(calls["int8_conv"]))
        del convs
        if route == "preresnet":
            steps = [(a, k) for a, k, _ in calls["preact"]]
            t["preact"] = (
                _cuda_ms(lambda: [preact(*a, **k) for a, k in steps], 20),
                _cuda_ms(lambda: [preact_reference(*a, **k)
                                  for a, k in steps], 5),
                None, _work_preact(calls["preact"]))
            k13_fwd, k13_share, _ = _launch_ms(
                lambda: serve(raw128), "preact_", launches["preact"], reps=3)
            for vec in (True, False):
                info = k13_info(vec)
                kind = "8-channel" if vec else "one-element"
                print(f"[{card}] {name} K13 {kind} instance: "
                      f"{info['registers']} registers a thread, "
                      f"{info['spill_bytes']} bytes spilled")
                _require(info["spill_bytes"] == 0, "K13 spills")
            print(f"[{card}] {name} K13 in the forward on the device: "
                  f"{k13_fwd:.4f} ms (the mean of the {100 * k13_share:.0f} "
                  f"% of launches recorded, times {launches['preact']})")
            del steps
        del calls
    kernels_ms = sum(v[0] for v in t.values())
    print(f"[{card}] {name} the kernels' calls of one forward replayed back "
          f"to back: {kernels_ms:.4f} ms of the {ms_serve:.3f} ms batch; "
          f"the rest (torch ops: the head, the bf16 pool, SE squeezes; and "
          f"idle) {100.0 * max(ms_serve - kernels_ms, 0.0) / ms_serve:.1f} "
          f"% (the profiler's idle share above counts only the launches it "
          f"recorded)")
    for kname, (ms, plain, lib, bound) in t.items():
        print(f"[{card}] {name} {kname} batch {BATCH_TIME} "
              f"({launches[kname]} calls a forward): kernel {ms:.4f} ms "
              f"({100.0 * ms / ms_serve:.1f} % of the batch), plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}, {ms / bound[0]:.1f}x)")
        source, rep = _CLASSIC_REPLACES[route][kname]
        record.append(_record_entry(kname, name, source, rep,
                                    launches[kname], max_err[kname], ms,
                                    plain, bound, lib))


_CLASSIC_REPLACES = {
    route: {"preprocess": ("preprocess.cu",
                           "pytorchcv_tpu/kernels/preprocess.py:133"),
            "stem": ("stem.cu", f"pytorchcv_tpu/quant/{route}_int8.py:{s}"),
            "int8_conv": ("int8_conv.cu",
                          f"pytorchcv_tpu/quant/{route}_int8.py:{c}"),
            "maxpool_i8": ("stem.cu", "pytorchcv_tpu/quant/vgg_int8.py:120"),
            "preact": ("preact.cu",
                       "pytorchcv_tpu/quant/preresnet_int8.py:181")}
    for route, s, c in (("vgg", 137, 152), ("darknet", 92, 78),
                        ("preresnet", 123, 162))}


def _classic(card, record) -> None:
    """Phases 36-37: the VGG, DarkNet-53 and PreResNet int8 routes."""
    k2_cache = {}
    for name in CLASSIC:
        t_phase = time.perf_counter()
        serve, model, max_err, launches = _classic_check(name)
        print(f"phase 36 ({name}): {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        _classic_times(card, record, name, serve, model, max_err, launches,
                       k2_cache)
        del serve, model
        torch.cuda.empty_cache()
        print(f"phase 37 ({name}): {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script runs only on a CUDA card")
    from pytorchcv_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    torch.cuda.synchronize()
    print(f"[{card}] kernel build and load: "
          f"{time.perf_counter() - t0:.3f} s")

    record = []
    t0 = time.perf_counter()
    routes = {"resnet50": _int8_route(card, record, "resnet50")}
    print(f"resnet50 phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _danet(card, record)
    print(f"danet phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _rfc(card, record)
    print(f"rfc phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _effnet(card, record)
    print(f"{EFF_NAME} phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _propainter(card, record)
    print(f"propainter phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    routes["wrn50_2"] = _int8_route(card, record, "wrn50_2")
    _chains(routes, record)
    print(f"wrn50_2 and K8 phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _stem_int8(card, routes, record)
    _patch_probe(card, record)
    print(f"K9 and K10 phases: {time.perf_counter() - t0:.1f} s")
    for name in SE_GROUP_ROUTES:
        t0 = time.perf_counter()
        _se_group_route(card, record, name)
        print(f"{name} phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _pipeline(card, record)
    print(f"pipeline phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _mobilenet(card, record)
    print(f"mobilenet phases: {time.perf_counter() - t0:.1f} s")
    k2_cache = {}
    t0 = time.perf_counter()
    _dense_seg(card, record, k2_cache)
    print(f"segmentation head phases: {time.perf_counter() - t0:.1f} s")
    for name in DENSE_TRUNKS:
        t0 = time.perf_counter()
        _dense_trunk(card, record, name, k2_cache)
        print(f"{name} phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _classic(card, record)
    print(f"vgg, darknet and preresnet phases: "
          f"{time.perf_counter() - t0:.1f} s")

    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    if GATES_FAILED:
        raise RuntimeError(f"chip_smoke: {len(GATES_FAILED)} gate(s) "
                           f"failed: " + "; ".join(GATES_FAILED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
