#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line as it ends:

1. the card: its name and power limit as ``nvidia-smi`` gives them; and
   what the host offers the VOC input path: ``jpeglib.h``/``png.h`` and
   libjpeg/libpng on the compiler's paths, ``nvjpeg.h``/libnvjpeg in the
   CUDA toolkit, whether Pillow and PyYAML are installed (found, not
   imported) and the CPU count;
2. builds ``pixelssl_tpu_torch/csrc/blur.cu`` with ``nvcc`` for sm_90a and
   ``pixelssl_tpu_torch/csrc/augment.cpp`` (the JPEG/PNG decoders and the
   augmentation of the VOC path) with ``g++``;
3. holds the blur kernel against its plain PyTorch version in float32 at
   the three shapes of phase 5's GCT step at 321 px, the three of phase
   11's, the three of phase 19's PSPNet GCT script at 513 px, the three
   of phase 23's sreg demo at 64 px and the three of the 1-8 GCT script's
   debug visualization (phase 32: the whole batch, [4,321,321] at k=21, 41
   and 81; each derived from its script's batch and size), a non-square
   map, a
   map smaller than half the kernel (repeated reflection), the 513 px
   recipe's widest blur, a map one past the kernel's tiles, and kernels
   past 129 taps: [2,640,640] k=161, [1,1025,1025] k=257, [2,40,48] k=129
   (folded over several times), k=513 (a strip above 48 KB of shared
   memory) and k=1025 (three chunks of taps): max abs error
   <= 1e-5; times the kernel, the plain version and one cuBLAS form of the
   same product (``library_ms``, a yardstick the port never calls) with
   CUDA events around 50 calls from Python (``ms``, host overhead
   included), and the kernel and the cuBLAS form again as device time
   (``device_ms``, ``library_device_ms``): 20 calls captured in one CUDA
   graph, its replay timed between events, beside the same graph's time
   for one one-element ``torch.add`` (the launch floor);
4. one GCT step of the port at a small size (ResNet-10, 96 px, float32)
   on the card and on the CPU from the same weights and batch: the losses
   must agree (rtol 2e-3 on task/FD losses, 2e-2 on the thresholded fc/dc);
5. the GCT path: GCT on DeepLab-v2/ResNet-101, output stride 16, 321 px,
   21 classes, batch 4 labeled + 4 unlabeled, through
   ``harness.default_args`` -> ``harness.build_algorithm`` ->
   ``SSLGCT.train_step``, random weights from ``--seed``, a synthetic batch
   from numpy; every metric finite, the four task/FD losses > 0,
   ``state.step == 3``, and the blur kernel launched 6 times a step;
6. three MT steps and three SupOnly steps at the small size on the card
   and on the CPU from the same weights and batch (losses rtol 2e-3,
   cons_loss rtol 2e-2), and one MT step with input noise on the card;
7. the MT path at full width (the recipe of
   ``scripts/deeplabv2_pascalvoc_1-8_sslmt.py``, batch 4 + 4): three steps
   timed with CUDA events, every metric finite, both task losses > 0,
   ``cons_loss > 0`` on step 2, no blur launch; then one step under
   ``torch.profiler`` and its ten CUDA kernels with the most device time;
8. the SupOnly path at full width, batch 4 + 0: three steps, task loss > 0;
9. ``validate`` of MT's student and teacher on two synthetic batches of 4
   at 321 px (mIoU in [0, 1], losses finite), and a checkpoint saved into
   a temporary directory, loaded into a fresh MT (equal parameters,
   teacher included) and refused by SupOnly;
10. the script path of MT: ``run_script`` with the config of
    ``pixelssl_tpu_torch/scripts/deeplabv2_pascalvoc_1-8_sslmt.py``, its
    data keys swapped for the synthetic dataset (ResNet-101 with random
    weights, training from scratch), batch 2 + 2 at 321 px, 2 epochs of 5
    iterations from two loader workers, validation (exact, 20 samples) and
    a checkpoint after each epoch; prints each epoch's wall time per
    iteration and samples/s, each iteration's time and its wait for the
    loader, the peak memory, the student's and teacher's mIoU, the
    ``metrics.jsonl`` line count (14), 3 more ``train_step`` calls of the
    same algorithm on a batch already on the card, and 2 more after a
    validation; then
    ``run_script`` again in validation mode from ``checkpoint_2.pth``,
    whose scores must equal the training run's within atol 1e-4 (the
    largest difference printed; ``cudnn.benchmark`` may choose other
    algorithms in another build);
11. the script path of GCT: the same with
    ``deeplabv2_pascalvoc_1-8_sslgct.py``, 1 epoch of 3 iterations; every
    loss finite and the blur kernel launched 6 times an iteration;
12. three AdvSSL, S4L and CutMix steps at ResNet-10 / 64 px in float32 on
    the card and on the CPU from the same weights, batch and draws (S4L's
    angles, CutMix's box masks); the limits of phase 6, the largest
    relative difference printed;
13. AdvSSL, S4L and CutMix at full width, batch 4 + 4 (S4L doubles it to
    16), three timed steps each: AdvSSL and S4L with the flags of their
    1-8 scripts, CutMix with the PSPNet 1-8 script's and
    ``cons_threshold`` 0.05; then one more CutMix step, untimed, that
    reads the confidence at 0.05 and at the recipe's 0.97; every metric
    finite, the losses of ``NEW_ALGOS`` > 0, no
    blur launch; one AdvSSL and one S4L step under ``torch.profiler``, and
    the discriminator's kernel time at the AdvSSL step's shapes beside the
    step's;
14. ``validate`` of each of the three (scores in [0, 1]), and a
    checkpoint of each loaded into a fresh build (modules and optimizer
    states equal: D and its Adam state, the rotation head, the teacher)
    and refused by another of them;
15. the 1-8 AdvSSL and S4L scripts through ``run_script`` at full width on
    synthetic data, batch 2 + 2, 1 epoch of 3 iterations, validation and
    ``checkpoint_1.pth``; a rescore of the S4L run from it reproduces its
    val scores (atol 1e-4);
16. PSPNet at ResNet-10 / 64 px in float32: three SupOnly steps and three
    CCT steps with a decoder of every family (the 1-8 CCT script's flags)
    on the card and on the CPU from the same weights, batch and decoder
    draws; the limits of phase 6;
17. PSPNet/ResNet-101, output stride 16, 513 px, 21 classes, bf16, at the
    scripts' batches: SupOnly 4 + 0, CCT 2 + 2 with the 1-8 script's 11
    decoders, CutMix 2 + 4 with its 1-8 script's flags and
    ``cons_threshold`` 0.05; three timed steps each, the task model's
    parameter count, every metric finite, the listed losses > 0, no blur
    launch; then one more CutMix step, untimed, reading the confidence at
    0.05 and at the recipe's 0.97; one CCT step under ``torch.profiler``,
    and the 11 decoders' kernel time at that step's shapes beside the
    step's;
18. ``validate`` of CCT on two synthetic batches of 2 at 513 px, and its
    checkpoint (decoders and SGD momentum included) loaded into a fresh
    build and refused by the PSPNet SupOnly of phase 17;
19. the PSPNet 1-8 CCT and GCT scripts through ``run_script`` at 513 px on
    synthetic data, batch 2 + 2, 1 epoch of 3 iterations, validation and
    ``checkpoint_1.pth``; CCT rescored from it (atol 1e-4), GCT launching
    the blur kernel 6 times an iteration;
20. VOC-A: the DeepLab-v2 1-8 MT script through ``run_script`` at full
    width (ResNet-101 @321, base 400, batch 2 + 2, two loader workers) on
    the VOC-format fixture tree ``tests/data/voc_fixture/VOC2012`` (20
    train images, 10 of them labeled by the script's 1-8 prefix list, 4
    val images of their own sizes), on the default input path (the port's
    JPEG decoder and PIL-equal resize), 1 epoch of 5 iterations and
    validation; cuDNN autotuning off, as a user runs the script;
21. VOC-B: the same with the DeepLab-v2 1-8 GCT script and
    ``--native-augment --decoded-cache --u8-transfer``; the blur kernel
    launched 6 times an iteration; and the C++ augmentation of each
    fixture sample held against the default path on the same geometry:
    labels equal on at least 97% of the pixels (the C++ nearest index is
    float32 arithmetic, PIL's double), and where the image is enlarged
    every pixel within one grey level (PIL's antialiased filter makes
    shrunk images differ by design); then the same run at
    ``--steps-per-dispatch 4`` (one CUDA graph dispatch and a tail):
    ``state.step`` 5, the blur kernel 6 times an iteration, the first
    step's losses equal to the plain run's, and one replay from the run's
    final state against eager steps as in phase 26 (``device_prep`` of the
    uint8 batch inside the graph);
22. VOC-C: the PSPNet 1-8 CCT script @513 (base 513) on the default path.
    Each VOC phase prints the iteration times and their loader waits
    (``data_time``) beside 3 bare ``train_step`` calls on a batch of the
    run, the loader alone in the main process (samples/s of one worker at
    the crop, and the ms of decoding a sample's JPEG and PNG alone), the
    peak memory, the losses (finite) and the val scores (in [0, 1]);
23. the pixel-regression task: ``pixelssl_tpu_torch/scripts/
    sreg_synthetic_sslmt.py``'s config through ``run_script`` (``unet_lite``
    at base 32, 64 px, 64 synthetic samples, batch 1 + 1, Adam at lr 1e-3
    with the gradients clipped to norm 5, the poly schedule), MT for the
    script's 4 epochs and rescored from ``checkpoint_4.pth`` (atol 1e-4),
    SupOnly (batch 2 + 0), AdvSSL, GCT and S4L for 1 epoch each: every
    logged loss finite, MSE in [0, 1], MAE and PSNR finite, the blur kernel
    launched 6 times a GCT iteration, the ms an iteration with its loader
    wait and the peak memory printed; CCT and CutMix refused by name;
24. three MT steps at ResNet-10 / 96 px in float32 on the card and on the
    CPU from the same weights and batch, for each of ``rmsprop`` (centered,
    momentum) with ``steplr``, ``adam`` (weight decay) with
    ``multisteplr`` and ``wdadam`` with ``--amsgrad``,
    ``--clip-grad-norm 1.0`` and ``--bf16-opt-state`` with
    ``cosineannealinglr``, one iteration an epoch: losses within phase 6's
    limits, and the optimizer state of a checkpoint loaded into a fresh
    build on each side in its dtype (bf16 for the last);
25. the sseg model flags at full width (DeepLab-v2/ResNet-101 @321, MT
    4 + 4, the 1-8 recipe), three timed steps each from the same weights
    and batch with ``--remat``, ``--bf16-opt-state`` (bf16 momentum) and
    ``--freeze-bn`` (its statistics first set to the batch's, as random
    weights with the init's overflow when frozen; then no running
    statistic moves) beside the plain run, each with its step ms and peak
    memory; ``--remat`` held to the plain run in float32 with cuDNN
    deterministic: steps 0 and 1 within rtol 2e-3 and the BN running
    statistics after them within atol 1e-4 and rtol 1e-4, step 2 printed
    beside a second plain run, whose spread there is about 1%; and
    ``--pretrained-path`` with a torch ResNet-101 checkpoint written from
    ``--seed``, every backbone tensor copied;
26. ``--steps-per-dispatch`` at full width (DeepLab-v2/ResNet-101 @321):
    SupOnly 4+0, MT 4+4 (with input noise) and GCT 4+4 in float32 with
    cuDNN deterministic, 9 steps from the same weights and batches, twice
    eagerly and once through ``train_steps`` with n = 4 (two dispatches:
    an eager step, the CUDA graph's capture and 3 replays, then 4
    replays; a tail of one eager step): ``state.step`` 9, the blur kernel
    6 times a GCT step on both paths, the first losses equal, every
    step's lr equal, and after the runs every optimizer's update counts
    and group lrs equal; the later loss gaps printed; one more step from
    the graph run's state, replayed and eager twice, the replay within the
    eager steps' own spread (``SPREAD_FACTOR``, ``GAP_FLOOR``); MT's
    captured noise equal to the eager noise; the FD's and D's Adam
    captured with a device lr and replayed, equal bit for bit to the same
    Adam stepped eagerly; then all seven algorithms at their full-width
    batches in bf16, three eager steps and two dispatches, each one's ms a
    step eager and replayed and the device's busy share of both
    (``torch.profiler``);
27. ``--profile-dir`` on the 1-8 MT script at phase 10's config with
    ``--steps-per-dispatch 4`` and ``--profile-steps 2``: 2 epochs of 17
    iterations (4 dispatches and a tail), each validated and
    checkpointed; one Chrome trace of dispatches 1 and 2, its kernel count
    and the window's busy share; ``state.step`` 34; then one replay from
    the run's final state against eager steps as in phase 26;
28. ``--eager-ingest`` on the same script at 1 epoch of 5 iterations: run
    plain, with it and plain again, then at ``--steps-per-dispatch 4``
    without and with it; every batch equal bit for bit in all five, the
    first step's losses equal, the later ones printed beside the two plain
    runs' own gap; each graph run's ``state.step`` 5 and one replay from
    its final state against eager steps as in phase 26;
29. the port's bench (``python -m pixelssl_tpu_torch.bench``) at
    ``--steps 8 --calls 3 --cudnn-benchmark``: its JSON line,
    ``mfu_bf16`` in (0, 1];
30. ``tools/infer_bench.py`` and ``tools/export_serving.py`` on
    DeepLab-v2/ResNet-101 @321, batch 8: images/s, and the ``.pt2``
    round trip within atol 5e-3, rtol 2e-2;
31. ``scripts/rescore.py`` of the port on the fixture tree: a
    reference-layout checkpoint written from the port's random weights,
    rescored; its mIoU equal to the port's own validation of the same
    weights (atol 1e-4), ``pretrained/<exp_id>.pth`` written;
32. ``--visualize`` through ``run_script`` at full width: the 1-8 GCT
    script's config (2+2 @321) with ``--visual-freq 2``, eagerly (3
    iterations) and at ``--steps-per-dispatch 4`` (8 iterations, two
    dispatches), and the 1-8 AdvSSL script's eagerly: the PNG names of the
    three folders equal those the JAX package writes for the config (built
    from its naming rules), each PNG read back by the port's reader equal
    to the array written at 321 px, the blur kernel launched 6 times a
    step and 6 more a visualized GCT step, ``state.step``; a
    visualization's wall ms beside an eager step's;
33. ``--distributed`` at world size 1 over NCCL: the 1-8 GCT script's
    config (2+2 @321) eagerly (3 iterations) and at ``--steps-per-dispatch
    4`` (8; the NCCL all-reduces inside the CUDA graph), in a process under
    ``python -m torch.distributed.run --standalone --nproc-per-node 1``
    against the same without ``--distributed`` in a plain process, cuDNN
    deterministic in both: the first (eager) step's losses equal (rtol
    1e-6), the lr of every record, the blur launches and ``state.step``
    equal; each run's ms a step (eager steps and replays on a batch of the
    run), the NCCL kernels' share of the step's kernel time
    (``torch.profiler``) and the host's cost of an all-reduce;
34. two ranks sharing the card over gloo (``--nproc-per-node 2``), each on
    half of the global batch, against one process on the whole batch:
    SupOnly 4+0 and MT 4+4 at ResNet-10 @64 in float32, a validation of 4
    samples on the starting weights (scores rtol 1e-6), then two steps:
    losses rtol 1e-4 (atol 1e-5), parameters and BN statistics atol 1e-5
    with rtol 1e-4;
35. ``--spatial-train 2`` on two gloo ranks sharing the card, each with the
    rows of every image (``parallel/spatial.py``), against one process on
    the whole batch: SupOnly 4+0, MT 4+4 with input noise, GCT, AdvSSL,
    S4L and CutMix 4+4 on DeepLab-v2/ResNet-101 @321 in float32, cuDNN
    deterministic, lr 1e-5, two steps from one set of weights: losses
    within rtol 2e-3 (the thresholded ones 2e-2; the losses that read
    GCT's flaw detector or AdvSSL's D on the first step only), the
    weights after the first step within atol
    1e-3 (BN statistics 1e-2), the ranks equal, the blur kernel 6 times a
    GCT step a rank on its strips of rows; each one's step ms, peak memory
    and the row exchanges' host ms, count and MiB a step;
36. the 1-8 GCT script (2+2 @321, float32) through ``run_script`` with
    ``--distributed --spatial-train 2 --visualize`` on two gloo ranks
    against the same in one process: 3 iterations, the first visualized,
    and the validation, the first iteration's losses within rtol 2e-3
    (fc/dc 2e-2), every lr equal, the later gaps printed, rank 0's PNGs
    against one process's (names, sizes, inputs and GT equal; the model's
    maps, against those one process draws on rank 0's weights of the
    first step, at least 98% of coloured pixels the same and at most 1% of
    gray ones more than a level apart), 6 blur launches an
    iteration and 6 for the visualization on each rank, the wall s, peak
    memory and a visualization's ms of each;
37. ``--spatial-val --visualize`` on two gloo ranks: SupOnly's
    DeepLab-v2/ResNet-101 validation of two 1025 px images (padded to
    1056) in float32 against one process's bucketed validation of the same
    padded images: losses rtol 1e-5, scores atol 1e-4, rank 0's PNGs
    against one process's as in phase 36; the peak memory and ms an image
    of each. Phase 3 also holds the kernel on the strips of rows of phases
    35 and 36 ([8,181,321] k=21, [4,201,321] k=41, [4,241,321] k=81 on
    rank 0, one row fewer on rank 1; the script's at 4+2 samples, its
    visualization's at 4+4) and of phase 38 ([4,289,513] k=33,
    [2,321,513] k=65, [2,385,513] k=129 on rank 0, one row fewer on rank
    1);
38. phase 35's check of PSPNet and the sreg task under ``--spatial-train
    2``: PSPNet/ResNet-101 @513 SupOnly 4+0, GCT 2+2 (its six blurs a step
    on each rank's strips of the 513-row maps, k = 33, 65, 129) and CCT 2+2
    with the 1-8 script's 11 decoders, and the sreg demo's MT
    (``unet_lite`` base 32 @64, batch 1+1), the first step's losses held
    (F13), the weights after it, the ranks equal and the blur launches;
39. ``--spatial-val`` on two gloo ranks as in phase 37: PSPNet/ResNet-101
    SupOnly on two 513 px images (padded to 544), and the sreg demo's
    ``unet_lite`` on two 60 px images (padded to 64), whose scored valid
    pixels are 2 x 60 x 60 on each rank and in one process;
40. the bf16 policy (``models/layers.py``: BatchNorm applied as ``x *
    bf16(inv) + bf16(shift)``, a bias added after the bf16 product) on
    the card against the port on the CPU: (a) ``SyncBatchNorm`` in
    training and in eval, and its apply from the CPU's own ``inv`` and
    ``shift``, bit for bit; LeakyReLU(0.2) bit for bit; the biased sites
    (ASPP, the flaw detector's and D's 4x4 convolutions, the classifier
    convolution and the rotation head's ``fc`` with their float32 sums,
    PSPNet's shuffle convolution) and the BatchNorms: at most
    ``BF16_FLIP_SHARE`` of the outputs differ, by at most one bf16 ulp of
    the output's largest magnitude (cuDNN sums in another order than
    oneDNN); (b) the first bf16 step of MT (ResNet-10 @64) and GCT (@96)
    on the card against the CPU from the same weights and batch: the
    parameters' and BN statistics' mean |diff| after it within
    ``BF16_STEP_FACTOR`` times the CPU's own spread (its step on the batch
    with 1% of the image's elements moved by one bf16 ulp), the losses'
    mean relative gap within ``BF16_LOSS_FACTOR`` times the spread's
    largest; (c) MT and GCT 4+4 @321 at full width through the CUDA
    graph: ms a step eager and replayed, the peak memory, and BatchNorm's
    share of a replay's kernel time: every BatchNorm call of a step
    (forward, and backward where the step differentiates it) replayed
    alone under ``torch.profiler``, its kernel time and its number of
    kernels, beside the same calls through PyTorch's native
    ``batch_norm`` (cuDNN), the policy it replaced.

Phases 5, 7, 8, 10, 11, 13, 15, 17, 19, 20-23, 25, 26, 33, 35-40 print
their step times and peak memory (the harness phases also the peak over the
steps after the first, which leaves out cuDNN's autotuning of new shapes),
and the run its total wall time and each phase's. Then one JSON line with
the kernel's numbers, and as the last line ``{"ok": true, "device":
{...}}``. Any failure exits non-zero and prints no result; so does a host
without CUDA or a directory without the port. It writes nothing but the
kernel build under ``pixelssl_tpu_torch/build/``, and the checkpoints and
run directories in temporary directories that it removes, and the
augmentation library under the same directory. The processes of phases
33-39 run this script again (``--worker``), each with a time limit, killed
with every process it started past it; a failing one fails its phase. """

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
KERNEL_TOL = 1e-5
BLUR_LAUNCHES_PER_STEP = 6
STEPS = 3
ITERS_PER_EPOCH = 100

IM_SIZE = 321
GCT_BATCH = (8, 4)  # the GCT path of phase 5: batch 4 labeled + 4 unlabeled


def gct_blur_cases(batch_size, unlabeled_batch_size, im_size):
    """(N, H, W, k) of the blur calls of one GCT step, each made twice (the
    l and r models): ssl_gct.py flawmap_handler on the whole batch,
    k=odd(im/16); fdgt_generator on the labeled part, k=odd(im/8) and
    k=odd(im/4)."""
    def odd(k):
        return k + 1 if k % 2 == 0 else k
    lbs = batch_size - unlabeled_batch_size
    return [(batch_size, im_size, im_size, odd(int(im_size / 16))),
            (lbs, im_size, im_size, odd(int(im_size / 8))),
            (lbs, im_size, im_size, odd(int(im_size / 4)))]


# the GCT step's calls of phase 5; then a non-square map, a map with
# k//2 >= H, the widest blur at 513 px (k=odd(513/4)) and a map one row and
# one column past the kernel's tiles; the script-GCT path's calls (phase
# 11) come from its script's config, in phase 3
MAIN_PATH_CASES = gct_blur_cases(GCT_BATCH[0], GCT_BATCH[1], IM_SIZE)
EXTRA_CASES = [(3, 200, 321, 41), (2, 20, 24, 81), (2, 513, 513, 129),
               (1, 65, 33, 21)]
# kernels past 129 taps (GCT at im_size >= 520): the dilation blur at 640
# px, k=257 at 1025 px, a map the window folds over several times, a strip
# above 48 KB of shared memory (k=513) and three chunks of taps (k=1025)
LARGE_K_CASES = [(2, 640, 640, 161), (1, 1025, 1025, 257), (2, 40, 48, 129),
                 (1, 1025, 1025, 513), (1, 1025, 1025, 1025)]
GRAPH_CALLS = 20


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=GRAPH_CALLS, replays=10):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, its replay timed between events. The host's Python,
    ctypes and dispatch run once, at capture, and not in the timed
    replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def blur_bound_terms_ms(n, h, w, k):
    """The two terms of one call's least time: each map read and written
    once over the memory rate, and the band form's 2k multiply-adds per
    output pixel over the float32 rate."""
    t_bytes = 2 * n * h * w * 4 / H100_BYTES_PER_S * 1e3
    t_ops = 2 * n * h * w * 2 * k / H100_FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def bound(t_bytes, t_ops):
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def phase_device():
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError('nvidia-smi failed: ' + smi.stderr)
    card = smi.stdout.strip()
    say('[1/40] device: {0} x{1}; torch {2}, CUDA {3}'.format(
        torch.cuda.get_device_name(0), torch.cuda.device_count(),
        torch.__version__, torch.version.cuda))
    say('[1/40] host for the VOC input path: ' + '  '.join(
        '{0} {1}'.format(k, v) for k, v in probe_host().items()))
    say('[1/40] decoders of the VOC path: JPEG by csrc/augment.cpp '
        '(baseline Huffman, libjpeg\'s integer IDCT, upsampling and colour '
        'conversion), PNG labels by zlib; built with g++ -lz')
    return card


def probe_host():
    """What the host offers a JPEG/PNG decoder: headers on g++'s include
    path, libraries on the linker's cache, nvJPEG in the CUDA toolkit,
    Pillow and PyYAML (found, not imported), the CPU count."""
    import glob
    import importlib.util
    import shutil

    def header(name):
        if shutil.which('g++') is None:
            return 'no g++'
        proc = subprocess.run(['g++', '-E', '-x', 'c++', '-'],
                              input='#include <{0}>\n'.format(name),
                              capture_output=True, text=True, timeout=60)
        return 'found' if proc.returncode == 0 else 'missing'

    ldconfig = subprocess.run(['ldconfig', '-p'], capture_output=True,
                              text=True, timeout=60).stdout
    cuda = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    return dict([
        ('jpeglib.h', header('jpeglib.h')), ('png.h', header('png.h')),
        ('zlib.h', header('zlib.h')),
        ('libjpeg', 'found' if 'libjpeg.so' in ldconfig else 'missing'),
        ('libpng', 'found' if 'libpng' in ldconfig else 'missing'),
        ('nvjpeg.h', 'found' if os.path.exists(os.path.join(
            cuda, 'include', 'nvjpeg.h')) else 'missing'),
        ('libnvjpeg', 'found' if glob.glob(os.path.join(
            cuda, 'lib64', 'libnvjpeg.so*')) else 'missing'),
        ('PIL', 'installed' if importlib.util.find_spec('PIL') else
         'missing'),
        ('yaml', 'installed' if importlib.util.find_spec('yaml') else
         'missing'),
        ('cpu_count', os.cpu_count()),
    ])



def phase_build():
    from pixelssl_tpu_torch.nn import native
    from pixelssl_tpu_torch.ops import blur
    t0 = time.perf_counter()
    blur.build()
    say('[2/40] built csrc/blur.cu for sm_90a in {0:.1f} s'.format(
        time.perf_counter() - t0))
    t0 = time.perf_counter()
    native.lib()
    say('[2/40] built csrc/augment.cpp with g++ in {0:.1f} s'.format(
        time.perf_counter() - t0))


def phase_kernel(seed, script_cases):
    """The kernel against its plain version, and both timed, at the calls
    of phase 5's GCT step (``gct``), of the script-GCT paths
    (``script_cases``: {path: calls}, ``script_gct`` at 321 px and
    ``pspnet_gct`` at 513) and at ``EXTRA_CASES``."""
    import numpy as np
    import torch
    from pixelssl_tpu_torch.ops import blur

    one = torch.ones(1, device='cuda')
    floor_ms = graph_ms(lambda: torch.add(one, one))
    say('[3/40] launch floor: {0:.5f} ms a call (one one-element torch.add, '
        '{1} calls in one CUDA graph)'.format(floor_ms, GRAPH_CALLS))
    rng = np.random.default_rng(seed)
    rows = []
    cases = ([('gct', c) for c in MAIN_PATH_CASES] +
             [(path, c) for path, calls in script_cases.items()
              for c in calls] +
             [('extra', c) for c in EXTRA_CASES] +
             [('large_k', c) for c in LARGE_K_CASES])
    for path, (n, h, w, k) in cases:
        x = torch.from_numpy(rng.standard_normal((n, h, w)).astype(
            np.float32)).cuda()
        out = blur.blur_kernel(x, k)
        ref = blur.blur_plain(x, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bh = torch.from_numpy(blur._blur_matrix(h, k)).cuda()
        bw = torch.from_numpy(blur._blur_matrix(w, k)).cuda()
        row = {
            'path': path, 'shape': [n, h, w], 'k': k, 'max_abs_err': err,
            'ms': time_ms(lambda: blur.blur_kernel(x, k)),
            'plain_ms': time_ms(lambda: blur.blur_plain(x, k)),
            'library_ms': time_ms(
                lambda: torch.matmul(torch.matmul(bh, x), bw.t())),
            'device_ms': graph_ms(lambda: blur.blur_kernel(x, k)),
            'library_device_ms': graph_ms(
                lambda: torch.matmul(torch.matmul(bh, x), bw.t())),
        }
        row['bound_ms'], row['bound_by'] = bound(
            *blur_bound_terms_ms(n, h, w, k))
        say('[3/40] blur {12} [{0},{1},{2}] k={3}: max_abs_err {4:.3g}  '
            'kernel_ms {5:.4f}  plain_ms {6:.4f}  library_ms {7:.4f}  '
            'device_ms {8:.5f}  library_device_ms {9:.5f}  '
            'bound_ms {10:.5f} ({11})'.format(
                n, h, w, k, err, row['ms'], row['plain_ms'],
                row['library_ms'], row['device_ms'],
                row['library_device_ms'], row['bound_ms'], row['bound_by'],
                path))
        if not err <= KERNEL_TOL:
            raise AssertionError('blur kernel disagrees with its plain '
                                 'version at {0}: {1} > {2}'.format(
                                     (n, h, w, k), err, KERNEL_TOL))
        rows.append(row)
    return rows, floor_ms


GCT_CONFIG = dict(
    ssl_mode='gct', fc_ssl_scale=1.0, dc_ssl_scale=100.0, dc_threshold=0.6,
    dc_rampup_epochs=3, fd_lr=1e-4, fd_scale=10.0, mu=0.5, nu=1,
    lr=2.5e-4, momentum=0.9, weight_decay=5e-4, ignore_unlabeled=False)


def phase_small_reference(seed):
    """One float32 GCT step at ResNet-10 / 96 px on the card and on the
    CPU from the same weights and batch."""
    from pixelssl_tpu_torch import harness

    args = harness.default_args(
        'ssl_gct', backbone='resnet10', im_size=96, num_classes=5,
        batch_size=4, unlabeled_batch_size=2, epochs=2, bf16=False,
        seed=seed, **dict(GCT_CONFIG, dc_rampup_epochs=1))
    rows = {}
    for device in ('cpu', 'cuda'):
        algo = harness.build_algorithm(args, device=device)
        batch = harness.synthetic_batch(args, device=device, seed=seed)
        metrics = algo.train_step(batch)
        rows[device] = {k: float(v) for k, v in metrics.items()}
    for key, ref in rows['cpu'].items():
        got = rows['cuda'][key]
        tol = 2e-2 if ('_fc_' in key or '_dc_' in key) else 2e-3
        if not math.isclose(got, ref, rel_tol=tol, abs_tol=1e-6):
            raise AssertionError('small GCT step: {0} on the card {1} vs '
                                 'CPU {2}'.format(key, got, ref))
    say('[4/40] small GCT step (ResNet-10, 96 px) card vs CPU agree: ' +
        '  '.join('{0} {1:.5f}/{2:.5f}'.format(k, rows['cuda'][k],
                                                rows['cpu'][k])
                  for k in sorted(rows['cpu'])))


def timed_steps(algo, batch, steps, tag, what, positive):
    """``steps`` train steps, each between CUDA events, with the blur
    launches counted from 0 and the peak memory from a reset; every metric
    must be finite and the ``positive`` ones > 0. Prints the step times and
    the peak memory on one line; returns the metrics of each step, the step
    times and the blur launches."""
    import torch
    from pixelssl_tpu_torch.ops import blur

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blur.launches = 0
    history, step_ms = [], []
    peak_first = 0
    for s in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = algo.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        values = {k: float(v) for k, v in metrics.items()}
        history.append(values)
        say('{0} step {1}: {2:.1f} ms  {3}'.format(
            tag, s, step_ms[-1], '  '.join(
                '{0} {1:.6g}'.format(k, v) for k, v in sorted(values.items()))))
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError('non-finite metrics at step {0}: {1}'
                                 .format(s, bad))
        for k in positive:
            if not values[k] > 0:
                raise AssertionError('{0} = {1} at step {2}'.format(
                    k, values[k], s))
        if s == 0:  # step 0's peak holds cuDNN's autotuning of new shapes
            peak_first = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    launches = blur.launches
    later_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_gib = max(peak_first / 2 ** 30, later_gib)
    if algo.state.step != steps:
        raise AssertionError('state.step {0} != {1}'.format(
            algo.state.step, steps))
    say('{0} {1} {2} steps, state.step {3}, blur launches {4}, step ms {5}, '
        'peak memory {6:.2f} GiB ({7:.2f} GiB over the steps after the '
        'first)'.format(
            tag, what, steps, algo.state.step, launches,
            ' '.join('{0:.1f}'.format(t) for t in step_ms), peak_gib,
            later_gib))
    return history, step_ms, launches


MODEL_NAMES = {'deeplabv2': 'DeepLab-v2', 'pspnet': 'PSPNet'}
MODEL_IM_SIZE = {'deeplabv2': IM_SIZE, 'pspnet': 513}


def full_width_args(algo_name, seed, model='deeplabv2', **config):
    """DeepLab-v2 (321 px) or PSPNet (513 px) on ResNet-101, output stride
    16, 21 classes, bf16 autocast, 20 epochs of the poly schedule."""
    from pixelssl_tpu_torch import harness
    flags = dict(models={'model': model}, backbone='resnet101',
                 output_stride=16, im_size=MODEL_IM_SIZE[model],
                 num_classes=21, epochs=20, bf16=True, seed=seed)
    flags.update(config)
    return harness.default_args(algo_name, **flags)


def build_full_width(args, tag, what):
    import torch
    from pixelssl_tpu_torch import harness

    t0 = time.perf_counter()
    algo = harness.build_algorithm(args, iters_per_epoch=ITERS_PER_EPOCH)
    batch = harness.synthetic_batch(args, seed=args.seed)
    torch.cuda.synchronize()
    say('{0} built {1} on {2}/ResNet-101 @{3} (batch {4}+{5}) in '
        '{6:.1f} s'.format(tag, what, MODEL_NAMES[args.models['model']],
                           args.im_size, args.labeled_batch_size,
                           args.unlabeled_batch_size,
                           time.perf_counter() - t0))
    return algo, batch


def phase_main_path(seed, steps):
    import torch

    args = full_width_args('ssl_gct', seed, batch_size=GCT_BATCH[0],
                           unlabeled_batch_size=GCT_BATCH[1], **GCT_CONFIG)
    algo, batch = build_full_width(args, '[5/40]', 'GCT')
    _, _, launches = timed_steps(
        algo, batch, steps, '[5/40]', 'GCT',
        ('l_task_loss', 'r_task_loss', 'l_fd_loss', 'r_fd_loss'))
    if launches != BLUR_LAUNCHES_PER_STEP * steps:
        raise AssertionError('blur kernel launched {0} times in {1} steps, '
                             'expected {2}'.format(
                                 launches, steps,
                                 BLUR_LAUNCHES_PER_STEP * steps))

    algo.l_model.eval()
    with torch.no_grad():
        pred = algo.l_model(batch['inp'])['activated_pred'][0]
    if tuple(pred.shape) != (GCT_BATCH[0], 21, IM_SIZE, IM_SIZE) or not bool(
            torch.isfinite(pred).all()):
        raise AssertionError('eval prediction {0} not finite or of the wrong '
                             'shape'.format(tuple(pred.shape)))
    return launches


# the MT recipe, scripts/deeplabv2_pascalvoc_1-8_sslmt.py:13-14, without
# input noise (--gaussian-noise-std is off by default)
MT_CONFIG = dict(
    cons_for_labeled=False, cons_scale=1.0, cons_rampup_epochs=3,
    ema_decay=0.99, gaussian_noise_std=None, lr=2.5e-4, momentum=0.9,
    weight_decay=5e-4)
NULL_CONFIG = dict(lr=2.5e-4, momentum=0.9, weight_decay=5e-4)


def phase_small_mt_null(seed, steps):
    """MT and SupOnly at ResNet-10 / 96 px in float32, ``steps`` steps
    each on the card and on the CPU from the same weights and batch; the
    losses must agree (rtol 2e-3; cons_loss rtol 2e-2, atol 1e-6: a mean
    squared difference of two nearly equal predictions, 0 on steps 0 and
    1). lr 5e-5: at 2.5e-4 this toy diverges and amplifies float32 noise
    tenfold a step (tests/test_torch_mt.py). Then one MT step with input
    noise, on the card only: its metrics must be finite."""
    from pixelssl_tpu_torch import harness

    small = dict(backbone='resnet10', im_size=96, num_classes=5, epochs=20,
                 bf16=False, seed=seed)
    cases = (
        ('ssl_mt', dict(MT_CONFIG, lr=5e-5, batch_size=4,
                        unlabeled_batch_size=2, **small)),
        ('ssl_null', dict(NULL_CONFIG, lr=5e-5, batch_size=4,
                          unlabeled_batch_size=0, **small)))
    for algo_name, config in cases:
        args = harness.default_args(algo_name, **config)
        rows = {}
        for device in ('cpu', 'cuda'):
            algo = harness.build_algorithm(
                args, device=device, iters_per_epoch=2)
            batch = harness.synthetic_batch(args, device=device, seed=seed)
            rows[device] = [{k: float(v) for k, v in
                             algo.train_step(batch).items()}
                            for _ in range(steps)]
        for s, (ref_row, got_row) in enumerate(zip(rows['cpu'],
                                                   rows['cuda'])):
            for key, ref in ref_row.items():
                rtol, atol = (2e-2, 1e-6) if key == 'cons_loss' else (2e-3,
                                                                      1e-6)
                if not math.isclose(got_row[key], ref, rel_tol=rtol,
                                    abs_tol=atol):
                    raise AssertionError(
                        'small {0} step {1}: {2} on the card {3} vs CPU '
                        '{4}'.format(algo_name, s, key, got_row[key], ref))
        say('[6/40] small {0} ({1} steps, ResNet-10, 96 px) card vs CPU agree; '
            'last step: {2}'.format(algo_name, steps, '  '.join(
                '{0} {1:.6g}/{2:.6g}'.format(k, rows['cuda'][-1][k],
                                             rows['cpu'][-1][k])
                for k in sorted(rows['cpu'][-1]))))
    args = harness.default_args('ssl_mt', **dict(
        cases[0][1], gaussian_noise_std=0.1))
    algo = harness.build_algorithm(args, iters_per_epoch=2)
    values = {k: float(v) for k, v in algo.train_step(
        harness.synthetic_batch(args, seed=seed)).items()}
    if not all(math.isfinite(v) for v in values.values()):
        raise AssertionError('noisy MT step: {0}'.format(values))
    say('[6/40] small MT step with gaussian_noise_std 0.1 on the card: ' +
        '  '.join('{0} {1:.6g}'.format(k, v) for k, v in sorted(values.items())))


def profile_kernels(fn):
    """``fn()`` under ``torch.profiler``: its CUDA kernels (the device time
    of each summed by name), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and
              not getattr(e, 'is_user_annotation', False)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return events


def profile_step(algo, batch, step_ms, tag, what, top=10):
    """One train step under ``torch.profiler``: the ``top`` CUDA kernels
    with the most device time, and the kernels' total beside the median of
    the timed steps after the first (the device's busy share of a step).
    Returns the total in ms (None if the profiler saw no device time)."""
    import statistics

    events = profile_kernels(lambda: algo.train_step(batch))
    total_us = sum(e.self_device_time_total for e in events)
    if not events or total_us <= 0:
        say('{0} {1} step profile: the profiler recorded no device '
            'time'.format(tag, what))
        return None
    steady_ms = statistics.median(step_ms[1:])
    say('{0} {1} step profile: {2:.3f} ms of device time in {3} kernel '
        'launches ({4} distinct kernels), {5:.1f}% of a {6:.1f} ms step '
        '(median of the timed steps after the first); top {7}:'.format(
            tag, what, total_us / 1e3, sum(e.count for e in events),
            len(events), 100.0 * total_us / 1e3 / steady_ms, steady_ms,
            top))
    for e in events[:top]:
        say('{0}   {1:8.3f} ms {2:5.1f}% x{3:<4} {4}'.format(
            tag, e.self_device_time_total / 1e3,
            100.0 * e.self_device_time_total / total_us, e.count,
            e.key[:150]))
    return total_us / 1e3


def phase_mt(seed, steps):
    """MT at full width: ``steps`` timed steps, then one profiled step."""
    args = full_width_args('ssl_mt', seed, batch_size=8,
                           unlabeled_batch_size=4, **MT_CONFIG)
    algo, batch = build_full_width(args, '[7/40]', 'MT')
    history, step_ms, launches = timed_steps(
        algo, batch, steps, '[7/40]', 'MT', ('s_task_loss', 't_task_loss'))
    if not history[2]['cons_loss'] > 0:
        raise AssertionError('cons_loss {0} on step 2'.format(
            history[2]['cons_loss']))
    if launches != 0:
        raise AssertionError('MT launched the blur kernel {0} times'.format(
            launches))
    profile_step(algo, batch, step_ms, '[7/40]', 'MT')
    return algo


def phase_null(seed, steps):
    """SupOnly at full width, batch 4 + 0."""
    args = full_width_args('ssl_null', seed, batch_size=4,
                           unlabeled_batch_size=0, **NULL_CONFIG)
    algo, batch = build_full_width(args, '[8/40]', 'SupOnly')
    _, _, launches = timed_steps(algo, batch, steps, '[8/40]', 'SupOnly',
                                 ('task_loss',))
    if launches != 0:
        raise AssertionError('SupOnly launched the blur kernel {0} '
                             'times'.format(launches))
    return algo


def phase_validate_checkpoint(mt_algo, null_algo, seed):
    """``validate`` of MT's student and teacher on two synthetic batches of
    4 at 321 px; a checkpoint saved, loaded into a fresh MT (equal
    parameters, teacher included) and refused by SupOnly."""
    import tempfile

    import torch
    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.utils import logger

    args = mt_algo.args
    scores = mt_algo.validate(harness.synthetic_val_batches(args, 2,
                                                            seed=seed + 1),
                              epoch=0)
    for model_id in ('student', 'teacher'):
        miou = scores.get(model_id + '_metric_mIoU')
        if miou is None or not 0.0 <= miou <= 1.0:
            raise AssertionError('{0} mIoU {1}'.format(model_id, miou))
    losses = {k: m.avg for k, m in mt_algo.meters.items()
              if k.endswith('_loss')}
    if sorted(losses) != ['student_loss', 'teacher_loss'] or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError('validation losses {0}'.format(losses))
    say('[9/40] MT validate (2 batches of 4 @321): ' + '  '.join(
        '{0} {1:.5f}'.format(k, float(v))
        for k, v in sorted(dict(scores, **losses).items())))

    with tempfile.TemporaryDirectory() as tmp:
        path = mt_algo.save_checkpoint(epoch=0,
                                       path=os.path.join(tmp, 'mt.pth'))
        size_mib = os.path.getsize(path) / 2 ** 20
        fresh = harness.build_algorithm(
            full_width_args('ssl_mt', seed + 1, batch_size=8,
                            unlabeled_batch_size=4, **MT_CONFIG),
            iters_per_epoch=ITERS_PER_EPOCH)
        fresh.load_checkpoint(path)
        for key in ('model', 'teacher'):
            theirs = mt_algo.modules[key].state_dict()
            for name, value in fresh.modules[key].state_dict().items():
                if not torch.equal(value, theirs[name]):
                    raise AssertionError('loaded {0}.{1} differs'.format(
                        key, name))
        if fresh.state.step != mt_algo.state.step:
            raise AssertionError('loaded step {0} != {1}'.format(
                fresh.state.step, mt_algo.state.step))
        try:
            null_algo.load_checkpoint(path)
        except logger.FatalError:
            pass
        else:
            raise AssertionError('SupOnly loaded a checkpoint of ssl_mt')
    say('[9/40] checkpoint of {0:.0f} MiB saved, loaded into a fresh MT '
        '(student and teacher equal, step {1}), refused by SupOnly'.format(
            size_mib, fresh.state.step))


# the script phases: samples of the synthetic set (every other one
# labeled) and the iterations an epoch that they give at batch 2 + 2
SCRIPT_SAMPLES = {'ssl_mt': 20, 'ssl_gct': 12, 'ssl_adv': 12, 'ssl_s4l': 12,
                  'ssl_cct': 12}
SCRIPT_EPOCHS = {'ssl_mt': 2, 'ssl_gct': 1, 'ssl_adv': 1, 'ssl_s4l': 1,
                 'ssl_cct': 1}
RESCORE_ATOL = 1e-4


SCRIPT_MT = 'deeplabv2_pascalvoc_1-8_sslmt.py'
SCRIPT_GCT = 'deeplabv2_pascalvoc_1-8_sslgct.py'
SCRIPT_ADV = 'deeplabv2_pascalvoc_1-8_ssladv.py'
SCRIPT_S4L = 'deeplabv2_pascalvoc_1-8_ssls4l.py'


def load_script_config(script):
    """The config of one of the port's experiment scripts, as written."""
    import runpy

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'pixelssl_tpu_torch', 'scripts', script)
    return runpy.run_path(path)['config']


def script_batch(script):
    """(batch size, unlabeled batch size, image size) of ``script``."""
    config = load_script_config(script)
    return (config['batch_size'], config['unlabeled_batch_size'],
            config['im_size'])


def script_blur_cases(script):
    """The blur calls of one GCT step at the batch and size of ``script``."""
    return gct_blur_cases(*script_batch(script))


def script_config(script, out, algo_name, samples=None):
    """The config of one of the port's experiment scripts with its data
    keys swapped: the synthetic dataset in place of PASCAL VOC, a
    sublabeled file of synthetic names (every other one of ``samples``,
    by default ``SCRIPT_SAMPLES``'), ResNet-101 with random weights,
    training from scratch, a few epochs; the recipe's other values as the
    script gives them."""
    config = load_script_config(script)
    n = samples or SCRIPT_SAMPLES[algo_name]
    sub_path = os.path.join(out, 'sublabeled.txt')
    with open(sub_path, 'w') as f:
        for i in range(0, n, 2):
            f.write('synthetic_{0:05d}\n'.format(i))
    config.update([
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', n),
        ('sublabeled_path', sub_path),
        ('backbone', 'resnet101'),
        ('validation', False),
        ('resume', ''),
        ('out_path', out),
        ('epochs', SCRIPT_EPOCHS[algo_name]),
        ('log_freq', 1), ('val_freq', 1), ('checkpoint_freq', 1),
        ('num_workers', 2),
    ])
    return config


def read_records(config):
    path = os.path.join(config['out_path'], config['exp_id'], 'metrics.jsonl')
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_script_phase(tag, script, algo_name, out, config=None):
    """``run_script`` of a script config (by default ``script_config``'s)
    on the card, the blur launches counted from 0 and the peak memory from
    a reset; every train record's losses finite and > 0 where they are task
    losses. Returns the config, the proxy, the records and the blur
    launches."""
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.tasks import sseg

    if config is None:
        config = script_config(script, out, algo_name)
    say('{0} run_script {1}: {2}, batch {3}+{4}, '
        '{5} epoch(s), {6} workers, exact_val {7}'.format(
            tag, script, config['trainset'],
            config['batch_size'] - config['unlabeled_batch_size'],
            config['unlabeled_batch_size'], config['epochs'],
            config['num_workers'], config['exact_val']))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blur.launches = 0
    t0 = time.perf_counter()
    proxy = pixelssl_tpu_torch.run_script(
        config, sseg, sseg.SemanticSegmentationProxy, device='cuda',
        cli_override=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = blur.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    records = read_records(config)
    train = [r for r in records if r['phase'] == 'train']
    iters = len(proxy.train_loader)
    # a record an iteration; with --steps-per-dispatch n, one a dispatch
    # and one for each iteration of the tail
    n = int(config.get('steps_per_dispatch', 1))
    per_epoch = iters if n == 1 else iters // n + iters % n
    if len(train) != per_epoch * config['epochs']:
        raise AssertionError('{0} train records, expected {1}'.format(
            len(train), per_epoch * config['epochs']))
    for r in train:
        losses = {k: v for k, v in r.items() if k.endswith('_loss')}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError('non-finite loss: {0}'.format(r))
        if not all(v > 0 for k, v in losses.items() if 'task' in k):
            raise AssertionError('task loss <= 0: {0}'.format(r))
    for r in records:
        if r['phase'] == 'epoch_summary':
            its = [t for t in train if t['epoch'] == r['epoch']]
            say('{0} epoch {1}: {2} iterations in {3:.3f} s, {4:.1f} ms an '
                'iteration, {5:.2f} samples/s; each iteration ms (of it '
                'waiting for the loader): {6}'.format(
                    tag, r['epoch'], r['iters'], r['wall_s'],
                    1e3 * r['wall_s'] / r['iters'], r['samples_per_sec'],
                    ' '.join('{0:.1f} ({1:.1f})'.format(
                        1e3 * t['batch_time'], 1e3 * t['data_time'])
                        for t in its)))
    val = [r for r in records if r['phase'] == 'val']
    if len(val) != config['epochs']:
        raise AssertionError('{0} val records'.format(len(val)))
    for key, value in val[-1].items():
        if 'mIoU' in key and not 0.0 <= value <= 1.0:
            raise AssertionError('{0} = {1}'.format(key, value))
    say('{0} run_script took {1:.1f} s; peak memory {2:.2f} GiB; '
        'blur launches {3}; last val: {4}'.format(
            tag, wall_s, peak_gib, launches, '  '.join(
                '{0} {1:.5f}'.format(k, v) for k, v in sorted(val[-1].items())
                if 'mIoU' in k or k.endswith('_loss'))))
    return config, proxy, records, launches


def bare_steps_ms(algo, loader, steps):
    """``steps`` more ``train_step`` calls on one batch of ``loader``,
    already on the card, each between CUDA events."""
    import torch
    batch = next(iter(loader))
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = algo.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError('non-finite metrics {0}'.format(metrics))
    return times


def phase_script_mt():
    """MT through the script path, then its rescore from
    ``checkpoint_2.pth``."""
    import statistics
    import tempfile

    tag = '[10/40]'
    with tempfile.TemporaryDirectory() as out:
        config, proxy, records, launches = run_script_phase(
            tag, SCRIPT_MT, 'ssl_mt', out)
        if launches != 0:
            raise AssertionError('MT launched the blur kernel {0} '
                                 'times'.format(launches))
        expected_lines = config['epochs'] * (len(proxy.train_loader) + 2)
        if len(records) != expected_lines:
            raise AssertionError('metrics.jsonl has {0} lines, expected '
                                 '{1}'.format(len(records), expected_lines))
        bare = bare_steps_ms(proxy.ssl_algorithm, proxy.train_loader, STEPS)
        say('{0} metrics.jsonl: {1} lines; {2} more train_step calls on a '
            'batch on the card: {3} ms (median {4:.1f})'.format(
                tag, len(records), STEPS,
                ' '.join('{0:.1f}'.format(t) for t in bare),
                statistics.median(bare)))
        # the first step of an epoch follows a validation: time one such
        # step without the loader in the way
        proxy.ssl_algorithm.validate(proxy.val_loader, config['epochs'])
        after = bare_steps_ms(proxy.ssl_algorithm, proxy.train_loader, 2)
        say('{0} after a validation, 2 train_step calls on a batch on the '
            'card: {1} ms'.format(
                tag, ' '.join('{0:.1f}'.format(t) for t in after)))

        rescore_matches(tag, config, proxy, records)
        del proxy
    no_workers_left(tag)


def rescore_matches(tag, config, proxy, records):
    """``run_script`` in validation mode from the run's last checkpoint:
    its scores and losses must equal the training run's last validation
    within ``RESCORE_ATOL``."""
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sseg

    trained = [r for r in records if r['phase'] == 'val'][-1]
    name = 'checkpoint_{0}.pth'.format(config['epochs'])
    ckpt = os.path.join(proxy.args.checkpoint_path, name)
    rescore = dict(config, validation=True, resume=ckpt)
    pixelssl_tpu_torch.run_script(
        rescore, sseg, sseg.SemanticSegmentationProxy, device='cuda',
        cli_override=False)
    rescored = read_records(config)[-1]
    keys = [k for k in trained if 'metric' in k or k.endswith('_loss')]
    if rescored['phase'] != 'val' or sorted(keys) != sorted(
            k for k in rescored if 'metric' in k or k.endswith('_loss')):
        raise AssertionError('rescore record {0}'.format(rescored))
    diff = max(abs(rescored[k] - trained[k]) for k in keys)
    say('{0} rescore from {1}: {2} scores, largest difference from the '
        'training run {3:.3g} (atol {4:g})'.format(
            tag, name, len(keys), diff, RESCORE_ATOL))
    if not diff <= RESCORE_ATOL:
        raise AssertionError('rescore differs by {0}'.format(diff))


def no_workers_left(tag):
    """The loader's worker processes end with their run: none may be left
    once the run's objects are gone."""
    import gc
    import multiprocessing

    gc.collect()
    children = multiprocessing.active_children()
    if children:
        raise AssertionError('{0} worker processes left: {1}'.format(
            tag, children))


def loss_values(metrics):
    return {k: float(v) for k, v in metrics.items() if k.endswith('_loss')}


@contextlib.contextmanager
def watched_steps():
    """``SSLBase.train_step`` and ``train_steps`` watched while the block
    runs: yields {'sums': each batch a step takes, in order
    (``batch_sums``), 'eager': the losses of each eager ``train_step``
    (every step of a plain run; the first of a graph run and its tail)}.
    Each adds a sync: untimed runs only."""
    from pixelssl_tpu_torch.ssl_algorithm import ssl_base

    seen = {'sums': [], 'eager': []}
    one, many = ssl_base.SSLBase.train_step, ssl_base.SSLBase.train_steps
    inside = []

    def train_step(self, batch):
        if not inside:
            seen['sums'].append(batch_sums(batch))
        metrics = one(self, batch)
        seen['eager'].append(loss_values(metrics))
        return metrics

    def train_steps(self, batches, history=None):
        batches = list(batches)
        seen['sums'].extend(batch_sums(b) for b in batches)
        inside.append(True)
        try:
            return many(self, batches, history)
        finally:
            inside.pop()

    ssl_base.SSLBase.train_step = train_step
    ssl_base.SSLBase.train_steps = train_steps
    try:
        yield seen
    finally:
        ssl_base.SSLBase.train_step = one
        ssl_base.SSLBase.train_steps = many


def script_graph_checks(tag, what, proxy, epochs, blur_per_step, launches):
    """A script's run at ``--steps-per-dispatch`` ``MULTI_N``: the algorithm
    captured its step, ``state.step`` counts every iteration, the blur
    kernel ran ``blur_per_step`` times each; then one replay from the
    run's final state against eager steps (``check_one_step``) on a batch
    of the run's loader."""
    algo = proxy.ssl_algorithm
    steps = len(proxy.train_loader) * epochs
    if algo.steps_per_dispatch != MULTI_N or algo._captured is None:
        raise AssertionError('{0}: no captured step at --steps-per-dispatch '
                             '{1}'.format(what, algo.steps_per_dispatch))
    if algo.state.step != steps or launches != blur_per_step * steps:
        raise AssertionError('{0}: state.step {1}, blur launches {2}; '
                             'expected {3}, {4}'.format(
                                 what, algo.state.step, launches, steps,
                                 blur_per_step * steps))
    check_one_step(tag, what, algo, next(iter(proxy.train_loader)),
                   blur_per_step)


def phase_script_gct():
    """GCT through the script path; returns its blur launches."""
    import tempfile

    tag = '[11/40]'
    with tempfile.TemporaryDirectory() as out:
        _, proxy, records, launches = run_script_phase(
            tag, SCRIPT_GCT, 'ssl_gct', out)
        iters = len(proxy.train_loader)
        if launches != BLUR_LAUNCHES_PER_STEP * iters:
            raise AssertionError('blur kernel launched {0} times in {1} '
                                 'iterations, expected {2}'.format(
                                     launches, iters,
                                     BLUR_LAUNCHES_PER_STEP * iters))
        del proxy
    no_workers_left(tag)
    return launches


# the AdvSSL, S4L and CutMix phases (12-15). The AdvSSL and S4L flags are
# those of their 1-8 scripts; CutMix's those of the PSPNet 1-8 script
# (scripts/pspnet_pascalvoc_1-8_sslcutmix.py) with cons_threshold 0.05, so
# that at a random init the confidence, and with it cons_loss, is not 0
# (the recipe's 0.97 is printed beside it). Each lists the losses that
# must be > 0 (__graft_entry__.py:40-70).
ADV_CONFIG = dict(
    NULL_CONFIG, adv_for_labeled=True, labeled_adv_scale=0.01,
    unlabeled_adv_scale=0.001, discriminator_lr=1e-4,
    unlabeled_for_discriminator=True)
S4L_CONFIG = dict(NULL_CONFIG, rotated_sup_scale=0.1, rotation_scale=0.1)
CUTMIX_THRESHOLD = 0.97
CUTMIX_CONFIG = dict(
    NULL_CONFIG, cons_type='mse', cons_scale=20.0, cons_rampup_epochs=0,
    cons_threshold=0.05, ema_decay=0.99, mask_prop_range=(0.5, 0.5))
NEW_ALGOS = (
    ('ssl_adv', 'AdvSSL', ADV_CONFIG,
     ('task_loss', 'labeled_adv_loss', 'unlabeled_adv_loss', 'fake_d_loss',
      'real_d_loss')),
    ('ssl_s4l', 'S4L', S4L_CONFIG,
     ('unrotated_task_loss', 'rotated_task_loss', 'rotation_loss')),
    ('ssl_cutmix', 'CutMix', CUTMIX_CONFIG, ('task_loss', 'cons_loss')),
)


def inject_draws(algo, seed, steps):
    """Fix the per-step draws of S4L (angles), CutMix (box masks) and CCT
    (the decoders' draws) from numpy and a CPU generator, so that the card
    and the CPU take the same ones."""
    import numpy as np
    import torch
    from pixelssl_tpu_torch.ops import boxmask

    if algo.NAME == 'ssl_s4l':
        angles = np.random.default_rng(seed).integers(
            1, 4, (steps, algo.args.batch_size))
        algo._draw_angles = lambda n: torch.from_numpy(
            angles[algo.state.step, :n]).to(algo.device)
    elif algo.NAME == 'ssl_cutmix':
        def draw(n, shape):
            generator = torch.Generator().manual_seed(seed + algo.state.step)
            return boxmask.box_masks(generator, n, shape,
                                     algo.args.mask_prop_range).to(
                                         algo.device)
        algo._draw_masks = draw
    elif algo.NAME == 'ssl_cct':
        from pixelssl_tpu_torch.ssl_algorithm.ssl_cct import \
            draw_decoder_noise

        def to_device(d):
            if isinstance(d, tuple):
                return tuple(t.to(algo.device) for t in d)
            return None if d is None else d.to(algo.device)

        def draw_cct(step, latent_shape):
            generator = torch.Generator().manual_seed(seed + step)
            return [to_device(d) for d in draw_decoder_noise(
                algo.specs, generator, latent_shape, 'cpu')]
        algo._draw_decoder_noise = draw_cct


def small_card_vs_cpu(tag, what, args, seed, steps):
    """``steps`` steps of the algorithm of ``args`` on the card and on the
    CPU from the same weights, batch and draws; the losses must agree with
    phase 6's limits (rtol 2e-3; cons_loss rtol 2e-2, atol 1e-6),
    rotation_acc exactly."""
    from pixelssl_tpu_torch import harness

    rows = {}
    for device in ('cpu', 'cuda'):
        algo = harness.build_algorithm(args, device=device, iters_per_epoch=2)
        inject_draws(algo, seed, steps)
        batch = harness.synthetic_batch(args, device=device, seed=seed)
        rows[device] = [{k: float(v) for k, v in
                         algo.train_step(batch).items()}
                        for _ in range(steps)]
    worst = 0.0
    for s, (ref_row, got_row) in enumerate(zip(rows['cpu'], rows['cuda'])):
        for key, ref in ref_row.items():
            rtol, atol = {'cons_loss': (2e-2, 1e-6),
                          'rotation_acc': (0.0, 0.0)}.get(key, (2e-3, 1e-6))
            got = got_row[key]
            worst = max(worst, abs(got - ref) / max(abs(ref), 1e-12))
            if not math.isclose(got, ref, rel_tol=rtol, abs_tol=atol):
                raise AssertionError(
                    'small {0} step {1}: {2} on the card {3} vs CPU '
                    '{4}'.format(what, s, key, got, ref))
    say('{0} small {1} ({2} steps, ResNet-10, {3} px) card vs CPU agree, '
        'largest relative metric difference {4:.3g}; last step: {5}'.format(
            tag, what, steps, args.im_size, worst, '  '.join(
                '{0} {1:.6g}/{2:.6g}'.format(k, rows['cuda'][-1][k],
                                             rows['cpu'][-1][k])
                for k in sorted(rows['cpu'][-1]))))


SMALL = dict(backbone='resnet10', im_size=64, num_classes=5, epochs=20,
             bf16=False, lr=5e-5)


def phase_small_new(seed, steps):
    """AdvSSL, S4L and CutMix at ResNet-10 / 64 px in float32, card
    against CPU."""
    from pixelssl_tpu_torch import harness

    for algo_name, what, config, _ in NEW_ALGOS:
        args = harness.default_args(algo_name, **dict(
            config, seed=seed, batch_size=4, unlabeled_batch_size=2,
            **SMALL))
        small_card_vs_cpu('[12/40]', what, args, seed, steps)


def cutmix_confidences(algo, thresholds):
    """Record, on the next steps, the share of mixed teacher pixels whose
    largest class probability exceeds each threshold; returns the list
    that collects one {threshold: share} a step. Each read waits for the
    card, so the steps it watches are not timed."""
    import torch

    seen = []
    draw, teacher_forward = algo._draw_masks, algo._teacher_forward
    masks = []

    def draw_and_keep(n, shape):
        masks.append(draw(n, shape))
        return masks[-1]

    def forward_and_measure(inp):
        resulter = teacher_forward(inp)
        act = resulter['activated_pred'][0]
        half = act.shape[0] // 2
        mask = masks[-1]
        top = (mask * act[:half] + (1.0 - mask) * act[half:]).amax(dim=1)
        with torch.no_grad():
            seen.append({t: float((top > t).float().mean())
                         for t in thresholds})
        return resulter

    algo._draw_masks = draw_and_keep
    algo._teacher_forward = forward_and_measure
    return seen


def d_share(algo, batch, step_kernel_ms):
    """The discriminator's work of one AdvSSL step, profiled on its own
    at the step's shapes on a copy of D: its forward on the batch's
    activated prediction and the backward to that input (step 1), its
    forward on [fake ++ real] rows, the backward to its parameters and an
    Adam step (step 2). Prints its kernel time beside the step's."""
    import copy

    import torch

    lbs = algo.ctx.lbs
    n_fake = (lbs + algo.ctx.ubs if algo.args.unlabeled_for_discriminator
              else lbs)
    with torch.no_grad():
        act = algo.model(tuple(batch['inp']))['activated_pred'][0]
    real = algo.ctx.task_func.ssladv_convert_task_gt_to_fcd_input(
        batch['gt'][0][:lbs])
    d_model = copy.deepcopy(algo.d_model)
    d_opt = torch.optim.Adam(d_model.parameters(), lr=1e-4,
                             betas=(0.9, 0.99))

    def work():
        x = act.clone().requires_grad_()
        d_model(x).mean().backward(inputs=[x])
        d_opt.zero_grad(set_to_none=True)
        d_model(torch.cat([act[:n_fake], real])).mean().backward(
            inputs=list(d_model.parameters()))
        d_opt.step()

    work()
    events = profile_kernels(work)
    d_ms = sum(e.self_device_time_total for e in events) / 1e3
    say('[13/40] AdvSSL discriminator alone (forward on {0} rows and '
        'backward to its input; forward on {1}+{2} rows, backward to its '
        'weights, Adam): {3:.3f} ms of device time in {4} launches{5}'.format(
            act.shape[0], n_fake, lbs, d_ms, sum(e.count for e in events),
            '' if not step_kernel_ms else
            ', {0:.1f}% of the AdvSSL step\'s {1:.3f} ms'.format(
                100.0 * d_ms / step_kernel_ms, step_kernel_ms)))


def phase_new_full_width(seed, steps):
    """AdvSSL, S4L and CutMix at full width, batch 4 + 4: ``steps`` timed
    steps each; one AdvSSL and one S4L step profiled, and D's share of
    AdvSSL's kernel time. Returns the algorithms."""
    import torch

    algos = {}
    for algo_name, what, config, positive in NEW_ALGOS:
        args = full_width_args(algo_name, seed, batch_size=8,
                               unlabeled_batch_size=4, **config)
        algo, batch = build_full_width(args, '[13/40]', what)
        history, step_ms, launches = timed_steps(
            algo, batch, steps, '[13/40]', what, positive)
        if launches != 0:
            raise AssertionError('{0} launched the blur kernel {1} '
                                 'times'.format(what, launches))
        if algo_name == 'ssl_s4l':
            if not all(0.0 <= h['rotation_acc'] <= 100.0 for h in history):
                raise AssertionError('rotation_acc {0}'.format(history))
        if algo_name == 'ssl_cutmix':
            # one more step, untimed: the confidence read waits for the
            # card between the teacher's forward and the student's
            seen = cutmix_confidences(
                algo, (args.cons_threshold, CUTMIX_THRESHOLD))
            cons_loss = float(algo.train_step(batch)['cons_loss'])
            del algo._draw_masks, algo._teacher_forward  # the class's again
            say('[13/40] CutMix step {0} (untimed): cons_loss {1:.6g}, '
                'confidence of the mixed teacher pixels at threshold {2:g} '
                '(this run) / {3:g} (the recipe): {4:.5f}/{5:.5f}'.format(
                    steps, cons_loss, args.cons_threshold, CUTMIX_THRESHOLD,
                    seen[0][args.cons_threshold], seen[0][CUTMIX_THRESHOLD]))
            if not cons_loss > 0:
                raise AssertionError('CutMix cons_loss {0} on the untimed '
                                     'step'.format(cons_loss))
        if algo_name in ('ssl_adv', 'ssl_s4l'):
            kernel_ms = profile_step(algo, batch, step_ms, '[13/40]', what)
            if algo_name == 'ssl_adv':
                d_share(algo, batch, kernel_ms)
        algos[algo_name] = algo
        torch.cuda.empty_cache()
    return algos


def validate_and_round_trip(tag, algo, fresh_args, refuser, seed, tmp):
    """``validate`` of ``algo`` on two synthetic batches of its labeled
    batch size (scores in [0, 1], losses finite); its checkpoint saved,
    loaded into a fresh build from ``fresh_args`` (every module and
    optimizer state equal) and refused by the algorithm ``refuser``."""
    import torch
    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.utils import logger

    algo_name = algo.NAME
    scores = algo.validate(harness.synthetic_val_batches(
        algo.args, 2, seed=seed + 1), epoch=0)
    losses = {k: m.avg for k, m in algo.meters.items()
              if k.endswith('_loss')}
    bad = {k: v for k, v in scores.items() if not 0.0 <= v <= 1.0}
    if not scores or bad or not losses or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError('{0} validation: {1} {2}'.format(
            algo_name, scores, losses))
    say('{0} {1} validate (2 batches of {2} @{3}): {4}'.format(
        tag, algo_name, algo.args.labeled_batch_size, algo.args.im_size,
        '  '.join('{0} {1:.5f}'.format(k, float(v)) for k, v in sorted(
            dict(scores, **losses).items())
            if 'mIoU' in k or k.endswith('_loss'))))

    path = algo.save_checkpoint(
        epoch=0, path=os.path.join(tmp, algo_name + '.pth'))
    fresh = harness.build_algorithm(fresh_args,
                                    iters_per_epoch=ITERS_PER_EPOCH)
    fresh.load_checkpoint(path)
    compared = 0
    for key, module in algo.modules.items():
        theirs = fresh.modules[key].state_dict()
        for name, value in module.state_dict().items():
            if not torch.equal(value, theirs[name]):
                raise AssertionError('loaded {0}.{1} differs'.format(
                    key, name))
            compared += 1
    for key, opt in algo.optimizers.items():
        ours, theirs = opt.state_dict(), fresh.optimizers[key].state_dict()
        for pid, st in ours['state'].items():
            for name, value in st.items():
                other = theirs['state'][pid][name]
                if torch.as_tensor(value).device != torch.as_tensor(
                        other).device or not torch.equal(
                            torch.as_tensor(value).cpu(),
                            torch.as_tensor(other).cpu()):
                    raise AssertionError(
                        'loaded {0} state {1}.{2} differs'.format(
                            key, pid, name))
                compared += 1
    if fresh.state.step != algo.state.step:
        raise AssertionError('loaded step {0} != {1}'.format(
            fresh.state.step, algo.state.step))
    del fresh
    try:
        refuser.load_checkpoint(path)
    except logger.FatalError:
        pass
    else:
        raise AssertionError('{0} loaded a checkpoint of {1}'.format(
            refuser.NAME, algo_name))
    say('{0} {1} checkpoint of {2:.0f} MiB ({3} modules: {4}; '
        'optimizers: {5}) loaded into a fresh build, {6} tensors '
        'equal, step {7}; refused by {8}'.format(
            tag, algo_name, os.path.getsize(path) / 2 ** 20,
            len(algo.modules), ', '.join(algo.modules),
            ', '.join(algo.optimizers), compared, algo.state.step,
            refuser.NAME))
    torch.cuda.empty_cache()


def phase_new_validate_checkpoint(algos, seed):
    """``validate`` and a checkpoint round trip of each of the three, each
    checkpoint refused by another of them."""
    import tempfile

    configs = {name: config for name, _, config, _ in NEW_ALGOS}
    refusers = {'ssl_adv': 'ssl_s4l', 'ssl_s4l': 'ssl_cutmix',
                'ssl_cutmix': 'ssl_adv'}
    with tempfile.TemporaryDirectory() as tmp:
        for algo_name, algo in algos.items():
            validate_and_round_trip(
                '[14/40]', algo, full_width_args(
                    algo_name, seed + 1, batch_size=8,
                    unlabeled_batch_size=4, **configs[algo_name]),
                algos[refusers[algo_name]], seed, tmp)


def phase_script_new():
    """The 1-8 AdvSSL and S4L scripts through ``run_script`` at full width
    on synthetic data (1 epoch of 3 iterations, validation,
    ``checkpoint_1.pth``), and a rescore of the S4L run from it."""
    import tempfile

    tag = '[15/40]'
    for script, algo_name in ((SCRIPT_ADV, 'ssl_adv'),
                              (SCRIPT_S4L, 'ssl_s4l')):
        with tempfile.TemporaryDirectory() as out:
            config, proxy, records, launches = run_script_phase(
                tag, script, algo_name, out)
            if launches != 0:
                raise AssertionError('{0} launched the blur kernel {1} '
                                     'times'.format(algo_name, launches))
            ckpt = os.path.join(proxy.args.checkpoint_path,
                                'checkpoint_1.pth')
            if not os.path.isfile(ckpt):
                raise AssertionError('no {0}'.format(ckpt))
            if algo_name == 'ssl_s4l':
                rescore_matches(tag, config, proxy, records)
            del proxy
        no_workers_left(tag)


# the PSPNet phases (16-19): the PSPNet scripts' model and crop
# (scripts/_common.py), each algorithm at its 1-8 script's batch and flags;
# CutMix's cons_threshold 0.05 for the reason given above phase 12
CCT_CONFIG = dict(
    NULL_CONFIG, cons_scale=30.0, cons_rampup_epochs=5, ad_lr_scale=10.0,
    vat_dec_num=1, drop_dec_num=2, cut_dec_num=2, context_dec_num=1,
    object_dec_num=1, fn_dec_num=2, fd_dec_num=2)
PSP_ALGOS = (
    ('ssl_null', 'SupOnly', NULL_CONFIG, (4, 0), ('task_loss',)),
    ('ssl_cct', 'CCT', CCT_CONFIG, (4, 2), ('task_loss', 'cons_loss')),
    ('ssl_cutmix', 'CutMix', CUTMIX_CONFIG, (6, 4),
     ('task_loss', 'cons_loss')),
)
SCRIPT_PSP_CCT = 'pspnet_pascalvoc_1-8_sslcct.py'
SCRIPT_PSP_GCT = 'pspnet_pascalvoc_1-8_sslgct.py'


def phase_small_psp(seed, steps):
    """PSPNet at ResNet-10 / 64 px in float32: SupOnly, and CCT with every
    decoder family, card against CPU."""
    from pixelssl_tpu_torch import harness

    for algo_name, what, config, (bs, ubs), _ in PSP_ALGOS[:2]:
        args = harness.default_args(algo_name, **dict(
            config, models={'model': 'pspnet'}, seed=seed, batch_size=bs,
            unlabeled_batch_size=ubs, **SMALL))
        small_card_vs_cpu('[16/40]', 'PSPNet ' + what, args, seed, steps)


def decoder_share(algo, batch, step_kernel_ms):
    """The 11 decoders' work of one CCT step, profiled on its own at the
    step's shapes on copies of the decoders: each perturbation and decoder
    forward on the unlabeled rows' latent, the resize to the target, the
    softmax and the MSE, and the backward to the decoders' parameters and
    the latent. Prints its kernel time beside the step's."""
    import copy

    import torch
    from pixelssl_tpu_torch.models.layers import resize_bilinear
    from pixelssl_tpu_torch.ssl_algorithm.ssl_cct import apply_decoder

    lbs, ubs = algo.ctx.lbs, algo.ctx.ubs
    u_inp = tuple(t[lbs:lbs + ubs] for t in batch['inp'])
    algo.model.eval()  # the BN statistics stay as the steps left them
    with torch.no_grad():
        resulter = algo.model(u_inp)
    algo.model.train()
    latent = resulter['sslcct_ad_inp'].detach().requires_grad_()
    main_pred = resulter['pred'][0]
    ad_gt = resulter['activated_pred'][0].float()
    ads = copy.deepcopy(algo.model.ads)
    draws = algo._draw_decoder_noise(algo.state.step, tuple(latent.shape))
    task_func = algo.ctx.task_func

    def work():
        preds = [resize_bilinear(apply_decoder(
            spec, ads['ad_{0}'.format(i)], latent, main_pred, draw).float(),
            ad_gt.shape[2:], align_corners=False)
            for i, (spec, draw) in enumerate(zip(algo.specs, draws))]
        loss = sum(torch.square(a - ad_gt).mean()
                   for a in task_func.sslcct_activate_ad_preds(preds))
        loss.backward(inputs=list(ads.parameters()) + [latent])

    work()
    events = profile_kernels(work)
    dec_ms = sum(e.self_device_time_total for e in events) / 1e3
    say('[17/40] CCT decoders alone ({0} decoders on {1} rows, latent {2}, '
        'forward and backward): {3:.3f} ms of device time in {4} '
        'launches{5}'.format(
            len(algo.specs), ubs, list(latent.shape), dec_ms,
            sum(e.count for e in events),
            '' if not step_kernel_ms else
            ', {0:.1f}% of the CCT step\'s {1:.3f} ms'.format(
                100.0 * dec_ms / step_kernel_ms, step_kernel_ms)))


def phase_psp_full_width(seed, steps):
    """SupOnly, CCT and CutMix on PSPNet/ResNet-101 @513 at their scripts'
    batches: ``steps`` timed steps each; CutMix's confidence on one more
    step; one CCT step profiled with the decoders' share. Returns the
    algorithms."""
    import torch
    from pixelssl_tpu_torch.nn.func import count_params

    algos = {}
    for algo_name, what, config, (bs, ubs), positive in PSP_ALGOS:
        args = full_width_args(algo_name, seed, model='pspnet',
                               batch_size=bs, unlabeled_batch_size=ubs,
                               **config)
        algo, batch = build_full_width(args, '[17/40]', what)
        task_model = algo.model.main if algo_name == 'ssl_cct' else algo.model
        say('[17/40] {0}: task model {1:,} parameters{2}'.format(
            what, count_params(task_model),
            '' if algo_name != 'ssl_cct' else
            ', {0} decoders {1:,}'.format(len(algo.model.ads),
                                          count_params(algo.model.ads))))
        _, step_ms, launches = timed_steps(
            algo, batch, steps, '[17/40]', what, positive)
        if launches != 0:
            raise AssertionError('{0} launched the blur kernel {1} '
                                 'times'.format(what, launches))
        if algo_name == 'ssl_cutmix':
            seen = cutmix_confidences(
                algo, (args.cons_threshold, CUTMIX_THRESHOLD))
            cons_loss = float(algo.train_step(batch)['cons_loss'])
            del algo._draw_masks, algo._teacher_forward
            say('[17/40] CutMix step {0} (untimed): cons_loss {1:.6g}, '
                'confidence of the mixed teacher pixels at threshold {2:g} '
                '(this run) / {3:g} (the recipe): {4:.5f}/{5:.5f}'.format(
                    steps, cons_loss, args.cons_threshold, CUTMIX_THRESHOLD,
                    seen[0][args.cons_threshold], seen[0][CUTMIX_THRESHOLD]))
            if not cons_loss > 0:
                raise AssertionError('CutMix cons_loss {0} on the untimed '
                                     'step'.format(cons_loss))
        if algo_name == 'ssl_cct':
            kernel_ms = profile_step(algo, batch, step_ms, '[17/40]', what)
            decoder_share(algo, batch, kernel_ms)
        algos[algo_name] = algo
        torch.cuda.empty_cache()
    return algos


def phase_psp_validate_checkpoint(algos, seed):
    """``validate`` of CCT and its checkpoint round trip, refused by the
    PSPNet SupOnly."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        validate_and_round_trip(
            '[18/40]', algos['ssl_cct'], full_width_args(
                'ssl_cct', seed + 1, model='pspnet', batch_size=4,
                unlabeled_batch_size=2, **CCT_CONFIG),
            algos['ssl_null'], seed, tmp)


def phase_script_psp():
    """The PSPNet 1-8 CCT and GCT scripts through ``run_script`` at 513 px
    on synthetic data; CCT rescored from ``checkpoint_1.pth``, GCT's blur
    launches counted. Returns GCT's."""
    import tempfile

    tag = '[19/40]'
    gct_launches = None
    for script, algo_name in ((SCRIPT_PSP_CCT, 'ssl_cct'),
                              (SCRIPT_PSP_GCT, 'ssl_gct')):
        with tempfile.TemporaryDirectory() as out:
            config, proxy, records, launches = run_script_phase(
                tag, script, algo_name, out)
            iters = len(proxy.train_loader)
            if algo_name == 'ssl_cct':
                if launches != 0:
                    raise AssertionError('CCT launched the blur kernel {0} '
                                         'times'.format(launches))
                if not all(r['cons_loss'] > 0 for r in records
                           if r['phase'] == 'train'):
                    raise AssertionError('CCT cons_loss <= 0: {0}'.format(
                        records))
                rescore_matches(tag, config, proxy, records)
            elif launches != BLUR_LAUNCHES_PER_STEP * iters:
                raise AssertionError('blur kernel launched {0} times in {1} '
                                     'iterations, expected {2}'.format(
                                         launches, iters,
                                         BLUR_LAUNCHES_PER_STEP * iters))
            else:
                gct_launches = launches
            del proxy
        no_workers_left(tag)
    return gct_launches


# the VOC phases (20-22): the scripts on the committed VOC-format fixture
# tree, data keys in YAML flow style as a command line gives them
VOC_FIXTURE = os.path.join('tests', 'data', 'voc_fixture', 'VOC2012')
LOADER_SAMPLES = 24
NATIVE_LABELS_EQUAL = 0.97


def voc_config(script, out, **flags):
    """A script's config as written, its data keys on the fixture tree,
    ResNet-101 with random weights trained from scratch for 1 epoch, no
    checkpoint."""
    config = load_script_config(script)
    root = os.path.abspath(VOC_FIXTURE)
    config.update([
        ('trainset', '{{pascal_voc_aug: [{0}]}}'.format(root)),
        ('valset', '{{pascal_voc_aug: [{0}]}}'.format(root)),
        ('backbone', 'resnet101'), ('validation', False), ('resume', ''),
        ('out_path', out), ('epochs', 1), ('log_freq', 1), ('val_freq', 1),
        ('checkpoint_freq', 10)])
    config.update(flags)
    return config


def loader_rate(train_set, n=LOADER_SAMPLES):
    """Samples/s of one loader worker: ``n`` train samples of ``train_set``
    (the proxy's wrapped dataset) in the main process, keys past the run's
    accesses; and the ms of decoding one sample's JPEG and PNG alone."""
    from pixelssl_tpu_torch.nn import imageio

    t0 = time.perf_counter()
    for j in range(n):
        train_set[(j % len(train_set), 1000 + j)]
    rate = n / (time.perf_counter() - t0)
    ds = train_set.dataset
    t0 = time.perf_counter()
    for j in range(n):
        img_path, label_path = ds._paths(j % len(ds))
        imageio.read_rgb(img_path)
        imageio.read_label(label_path)
    return rate, 1e3 * (time.perf_counter() - t0) / n


def native_against_default(train_set, args, tag):
    """The C++ augmentation (point-sampled) of each fixture sample against
    the default path (PIL's filter) on the same draws, uint8 on both: the
    share of equal labels, and the largest pixel difference where the image
    is enlarged, where PIL's triangle filter is bilinear interpolation too
    (it is antialiased when it shrinks)."""
    import numpy as np
    from pixelssl_tpu_torch.nn import imageio, native
    from pixelssl_tpu_torch.tasks.sseg import data as sseg_data

    ds = train_set.dataset
    crop, base = args.im_size, args.train_base_size
    worst_labels, worst_up, n_up = 1.0, 0, 0
    for idx in range(len(ds)):
        img_path, label_path = ds._paths(idx)
        image = imageio.read_rgb(img_path)
        key = (ds._seed, idx, 2000)
        (oh, ow), (y1, x1), flip = ds._geometry(np.random.default_rng(key),
                                                *image.shape[:2])
        rng = np.random.default_rng(key)
        ref_img, ref_lbl = sseg_data.random_scale_crop(
            rng, image, imageio.read_label(label_path), base, crop)
        if rng.random() < 0.5:
            ref_img, ref_lbl = ref_img[:, ::-1], ref_lbl[:, ::-1]
        out_img, out_lbl = native.decode_augment_sample_raw(
            img_path, label_path, (oh, ow), (y1, x1), flip, 0, crop)
        worst_labels = min(worst_labels, float((out_lbl == ref_lbl).mean()))
        if oh >= image.shape[0]:
            n_up += 1
            worst_up = max(worst_up, int(np.abs(
                out_img.astype(np.int32) - ref_img).max()))
    say('{0} C++ augment vs the default path on {1} samples (same draws): '
        'labels equal on >= {2:.5f} of the pixels; {3} enlarged samples, '
        'largest pixel difference {4}'.format(tag, len(ds), worst_labels,
                                              n_up, worst_up))
    if worst_labels < NATIVE_LABELS_EQUAL or worst_up > 1 or n_up == 0:
        raise AssertionError('the C++ augmentation differs from the default '
                             'path beyond its bound')


def phase_voc(tag, script, algo_name, launches_per_iter, multi=False,
              **flags):
    """One VOC phase: the script through ``run_script`` on the fixture
    tree with ``flags``, validation on the 4 val images; then 3 bare
    ``train_step`` calls on a batch of the run and the loader alone; with
    ``multi``, the run again at ``--steps-per-dispatch`` (``voc_multi``).
    cuDNN's autotuning is off, as a user runs the script. Returns the blur
    launches of the first run."""
    import statistics
    import tempfile

    import torch

    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as out:
            config, proxy, records, launches = run_script_phase(
                tag, script, algo_name, out, voc_config(script, out, **flags))
            iters = len(proxy.train_loader)
            if launches != launches_per_iter * iters:
                raise AssertionError('blur kernel launched {0} times in {1} '
                                     'iterations, expected {2}'.format(
                                         launches, iters,
                                         launches_per_iter * iters))
            val = [r for r in records if r['phase'] == 'val'][-1]
            if not all(0.0 <= v <= 1.0 for k, v in val.items()
                       if 'metric' in k):
                raise AssertionError('val scores {0}'.format(val))
            bare = bare_steps_ms(proxy.ssl_algorithm, proxy.train_loader,
                                 STEPS)
            train_set = proxy.train_loader.loader.dataset
            rate, decode_ms = loader_rate(train_set)
            say('{0} {1} more train_step calls on a batch on the card: {2} '
                'ms (median {3:.1f}); the loader alone: {4:.2f} samples/s '
                'a worker at {5} px ({6} workers); decoding a sample\'s JPEG '
                'and PNG alone {7:.2f} ms'.format(
                    tag, STEPS, ' '.join('{0:.1f}'.format(t) for t in bare),
                    statistics.median(bare), rate, config['im_size'],
                    config['num_workers'], decode_ms))
            if flags.get('native_augment'):
                native_against_default(train_set, proxy.args, tag)
            del proxy, train_set
        no_workers_left(tag)
        if multi:
            voc_multi(tag, script, algo_name, launches_per_iter, records,
                      flags)
            no_workers_left(tag)
    finally:
        torch.backends.cudnn.benchmark = True
    return launches


def voc_multi(tag, script, algo_name, launches_per_iter, plain_records,
              flags):
    """The VOC run of ``flags`` again at ``--steps-per-dispatch``
    ``MULTI_N``: its first step's losses equal to the plain run's first
    iteration, and ``script_graph_checks``."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        config = voc_config(script, out, steps_per_dispatch=MULTI_N, **flags)
        with watched_steps() as seen:
            _, proxy, records, launches = run_script_phase(
                tag, script, algo_name, out, config)
        plain = loss_values([r for r in plain_records
                             if r['phase'] == 'train'][0])
        say('{0} --steps-per-dispatch {1}: first step\'s losses {2}, the '
            'plain run\'s {3}; dispatch records: {4}'.format(
                tag, MULTI_N, seen['eager'][0], plain, [
                    loss_values(r) for r in records
                    if r['phase'] == 'train']))
        if seen['eager'][0] != plain:
            raise AssertionError('the first step\'s losses differ from the '
                                 'plain run\'s')
        script_graph_checks(tag, algo_name + ' at --steps-per-dispatch',
                            proxy, 1, launches_per_iter, launches)
        del proxy


# the sreg phase (23): the port's demo script, each algorithm that
# supports REGRESSION at the script's width (unet_lite base 32, 64 px,
# 64 samples, batch 1 + 1, Adam with the gradients clipped to norm 5);
# MT for the script's 4 epochs, the others for 1
SREG_SCRIPT = 'sreg_synthetic_sslmt.py'
SREG_EPOCHS = {'ssl_mt': 4, 'ssl_null': 1, 'ssl_adv': 1, 'ssl_gct': 1,
               'ssl_s4l': 1}
SREG_REFUSED = {
    'ssl_cct': dict(cons_scale=1.0, cons_rampup_epochs=1, ad_lr_scale=10.0,
                    vat_dec_num=1, drop_dec_num=1),
    'ssl_cutmix': dict(cons_scale=1.0, cons_rampup_epochs=1,
                       cons_threshold=0.1, ema_decay=0.99, batch_size=3,
                       unlabeled_batch_size=2)}


def load_sreg_demo():
    """The module globals of the port's sreg demo script."""
    import runpy

    return runpy.run_path(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'pixelssl_tpu_torch',
        'scripts', SREG_SCRIPT))


def sreg_blur_cases():
    """The blur calls of one GCT step of the sreg demo script."""
    config = load_sreg_demo()['make_config']('ssl_gct')
    return gct_blur_cases(config['batch_size'],
                          config['unlabeled_batch_size'], config['im_size'])


def run_sreg(tag, config):
    """``run_script`` of an sreg config on the card, the blur launches
    counted from 0 and the peak memory from a reset; every logged loss
    finite, every val MSE in [0, 1] and MAE and PSNR finite. Returns the
    proxy, the records and the blur launches."""
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.tasks import sreg

    log = os.path.join(config['out_path'], config['exp_id'], 'metrics.jsonl')
    earlier = len(read_records(config)) if os.path.exists(log) else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blur.launches = 0
    t0 = time.perf_counter()
    proxy = pixelssl_tpu_torch.run_script(
        config, sreg, sreg.PixelRegressionProxy, device='cuda',
        cli_override=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = blur.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    records = read_records(config)[earlier:]
    for r in records:
        if r['phase'] == 'train' and not all(
                math.isfinite(v) for k, v in r.items()
                if k.endswith('_loss')):
            raise AssertionError('non-finite loss: {0}'.format(r))
        if r['phase'] == 'val':
            for key, value in r.items():
                if key.endswith('_mse') and not 0.0 <= value <= 1.0:
                    raise AssertionError('{0} = {1}'.format(key, value))
                if ('metric' in key or key.endswith('_loss')) and \
                        not math.isfinite(value):
                    raise AssertionError('{0} = {1}'.format(key, value))
    for r in records:
        if r['phase'] == 'epoch_summary':
            its = [t for t in records if t['phase'] == 'train' and
                   t['epoch'] == r['epoch']]
            say('{0} epoch {1}: {2} iterations in {3:.3f} s, {4:.2f} ms an '
                'iteration; at each logged iteration, ms an iteration (of it '
                'waiting for the loader): {5}'.format(
                    tag, r['epoch'], r['iters'], r['wall_s'],
                    1e3 * r['wall_s'] / r['iters'], ' '.join(
                        '{0:.2f} ({1:.2f})'.format(1e3 * t['batch_time'],
                                                   1e3 * t['data_time'])
                        for t in its)))
    val = [r for r in records if r['phase'] == 'val']
    if not config.get('validation') and len(val) != config['epochs']:
        raise AssertionError('{0} val records'.format(len(val)))
    say('{0} {1}: run_script took {2:.1f} s; peak memory {3:.3f} GiB; blur '
        'launches {4}; last val: {5}'.format(
            tag, config['ssl_algorithm'], wall_s, peak_gib, launches,
            '  '.join('{0} {1:.5f}'.format(k, v) for k, v in sorted(
                val[-1].items()) if 'metric' in k or k.endswith('_loss'))))
    return proxy, records, launches


def phase_sreg():
    """The sreg demo through ``run_script`` for each of the five
    algorithms; MT rescored from its last checkpoint; GCT's blur launches
    counted (returned); CCT and CutMix refused by name."""
    import tempfile

    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sreg
    from pixelssl_tpu_torch.utils import logger

    tag = '[23/40]'
    demo = load_sreg_demo()
    gct_launches = None
    for algo_name in ('ssl_mt', 'ssl_null', 'ssl_adv', 'ssl_gct', 'ssl_s4l'):
        with tempfile.TemporaryDirectory() as out:
            config = demo['make_config'](algo_name, out,
                                         SREG_EPOCHS[algo_name])
            proxy, records, launches = run_sreg(tag, config)
            iters = len(proxy.train_loader)
            steps = proxy.ssl_algorithm.state.step
            if steps != iters * config['epochs']:
                raise AssertionError('{0} steps, expected {1}'.format(
                    steps, iters * config['epochs']))
            if algo_name == 'ssl_gct':
                if launches != BLUR_LAUNCHES_PER_STEP * iters:
                    raise AssertionError(
                        'blur kernel launched {0} times in {1} iterations, '
                        'expected {2}'.format(launches, iters,
                                              BLUR_LAUNCHES_PER_STEP * iters))
                gct_launches = launches
            elif launches != 0:
                raise AssertionError('{0} launched the blur kernel {1} '
                                     'times'.format(algo_name, launches))
            if algo_name in ('ssl_mt', 'ssl_gct'):
                # the launch-bound step alone: bare steps on a batch on the
                # card, and one under the profiler
                batch = next(iter(proxy.train_loader))
                bare = bare_steps_ms(proxy.ssl_algorithm, [batch], STEPS)
                say('{0} {1}: {2} more train_step calls on a batch on the '
                    'card: {3} ms'.format(tag, algo_name, STEPS, ' '.join(
                        '{0:.2f}'.format(t) for t in bare)))
                profile_step(proxy.ssl_algorithm, batch, bare, tag,
                             algo_name, top=5)
            if algo_name == 'ssl_mt':
                trained = [r for r in records if r['phase'] == 'val'][-1]
                ckpt = os.path.join(proxy.args.checkpoint_path,
                                    'checkpoint_{0}.pth'.format(
                                        config['epochs']))
                run_sreg(tag, demo['make_config'](
                    algo_name, out, config['epochs'], rescore=ckpt))
                rescored = read_records(config)[-1]
                keys = [k for k in trained
                        if 'metric' in k or k.endswith('_loss')]
                diff = max(abs(rescored[k] - trained[k]) for k in keys)
                say('{0} MT rescore from {1}: {2} scores, largest difference '
                    'from the training run {3:.3g} (atol {4:g})'.format(
                        tag, os.path.basename(ckpt), len(keys), diff,
                        RESCORE_ATOL))
                if not diff <= RESCORE_ATOL:
                    raise AssertionError('rescore differs by {0}'.format(
                        diff))
            del proxy
        torch.cuda.empty_cache()
    for algo_name, flags in SREG_REFUSED.items():
        with tempfile.TemporaryDirectory() as out:
            config = demo['make_config']('ssl_mt', out, 1)
            config.update(flags, ssl_algorithm=algo_name)
            try:
                pixelssl_tpu_torch.run_script(
                    config, sreg, sreg.PixelRegressionProxy, device='cuda',
                    cli_override=False)
            except logger.FatalError as exc:
                if algo_name not in str(exc) or 'regression' not in str(exc):
                    raise
                say('{0} {1} refused: {2}'.format(tag, algo_name, exc))
            else:
                raise AssertionError('{0} trained on sreg'.format(algo_name))
    return gct_launches


# the optimizer phase (24): each new update rule with an epoch-wise
# schedule, 3 MT steps on the card and on the CPU from the same weights
# and batch (ResNet-10, 96 px, float32, as phase 6), one iteration an
# epoch so that the schedules move every step
OPTIMIZER_CASES = (
    ('rmsprop', dict(optimizers={'model': 'rmsprop'}, lr=1e-5,
                     centered=True, momentum=0.9,
                     lrers={'model': 'steplr'}, step_size=1, gamma=0.5)),
    ('adam', dict(optimizers={'model': 'adam'}, lr=1e-5, weight_decay=5e-4,
                  lrers={'model': 'multisteplr'}, milestones=[1, 2],
                  gamma=0.3)),
    ('wdadam', dict(optimizers={'model': 'wdadam'}, lr=1e-5,
                    weight_decay=1e-2, amsgrad=True, clip_grad_norm=1.0,
                    bf16_opt_state=True,
                    lrers={'model': 'cosineannealinglr'}, T_max=4)),
)


def phase_optimizers(seed, steps):
    """The three configurations card against CPU: losses rtol 2e-3
    (cons_loss rtol 2e-2, atol 1e-6); then each side's checkpoint loaded
    into a fresh build, whose optimizer state keeps its dtype (bf16 with
    ``--bf16-opt-state``)."""
    import tempfile

    import torch
    from pixelssl_tpu_torch import harness

    tag = '[24/40]'
    for name, flags in OPTIMIZER_CASES:
        args = harness.default_args('ssl_mt', **dict(
            MT_CONFIG, backbone='resnet10', im_size=96, num_classes=5,
            epochs=4, bf16=False, seed=seed, batch_size=4,
            unlabeled_batch_size=2, momentum=flags.get('momentum', -1),
            weight_decay=flags.get('weight_decay', -1), **{
                k: v for k, v in flags.items()
                if k not in ('momentum', 'weight_decay')}))
        rows, dtypes = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for device in ('cpu', 'cuda'):
                algo = harness.build_algorithm(args, device=device,
                                               iters_per_epoch=1)
                batch = harness.synthetic_batch(args, device=device,
                                                seed=seed)
                rows[device] = [{k: float(v) for k, v in
                                 algo.train_step(batch).items()}
                                for _ in range(steps)]
                path = algo.save_checkpoint(
                    steps, path=os.path.join(tmp, device + '.pth'))
                fresh = harness.build_algorithm(args, device=device,
                                                iters_per_epoch=1)
                fresh.load_checkpoint(path)
                dtypes[device] = sorted({
                    str(v.dtype) for st in fresh.opt.state.values()
                    for k, v in st.items() if torch.is_tensor(v)})
        want = ['torch.bfloat16' if args.bf16_opt_state else 'torch.float32']
        if dtypes['cpu'] != want or dtypes['cuda'] != want:
            raise AssertionError('{0} optimizer state after a load: {1}, '
                                 'expected {2}'.format(name, dtypes, want))
        worst = 0.0
        for s, (ref_row, got_row) in enumerate(zip(rows['cpu'],
                                                   rows['cuda'])):
            for key, ref in ref_row.items():
                rtol, atol = (2e-2, 1e-6) if key == 'cons_loss' else (2e-3,
                                                                      1e-6)
                got = got_row[key]
                worst = max(worst, abs(got - ref) / max(abs(ref), 1e-12))
                if not math.isclose(got, ref, rel_tol=rtol, abs_tol=atol):
                    raise AssertionError(
                        '{0} step {1}: {2} on the card {3} vs CPU {4}'.format(
                            name, s, key, got, ref))
        say('{0} MT with {1} ({2}; {3}) card vs CPU agree over {4} steps, '
            'largest relative metric difference {5:.3g}; lr by step: {6}; '
            'optimizer state after a checkpoint round trip: {7} on both'
            .format(tag, name, ', '.join(
                '{0} {1}'.format(k, v) for k, v in sorted(flags.items())
                if k not in ('optimizers', 'lrers')), args.lrers['model'],
                steps, worst, ' '.join('{0:.3g}'.format(r['lr'])
                                       for r in rows['cuda']), want[0]))


def bn_stats(module):
    return {k: v.detach().float().clone() for k, v in
            module.state_dict().items() if 'running_' in k}


def calibrate_bn(algo, batch):
    """The student's BN running statistics set to the batch's own (one
    train-mode forward at momentum 1, no gradient), and the teacher made
    its copy: a frozen ResNet-101 from random weights and the init's
    statistics (0, 1) overflows within a step, as it would in the JAX
    package."""
    import torch

    net = algo.model.net
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    net.train(True)
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        algo.model(tuple(batch['inp']))
    for bn in bns:
        bn.momentum = 0.1
    algo.model.train()
    algo.teacher.load_state_dict(algo.model.state_dict())
    if net.training:
        raise AssertionError('--freeze-bn left the net in train mode')


def largest_loss_gap(a, b):
    """The largest relative difference of two runs' losses, step by step."""
    return max(abs(y[k] - x[k]) / max(abs(x[k]), 1e-12)
               for x, y in zip(a, b) for k in x if k.endswith('_loss'))


def f32_steps(seed, steps, **flags):
    """``steps`` MT steps of the full-width recipe in float32 with cuDNN
    deterministic: each step's losses, and the student's BN running
    statistics after step 1."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        args = full_width_args('ssl_mt', seed, batch_size=8,
                               unlabeled_batch_size=4,
                               **dict(MT_CONFIG, bf16=False, **flags))
        algo, batch = build_full_width(
            args, '[25/40]', 'MT float32 ' + (' '.join(sorted(flags)) or
                                              'plain'))
        losses, stats = [], None
        for s in range(steps):
            metrics = algo.train_step(batch)
            losses.append({k: float(v) for k, v in metrics.items()
                           if k.endswith('_loss')})
            if not all(math.isfinite(v) for v in losses[-1].values()):
                raise AssertionError('non-finite losses {0}'.format(
                    losses[-1]))
            if s == 1:
                stats = bn_stats(algo.model)
        del algo, batch
        torch.cuda.empty_cache()
        return {'losses': losses, 'stats': stats}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True


def phase_sseg_flags(seed, steps):
    """The sseg model flags at full width (DeepLab-v2/ResNet-101 @321, MT
    4 + 4, the 1-8 recipe): in bf16 as the recipe runs, the step time and
    peak memory with ``--remat``, ``--bf16-opt-state`` and ``--freeze-bn``
    beside the plain run's; ``--remat`` held to the plain run in float32
    (``f32_steps``);
    ``--freeze-bn`` leaving the statistics; ``--pretrained-path`` loading
    a torch ResNet-101 checkpoint written from ``--seed``."""
    import statistics
    import tempfile

    import torch
    from pixelssl_tpu_torch.models.resnet import resnet101

    tag = '[25/40]'
    runs = {}
    for label, flags in (('plain', {}), ('remat', dict(remat=True)),
                         ('bf16_opt_state', dict(bf16_opt_state=True)),
                         ('freeze_bn', dict(freeze_bn=True))):
        args = full_width_args('ssl_mt', seed, batch_size=8,
                               unlabeled_batch_size=4,
                               **dict(MT_CONFIG, **flags))
        algo, batch = build_full_width(args, tag, 'MT ' + label)
        if label == 'freeze_bn':
            calibrate_bn(algo, batch)
        before = bn_stats(algo.model)
        history, step_ms, _ = timed_steps(
            algo, batch, steps, tag, 'MT ' + label,
            ('s_task_loss', 't_task_loss'))
        runs[label] = dict(history=history, step_ms=step_ms,
                           peak=torch.cuda.max_memory_allocated(),
                           before=before, after=bn_stats(algo.model))
        if label == 'bf16_opt_state':
            dtypes = {v.dtype for st in algo.opt.state.values()
                      for v in st.values() if torch.is_tensor(v)}
            if dtypes != {torch.bfloat16}:
                raise AssertionError('optimizer state {0}'.format(dtypes))
        del algo, batch
        torch.cuda.empty_cache()

    for label, run in runs.items():
        say('{0} {1}: median step {2:.1f} ms over the steps after the first; '
            'peak memory over the steps after the first {3:.3f} GiB'.format(
                tag, label, statistics.median(run['step_ms'][1:]),
                run['peak'] / 2 ** 30))
    # remat against plain in float32 with cuDNN deterministic, beside a
    # second plain run: at the recipe's lr from random weights the card's
    # own run-to-run spread grows from ~1e-6 on step 1 to about 1% on step 2
    # (the resize's backward sums with atomics), so steps 0-1 and the BN
    # statistics after them are held, and step 2 is printed beside the
    # spread
    f32 = {label: f32_steps(seed, steps, **flags) for label, flags in (
        ('plain', {}), ('plain2', {}), ('remat', dict(remat=True)))}
    for s_ in range(2):
        for key, value in f32['plain']['losses'][s_].items():
            got = f32['remat']['losses'][s_][key]
            if not math.isclose(got, value, rel_tol=2e-3, abs_tol=1e-6):
                raise AssertionError('remat step {0}: {1} {2} vs {3}'.format(
                    s_, key, got, value))
    # atol 1e-4 with rtol 1e-4 beside it, as tests/test_torch_gct.py
    # holds the statistics: the deep layers' running variances reach O(10)
    worst = max(float(((f32['plain']['stats'][k] - f32['remat']['stats'][k])
                       .abs() / (1e-4 + 1e-4 * f32['plain']['stats'][k]
                                 .abs())).max())
                for k in f32['plain']['stats'])
    if not worst <= 1.0:
        raise AssertionError('remat BN statistics differ by {0} x their '
                             'tolerance'.format(worst))

    def gaps(a, b):
        return ' '.join('{0:.3g}'.format(largest_loss_gap([x], [y]))
                        for x, y in zip(f32[a]['losses'], f32[b]['losses']))

    say('{0} remat against plain in float32, cuDNN deterministic: largest '
        'relative loss difference by step {1} (steps 0-1 within rtol '
        '2e-3), BN running statistics after step 1 apart by {2:.3g} of '
        'their tolerance (atol 1e-4, rtol 1e-4); a second plain run against the first, by step: {3}; in '
        'bf16, remat against plain {4:.3g}, and at step 1 the bf16 optimizer '
        'state against plain {5:.3g} (its step 0 updates the weights as '
        'plain does); bf16 step ms {6:.1f} with remat against {7:.1f}, peak '
        '{8:.3f} against {9:.3f} GiB, {10:.3f} GiB with the bf16 optimizer '
        'state'.format(
            tag, gaps('plain', 'remat'), worst, gaps('plain', 'plain2'),
            largest_loss_gap(runs['plain']['history'],
                             runs['remat']['history']),
            largest_loss_gap(runs['plain']['history'][1:2],
                             runs['bf16_opt_state']['history'][1:2]),
            statistics.median(runs['remat']['step_ms'][1:]),
            statistics.median(runs['plain']['step_ms'][1:]),
            runs['remat']['peak'] / 2 ** 30, runs['plain']['peak'] / 2 ** 30,
            runs['bf16_opt_state']['peak'] / 2 ** 30))
    frozen, plain = runs['freeze_bn'], runs['plain']
    moved = [k for k in frozen['before']
             if not torch.equal(frozen['before'][k], frozen['after'][k])]
    if moved:
        raise AssertionError('--freeze-bn moved {0}'.format(moved[:3]))
    if all(torch.equal(plain['before'][k], plain['after'][k])
           for k in plain['before']):
        raise AssertionError('the plain run moved no BN statistics')
    say('{0} freeze_bn (statistics calibrated on the batch first): all {1} '
        'running statistics unchanged after {2} steps'.format(
            tag, len(frozen['before']), steps))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'resnet101.pth')
        net = resnet101(16)
        generator = torch.Generator().manual_seed(seed + 7)
        state = {k: (torch.randn(v.shape, generator=generator)
                     if v.is_floating_point() else v)
                 for k, v in net.state_dict().items()}
        state['fc.weight'] = torch.randn(1000, 2048, generator=generator)
        state['fc.bias'] = torch.zeros(1000)
        torch.save(state, path)
        args = full_width_args('ssl_mt', seed, batch_size=8,
                               unlabeled_batch_size=4, pretrained_path=path,
                               **MT_CONFIG)
        algo, _ = build_full_width(args, tag, 'MT pretrained_path')
        ours = algo.model.state_dict()
        backbone = [k for k in ours if k.startswith('net.backbone.') and
                    not k.endswith('num_batches_tracked')]
        copied = sum(torch.equal(ours[k].cpu(), state[k[len('net.backbone.'):]])
                     for k in backbone)
        teacher = algo.teacher.state_dict()
        same_teacher = all(torch.equal(teacher[k].float(), ours[k].float())
                           for k in backbone)
    say('{0} pretrained_path: {1} of the backbone\'s {2} tensors copied '
        'from a torch ResNet-101 checkpoint ({3} keys, fc included); the '
        'teacher starts from them: {4}'.format(
            tag, copied, len(backbone), len(state), same_teacher))
    if copied != len(backbone) or not same_teacher:
        raise AssertionError('pretrained backbone: {0} of {1} copied'.format(
            copied, len(backbone)))
    del algo
    torch.cuda.empty_cache()


# phase 26: the multi-step path (--steps-per-dispatch) at full width
MULTI_N = 4        # steps a dispatch
MULTI_BATCHES = 9  # two dispatches and a tail of one
# a graph step's gaps to an eager step may be at most this many times an
# eager step's to another from the same state, or the floor below: the
# card's own spread, measured in the phase (the bilinear resize's
# backward adds with atomics, so no two steps update alike)
SPREAD_FACTOR = 2.0
GAP_FLOOR = 1e-5
MULTI_EQUAL = (
    ('ssl_null', 'SupOnly', NULL_CONFIG, (4, 0), ('task_loss',)),
    ('ssl_mt', 'MT', dict(MT_CONFIG, gaussian_noise_std=0.1), (8, 4),
     ('s_task_loss', 't_task_loss')),
    ('ssl_gct', 'GCT', GCT_CONFIG, (8, 4),
     ('l_task_loss', 'r_task_loss', 'l_fd_loss', 'r_fd_loss')),
)
MULTI_TIMED = (
    ('ssl_null', 'SupOnly', NULL_CONFIG, 'deeplabv2', (4, 0)),
    ('ssl_mt', 'MT', MT_CONFIG, 'deeplabv2', (8, 4)),
    ('ssl_gct', 'GCT', GCT_CONFIG, 'deeplabv2', (8, 4)),
    ('ssl_adv', 'AdvSSL', ADV_CONFIG, 'deeplabv2', (8, 4)),
    ('ssl_s4l', 'S4L', S4L_CONFIG, 'deeplabv2', (8, 4)),
    ('ssl_cutmix', 'CutMix', CUTMIX_CONFIG, 'pspnet', (6, 4)),
    ('ssl_cct', 'CCT', CCT_CONFIG, 'pspnet', (4, 2)),
)


def multi_batches(args, seed, n):
    from pixelssl_tpu_torch import harness
    return [harness.synthetic_batch(args, seed=seed + i) for i in range(n)]


def optimizer_counters(algo):
    """Each optimizer's update counts and group lrs, as numbers."""
    return {key: ([float(st['step']) for st in opt.state.values() if st],
                  [float(g['lr']) for g in opt.param_groups])
            for key, opt in algo.optimizers.items()}


def eager_run(algo, batches):
    """One ``train_step`` a batch; each step's metrics and ms (CUDA
    events)."""
    import torch
    rows, times = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = algo.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        rows.append({k: float(v) for k, v in metrics.items()})
    return rows, times


def graph_run(algo, batches, n):
    """``batches`` as ``_train_multi`` takes them: ``train_steps`` on each
    n of them, the tail one ``train_step`` at a time; {step index: metrics}
    at every step (``history``), and each dispatch's ms."""
    import torch
    from pixelssl_tpu_torch.nn.loader import chunked
    history, times = [], []
    for kind, payload in chunked(batches, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if kind == 'chunk':
            algo.train_steps(payload, history)
        else:
            history.append(algo.train_step(payload))
        end.record()
        torch.cuda.synchronize()
        times.append((kind, start.elapsed_time(end)))
    rows = {s: {k: float(v) for k, v in m.items()}
            for s, m in enumerate(history)}
    return rows, times


def update_gap(before, a, b):
    """How far two updates of the same parameters part: ``|a - b|`` over
    ``|a - before|``, L2 norms over all parameters."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in a)
    den = sum(float((a[k] - before[k]).double().square().sum()) for k in a)
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def float_params(algo):
    return {'{0}.{1}'.format(key, name): p.detach().float().clone()
            for key, m in algo.modules.items()
            for name, p in m.named_parameters()}


def busy_share(fn, wall_ms=None):
    """Kernel time of ``fn()`` under ``torch.profiler`` over ``wall_ms``
    (by default ``fn``'s own time between CUDA events); (kernel ms,
    launches, share), or None if the profiler saw no device time."""
    import torch
    timed = {}

    def timed_fn():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        timed['ms'] = start.elapsed_time(end)

    events = profile_kernels(timed_fn)
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events or total_ms <= 0:
        return None
    wall = timed['ms'] if wall_ms is None else wall_ms
    return total_ms, sum(e.count for e in events), total_ms / wall


def generator_draws_match(algo):
    """The captured step's generator against ``_step_rng``'s: a graph of
    MT's input noise, replayed after seeding its registered generator as
    ``CapturedStep.run`` does, draws what the eager noise of the same step
    draws, bit for bit."""
    import torch
    from pixelssl_tpu_torch.nn.module.gaussian_noise import gaussian_noise

    x = torch.randn((2, 3, 64, 64), device='cuda')
    generator = torch.Generator(device='cuda')
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = gaussian_noise(x, 0.1, generator)
    worst = 0.0
    for step in (0, 1, 7):
        for salt in (0, 1):
            generator.manual_seed(algo._step_seed(step, salt))
            graph.replay()
            eager = gaussian_noise(x, 0.1, torch.Generator(
                device='cuda').manual_seed(algo._step_seed(step, salt)))
            worst = max(worst, float((out - eager).abs().max()))
    return worst


def adam_graph_gap(steps=5):
    """The FD's and D's Adam (``nn.optimizer.Adam``, torch's capturable
    step on the card) stepped eagerly with a Python lr, against the same
    Adam's step captured into a CUDA graph with the lr a ``StepScalars``
    slot, replayed after an eager first step: the largest difference of
    the parameters, moments and update counts after ``steps`` steps of
    the same gradients and poly lrs (0 is equal bit for bit)."""
    import torch
    from pixelssl_tpu_torch.nn.optimizer import Adam
    from pixelssl_tpu_torch.ssl_algorithm.ssl_base import StepScalars

    gen = torch.Generator(device='cuda').manual_seed(0)
    shapes = ((64, 128, 4, 4), (64,), (1, 64, 4, 4), (1,))
    init = [torch.randn(s, device='cuda', generator=gen) for s in shapes]
    grads = [[torch.randn(s, device='cuda', generator=gen) for s in shapes]
             for _ in range(steps)]
    lrs = [1e-4 * (1 - k / 10.0) ** 0.9 for k in range(steps)]

    def make():
        params = [torch.nn.Parameter(t.clone()) for t in init]
        return params, Adam(params, lr=lrs[0], betas=(0.9, 0.99), eps=1e-8)

    eager, eager_opt = make()
    for k in range(steps):
        for p, g in zip(eager, grads[k]):
            p.grad = g.clone()
        eager_opt.param_groups[0]['lr'] = lrs[k]
        eager_opt.step()

    params, opt = make()
    static = [torch.zeros_like(t) for t in init]
    for p, g in zip(params, static):
        p.grad = g
    torch._foreach_copy_(static, grads[0])
    opt.step()
    scalars = StepScalars('cuda')
    at = [1]
    scalars.begin()
    opt.param_groups[0]['lr'] = scalars.get(lambda: lrs[at[0]])
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(graph):
            opt.step()
    finally:
        fns = scalars.end()
    for k in range(1, steps):
        at[0] = k
        torch._foreach_copy_(static, grads[k])
        scalars.refill(fns)
        graph.replay()
    torch.cuda.synchronize()
    worst = 0.0
    for p, q in zip(eager, params):
        a, b = eager_opt.state[p], opt.state[q]
        for x, y in ((p, q), (a['exp_avg'], b['exp_avg']),
                     (a['exp_avg_sq'], b['exp_avg_sq']),
                     (a['step'], b['step'])):
            worst = max(worst, float((x - y).abs().max()))
    return worst


def phase_multi_step(seed):
    """``--steps-per-dispatch`` at full width (DeepLab-v2/ResNet-101
    @321): SupOnly 4+0, MT 8+4 (with input noise: the per-step generators)
    and GCT 8+4 in float32 with cuDNN deterministic and no autotuning.
    Nine steps from the same weights and batches, twice eagerly and once
    through ``train_steps`` (n = 4: two dispatches, the first an eager
    step, the capture and 3 replays, then a tail of one eager step):
    ``state.step`` 9 and the blur count 6 a GCT step on every run, every
    loss finite, the first step's losses equal (both eager from the same
    state), the later gaps printed beside the eager runs' own: from random
    weights one step's atomic sums grow into percents within a few steps
    (on an NVIDIA H100 80GB HBM3), so the runs are held one step at a
    time. One
    step from the state the graph run ended in, replayed and eager twice:
    the replay's losses and parameter update within ``SPREAD_FACTOR`` of
    the two eager steps' own gap (or ``GAP_FLOOR``), its lr equal; and
    MT's captured noise equal to the eager noise of the same steps; the
    FD's and D's Adam captured against eager (``adam_graph_gap``), equal
    bit for bit. Then all seven algorithms at their full-width batches
    in bf16 (``MULTI_TIMED``): three eager steps and two dispatches, every
    loss finite, each one's ms a step eager and replayed and the device's
    busy share of both (``torch.profiler``). Returns the blur launches of
    GCT's graph run."""
    import torch
    from pixelssl_tpu_torch.bench import restore, snapshot
    from pixelssl_tpu_torch.ops import blur

    tag = '[26/40]'
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for algo_name, what, config, (bs, ubs), positive in MULTI_EQUAL:
            args = full_width_args(algo_name, seed, batch_size=bs,
                                   unlabeled_batch_size=ubs,
                                   **dict(config, bf16=False))
            algo, _ = build_full_width(args, tag, what + ' float32')
            batches = multi_batches(args, seed, MULTI_BATCHES + 1)
            snap = snapshot(algo)
            before = float_params(algo)
            runs = {}
            for label in ('eager_a', 'eager_b', 'graph'):
                restore(algo, snap, 0)
                blur.launches = 0
                if label == 'graph':
                    rows, times = graph_run(algo, batches[:MULTI_BATCHES],
                                            MULTI_N)
                else:
                    rows, times = eager_run(algo, batches[:MULTI_BATCHES])
                    rows = dict(enumerate(rows))
                runs[label] = dict(rows=rows, times=times,
                                   params=float_params(algo),
                                   launches=blur.launches,
                                   step=algo.state.step,
                                   counters=optimizer_counters(algo))
            per_step = (BLUR_LAUNCHES_PER_STEP if algo_name == 'ssl_gct'
                        else 0)
            check_multi(tag, what, runs, before, positive, per_step)
            if algo_name == 'ssl_gct':
                graph_launches = runs['graph']['launches']
            check_one_step(tag, what + ' float32', algo,
                           batches[MULTI_BATCHES], per_step)
            if algo_name == 'ssl_mt':
                worst = generator_draws_match(algo)
                say('{0} MT input noise from the graph\'s registered '
                    'generator against _step_rng\'s, steps 0/1/7, salts '
                    '0/1: largest difference {1:g}'.format(tag, worst))
                if worst != 0.0:
                    raise AssertionError('captured draws differ by '
                                         '{0}'.format(worst))
            del algo
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
    worst = adam_graph_gap()
    say('{0} the FD\'s and D\'s Adam, 5 steps eager against an eager step '
        'and 4 replays of its captured step (lr from StepScalars): '
        'parameters, moments and counts apart by at most {1:g}'.format(
            tag, worst))
    if worst != 0.0:
        raise AssertionError('the captured Adam step differs by {0}'.format(
            worst))

    table = []
    for algo_name, what, config, model, (bs, ubs) in MULTI_TIMED:
        args = full_width_args(algo_name, seed, model=model, batch_size=bs,
                               unlabeled_batch_size=ubs, **config)
        algo, _ = build_full_width(args, tag, what)
        batches = multi_batches(args, seed, 2 * MULTI_N + 3)
        blur.launches = 0
        rows, eager_times = eager_run(algo, batches[:3])
        graph_rows, graph_times = graph_run(algo, batches[3:], MULTI_N)
        for row in rows + list(graph_rows.values()):
            bad = [k for k, v in row.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError('{0}: non-finite {1}'.format(what, bad))
        steps = 3 + 2 * MULTI_N
        if algo.state.step != steps:
            raise AssertionError('{0}: state.step {1}'.format(
                what, algo.state.step))
        per_step = BLUR_LAUNCHES_PER_STEP if algo_name == 'ssl_gct' else 0
        if blur.launches != per_step * steps:
            raise AssertionError('{0}: blur launches {1}, expected '
                                 '{2}'.format(what, blur.launches,
                                              per_step * steps))
        say('{0} {1} bf16: 3 eager steps then 2 dispatches of {2}, '
            'state.step {3}, blur launches {4}; last metrics {5}'.format(
                tag, what, MULTI_N, algo.state.step, blur.launches,
                '  '.join('{0} {1:.6g}'.format(k, v) for k, v in sorted(
                    graph_rows[len(graph_rows) - 1].items()))))
        runs = {'eager_a': dict(times=eager_times),
                'graph': dict(times=graph_times)}
        table.append(time_both(tag, what + ' bf16', algo, batches, runs))
        del algo
        torch.cuda.empty_cache()
    say('{0} ms a step, eager (median after the first) / replayed (the '
        'second dispatch over its {1} steps), and the device\'s busy share '
        'of each (torch.profiler): {2}'.format(tag, MULTI_N, '; '.join(
            table)))
    return graph_launches


def check_multi(tag, what, runs, before, positive, blur_per_step):
    """The 9-step runs of ``phase_multi_step``."""
    a, b, g = runs['eager_a'], runs['eager_b'], runs['graph']
    for label, run in runs.items():
        if run['step'] != MULTI_BATCHES:
            raise AssertionError('{0} {1}: state.step {2}'.format(
                what, label, run['step']))
        if run['launches'] != blur_per_step * MULTI_BATCHES:
            raise AssertionError('{0} {1}: blur launches {2}, expected '
                                 '{3}'.format(what, label, run['launches'],
                                              blur_per_step * MULTI_BATCHES))
        for step, row in run['rows'].items():
            for key, value in row.items():
                if not math.isfinite(value) or (
                        key in positive and not value > 0):
                    raise AssertionError('{0} {1} step {2}: {3} = {4}'.format(
                        what, label, step, key, value))
    lrs = [(a['rows'][step]['lr'], g['rows'][step]['lr'])
           for step in range(MULTI_BATCHES)]
    if any(x != y for x, y in lrs):
        raise AssertionError('{0}: lr by step, eager / graph: {1}'.format(
            what, lrs))
    for key, (counts, group_lrs) in a['counters'].items():
        if (counts, group_lrs) != g['counters'][key]:
            raise AssertionError(
                '{0}: optimizer {1} after the runs, eager counts {2} and '
                'lrs {3}, graph {4}'.format(what, key, sorted(set(counts)),
                                            group_lrs, g['counters'][key]))
    lines = []
    for step in range(MULTI_BATCHES):
        gap_g = largest_loss_gap([a['rows'][step]], [g['rows'][step]])
        gap_b = largest_loss_gap([a['rows'][step]], [b['rows'][step]])
        lines.append('{0:.3g} ({1:.3g})'.format(gap_g, gap_b))
        if step == 0 and (gap_g or gap_b):
            raise AssertionError('{0}: the first step\'s losses differ: '
                                 '{1:.3g} / {2:.3g}'.format(what, gap_g,
                                                            gap_b))
    say('{0} {1} float32, 9 steps, state.step 9 and blur launches {2} / '
        '{3} / {4} (eager, eager, graph); every step\'s lr, and the '
        'optimizers\' update counts and group lrs after the runs, equal '
        '({8}); relative loss gap to the first eager run by step, graph '
        '(second eager run): {5}; update after 9 steps apart by {6:.3g} '
        '({7:.3g})'.format(
            tag, what, a['launches'], b['launches'], g['launches'],
            ', '.join(lines), update_gap(before, a['params'], g['params']),
            update_gap(before, a['params'], b['params']),
            ', '.join('{0} counts {1}'.format(k, sorted(set(c)))
                      for k, (c, _) in sorted(a['counters'].items()))))


def check_one_step(tag, what, algo, batch, blur_per_step):
    """One step from the state the graph run ended in: a replay, and an
    eager step twice, each from that state; the replay's losses and
    parameter update against the first eager step's, within the two
    eager steps' own gap."""
    import torch
    from pixelssl_tpu_torch.bench import restore, snapshot
    from pixelssl_tpu_torch.ops import blur

    snap = snapshot(algo)
    step = algo.state.step
    before = float_params(algo)
    out = {}
    for label in ('graph', 'eager_a', 'eager_b'):
        restore(algo, snap, step)
        blur.launches = 0
        if label == 'graph':
            metrics = algo.train_steps([batch])
        else:
            metrics = algo.train_step(batch)
        torch.cuda.synchronize()
        out[label] = dict(losses={k: float(v) for k, v in metrics.items()},
                          params=float_params(algo), launches=blur.launches)
        if algo.state.step != step + 1 or blur.launches != blur_per_step:
            raise AssertionError('{0} {1}: step {2}, blur launches {3}'
                                 .format(what, label, algo.state.step,
                                         blur.launches))
    a, b, g = out['eager_a'], out['eager_b'], out['graph']
    loss_g = largest_loss_gap([a['losses']], [g['losses']])
    loss_b = largest_loss_gap([a['losses']], [b['losses']])
    lr_equal = a['losses']['lr'] == g['losses']['lr']
    upd_g = update_gap(before, a['params'], g['params'])
    upd_b = update_gap(before, a['params'], b['params'])
    say('{0} {1}, one step from the state at step {2}, replayed '
        'against eager (a second eager step against the first): losses '
        'apart by {3:.3g} ({4:.3g}), updates by {5:.3g} ({6:.3g}); lr '
        'equal: {7}'.format(tag, what, step, loss_g, loss_b, upd_g, upd_b,
                            lr_equal))
    if not lr_equal or not loss_g <= max(SPREAD_FACTOR * loss_b,
                                         GAP_FLOOR) or \
            not upd_g <= max(SPREAD_FACTOR * upd_b, GAP_FLOOR):
        raise AssertionError('{0}: the replayed step parts from the eager '
                             'one beyond their own spread'.format(what))


def time_both(tag, what, algo, batches, runs):
    """'what eager ms / replayed ms (busy share eager / replayed)' from
    the runs' times, one profiled eager step (its kernel time over the
    median eager step) and one profiled replay (over its own time)."""
    import statistics

    eager_ms = statistics.median(runs['eager_a']['times'][1:])
    chunk_ms = [t for kind, t in runs['graph']['times'] if kind == 'chunk']
    replay_ms = chunk_ms[1] / MULTI_N
    eager_busy = busy_share(lambda: algo.train_step(batches[0]), eager_ms)
    graph_busy = busy_share(lambda: algo.train_steps(batches[:1]))

    def fmt(busy):
        return 'no device time seen' if busy is None else \
            '{0:.1f}% ({1:.2f} ms in {2} launches)'.format(
                100.0 * busy[2], busy[0], busy[1])
    say('{0} {1}: {2:.2f} ms a step eager, {3:.2f} replayed ({4:.2f}x); '
        'busy eager {5}, replayed {6}'.format(
            tag, what, eager_ms, replay_ms, eager_ms / replay_ms,
            fmt(eager_busy), fmt(graph_busy)))
    return '{0} {1:.2f} / {2:.2f} ({3} / {4})'.format(
        what, eager_ms, replay_ms,
        '-' if eager_busy is None else '{0:.0f}%'.format(100 * eager_busy[2]),
        '-' if graph_busy is None else '{0:.0f}%'.format(100 * graph_busy[2]))


def trace_kernels(path):
    """(kernel launches, their summed ms, the span of the profiled steps
    in ms) of a Chrome trace of ``utils.profiler``."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    steps = [e for e in events
             if e.get('name', '').startswith('ProfilerStep#') and 'dur' in e]
    span_us = (max(e['ts'] + e['dur'] for e in steps) -
               min(e['ts'] for e in steps)) if steps else 0.0
    return (len(kernels), sum(e.get('dur', 0) for e in kernels) / 1e3,
            span_us / 1e3, len({e['name'] for e in steps}))


# phase 27: 17 iterations an epoch at 2+2 (34 labeled samples of 68): 4
# dispatches of MULTI_N and a tail of one; the window holds dispatches 1-2
PROFILE_SAMPLES = 68
PROFILE_DISPATCHES = 2


def phase_profile_dir():
    """``--profile-dir`` on the 1-8 MT script at the phase-10 config (2+2
    @321, synthetic data) with ``--steps-per-dispatch`` ``MULTI_N``: 2
    epochs of 17 iterations, each validated and checkpointed,
    ``--profile-steps`` ``PROFILE_DISPATCHES``: one Chrome trace with the
    window's dispatches; its kernel count, their device time and the busy
    share of the window; then ``script_graph_checks``."""
    import glob
    import tempfile

    tag = '[27/40]'
    with tempfile.TemporaryDirectory() as out:
        prof_dir = os.path.join(out, 'prof')
        config = script_config(SCRIPT_MT, out, 'ssl_mt', PROFILE_SAMPLES)
        config.update(epochs=2, profile_dir=prof_dir,
                      profile_steps=PROFILE_DISPATCHES,
                      steps_per_dispatch=MULTI_N)
        _, proxy, _, launches = run_script_phase(tag, SCRIPT_MT, 'ssl_mt',
                                                 out, config)
        ckpts = sorted(os.listdir(proxy.args.checkpoint_path))
        script_graph_checks(tag, 'MT script', proxy, 2, 0, launches)
        del proxy
        traces = glob.glob(os.path.join(prof_dir, '*.json'))
        if len(traces) != 1:
            raise AssertionError('{0} traces in {1}'.format(len(traces),
                                                            prof_dir))
        n, kernel_ms, span_ms, steps = trace_kernels(traces[0])
        size_mib = os.path.getsize(traces[0]) / 2 ** 20
    say('{0} --profile-dir at --steps-per-dispatch {1}: one trace of {2:.1f} '
        'MiB, {3} profiled dispatches, {4} kernel launches, {5:.2f} ms of '
        'device time in a {6:.2f} ms window: busy {7:.1f}%; checkpoints '
        '{8}'.format(tag, MULTI_N, size_mib, steps, n, kernel_ms, span_ms,
                     100.0 * kernel_ms / max(span_ms, 1e-9), ckpts))
    if steps != PROFILE_DISPATCHES or n == 0:
        raise AssertionError('the trace holds {0} dispatches and {1} kernels'
                             .format(steps, n))
    if ckpts != ['checkpoint_1.pth', 'checkpoint_2.pth']:
        raise AssertionError('checkpoints {0}'.format(ckpts))
    no_workers_left(tag)


def batch_sums(batch):
    """One float64 sum a tensor of a batch (a sync: untimed phases only)."""
    return tuple(float(t.double().sum()) for key in ('inp', 'gt')
                 for t in batch[key])


INGEST_RUNS = (('plain', False, 1), ('eager', True, 1), ('plain2', False, 1),
               ('graph', False, MULTI_N), ('graph_eager', True, MULTI_N))


def phase_eager_ingest():
    """The phase-10 script config, 1 epoch of 5 iterations, run five times
    (``INGEST_RUNS``): plain, with ``--eager-ingest``, plain again, then at
    ``--steps-per-dispatch`` ``MULTI_N`` (a dispatch and a tail) without
    and with it. Every batch a step takes is the same in all five (its
    sums, bit for bit), and so are the first step's losses; the later
    losses are printed beside the two plain runs' own gap, not held: the
    bilinear resize's backward adds with atomics, so two plain runs part
    after the first update and grow apart by percents on an NVIDIA H100
    80GB HBM3. Each graph run passes ``script_graph_checks``."""
    import tempfile

    tag = '[28/40]'
    runs = {}
    for label, eager, n in INGEST_RUNS:
        with tempfile.TemporaryDirectory() as out:
            config = script_config(SCRIPT_MT, out, 'ssl_mt')
            config.update(epochs=1, eager_ingest=eager, steps_per_dispatch=n)
            with watched_steps() as seen:
                _, proxy, records, launches = run_script_phase(
                    tag, SCRIPT_MT, 'ssl_mt', out, config)
            if proxy.train_loader.eager_ingest != eager:
                raise AssertionError('eager_ingest not wired')
            if n > 1:
                script_graph_checks(tag, 'MT script, ' + label, proxy, 1, 0,
                                    launches)
            del proxy
        runs[label] = dict(sums=seen['sums'], first=seen['eager'][0],
                           losses={r['iter']: loss_values(r)
                                   for r in records if r['phase'] == 'train'})
    plain = runs['plain']
    for label, run in runs.items():
        if run['sums'] != plain['sums']:
            raise AssertionError('{0}: the batches differ'.format(label))
        if run['first'] != plain['first']:
            raise AssertionError('{0}: first losses {1}, plain {2}'.format(
                label, run['first'], plain['first']))
    gaps = {label: ', '.join('{0} {1:.3g}'.format(it, largest_loss_gap(
        [plain['losses'][it]], [losses])) for it, losses in sorted(
            run['losses'].items())) for label, run in runs.items()
        if label != 'plain'}
    say('{0} {1} batches equal bit for bit in all {2} runs, the first step\'s '
        'losses equal; relative loss gap to the plain run by iteration: '
        '{3}'.format(tag, len(plain['sums']), len(runs), '; '.join(
            '{0}: {1}'.format(k, v) for k, v in gaps.items())))
    no_workers_left(tag)


def phase_bench():
    """The port's bench at a reduced count (``--steps 8 --calls 3``), in
    this process, whose cuDNN autotunes: its JSON line parses and holds
    ``mfu_bf16`` in (0, 1]."""
    import io

    from pixelssl_tpu_torch import bench

    tag = '[29/40]'
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(['--steps', '8', '--calls', '3', '--cudnn-benchmark'])
    line = out.getvalue().strip().splitlines()[-1]
    record = json.loads(line)
    say('{0} bench (--steps 8 --calls 3): {1}'.format(tag, line))
    mfu = record.get('mfu_bf16')
    if mfu is None or not 0.0 < mfu <= 1.0:
        raise AssertionError('mfu_bf16 {0}'.format(mfu))
    for key in ('samples_per_sec_per_chip', 'eager_samples_per_sec_per_chip',
                'gct_steps_per_sec_per_chip', 'tflop_per_step', 'peak_gib'):
        if not record[key] > 0:
            raise AssertionError('{0} = {1}'.format(key, record[key]))
    return record


def phase_serving():
    """``tools/infer_bench.py`` and ``tools/export_serving.py`` on
    DeepLab-v2/ResNet-101 @321, batch 8, in this process: the inference
    bench's JSON line, and the exported program's round trip within the
    tool's limits (atol 5e-3, rtol 2e-2), its file in a temporary
    directory."""
    import argparse as _argparse
    import io
    import tempfile

    from pixelssl_tpu_torch.tools import export_serving, infer_bench

    tag = '[30/40]'
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer_bench.main(['--model', 'deeplabv2', '--backbone', 'resnet101',
                          '--im-size', str(IM_SIZE), '--batch', '8'])
    line = out.getvalue().strip().splitlines()[-1]
    record = json.loads(line)
    say('{0} infer_bench: {1}'.format(tag, line))
    if not record['images_per_sec_per_chip'] > 0:
        raise AssertionError('infer_bench {0}'.format(record))
    with tempfile.TemporaryDirectory() as tmp:
        opts = _argparse.Namespace(
            ckpt='', algo='ssl_mt', model_key='model', backbone='resnet101',
            im_size=IM_SIZE, num_classes=21, batch=8, bf16=1, seed=0,
            cpu=False,
            out=os.path.join(tmp, 'model.pt2'))
        t0 = time.perf_counter()
        path, diff = export_serving.export(opts)
        say('{0} export_serving: {1:.1f} MB .pt2 in {2:.1f} s (export, '
            'save, load, run), round trip max|diff| {3:.3g} within atol '
            '5e-3, rtol 2e-2'.format(tag, os.path.getsize(path) / 1e6,
                                     time.perf_counter() - t0, diff))


def reference_layout(model):
    """The reference's checkpoint layout of a port DeepLab-v2 task model
    (``module.model.`` + the reference's key), by inverting
    ``models/convert.convert_deeplab_v2``'s map: the port keeps the
    reference's backbone and classifier names under ``net.``."""
    import re

    state = {}
    for key, value in model.state_dict().items():
        if key.endswith('num_batches_tracked'):
            continue
        if not key.startswith('net.'):
            raise AssertionError('unexpected key {0}'.format(key))
        inner = key[len('net.'):]
        if not re.match(r'^(backbone\.|classifier\.conv2d_list\.\d+\.)',
                        inner):
            raise AssertionError('unexpected key {0}'.format(key))
        state['module.model.' + inner] = value.detach().cpu().clone()
    return state


def phase_rescore(seed):
    """``scripts/rescore.py`` of the port on the committed fixture tree:
    a reference-layout checkpoint of the DeepLab-v2 1-8 SupOnly model,
    written here from the port's own random weights (``reference_layout``),
    rescored with the exact protocol; its mIoU must equal (atol 1e-4) the
    port's own validation of the same weights through the script
    (``run_script``, validation from a port checkpoint)."""
    import tempfile

    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.scripts import rescore as rescore_mod
    from pixelssl_tpu_torch.tasks import sseg

    tag = '[31/40]'
    script = 'deeplabv2_pascalvoc_1-8_suponly.py'
    root = os.path.abspath(VOC_FIXTURE)
    args = full_width_args('ssl_null', seed, batch_size=4,
                           unlabeled_batch_size=0, **NULL_CONFIG)
    algo = harness.build_algorithm(args, iters_per_epoch=ITERS_PER_EPOCH)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, 'reference.ckpt')
        torch.save({'algorithm': 'ssl_null', 'epoch': 40,
                    'model': reference_layout(algo.model)}, ref)
        own = algo.save_checkpoint(0, path=os.path.join(tmp, 'own.pth'))
        del algo
        overrides = {'out_path': os.path.join(tmp, 'result'),
                     'num_workers': 0}
        os.chdir(tmp)  # rescore writes pretrained/<exp_id>.pth here
        try:
            rescored = rescore_mod.rescore(script, ref, voc_root=root,
                                           overrides=overrides)
        finally:
            os.chdir(cwd)
        pretrained = os.path.join(tmp, 'pretrained',
                                  script[:-3] + '.pth')
        config = dict(load_script_config(script), **overrides)
        config.update(trainset={'pascal_voc_aug': [root]},
                      valset={'pascal_voc_aug': [root]}, resume=own,
                      validation=True, exact_val=True)
        proxy = pixelssl_tpu_torch.run_script(
            config, sseg, sseg.SemanticSegmentationProxy, device='cuda',
            cli_override=False)
        own_scores = {k: float(m.avg) for k, m in
                      proxy.ssl_algorithm.meters.items() if 'mIoU' in k}
        del proxy
        pretrained_ok = os.path.exists(pretrained)
    gap = max(abs(rescored[k] - own_scores[k]) for k in own_scores)
    say('{0} rescore of a reference-layout checkpoint on the fixture tree '
        '(4 val images, exact protocol): {1}; the port\'s own validation '
        'of the same weights: {2}; largest difference {3:.3g} (atol 1e-4); '
        'pretrained/<exp_id>.pth written: {4}'.format(
            tag, rescored, own_scores, gap, pretrained_ok))
    if sorted(rescored) != sorted(own_scores) or not gap <= 1e-4 or \
            not pretrained_ok:
        raise AssertionError('rescore {0} vs {1}'.format(rescored,
                                                         own_scores))


# ---------------------------------------------------------------------------
# phases 32-34: --visualize, --distributed at world size 1 over NCCL, and two
# gloo ranks sharing the card
# ---------------------------------------------------------------------------

VISUAL_FREQ = 2
VIS_SAMPLES = {1: 12, MULTI_N: 32}  # 3 iterations eager; 8 (two dispatches)
WORKER_TIMEOUT = 600
GCT_DEBUG = ('l-fmap', 'l-fmap-gt', 'l-pseudo-gt', 'r-fmap', 'r-fmap-gt',
             'r-pseudo-gt')
PANELS = ('1-inp', '2-pred', '3-gt')


def debug_blur_cases(batch_size, im_size):
    """(N, H, W, k) of the blur calls of GCT's debug visualization, each
    twice (l and r): ``flawmap_handler`` and ``fdgt_generator`` on the
    whole batch, k=odd(im/16), odd(im/8), odd(im/4)."""
    return gct_blur_cases(batch_size, 0, im_size)


def script_debug_blur_cases(script):
    config = load_script_config(script)
    return debug_blur_cases(config['batch_size'], config['im_size'])


@contextlib.contextmanager
def recorded_pngs():
    """Every array ``nn.imageio.write_png`` writes while the block runs,
    by path."""
    import numpy as np
    from pixelssl_tpu_torch.nn import imageio

    written = {}
    write = imageio.write_png

    def record(path, img):
        written[os.path.abspath(path)] = np.array(img, copy=True)
        return write(path, img)

    imageio.write_png = record
    try:
        yield written
    finally:
        imageio.write_png = write


def expected_pngs(n_iters, n, freq, n_val, model_ids, debug):
    """The PNG names the JAX package writes for one epoch of ``n_iters``
    iterations at ``--steps-per-dispatch`` ``n`` and ``--visual-freq``
    ``freq`` with ``n_val`` exact validation batches, by folder: its
    ``train`` names ``<epoch>_<idx>`` each iteration idx % freq == 0,
    its ``_train_multi`` ``<epoch>_<done>`` each dispatch whose ``done``
    passes a multiple of ``freq`` (the tail's steps none), its
    ``validate`` ``<epoch>_<idx>`` each batch idx % freq == 0; for each,
    ``_<model id><panel>.png`` of every model and the algorithm's
    ``_debug_visualize`` maps (JAX ssl_base.py:246-264,355-368,417-426,
    ssl_gct.py:458-468, ssl_adv.py:266-270)."""
    if n == 1:
        names = [i for i in range(n_iters) if i % freq == 0]
    else:
        names = [done for done in range(n, n_iters - n_iters % n + 1, n)
                 if done % freq < n]
    train = set()
    for i in names:
        for mid in model_ids:
            train.update('0_{0}_{1}{2}.png'.format(i, mid, p) for p in PANELS)
        train.update('0_{0}_{1}.png'.format(i, d) for d in debug)
    val = {'0_{0}_{1}{2}.png'.format(b, mid, p)
           for b in range(n_val) if b % freq == 0
           for mid in model_ids for p in PANELS}
    return {'debug': set(), 'train': train, 'val': val}


def check_pngs(tag, what, proxy, written, expected, size):
    """The folders hold ``expected``'s names; each PNG read back by the
    port's reader equals the array written, [size, size, 3] or [size,
    size]."""
    from pixelssl_tpu_torch.nn import imageio

    args = proxy.args
    found = {sub: set(os.listdir(getattr(args, 'visual_{0}_path'.format(
        sub)))) for sub in ('debug', 'train', 'val')}
    if found != expected:
        raise AssertionError('{0}: PNG names differ from the JAX package\'s: '
                             'missing {1}, extra {2}'.format(
                                 what, {k: sorted(expected[k] - found[k])
                                        for k in found},
                                 {k: sorted(found[k] - expected[k])
                                  for k in found}))
    n_files = 0
    for sub in ('train', 'val'):
        folder = getattr(args, 'visual_{0}_path'.format(sub))
        for name in found[sub]:
            path = os.path.abspath(os.path.join(folder, name))
            back = imageio.read_png(path)
            if path not in written or back.shape[:2] != (size, size) or \
                    not (back == written[path]).all():
                raise AssertionError('{0}: {1} does not read back as '
                                     'written'.format(what, path))
            n_files += 1
    say('{0} {1}: {2} PNGs, the JAX package\'s names ({3} train, {4} val), '
        'each read back equal to the array written, {5} px'.format(
            tag, what, n_files, len(found['train']), len(found['val']),
            size))


def visualize_cost_ms(algo, batch, reps=3):
    """Wall ms of one ``_visualize`` (the eval forwards, the debug maps,
    the PNGs) and of one eager ``train_step`` on ``batch``, medians of
    ``reps``; the card synchronised around each."""
    import statistics
    import torch

    def wall(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    return (wall(lambda: algo._visualize(batch, 'timing')),
            wall(lambda: algo.train_step(batch)))


def phase_visualize():
    """``--visualize`` through ``run_script``: the 1-8 GCT script's config
    at 2+2 @321 with ``--visual-freq 2``, eagerly (3 iterations) and at
    ``--steps-per-dispatch 4`` (8 iterations, two dispatches), and the
    1-8 AdvSSL script's eagerly. Returns the GCT runs' blur launches."""
    import tempfile
    from pixelssl_tpu_torch.ops import blur

    tag = '[32/40]'
    launches = {}
    for algo_name, script, n, model_ids, debug in (
            ('ssl_gct', SCRIPT_GCT, 1, ('l', 'r'), GCT_DEBUG),
            ('ssl_gct', SCRIPT_GCT, MULTI_N, ('l', 'r'), GCT_DEBUG),
            ('ssl_adv', SCRIPT_ADV, 1, ('ssl_adv',),
             ('labeled-cmap', 'unlabeled-cmap'))):
        what = '{0} --visualize at --steps-per-dispatch {1}'.format(
            algo_name, n)
        with tempfile.TemporaryDirectory() as out:
            config = script_config(script, out, algo_name,
                                   samples=VIS_SAMPLES[n])
            config.update(visualize=True, visual_freq=VISUAL_FREQ,
                          steps_per_dispatch=n)
            with recorded_pngs() as written:
                _, proxy, _, count = run_script_phase(tag, script, algo_name,
                                                      out, config)
            algo = proxy.ssl_algorithm
            iters = len(proxy.train_loader)
            expected = expected_pngs(iters, n, VISUAL_FREQ,
                                     len(proxy.val_loader), model_ids, debug)
            check_pngs(tag, what, proxy, written, expected,
                       config['im_size'])
            visualized = len({name.split('_')[1]
                              for name in expected['train']})
            per_step = BLUR_LAUNCHES_PER_STEP if algo_name == 'ssl_gct' else 0
            want = per_step * (iters + visualized)
            if count != want or algo.state.step != iters:
                raise AssertionError('{0}: blur launches {1}, state.step {2};'
                                     ' expected {3}, {4}'.format(
                                         what, count, algo.state.step, want,
                                         iters))
            if n > 1 and algo._captured is None:
                raise AssertionError(what + ': no captured step')
            vis_ms, step_ms = visualize_cost_ms(
                algo, next(iter(proxy.train_loader)))
            say('{0} {1}: {2} iterations, {3} visualized; blur launches {4} '
                '= {5} x ({2} + {3}); a visualization costs {6:.1f} ms of '
                'wall time (eval forwards, debug maps, PNGs), an eager train '
                'step {7:.1f} ms'.format(tag, what, iters, visualized, count,
                                         per_step, vis_ms, step_ms))
            if algo_name == 'ssl_gct':
                launches[n] = count
            del proxy, algo
        no_workers_left(tag)
    blur.launches = 0
    return launches


def run_bounded(tag, cmd, timeout=WORKER_TIMEOUT):
    """``cmd`` in a session of its own, killed with every process it
    started if it outlives ``timeout`` s; its output's tail printed and a
    failure raised if it exits with another code than 0."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError('{0} {1} outlived {2} s'.format(
            tag, ' '.join(cmd[-6:]), timeout))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        say('\n'.join(out.splitlines()[-60:]))
        raise AssertionError('{0} {1} exited with {2}'.format(
            tag, ' '.join(cmd[-6:]), proc.returncode))
    return time.perf_counter() - t0


def torchrun(n_proc):
    return [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            '--nproc-per-node', str(n_proc)]


def worker_gct(out, distributed):
    """One process of phase 33: the 1-8 GCT script's config through
    ``run_script`` at ``--steps-per-dispatch`` 1 (12 samples, 3
    iterations) and 4 (32 samples, 8), with ``--distributed`` or not, cuDNN deterministic, the
    first (eager) step's losses watched; then eager steps and replays
    timed on a batch of the run, and one of each under ``torch.profiler``,
    its NCCL kernels' share. Writes ``result.json`` into ``out``."""
    import statistics
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.tasks import sseg

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    result = {}
    for n in (1, MULTI_N):
        run_out = os.path.join(out, 'run{0}'.format(n))
        os.makedirs(run_out)
        config = script_config(SCRIPT_GCT, run_out, 'ssl_gct',
                               samples=VIS_SAMPLES[n])
        config.update(steps_per_dispatch=n, distributed=distributed)
        blur.launches = 0
        with watched_steps() as seen:
            proxy = pixelssl_tpu_torch.run_script(
                config, sseg, sseg.SemanticSegmentationProxy, device='cuda',
                cli_override=False)
        torch.cuda.synchronize()
        algo = proxy.ssl_algorithm
        row = {'launches': blur.launches, 'step': algo.state.step,
               'first': seen['eager'][0],
               'iters': len(proxy.train_loader),
               'captured': algo._captured is not None,
               'world_size': algo.mesh.world_size,
               'distributed': algo.mesh.distributed,
               'device': str(algo.device),
               'train': [r for r in read_records(config)
                         if r['phase'] == 'train']}
        batch = next(iter(proxy.train_loader))
        if n == 1:
            def one():
                algo.train_step(batch)
        else:
            def one():
                algo.train_steps([batch] * n)
        times = []
        for _ in range(WORKER_TIMED + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        row['step_ms'] = times
        row['median_step_ms'] = statistics.median(times[1:])
        events = profile_kernels(one)
        total = sum(e.self_device_time_total for e in events) / 1e3
        nccl = [e for e in events if 'nccl' in e.key.lower()]
        row['kernel_ms'] = total / n
        row['nccl_ms'] = sum(e.self_device_time_total for e in nccl) / 1e3 / n
        row['nccl_launches'] = sum(e.count for e in nccl) / n
        row['nccl_kernels'] = sorted({e.key[:60] for e in nccl})
        result[str(n)] = row
        del proxy, algo
    if distributed:
        # the host's cost of one all-reduce, of 2 floats (a global mean)
        # and of a task model's gradients
        for numel in (2, 44 * 2 ** 20):
            x = torch.ones(numel, device='cuda')
            for _ in range(5):
                torch.distributed.all_reduce(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                torch.distributed.all_reduce(x)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            result['all_reduce_us_{0}'.format(numel)] = [
                1e6 * host / 50, 1e6 * (time.perf_counter() - t0) / 50]
    if not distributed or torch.distributed.get_rank() == 0:
        with open(os.path.join(out, 'result.json'), 'w') as f:
            json.dump(result, f)


def relative_gap(a, b, keys):
    """The largest relative difference of ``a[k]`` from ``b[k]``."""
    return max([abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys] or
               [0.0])


def phase_distributed():
    """``--distributed`` at world size 1 over NCCL against the plain run,
    each a process of ``worker_gct``: the distributed one under ``python
    -m torch.distributed.run --standalone --nproc-per-node 1``. Returns
    the distributed run's blur launches."""
    import tempfile

    tag = '[33/40]'
    here = os.path.abspath(__file__)
    runs = {}
    for name, cmd in (
            ('plain', [sys.executable, here]),
            ('distributed', torchrun(1) + [here])):
        with tempfile.TemporaryDirectory() as out:
            wall = run_bounded(tag, cmd + ['--worker', 'gct', '--out', out] +
                               (['--distributed'] if name == 'distributed'
                                else []))
            with open(os.path.join(out, 'result.json')) as f:
                runs[name] = json.load(f)
        say('{0} {1} run: a process, {2:.1f} s'.format(tag, name, wall))
    launches = 0
    for n in ('1', str(MULTI_N)):
        plain, dist = runs['plain'][n], runs['distributed'][n]
        what = 'GCT script @321 2+2, --steps-per-dispatch {0}'.format(n)
        if not (dist['distributed'] and dist['world_size'] == 1 and
                not plain['distributed'] and dist['device'] == 'cuda:0'):
            raise AssertionError('{0}: the runs were not what was asked: '
                                 '{1} / {2}'.format(what, plain, dist))
        for key in ('launches', 'step', 'captured', 'iters'):
            if plain[key] != dist[key]:
                raise AssertionError('{0}: {1} {2} distributed, {3} '
                                     'plain'.format(what, key, dist[key],
                                                    plain[key]))
        if plain['launches'] != BLUR_LAUNCHES_PER_STEP * plain['step'] or \
                plain['captured'] != (n != '1'):
            raise AssertionError('{0}: {1}'.format(what, plain))
        first = relative_gap(dist['first'], plain['first'], plain['first'])
        later = {'task/fd': 0.0, 'fc/dc': 0.0}
        for s, (a, b) in enumerate(zip(dist['train'], plain['train'])):
            if a['lr'] != b['lr'] or a['iter'] != b['iter']:
                raise AssertionError('{0}: record {1} lr/iter {2} vs '
                                     '{3}'.format(what, s, a, b))
            losses = [k for k in b if k.endswith('_loss')]
            later['task/fd'] = max(later['task/fd'], relative_gap(a, b, [
                k for k in losses if 'task' in k or 'fd' in k]))
            later['fc/dc'] = max(later['fc/dc'], relative_gap(a, b, [
                k for k in losses if 'fc' in k or 'dc' in k]))
        if not first <= DIST_FIRST_RTOL:
            raise AssertionError('{0}: the first step\'s losses differ by '
                                 '{1} (rtol {2})'.format(
                                     what, first, DIST_FIRST_RTOL))
        say('{0} {1}: {2} iterations, blur launches {3} on both; the first '
            'step\'s losses equal (largest relative gap {4:.3g}); the '
            'records\' largest relative gaps: task and FD losses {5:.3g}, '
            'the thresholded fc/dc {6:.3g}; lr equal on every record'.format(
                tag, what, dist['iters'], dist['launches'], first,
                later['task/fd'], later['fc/dc']))
        say('{0} {1}: ms a step, plain {2:.3f} (median of {3}), '
            'distributed {4:.3f} (median of {5}), ratio {6:.4f}; kernel time '
            'a step plain {7:.3f} ms, distributed {8:.3f} ms, of it NCCL '
            '{9:.4f} ms in {10:g} launches ({11:.3f}% of the distributed '
            'step\'s kernel time): {12}'.format(
                tag, what, plain['median_step_ms'],
                ' '.join('{0:.3f}'.format(t) for t in plain['step_ms'][1:]),
                dist['median_step_ms'],
                ' '.join('{0:.3f}'.format(t) for t in dist['step_ms'][1:]),
                dist['median_step_ms'] / plain['median_step_ms'],
                plain['kernel_ms'], dist['kernel_ms'], dist['nccl_ms'],
                dist['nccl_launches'],
                100.0 * dist['nccl_ms'] / max(dist['kernel_ms'], 1e-9),
                ', '.join(dist['nccl_kernels']) or 'none seen'))
        launches += dist['launches']
    say('{0} host us an all-reduce (to return; to its end): {1}'.format(
        tag, '  '.join('{0} floats {1:.1f}; {2:.1f}'.format(
            k.rsplit('_', 1)[1], *v) for k, v in sorted(
                runs['distributed'].items()) if k.startswith('all_reduce'))))
    return launches


DIST_FIRST_RTOL = 1e-6
WORKER_TIMED = 6
GLOO_CASES = (('ssl_null', dict(NULL_CONFIG, batch_size=4,
                                unlabeled_batch_size=0)),
              ('ssl_mt', dict(MT_CONFIG, batch_size=8, unlabeled_batch_size=4,
                              ignore_unlabeled=False)))
GLOO_STEPS = 2
GLOO_VAL_SAMPLES = 4


def gloo_global_batch(args, seed):
    """A global two-stream batch (numpy NHWC images, [N,H,W] labels)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, s = args.batch_size, args.im_size
    images = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, args.num_classes, (b, s, s)).astype(np.int32)
    labels[args.labeled_batch_size:] = -1
    return images, labels


class ListDataset(object):
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def gloo_val_samples(args, seed):
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    s = args.im_size
    return [((rng.standard_normal((s, s, 3)).astype(np.float32),),
             (rng.integers(0, args.num_classes, (s, s)).astype(np.int32),))
            for _ in range(GLOO_VAL_SAMPLES)]


def gloo_case(algo_name, config, seed, rank=0, world=1):
    """Build ``algo_name`` at ResNet-10 @64 in float32 on the card,
    validate its share of the samples, then take ``GLOO_STEPS`` steps on
    rank ``rank``'s slice of the global batch; (losses a step, state dicts
    on the host, val scores)."""
    import torch
    from pixelssl_tpu_torch import harness, parallel
    from pixelssl_tpu_torch.task_template.proxy import _ValLoader

    args = harness.default_args(algo_name, **dict(config, seed=seed,
                                                  **SMALL))
    algo = harness.build_algorithm(args, device='cuda:0', iters_per_epoch=2)
    images, labels = gloo_global_batch(args, seed)
    lbs, ubs = args.labeled_batch_size, args.unlabeled_batch_size
    if world > 1:
        n = (lbs + ubs) // world
        if ubs:
            images = parallel.reorder_two_stream(images, lbs, ubs, world)
            labels = parallel.reorder_two_stream(labels, lbs, ubs, world)
        images = images[rank * n:(rank + 1) * n]
        labels = labels[rank * n:(rank + 1) * n]
    batch = harness._to_batch(images, labels, 'cuda:0')
    # validated first, on the weights every rank starts from
    val = algo.validate(_ValLoader(ListDataset(gloo_val_samples(args, seed)),
                                   'cuda:0', mesh=algo.mesh), 0)
    losses = [loss_values(algo.train_step(batch)) for _ in range(GLOO_STEPS)]
    states = {k: {n: t.detach().cpu() for n, t in m.state_dict().items()}
              for k, m in algo.modules.items()}
    return losses, states, {k: float(v) for k, v in val.items()}


def worker_gloo(out, seed):
    """One of phase 34's two ranks: a gloo group from ``torchrun``'s
    environment, both ranks on card 0, ``gloo_case`` for each of
    ``GLOO_CASES``; writes ``rank<r>.pt`` into ``out``."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group('gloo')
    rank, world = dist.get_rank(), dist.get_world_size()
    result = {name: gloo_case(name, config, seed, rank, world)
              for name, config in GLOO_CASES}
    torch.save(result, os.path.join(out, 'rank{0}.pt'.format(rank)))
    dist.barrier()
    dist.destroy_process_group()


def phase_gloo(seed):
    """Two ranks sharing the card over gloo (``python -m
    torch.distributed.run --standalone --nproc-per-node 2``), each on half
    of the global batch, against one process on the whole batch: SupOnly
    4+0 and MT 4+4 at ResNet-10 @64 in float32, a validation of
    ``GLOO_VAL_SAMPLES`` samples and ``GLOO_STEPS`` steps. Losses rtol 1e-4 (atol
    1e-5), parameters and BN statistics atol 1e-5 with rtol 1e-4 (the
    CPU test's limits), val scores rtol 1e-6."""
    import tempfile
    import numpy as np
    import torch

    tag = '[34/40]'
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as out:
            wall = run_bounded(tag, torchrun(2) + [
                os.path.abspath(__file__), '--worker', 'gloo', '--out', out,
                '--seed', str(seed)])
            ranks = [torch.load(os.path.join(out, 'rank{0}.pt'.format(r)),
                                weights_only=False) for r in range(2)]
        for name, config in GLOO_CASES:
            losses, states, val = gloo_case(name, config, seed)
            worst = {'loss': 0.0, 'param': 0.0}
            for rank, result in enumerate(ranks):
                r_losses, r_states, r_val = result[name]
                for s, (a, b) in enumerate(zip(r_losses, losses)):
                    for k in b:
                        worst['loss'] = max(worst['loss'], abs(a[k] - b[k]))
                        if not math.isclose(a[k], b[k], rel_tol=1e-4,
                                            abs_tol=1e-5):
                            raise AssertionError('{0} rank {1} step {2} {3}: '
                                                 '{4} vs {5}'.format(
                                                     name, rank, s, k, a[k],
                                                     b[k]))
                for key, state in states.items():
                    for pname, value in state.items():
                        if pname.endswith('num_batches_tracked'):
                            continue
                        got = r_states[key][pname].float().numpy()
                        want = value.float().numpy()
                        worst['param'] = max(worst['param'], float(
                            np.abs(got - want).max()))
                        if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
                            raise AssertionError('{0} rank {1} {2}.{3} '
                                                 'differs'.format(
                                                     name, rank, key, pname))
                if set(r_val) != set(val) or not all(
                        math.isclose(r_val[k], v, rel_tol=1e-6)
                        for k, v in val.items()):
                    raise AssertionError('{0} rank {1} val {2} vs {3}'.format(
                        name, rank, r_val, val))
            say('{0} {1}: 2 gloo ranks on the card ({2:.1f} s) equal one '
                'process on the whole batch: {3} steps, largest loss gap '
                '{4:.3g}, largest parameter gap {5:.3g}; val {6}'.format(
                    tag, name, wall, GLOO_STEPS, worst['loss'],
                    worst['param'], '  '.join(
                        '{0} {1:.5f}'.format(k, v)
                        for k, v in sorted(val.items()) if 'mIoU' in k)))
    finally:
        torch.backends.cudnn.deterministic = False

# ---------------------------------------------------------------------------
# phases 35-39: spatial partitioning (--spatial-train, --spatial-val)
# ---------------------------------------------------------------------------

SPATIAL_N = 2
SPATIAL_STEPS = 2
# lr 1e-5: a random-weight ResNet-101 turns float32 noise into
# trajectories apart after one step. ``python -m
# pixelssl_tpu_torch.tools.spatial_spread --backbone resnet101 --im-size 97
# --lr LR``: one process on 1 against 4 CPU threads parts by 2.0e-2 on the
# second step's loss at the recipes' 2.5e-4 (BN statistics by 1.86) and by
# 4.9e-4 at 1e-5 (0.22); two spatial ranks by 1.2e-2 and 1.2e-3
SPATIAL_LR = 1e-5
# (name, algorithm, flags) of each cell of phase 35, DeepLab-v2 @321
SPATIAL_CASES = (
    ('ssl_null', 'ssl_null', dict(NULL_CONFIG, batch_size=4,
                                  unlabeled_batch_size=0, lr=SPATIAL_LR)),
    ('ssl_mt', 'ssl_mt', dict(MT_CONFIG, batch_size=8,
                              unlabeled_batch_size=4, ignore_unlabeled=False,
                              gaussian_noise_std=0.1, lr=SPATIAL_LR)),
    ('ssl_gct', 'ssl_gct', dict(GCT_CONFIG, batch_size=8,
                                unlabeled_batch_size=4, lr=SPATIAL_LR)),
    ('ssl_adv', 'ssl_adv', dict(ADV_CONFIG, batch_size=8,
                                unlabeled_batch_size=4,
                                ignore_unlabeled=False, lr=SPATIAL_LR)),
    ('ssl_s4l', 'ssl_s4l', dict(S4L_CONFIG, batch_size=8,
                                unlabeled_batch_size=4,
                                ignore_unlabeled=False, lr=SPATIAL_LR)),
    ('ssl_cutmix', 'ssl_cutmix', dict(CUTMIX_CONFIG, batch_size=8,
                                      unlabeled_batch_size=4,
                                      ignore_unlabeled=False,
                                      lr=SPATIAL_LR)))
# phase 38: PSPNet/ResNet-101 @513 at its scripts' batches (GCT's blur on
# strips of the 513-row maps: k = 33, 65, 129), CCT with the 1-8 script's
# 11 decoders, and the sreg demo's MT at its width (unet_lite base 32 @64,
# batch 1 + 1; SGD, whose first update does not turn float32 noise into
# Adam's lr * sign(g))
PSP_GCT_BATCH = (4, 2)
SPATIAL_MODEL_CASES = (
    ('psp_null', 'ssl_null', dict(NULL_CONFIG, model='pspnet', batch_size=4,
                                  unlabeled_batch_size=0, lr=SPATIAL_LR)),
    ('psp_gct', 'ssl_gct', dict(GCT_CONFIG, model='pspnet',
                                batch_size=PSP_GCT_BATCH[0],
                                unlabeled_batch_size=PSP_GCT_BATCH[1],
                                lr=SPATIAL_LR)),
    ('psp_cct', 'ssl_cct', dict(CCT_CONFIG, model='pspnet', batch_size=4,
                                unlabeled_batch_size=2,
                                ignore_unlabeled=False, lr=SPATIAL_LR)),
    ('sreg_mt', 'ssl_mt', dict(task='sreg', base_channels=32, im_size=64,
                               batch_size=2, unlabeled_batch_size=1,
                               ignore_unlabeled=False, cons_scale=1.0,
                               cons_rampup_epochs=2, ema_decay=0.99,
                               gaussian_noise_std=0.05, lr=1e-3,
                               momentum=0.9)))
# phase 38 holds the first step only (F13: the pyramid's one-bin BatchNorm
# over the 2 labeled samples of a 2 + 2 batch magnifies float32 noise
# further after it); the later gaps are printed
SPATIAL_MODEL_HELD_STEPS = 1
# the thresholded GCT losses and the consistencies of MT and CutMix (its
# confidence a thresholded pixel share), against one process
SPATIAL_LOOSE = {'cons_loss', 'l_fc_loss', 'r_fc_loss', 'l_dc_loss',
                 'r_dc_loss'}
# the losses that read GCT's flaw detector or AdvSSL's D after its first
# Adam update, which moves each weight whose gradient is 0 up to float32
# noise by the lr either way (``tests/test_torch_parallel.py``'s FD_ATOL):
# held on the first step, their later gaps printed
SPATIAL_FD_KEYS = {'l_fc_loss', 'r_fc_loss', 'l_dc_loss', 'r_dc_loss',
                   'l_fd_loss', 'r_fd_loss', 'labeled_adv_loss',
                   'unlabeled_adv_loss', 'fake_d_loss', 'real_d_loss'}
# --visualize under the two flags: the first iteration only (F13: two ranks
# and one process are held on the first step), and each val batch at 1025
# px
SPATIAL_VISUAL_FREQ = 100
# the model's maps of two ranks against one process's on the same weights:
# the share of pixels of the same colour (prediction, pseudo-GT; a pixel
# whose best two classes tie to float32 noise may flip) and the share of
# gray pixels (flawmaps, their ground truth) more than a level apart. On
# one process's own weights after a step they part much further (F13: a
# random-weight ResNet-101 in eval mode magnifies the step's float32
# difference), which is printed
SPATIAL_COLOUR_SAME = 0.98
SPATIAL_GRAY_APART = 0.01
SPATIAL_VAL_SIZE = 1025
SPATIAL_VAL_SAMPLES = 2


def reset_peak():
    """The peak memory statistic reset after the garbage of earlier phases
    is collected; returns what the process still holds (their caches)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above(held):
    """The peak memory since ``reset_peak`` above ``held``, what the
    process held then, in GiB: the same for a fresh worker and for this
    process."""
    import torch
    return (torch.cuda.max_memory_allocated() - held) / 2 ** 30


def spatial_blur_cases(batch_size, unlabeled_batch_size, im_size,
                       rank=0, cases=None):
    """(N, H, W, k) of the blur calls of one GCT step (or of ``cases``,
    whole-map calls at ``im_size``) on spatial rank ``rank`` of
    ``SPATIAL_N``: its strip of rows [r0 - R, r1 + R)."""
    from pixelssl_tpu_torch.parallel import spatial
    lo, hi = spatial.row_range(im_size, SPATIAL_N, rank)
    if cases is None:
        cases = gct_blur_cases(batch_size, unlabeled_batch_size, im_size)
    return [(n, hi - lo + 2 * (k // 2), w, k) for n, _, w, k in cases]


def spatial_args(algo_name, config, seed, distributed):
    """The arguments of a spatial cell in float32: ``full_width_args``
    (DeepLab-v2 @321 or, with ``model='pspnet'``, PSPNet @513), or the
    ``sreg`` task's for ``task='sreg'``; ``--spatial-train`` on the grid
    when ``distributed``."""
    from pixelssl_tpu_torch import harness
    flags = dict(config, bf16=False,
                 spatial_train=SPATIAL_N if distributed else 0)
    if flags.get('task') == 'sreg':
        return harness.default_args(algo_name, seed=seed, epochs=20, **flags)
    return full_width_args(algo_name, seed, **flags)


def spatial_case(algo_name, config, seed, device='cuda'):
    """Build ``algo_name`` at full width (``spatial_args``) from ``seed``,
    on this process's place in the run (a 1 x SPATIAL_N grid under a
    process group), and take ``SPATIAL_STEPS`` steps on its samples and
    rows of the global batch (``harness.synthetic_batch``), timed; returns
    the step metrics, the step ms, the peak memory (GiB, from the build
    on), the blur launches, the algorithm, the row exchanges' host ms,
    count and MiB a step, and the weights after the first step
    (``float_state``)."""
    import torch
    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.parallel import spatial

    distributed = torch.distributed.is_initialized()
    torch.cuda.synchronize()
    held = reset_peak()
    args = spatial_args(algo_name, config, seed, distributed)
    algo = harness.build_algorithm(args, device=device,
                                   iters_per_epoch=ITERS_PER_EPOCH)
    batch = harness.synthetic_batch(args, device=device, seed=seed)
    blur.launches = 0
    history, step_ms = [], []
    # the row exchanges' host time (with gloo each waits for the card, and
    # stages the rows through the host), their count and bytes sent
    staging = {'s': 0.0, 'calls': 0, 'bytes': 0}
    exchange = spatial._exchange

    def timed_exchange(mesh, outgoing, incoming, like, dim):
        t0 = time.perf_counter()
        out = exchange(mesh, outgoing, incoming, like, dim)
        staging['s'] += time.perf_counter() - t0
        staging['calls'] += 1
        staging['bytes'] += sum(t.numel() * t.element_size()
                                for t in outgoing.values())
        return out

    spatial._exchange = timed_exchange
    first_state = None
    try:
        for s in range(SPATIAL_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = algo.train_step(batch)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            history.append(loss_values(metrics))
            if s == 0:
                spatial._exchange = exchange
                first_state = float_state(algo)
                spatial._exchange = timed_exchange
    finally:
        spatial._exchange = exchange
    staging = {'ms': 1e3 * staging['s'] / SPATIAL_STEPS,
               'calls': staging['calls'] / SPATIAL_STEPS,
               'mib': staging['bytes'] / SPATIAL_STEPS / 2 ** 20}
    return (history, step_ms, peak_above(held),
            blur.launches, algo, staging, first_state)


def float_state(algo):
    """A float32 copy on the host of every module's state (the step counts
    left out)."""
    return {k: {n: t.detach().float().cpu().clone()
                for n, t in m.state_dict().items()
                if not n.endswith('num_batches_tracked')}
            for k, m in algo.modules.items()}


def worker_spatial(out, seed, cases):
    """One of the two ranks of phase 35 or 38: a gloo group from
    ``torchrun``'s environment, both ranks on card 0, ``spatial_case`` for
    each of ``cases``; each rank checks that its weights equal rank 0's,
    and rank 0 writes its states. Writes ``rank<r>.pt`` into ``out``."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group('gloo')
    rank = dist.get_rank()
    result = {}
    for name, algo_name, config in cases:
        history, step_ms, peak, launches, algo, staging, first = \
            spatial_case(algo_name, config, seed, 'cuda:0')
        flat = torch.cat([t.detach().float().reshape(-1) for m in
                          algo.modules.values() for t in
                          m.state_dict().values()])
        rank0 = flat.clone()
        dist.broadcast(rank0, src=0)
        result[name] = {'losses': history, 'step_ms': step_ms,
                        'peak_gib': peak, 'launches': launches,
                        'staging': staging,
                        'equal_to_rank0': bool(torch.equal(rank0, flat)),
                        'grid': (algo.mesh.data_size, algo.mesh.n_spatial)}
        if rank == 0:
            torch.save({'first': first, 'last': float_state(algo)},
                       os.path.join(out, '{0}.pt'.format(name)))
        del algo, flat, rank0, first
        torch.cuda.empty_cache()
    torch.save(result, os.path.join(out, 'rank{0}.pt'.format(rank)))
    dist.barrier()
    dist.destroy_process_group()


def state_gap(ours, theirs):
    """The largest absolute difference of parameters and of running
    statistics between two ``float_state``s."""
    gap = {'param': 0.0, 'stat': 0.0}
    for key, state in theirs.items():
        for name, value in state.items():
            kind = 'stat' if 'running_' in name else 'param'
            gap[kind] = max(gap[kind], float(
                (ours[key][name] - value).abs().max()))
    return gap


def phase_spatial_train(seed):
    """``--spatial-train 2`` on two gloo ranks sharing the card
    (``worker_spatial``) against one process on the whole batch: SupOnly
    4+0, MT 4+4 with input noise, GCT, AdvSSL, S4L and CutMix 4+4 (each
    rank a share of each half of CutMix's unlabeled block) at full width
    in float32, cuDNN deterministic, two steps from the same weights at lr
    ``SPATIAL_LR`` (``spatial_cells``: the losses of both steps held).
    Returns the GCT run's blur launches on rank 0."""
    return spatial_cells('[35/40]', 'spatial', SPATIAL_CASES, seed,
                         SPATIAL_STEPS)['ssl_gct']


def phase_spatial_models(seed):
    """Phase 35's check of ``SPATIAL_MODEL_CASES``: PSPNet/ResNet-101 @513
    SupOnly 4+0, GCT 2+2 (its blur on strips of the 513-row maps) and CCT
    2+2 with 11 decoders, and the sreg demo's MT (``unet_lite`` base 32
    @64), the first step's losses held. Returns the PSPNet GCT run's blur
    launches on rank 0."""
    return spatial_cells('[38/40]', 'spatial_models', SPATIAL_MODEL_CASES,
                         seed, SPATIAL_MODEL_HELD_STEPS)['psp_gct']


def spatial_cells(tag, worker, cases, seed, held_steps):
    """``cases`` under ``--spatial-train 2`` on two gloo ranks sharing the
    card (``--worker worker``) against one process on the whole batch, in
    float32, cuDNN deterministic, ``SPATIAL_STEPS`` steps from the same
    weights. The losses of the first ``held_steps`` steps within rtol 2e-3
    (the thresholded GCT losses and the consistencies within 2e-2; the
    losses that read GCT's flaw detector or AdvSSL's D on the first step
    only, their later gaps printed), the parameters after the first step
    within atol 1e-3 and the BN statistics within atol 1e-2 (after the
    last the gaps are printed: a random-weight ResNet-101 magnifies
    float32 noise step by step, one process against itself too), the
    ranks equal, each rank's blur launches one process's; each one's step
    ms and peak memory printed beside one process's. Returns rank 0's blur
    launches of each case."""
    import tempfile
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as out:
            wall = run_bounded(tag, torchrun(SPATIAL_N) + [
                os.path.abspath(__file__), '--worker', worker, '--out',
                out, '--seed', str(seed)])
            ranks = [torch.load(os.path.join(out, 'rank{0}.pt'.format(r)),
                                weights_only=False)
                     for r in range(SPATIAL_N)]
            say('{0} {1} gloo ranks sharing the card: {2:.1f} s'.format(
                tag, SPATIAL_N, wall))
            for name, algo_name, config in cases:
                history, step_ms, peak, one_launches, algo, _, first = \
                    spatial_case(algo_name, config, seed)
                im_size = algo.args.im_size
                ranks_state = torch.load(os.path.join(
                    out, '{0}.pt'.format(name)), weights_only=False)
                gap = state_gap(ranks_state['first'], first)
                last_gap = state_gap(ranks_state['last'], float_state(algo))
                del ranks_state, first
                del algo
                torch.cuda.empty_cache()
                worst = {'loss': 0.0, 'loose': 0.0, 'later': 0.0}
                for rank, result in enumerate(ranks):
                    r = result[name]
                    if not r['equal_to_rank0'] or r['grid'] != (1, SPATIAL_N):
                        raise AssertionError('{0} {1} rank {2}: {3}'.format(
                            tag, name, rank, r))
                    if r['launches'] != one_launches:
                        raise AssertionError('{0} {1} rank {2}: {3} blur '
                                             'launches, one process {4}'
                                             .format(tag, name, rank,
                                                     r['launches'],
                                                     one_launches))
                    for s, (a, b) in enumerate(zip(r['losses'], history)):
                        for k in b:
                            gap_k = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                            loose = k in SPATIAL_LOOSE
                            key = 'loose' if loose else 'loss'
                            if s >= held_steps or (k in SPATIAL_FD_KEYS and
                                                   s > 0):
                                worst['later'] = max(worst['later'], gap_k)
                                continue
                            worst[key] = max(worst[key], gap_k)
                            if not math.isclose(a[k], b[k], rel_tol=(
                                    2e-2 if loose else 2e-3), abs_tol=1e-6):
                                raise AssertionError(
                                    '{0} {1} rank {2} step {3} {4}: {5} vs '
                                    '{6}'.format(tag, name, rank, s, k, a[k],
                                                 b[k]))
                if gap['param'] > 1e-3 or gap['stat'] > 1e-2:
                    raise AssertionError('{0} {1}: weights differ from one '
                                         'process by {2}'.format(tag, name,
                                                                 gap))
                say('{0} {1} @{14} {2}+{3}, 1 x {4} grid: {5} steps equal one '
                    'process on the whole batch (largest relative loss gap '
                    '{6:.3g}, thresholded {7:.3g}; after step 0 parameters '
                    '{8:.3g}, BN statistics {9:.3g}; after the last '
                    '{10:.3g}, {11:.3g}; the losses not held (later steps, '
                    'the FD- and D-read ones after the first update) '
                    '{13:.3g}); blur launches {12} a rank'.format(
                        tag, name, config['batch_size'] -
                        config['unlabeled_batch_size'],
                        config['unlabeled_batch_size'], SPATIAL_N,
                        held_steps, worst['loss'], worst['loose'],
                        gap['param'], gap['stat'], last_gap['param'],
                        last_gap['stat'], one_launches, worst['later'],
                        im_size))
                say('{0} {1}: ms a step, one process {2}, ranks {3}; peak '
                    'memory (above what each held) one process {4:.2f} GiB, '
                    'a rank {5}'.format(
                        tag, name, ' '.join('{0:.1f}'.format(t)
                                            for t in step_ms),
                        ' / '.join(' '.join('{0:.1f}'.format(t) for t in
                                            r[name]['step_ms'])
                                   for r in ranks),
                        peak, ' / '.join('{0:.2f} GiB'.format(
                            r[name]['peak_gib']) for r in ranks)))
                say('{0} {1}: row exchanges a step a rank (host ms, calls, '
                    'MiB sent): {2}'.format(tag, name, ' / '.join(
                        '{ms:.1f} ms, {calls:g}, {mib:.1f} MiB'.format(
                            **r[name]['staging']) for r in ranks)))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
    return {name: ranks[0][name]['launches'] for name, _, _ in cases}


def spatial_script_config(out):
    """The 1-8 GCT script's config (2+2 @321, 12 samples: 3 iterations and
    the validation of 12 images) in float32, with ``--visualize`` at the
    first iteration and the first val batch."""
    config = script_config(SCRIPT_GCT, out, 'ssl_gct')
    config.update(bf16=False, num_workers=1, visualize=True,
                  visual_freq=SPATIAL_VISUAL_FREQ)
    return config


def gloo_on_card_0():
    """A gloo group from ``torchrun``'s environment with every rank on card
    0: ``--distributed`` would take NCCL and ``cuda:<LOCAL_RANK>``, and NCCL
    puts no two ranks on one card; the proxy keeps a group it finds
    (``parallel.multihost.initialize``)."""
    import torch.distributed as dist
    dist.init_process_group('gloo')
    os.environ['LOCAL_RANK'] = '0'


@contextlib.contextmanager
def timed_visualizations(save_to=None, again=None):
    """Each train-side visualization (``SSLBase._visualize``) while the
    block runs, timed: yields a list that gets its wall ms (the card
    synchronised around it) and its blur launches. ``save_to``: rank 0
    saves every module's state there after it (the weights it drew with).
    ``again`` (such a state file, a folder): the same batch is then
    visualized again on those weights into the folder, its blur launches
    counted apart, and the weights put back."""
    import torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.ssl_algorithm import ssl_base

    seen = []
    visualize = ssl_base.SSLBase._visualize

    def timed(self, batch, name):
        torch.cuda.synchronize()
        t0, launches = time.perf_counter(), blur.launches
        visualize(self, batch, name)
        torch.cuda.synchronize()
        seen.append({'ms': 1e3 * (time.perf_counter() - t0),
                     'launches': blur.launches - launches})
        if save_to is not None and self.mesh.rank == 0:
            torch.save({k: m.state_dict() for k, m in self.modules.items()},
                       save_to)
        if again is not None:
            kept = {k: {n: t.clone() for n, t in m.state_dict().items()}
                    for k, m in self.modules.items()}
            theirs = torch.load(again[0], map_location=self.device,
                                weights_only=True)
            folder, self.args.visual_train_path = \
                self.args.visual_train_path, again[1]
            launches = blur.launches
            try:
                for k, m in self.modules.items():
                    m.load_state_dict(theirs[k])
                visualize(self, batch, name)
            finally:
                self.args.visual_train_path = folder
                for k, m in self.modules.items():
                    m.load_state_dict(kept[k])
            seen[-1]['again_launches'] = blur.launches - launches

    ssl_base.SSLBase._visualize = timed
    try:
        yield seen
    finally:
        ssl_base.SSLBase._visualize = visualize


def read_pngs(folder, prefix=''):
    """{prefix + name: pixels} of the PNGs in ``folder``."""
    from pixelssl_tpu_torch.nn import imageio
    return {prefix + name: imageio.read_png(os.path.join(folder, name))
            for name in sorted(os.listdir(folder))}


def visual_pngs(config):
    """{folder/name: pixels} of the PNGs of a ``run_script`` of
    ``config``."""
    base = os.path.join(config['out_path'], config['exp_id'],
                        'visualization')
    out = {}
    for sub in ('debug', 'train', 'val'):
        out.update(read_pngs(os.path.join(base, sub), sub + '/'))
    return out


def compare_visuals(tag, what, ranks, one, same=None):
    """Rank 0's PNGs against one process's: the same names and sizes,
    the input and GT panels equal; the model's maps within
    ``SPATIAL_COLOUR_SAME`` / ``SPATIAL_GRAY_APART`` of those one process
    draws on the same weights: ``one``'s own, or ``same``'s (the train
    maps one process drew again on rank 0's weights), and then their
    distance from ``one``'s, drawn on one process's weights, only
    printed (F13). Returns the worst shares, held and printed."""
    import numpy as np
    if sorted(ranks) != sorted(one):
        raise AssertionError('{0} {1}: PNG names {2} vs {3}'.format(
            tag, what, sorted(ranks), sorted(one)))
    worst = {'colour_same': 1.0, 'gray_apart': 0.0,
             'own_colour_same': 1.0, 'own_gray_apart': 0.0}

    def gaps(prefix, got, px):
        if px.ndim == 3:
            key = prefix + 'colour_same'
            worst[key] = min(worst[key], float((got == px).all(-1).mean()))
        else:
            key = prefix + 'gray_apart'
            worst[key] = max(worst[key], float(
                (np.abs(got.astype(int) - px) > 1).mean()))

    for name, px in one.items():
        got = ranks[name]
        if got.shape != px.shape:
            raise AssertionError('{0} {1}: {2} {3} vs {4}'.format(
                tag, what, name, got.shape, px.shape))
        if name.endswith(('1-inp.png', '3-gt.png')):
            if not np.array_equal(got, px):
                raise AssertionError('{0} {1}: {2} differs'.format(
                    tag, what, name))
        elif same is None:
            gaps('', got, px)
        else:
            gaps('own_', got, px)
            if name in same:
                gaps('', got, same[name])
    if same is not None and not set(same) <= set(one):
        raise AssertionError('{0} {1}: {2} not among {3}'.format(
            tag, what, sorted(same), sorted(one)))
    if worst['colour_same'] < SPATIAL_COLOUR_SAME or \
            worst['gray_apart'] > SPATIAL_GRAY_APART:
        raise AssertionError('{0} {1}: the model\'s maps differ from one '
                             'process\'s: {2}'.format(tag, what, worst))
    return worst


def worker_spatial_script(out):
    """One of phase 36's two ranks: the 1-8 GCT script through
    ``run_script`` with ``--distributed --spatial-train 2 --visualize``
    (the first iteration visualized), cuDNN deterministic, both ranks on
    card 0 over gloo; writes ``rank<r>.json`` into ``out``, and rank 0 the
    weights it visualized with, ``visual_state.pt``."""
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.tasks import sseg

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    gloo_on_card_0()
    run_out = os.path.join(out, 'run')
    os.makedirs(run_out, exist_ok=True)
    config = spatial_script_config(run_out)
    config.update(distributed=True, spatial_train=SPATIAL_N)
    blur.launches = 0
    held = reset_peak()
    t0 = time.perf_counter()
    with timed_visualizations(save_to=os.path.join(
            out, 'visual_state.pt')) as visualized:
        proxy = pixelssl_tpu_torch.run_script(
            config, sseg, sseg.SemanticSegmentationProxy, device='cuda',
            cli_override=False)
    torch.cuda.synchronize()
    algo = proxy.ssl_algorithm
    result = {'launches': blur.launches, 'step': algo.state.step,
              'visualized': visualized,
              'wall_s': time.perf_counter() - t0,
              'peak_gib': peak_above(held),
              'grid': (algo.mesh.data_size, algo.mesh.n_spatial),
              'records': read_records(config) if algo.mesh.rank == 0
              else None}
    with open(os.path.join(out, 'rank{0}.json'.format(algo.mesh.rank)),
              'w') as f:
        json.dump(result, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def phase_spatial_script():
    """The 1-8 GCT script (2+2 @321, float32) through ``run_script`` with
    ``--distributed --spatial-train 2 --visualize`` on two gloo ranks
    sharing the card, against the same script in one process: 3
    iterations, the first visualized, and the validation, its first batch
    visualized. The first iteration's losses within rtol 2e-3 (the
    thresholded fc/dc 2e-2), every record's lr equal, the later records'
    and the validation's gaps printed (scores in [0, 1], losses finite);
    rank 0's PNGs against one process's (``compare_visuals``: the train
    maps held against those one process draws on rank 0's weights of the
    visualization, both runs' own printed); blur launches 6 an iteration
    and 6 more for the visualization on each rank. Returns rank 0's
    launches and its visualization's."""
    import tempfile
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.ops import blur
    from pixelssl_tpu_torch.tasks import sseg

    tag = '[36/40]'
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as out:
            wall = run_bounded(tag, torchrun(SPATIAL_N) + [
                os.path.abspath(__file__), '--worker', 'spatial_script',
                '--out', out])
            ranks = []
            for r in range(SPATIAL_N):
                with open(os.path.join(out, 'rank{0}.json'.format(r))) as f:
                    ranks.append(json.load(f))
            one_out = os.path.join(out, 'one')
            os.makedirs(one_out)
            config = spatial_script_config(one_out)
            blur.launches = 0
            torch.cuda.synchronize()
            held = reset_peak()
            t0 = time.perf_counter()
            same = os.path.join(out, 'same')
            os.makedirs(same)
            with timed_visualizations(again=(os.path.join(
                    out, 'visual_state.pt'), same)) as one_visualized:
                proxy = pixelssl_tpu_torch.run_script(
                    config, sseg, sseg.SemanticSegmentationProxy,
                    device='cuda', cli_override=False)
            torch.cuda.synchronize()
            one_wall = time.perf_counter() - t0
            one_peak = peak_above(held)
            one_launches = blur.launches
            one_records = read_records(config)
            iters = len(proxy.train_loader)
            del proxy
            rank_config = spatial_script_config(os.path.join(out, 'run'))
            visual_gap = compare_visuals(
                tag, 'GCT script --visualize', visual_pngs(rank_config),
                visual_pngs(config), read_pngs(same, 'train/'))
        gaps = {'first': 0.0, 'first_loose': 0.0, 'later': 0.0,
                'val_loss': 0.0, 'score': 0.0}
        records = ranks[0]['records']
        if [r['phase'] for r in records] != \
                [r['phase'] for r in one_records]:
            raise AssertionError('{0} records {1} vs {2}'.format(
                tag, records, one_records))
        for a, b in zip(records, one_records):
            if b['phase'] == 'train' and a['lr'] != b['lr']:
                raise AssertionError('{0} iteration {1}: lr {2} vs {3}'
                                     .format(tag, b['iter'], a['lr'],
                                             b['lr']))
            for k, v in b.items():
                if 'metric' in k:
                    if not 0.0 <= a[k] <= 1.0:
                        raise AssertionError('{0} {1} = {2}'.format(
                            tag, k, a[k]))
                    gaps['score'] = max(gaps['score'], abs(a[k] - v))
                    continue
                if not k.endswith('_loss'):
                    continue
                if not math.isfinite(a[k]):
                    raise AssertionError('{0} {1} = {2}'.format(tag, k,
                                                                a[k]))
                gap = abs(a[k] - v) / max(abs(v), 1e-12)
                if b['phase'] == 'val':
                    gaps['val_loss'] = max(gaps['val_loss'], gap)
                elif b['iter'] > 1:
                    gaps['later'] = max(gaps['later'], gap)
                else:
                    loose = '_fc_' in k or '_dc_' in k
                    key = 'first_loose' if loose else 'first'
                    gaps[key] = max(gaps[key], gap)
                    if not (gap <= (2e-2 if loose else 2e-3) or
                            abs(a[k] - v) <= 1e-6):
                        raise AssertionError('{0} iteration 1 {1}: {2} vs '
                                             '{3}'.format(tag, k, a[k], v))
        for rank, r in enumerate(ranks):
            if r['grid'] != [1, SPATIAL_N] or r['step'] != iters or \
                    r['launches'] != BLUR_LAUNCHES_PER_STEP * (iters + 1) or \
                    [v['launches'] for v in r['visualized']] != \
                    [BLUR_LAUNCHES_PER_STEP]:
                raise AssertionError('{0} rank {1}: {2}'.format(
                    tag, rank, {k: v for k, v in r.items()
                                if k != 'records'}))
        say('{0} GCT script @321 2+2, --distributed --spatial-train {1} on '
            '{1} gloo ranks ({2:.1f} s): {3} iterations and validation; the '
            'first iteration\'s losses equal one process\'s (largest '
            'relative gap {4:.3g}, thresholded {5:.3g}), the lr of every '
            'record equal; later records {6:.3g}, val losses {7:.3g}, '
            'scores {8:.3g} apart (the recipe\'s lr from random weights and '
            'the FD\'s Adam magnify the float32 difference step by step, '
            'phase 35); blur launches {9} a rank, one process {10}'.format(
                tag, SPATIAL_N, wall, iters, gaps['first'],
                gaps['first_loose'], gaps['later'], gaps['val_loss'],
                gaps['score'], ranks[0]['launches'], one_launches))
        say('{0} run_script wall s: one process {1:.1f}, ranks {2}; peak '
            'memory (above what each held) one process {3:.2f} GiB, a rank '
            '{4}'.format(
                tag, one_wall, ' / '.join('{0:.1f}'.format(r['wall_s'])
                                          for r in ranks), one_peak,
                ' / '.join('{0:.2f} GiB'.format(r['peak_gib'])
                           for r in ranks)))
        say('{0} --visualize: rank 0 wrote one process\'s PNG names and '
            'sizes, inputs and GT equal; its model maps against one '
            'process\'s on the same weights (rank 0\'s after the first '
            'step) {1:.4f} of the coloured pixels the same, {2:.4f} of the '
            'gray ones more than a level apart; against one process\'s own '
            'run (its weights, and the val maps after 3 steps) {3:.4f}, '
            '{4:.4f}; a visualization {5:.1f} ms of wall time one process, '
            'ranks {6}; blur launches of a visualization, ranks {7}'.format(
                tag, visual_gap['colour_same'], visual_gap['gray_apart'],
                visual_gap['own_colour_same'], visual_gap['own_gray_apart'],
                one_visualized[0]['ms'],
                ' / '.join('{0:.1f}'.format(r['visualized'][0]['ms'])
                           for r in ranks),
                ' / '.join(str(r['visualized'][0]['launches'])
                           for r in ranks)))
        # one process: the iterations, its visualization and the one again
        # on rank 0's weights
        if one_launches != BLUR_LAUNCHES_PER_STEP * (iters + 2) or \
                one_visualized[0]['again_launches'] != \
                BLUR_LAUNCHES_PER_STEP:
            raise AssertionError('{0} one process: {1} blur launches'
                                 .format(tag, one_launches))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
    return ranks[0]['launches'], ranks[0]['visualized'][0]['launches']


# --spatial-val of phase 37 (DeepLab-v2 @1025, with --visualize) and of
# phase 39 (PSPNet @513, padded to 544; the sreg demo's unet_lite base 32
# at 60 px, padded to 64, whose padded rows lie on rank 1 and must score
# nothing): {case: (model or task, image size)}
SPATIAL_VAL_CASES = {'deeplabv2': ('deeplabv2', SPATIAL_VAL_SIZE),
                     'pspnet': ('pspnet', 513), 'sreg': ('sreg', 60)}


def spatial_val_config(out, seed, case='deeplabv2'):
    """Validation only of ``SPATIAL_VAL_SAMPLES`` synthetic images (padded
    to the 32-px bucket) at random weights from ``seed``, float32:
    SupOnly on DeepLab-v2/ResNet-101 (each image's PNGs written,
    ``--visualize``) or PSPNet/ResNet-101, 21 classes; or the sreg demo's
    SupOnly config (``case`` 'sreg')."""
    import collections
    model, size = SPATIAL_VAL_CASES[case]
    if model == 'sreg':
        config = load_sreg_demo()['make_config']('ssl_null', out)
        config.update(exp_id='spatial_val', validation=True,
                      synthetic_samples=SPATIAL_VAL_SAMPLES, im_size=size,
                      bf16=False, seed=seed)
        return config
    return collections.OrderedDict([
        ('exp_id', 'spatial_val'), ('out_path', out),
        ('ssl_algorithm', 'ssl_null'), ('validation', True),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', SPATIAL_VAL_SAMPLES),
        ('models', {'model': model}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet101'), ('output_stride', 16),
        ('im_size', size), ('num_classes', 21),
        ('batch_size', 1), ('unlabeled_batch_size', 0), ('bf16', False),
        ('lr', 2.5e-4), ('num_workers', 0), ('seed', seed),
        ('visualize', model == 'deeplabv2'), ('visual_freq', 1)])


def spatial_val_run(config):
    """``run_script`` of ``config``; (scores and losses, wall s, peak GiB
    of the run and of a second validation without the PNGs, the eval
    forward's ms per image on that one, the PNGs of the first, and for
    the sreg task the valid pixels it scored)."""
    import torch
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sreg, sseg

    task, proxy_class = ((sreg, sreg.PixelRegressionProxy)
                         if 'base_channels' in config else
                         (sseg, sseg.SemanticSegmentationProxy))
    torch.cuda.synchronize()
    held = reset_peak()
    t0 = time.perf_counter()
    proxy = pixelssl_tpu_torch.run_script(
        config, task, proxy_class, device='cuda', cli_override=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    algo = proxy.ssl_algorithm
    scores = {k: m.avg for k, m in algo.meters.items()
              if 'metric' in k or k.endswith('_loss')}
    valid = [float(m.sum[2]) for k, m in algo.meters.items()
             if k.endswith('_err_sums')]
    pngs = (visual_pngs(config) if algo.mesh.rank == 0 and
            config.get('visualize') else None)
    peak = peak_above(held)
    algo.args.visualize = False
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    algo.validate(proxy.val_loader, 0)
    end.record()
    torch.cuda.synchronize()
    return (scores, wall, (peak, peak_above(held)),
            start.elapsed_time(end) / len(proxy.val_loader), pngs,
            valid[0] if valid else None)


def worker_spatial_val(out, seed, cases):
    """One of the two ranks of phase 37 or 39: ``spatial_val_config`` of
    each of ``cases`` with ``--spatial-val --distributed``, both ranks on
    card 0 over gloo; writes ``<case>_rank<r>.json``."""
    import torch
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    gloo_on_card_0()
    rank = torch.distributed.get_rank()
    for case in cases:
        config = spatial_val_config(os.path.join(out, case), seed, case)
        config.update(spatial_val=True, distributed=True)
        scores, wall, peak, ms, _, valid = spatial_val_run(config)
        with open(os.path.join(out, '{0}_rank{1}.json'.format(case, rank)),
                  'w') as f:
            json.dump({'scores': scores, 'wall_s': wall, 'peak_gib': peak,
                       'ms_per_image': ms, 'valid': valid}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def phase_spatial_val(seed):
    """``--spatial-val --visualize`` on two gloo ranks sharing the card
    against one process's bucketed validation of the same padded images:
    SupOnly on DeepLab-v2/ResNet-101 at 1025 px (padded to 1056)
    (``spatial_val_cells``), rank 0's PNGs of each image, from the rows
    both ranks hold, against one process's (``compare_visuals``)."""
    spatial_val_cells('[37/40]', ('deeplabv2',), seed)


def phase_spatial_val_models(seed):
    """``--spatial-val`` on two gloo ranks as in phase 37: SupOnly on
    PSPNet/ResNet-101 at 513 px (padded to 544), and the sreg demo's
    ``unet_lite`` at 60 px (padded to 64), whose valid pixels, on each
    rank and in one process, are the unpadded ones."""
    spatial_val_cells('[39/40]', ('pspnet', 'sreg'), seed)


def spatial_val_cells(tag, cases, seed):
    """Each of ``cases`` (``SPATIAL_VAL_CASES``) validated on two gloo ranks
    (``worker_spatial_val``) and in one process, float32, cuDNN
    deterministic: losses rtol 1e-5, scores atol 1e-4 (a pixel whose best
    two logits tie to float noise may take the other class); the PNGs
    where the case writes them, the valid pixels where it counts them;
    each one's peak memory and ms an image printed."""
    import tempfile
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as out:
            wall = run_bounded(tag, torchrun(SPATIAL_N) + [
                os.path.abspath(__file__), '--worker', 'spatial_val',
                '--out', out, '--seed', str(seed), '--cases',
                ','.join(cases)])
            say('{0} {1} gloo ranks: {2:.1f} s'.format(tag, SPATIAL_N, wall))
            for case in cases:
                spatial_val_case(tag, case, seed, out)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True


def spatial_val_case(tag, case, seed, out):
    ranks = []
    for r in range(SPATIAL_N):
        with open(os.path.join(out, '{0}_rank{1}.json'.format(case, r))) as f:
            ranks.append(json.load(f))
    config = spatial_val_config(os.path.join(out, case + '_one'), seed, case)
    scores, one_wall, one_peak, one_ms, one_pngs, one_valid = \
        spatial_val_run(config)
    model, size = SPATIAL_VAL_CASES[case]
    padded = -(-size // 32) * 32
    gaps = {'loss': 0.0, 'score': 0.0}
    for rank, r in enumerate(ranks):
        if set(r['scores']) != set(scores):
            raise AssertionError('{0} rank {1}: {2} vs {3}'.format(
                tag, rank, r['scores'], scores))
        for k, v in scores.items():
            a = r['scores'][k]
            if k.endswith('_loss'):
                gaps['loss'] = max(gaps['loss'], abs(a - v) / abs(v))
                ok = math.isclose(a, v, rel_tol=1e-5)
            else:
                gaps['score'] = max(gaps['score'], abs(a - v))
                ok = abs(a - v) <= 1e-4
            if not ok:
                raise AssertionError('{0} rank {1} {2}: {3} vs {4}'
                                     .format(tag, rank, k, a, v))
        if one_valid is not None and r['valid'] != one_valid:
            raise AssertionError('{0} rank {1}: {2} valid pixels, one '
                                 'process {3}'.format(tag, rank, r['valid'],
                                                      one_valid))
    what = ('sreg unet_lite base 32' if model == 'sreg' else
            '{0}/ResNet-101'.format(MODEL_NAMES[model]))
    say('{0} --spatial-val on {1} gloo ranks, {2} @{3} (padded to {4}), {5} '
        'images: equal to one process (largest loss gap {6:.3g} relative, '
        'score gap {7:.3g}); {8}'.format(
            tag, SPATIAL_N, what, size, padded, SPATIAL_VAL_SAMPLES,
            gaps['loss'], gaps['score'], '  '.join(
                '{0} {1:.5f}'.format(k, v) for k, v in
                sorted(scores.items()))))
    if one_valid is not None:
        if one_valid != SPATIAL_VAL_SAMPLES * size * size:
            raise AssertionError('{0} {1} valid pixels, not {2} x {3} x {3}'
                                 .format(tag, one_valid, SPATIAL_VAL_SAMPLES,
                                         size))
        say('{0} valid pixels scored, one process and each rank: {1:.0f} = '
            '{2} x {3} x {3} (the padded rows none)'.format(
                tag, one_valid, SPATIAL_VAL_SAMPLES, size))
    if one_pngs is not None:
        rank_config = spatial_val_config(os.path.join(out, case), seed, case)
        visual_gap = compare_visuals(tag, '--spatial-val --visualize',
                                     visual_pngs(rank_config), one_pngs)
        say('{0} --visualize: rank 0 wrote one process\'s {1} PNGs of the '
            'padded images, inputs and GT equal, the predictions {2:.4f} of '
            'the pixels the same colour'.format(tag, len(one_pngs),
                                               visual_gap['colour_same']))
    say('{0} {1}: peak memory (above what each held; the run, then a '
        'validation without its PNGs) one process {2:.2f} / {3:.2f} GiB, a '
        'rank {4}; ms an image one process {5:.1f}, ranks {6}'.format(
            tag, what, one_peak[0], one_peak[1], ' / '.join(
                '{0:.2f} / {1:.2f} GiB'.format(*r['peak_gib'])
                for r in ranks), one_ms,
            ' / '.join('{0:.1f}'.format(r['ms_per_image']) for r in ranks)))



# ---------------------------------------------------------------------------
# phase 40: the bf16 policy on the card
# ---------------------------------------------------------------------------

# a bf16 output of a convolution, card against CPU, may differ by one ulp
# where cuDNN sums the window in another order than oneDNN: at most this
# share of the outputs
BF16_FLIP_SHARE = 0.02
# the first bf16 step, card against CPU: the parameters' and statistics'
# gaps within this times the CPU's own spread, the losses' within
# BF16_LOSS_FACTOR times it (tests/test_torch_bf16.py's STEP_FACTOR and
# SPREAD_FACTOR)
BF16_STEP_FACTOR = 1.1
BF16_LOSS_FACTOR = 1.25
BF16_NUDGES = 2


def bf16_ulp(x):
    """The bf16 ulp at ``x`` (float32 tensor)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def bf16_site_modules(seed):
    """(name, module on the CPU, input shape) of phase 40's sites, their
    weights and biases drawn from ``seed``."""
    import torch
    from pixelssl_tpu_torch.models import layers
    from pixelssl_tpu_torch.models.deeplab_v2 import ASPPClassifier
    from pixelssl_tpu_torch.models.pspnet import PixelShuffleBlock

    torch.manual_seed(seed)
    sites = [
        ('aspp', ASPPClassifier(256, 21), (4, 256, 21, 21)),
        ('flaw_detector conv 4x4/2', layers.Conv2d(24, 64, 4, stride=2,
                                                   padding=1),
         (4, 24, 96, 96)),
        ('flaw_detector conv 4x4/1', layers.Conv2d(128, 128, 4, padding=1),
         (4, 128, 23, 23)),
        ('discriminator conv 4x4/2', layers.Conv2d(21, 64, 4, stride=2,
                                                   padding=1),
         (4, 21, 321, 321)),
        ('classifier (float32 sum)', layers.Conv2d(
            512, 1, 4, stride=2, padding=1, float32_out=True),
         (4, 512, 21, 21)),
        ('rotation fc (float32 sum)', layers.Linear(4096, 4,
                                                    float32_out=True),
         (16, 4096)),
        ('pspnet shuffle conv', PixelShuffleBlock(21), (4, 21, 65, 65)),
    ]
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, module, _ in sites:
            for name, p in module.named_parameters():
                p.copy_(torch.randn(p.shape, generator=g) *
                        (0.5 if name.endswith('bias') else 0.05))
    return sites


def bf16_compare(tag, what, got, ref, exact=False):
    """Card ``got`` against CPU ``ref``: (share of differing elements, the
    largest difference in bf16 ulps of ``ref``'s largest magnitude)."""
    got, ref = got.float().cpu(), ref.float()
    share = float((got != ref).float().mean())
    worst = float((got - ref).abs().max() / bf16_ulp(ref.abs().max()))
    say('{0} {1}: {2:.5f} of {3} elements differ, the largest by {4:.3f} '
        'ulp of the output\'s scale'.format(tag, what, share, ref.numel(),
                                            worst))
    if exact and share > 0.0:
        raise AssertionError('{0}: card and CPU differ'.format(what))
    if share > BF16_FLIP_SHARE or worst > 1.0:
        raise AssertionError('{0}: {1} of the outputs differ, by up to {2} '
                             'ulp'.format(what, share, worst))
    return share


def phase_bf16_layers(seed, tag):
    import copy
    import torch
    from pixelssl_tpu_torch.models import layers

    rng = torch.Generator().manual_seed(seed)
    for name, module, shape in bf16_site_modules(seed):
        x = torch.randn(shape, generator=rng)
        outs = []
        for device in ('cpu', 'cuda'):
            m = copy.deepcopy(module).to(device)
            xd = x.to(device)
            with torch.no_grad(), layers.bf16_autocast(xd):
                outs.append(m(xd))
        want = torch.float32 if 'float32' in name or name == 'aspp' else \
            torch.bfloat16
        if outs[1].dtype != want:
            raise AssertionError('{0}: {1} on the card'.format(
                name, outs[1].dtype))
        bf16_compare(tag, name, outs[1], outs[0])

    bn = layers.SyncBatchNorm(256)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=rng)
        bn.bias.normal_(0.0, 0.5, generator=rng)
        bn.running_mean.normal_(0.0, 0.5, generator=rng)
        bn.running_var.uniform_(0.5, 1.5, generator=rng)
    x = (torch.randn((4, 256, 41, 41), generator=rng) * 2.0 + 0.5).bfloat16()
    for mode in ('train', 'eval'):
        outs = []
        for device in ('cpu', 'cuda'):
            m = copy.deepcopy(bn).to(device).train(mode == 'train')
            with torch.no_grad():
                outs.append(m(x.to(device)))
        bf16_compare(tag, 'BatchNorm ' + mode, outs[1], outs[0])
    # the apply alone, from the CPU's statistics: two bf16 ops, exact
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
    inv = torch.rsqrt(var + bn.eps) * bn.weight.detach()
    shift = bn.bias.detach() - mean * inv
    outs = [xd * inv.to(xd.device, torch.bfloat16)[None, :, None, None] +
            shift.to(xd.device, torch.bfloat16)[None, :, None, None]
            for xd in (x, x.cuda())]
    bf16_compare(tag, 'BatchNorm apply, the CPU\'s inv and shift', outs[1],
                 outs[0], exact=True)
    y = torch.randn((64, 4096), generator=rng).bfloat16()
    bf16_compare(tag, 'LeakyReLU(0.2)', layers.leaky_relu_02(y.cuda()),
                 layers.leaky_relu_02(y), exact=True)


def nudged_batch(batch, seed, share=0.01):
    """``batch`` with its images rounded to bf16 (as the first convolution
    takes them) and ``share`` of their elements moved up by one bf16
    ulp."""
    import torch
    img = batch['inp'][0].bfloat16().float()
    g = torch.Generator().manual_seed(seed)
    moved = torch.rand(img.shape, generator=g) < share
    img = torch.where(moved, img + bf16_ulp(img), img)
    return dict(batch, inp=(img,))


def first_bf16_step(args, states, batch, device):
    """The losses and the float32 states after one step of a fresh build
    on ``device`` from ``states`` and ``batch`` (CPU tensors)."""
    from pixelssl_tpu_torch import harness

    algo = harness.build_algorithm(args, device=device, iters_per_epoch=2)
    for key, module in algo.modules.items():
        module.load_state_dict(states[key])
    on = {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v)
          for k, v in batch.items()}
    losses = {k: float(v) for k, v in algo.train_step(on).items()
              if k.endswith('_loss')}
    return losses, {key: {k: t.detach().float().cpu()
                          for k, t in m.state_dict().items()
                          if not k.endswith('num_batches_tracked')}
                    for key, m in algo.modules.items()}


def state_mean_gaps(a, b):
    """Mean |diff| over every parameter and every BN running statistic."""
    import torch
    out = {}
    for kind in ('params', 'stats'):
        diffs = [(a[m][k] - b[m][k]).abs().reshape(-1) for m in b
                 for k in b[m] if ('running_' in k) == (kind == 'stats')]
        out[kind] = float(torch.cat(diffs).mean())
    return out


def phase_bf16_steps(seed, tag):
    from pixelssl_tpu_torch import harness

    small = dict(backbone='resnet10', num_classes=5, batch_size=4,
                 unlabeled_batch_size=2, epochs=20, bf16=True, seed=seed)
    cases = (('ssl_mt', 'MT', 64, dict(MT_CONFIG, lr=5e-5)),
             ('ssl_gct', 'GCT', 96, dict(GCT_CONFIG, lr=5e-5,
                                          dc_rampup_epochs=1)))
    for algo_name, what, im, config in cases:
        args = harness.default_args(algo_name, im_size=im,
                                    **dict(small, **config))
        init = harness.build_algorithm(args, device='cpu', iters_per_epoch=2)
        states = {k: {n: t.clone() for n, t in m.state_dict().items()}
                  for k, m in init.modules.items()}
        batch = harness.synthetic_batch(args, device='cpu', seed=seed)
        ref_losses, ref = first_bf16_step(args, states, batch, 'cpu')
        spreads = [first_bf16_step(args, states,
                                   nudged_batch(batch, seed + 1 + i), 'cpu')
                   for i in range(BF16_NUDGES)]
        losses, got = first_bf16_step(args, states, batch, 'cuda')

        def rel(row):
            return sum(abs(row[k] - v) / max(abs(v), 1e-6)
                       for k, v in ref_losses.items()) / len(ref_losses)
        loss_gap = rel(losses)
        loss_spread = max(rel(row) for row, _ in spreads)
        gaps = state_mean_gaps(got, ref)
        spread = {kind: sum(state_mean_gaps(st, ref)[kind]
                            for _, st in spreads) / BF16_NUDGES
                  for kind in gaps}
        say('{0} first bf16 {1} step (ResNet-10 @{2}), card against CPU: '
            'losses\' mean relative gap {3:.3g} (the CPU\'s spread {4:.3g}); '
            'parameters\' mean |diff| {5:.3g} ({6:.3g}); BN statistics\' '
            '{7:.3g} ({8:.3g}); losses card/CPU {9}'.format(
                tag, what, im, loss_gap, loss_spread, gaps['params'],
                spread['params'], gaps['stats'], spread['stats'],
                '  '.join('{0} {1:.6g}/{2:.6g}'.format(k, losses[k], v)
                          for k, v in sorted(ref_losses.items()))))
        if loss_gap > BF16_LOSS_FACTOR * loss_spread:
            raise AssertionError('{0}: losses part by {1}, the CPU\'s own '
                                 'spread {2}'.format(what, loss_gap,
                                                     loss_spread))
        for kind in gaps:
            if gaps[kind] > BF16_STEP_FACTOR * spread[kind]:
                raise AssertionError('{0}: {1} part by {2}, the CPU\'s own '
                                     'spread {3}'.format(
                                         what, kind, gaps[kind],
                                         spread[kind]))


def bn_calls(algo, batch):
    """Every ``SyncBatchNorm`` call of one eager step of ``algo``: (the
    module, a copy of its input, whether the step differentiates it, and
    whether it normalised with the batch's statistics)."""
    from pixelssl_tpu_torch.models.layers import SyncBatchNorm

    calls, handles = [], []

    def hook(module, args):
        x = args[0]
        calls.append((module, x.detach().clone(), x.requires_grad,
                      module.training))
    for m in algo.modules.values():
        for sub in m.modules():
            if isinstance(sub, SyncBatchNorm):
                handles.append(sub.register_forward_pre_hook(hook))
    try:
        algo.train_step(batch)
    finally:
        for h in handles:
            h.remove()
    return calls


def bn_replay(calls, native):
    """A function that runs ``calls`` again, forward and backward where the
    step differentiated them, through the port's ``SyncBatchNorm`` or, with
    ``native``, PyTorch's ``batch_norm`` on the same bf16 input (cuDNN, the
    policy before), each in the mode of its call; on copies of the
    modules."""
    import copy
    import torch
    import torch.nn.functional as F

    mods = [copy.deepcopy(m).train(training)
            for m, _, _, training in calls]
    grads = [torch.randn_like(x) for _, x, _, _ in calls]

    def run():
        outs, outgrads = [], []
        for m, (_, x, rg, training), g in zip(mods, calls, grads):
            x = x.detach().requires_grad_(rg)
            with torch.set_grad_enabled(rg):
                if native:
                    y = F.batch_norm(x, m.running_mean, m.running_var,
                                     m.weight, m.bias, training, m.momentum,
                                     m.eps)
                else:
                    y = m(x)
            if rg:
                outs.append(y)
                outgrads.append(g)
        torch.autograd.backward(outs, outgrads)
    return run


def phase_bf16_full_width(seed, tag):
    import statistics
    import torch

    rows = []
    for algo_name, what, config in (('ssl_mt', 'MT', MT_CONFIG),
                                    ('ssl_gct', 'GCT', GCT_CONFIG)):
        args = full_width_args(algo_name, seed, batch_size=8,
                               unlabeled_batch_size=4, **config)
        held = reset_peak()
        algo, _ = build_full_width(args, tag, what)
        batches = multi_batches(args, seed, 2 * MULTI_N + 3)
        _, eager_times = eager_run(algo, batches[:3])
        _, graph_times = graph_run(algo, batches[3:], MULTI_N)
        peak = peak_above(held)
        eager_ms = statistics.median(eager_times[1:])
        replay_ms = [t for kind, t in graph_times if kind == 'chunk'][1] / \
            MULTI_N
        step = busy_share(lambda: algo.train_steps(batches[:1]))
        calls = bn_calls(algo, batches[0])
        shares, kernels = {}, {}
        for label, native in (('bf16 apply', False), ('native', True)):
            run = bn_replay(calls, native)
            run()
            torch.cuda.synchronize()
            events = profile_kernels(run)
            shares[label] = sum(e.self_device_time_total
                                for e in events) / 1e3
            kernels[label] = sum(e.count for e in events)
        step_kernel_ms = None if step is None else step[0]
        say('{0} {1} 4+4 @321 bf16: {2:.2f} ms a step eager, {3:.2f} '
            'replayed; peak {4:.2f} GiB; a replay\'s kernel time {5} ms; '
            'its {6} BatchNorm calls alone {7:.3f} ms of kernel time in '
            '{10} kernels ({8}), through the native batch_norm {9:.3f} ms '
            'in {11}'.format(
                tag, what, eager_ms, replay_ms, peak,
                'not seen' if step is None else '{0:.3f}'.format(step[0]),
                len(calls), shares['bf16 apply'],
                'share not measured' if step_kernel_ms is None else
                '{0:.1f}% of it'.format(100.0 * shares['bf16 apply'] /
                                        step_kernel_ms),
                shares['native'], kernels['bf16 apply'],
                kernels['native']))
        rows.append('{0} {1:.2f} ms / {2:.2f} GiB / BN {3:.3f} ms (native '
                    '{4:.3f})'.format(what, replay_ms, peak,
                                      shares['bf16 apply'],
                                      shares['native']))
        del algo, calls, batches
        torch.cuda.empty_cache()
    say('{0} replayed ms a step / peak / BatchNorm kernel ms a step: '
        '{1}'.format(tag, '; '.join(rows)))


def phase_bf16(seed):
    tag = '[40/40]'
    phase_bf16_layers(seed, tag)
    phase_bf16_steps(seed, tag)
    phase_bf16_full_width(seed, tag)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    # the processes that phases 33 and 34 start run this script again
    parser.add_argument('--worker', choices=('gct', 'gloo', 'spatial',
                                             'spatial_models',
                                             'spatial_script',
                                             'spatial_val'),
                        help=argparse.SUPPRESS)
    parser.add_argument('--out', help=argparse.SUPPRESS)
    parser.add_argument('--cases', help=argparse.SUPPRESS)
    parser.add_argument('--distributed', action='store_true',
                        help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)

    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available on this host',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pixelssl_tpu_torch  # noqa: F401
    except ImportError as exc:
        print('chip_smoke: the port is not beside this script: {0}'.format(
            exc), file=sys.stderr)
        return 2

    # float32 stays float32 (the blur's plain version and yardstick are
    # float32 matmuls); the convolutions run in bf16 under autocast
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.worker == 'gct':
        worker_gct(opts.out, opts.distributed)
        return 0
    if opts.worker == 'gloo':
        worker_gloo(opts.out, opts.seed)
        return 0
    if opts.worker in ('spatial', 'spatial_models'):
        worker_spatial(opts.out, opts.seed, SPATIAL_CASES
                       if opts.worker == 'spatial' else SPATIAL_MODEL_CASES)
        return 0
    if opts.worker == 'spatial_script':
        worker_spatial_script(opts.out)
        return 0
    if opts.worker == 'spatial_val':
        worker_spatial_val(opts.out, opts.seed, opts.cases.split(','))
        return 0
    torch.backends.cudnn.benchmark = True

    t_start = time.perf_counter()
    walls = []

    def run(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        walls.append('{0} {1:.1f}'.format(label, t1 - t0))
        say('chip_smoke: phase {0} took {1:.1f} s, {2:.1f} s so far'.format(
            label, t1 - t0, t1 - t_start))
        return out

    try:
        card = run('1', phase_device)
        run('2', phase_build)
        rows, floor_ms = run('3', phase_kernel, opts.seed, {
            'script_gct': script_blur_cases(SCRIPT_GCT),
            'pspnet_gct': script_blur_cases(SCRIPT_PSP_GCT),
            'sreg_gct': sreg_blur_cases(),
            'visualize_gct': script_debug_blur_cases(SCRIPT_GCT),
            'spatial_gct': spatial_blur_cases(*GCT_BATCH, IM_SIZE),
            'spatial_gct_rank1': spatial_blur_cases(*GCT_BATCH, IM_SIZE,
                                                    rank=1),
            'spatial_script_gct': spatial_blur_cases(
                *script_batch(SCRIPT_GCT)),
            'spatial_visualize_gct': spatial_blur_cases(
                *script_batch(SCRIPT_GCT),
                cases=script_debug_blur_cases(SCRIPT_GCT)),
            'spatial_psp_gct': spatial_blur_cases(*PSP_GCT_BATCH, 513),
            'spatial_psp_gct_rank1': spatial_blur_cases(*PSP_GCT_BATCH, 513,
                                                        rank=1)})
        run('4', phase_small_reference, opts.seed)
        launches = run('5', phase_main_path, opts.seed, STEPS)
        run('6', phase_small_mt_null, opts.seed, STEPS)
        mt_algo = run('7', phase_mt, opts.seed, STEPS)
        null_algo = run('8', phase_null, opts.seed, STEPS)
        run('9', phase_validate_checkpoint, mt_algo, null_algo, opts.seed)
        del mt_algo, null_algo
        run('10', phase_script_mt)
        script_launches = run('11', phase_script_gct)
        run('12', phase_small_new, opts.seed, STEPS)
        new_algos = run('13', phase_new_full_width, opts.seed, STEPS)
        run('14', phase_new_validate_checkpoint, new_algos, opts.seed)
        del new_algos
        run('15', phase_script_new)
        run('16', phase_small_psp, opts.seed, STEPS)
        psp_algos = run('17', phase_psp_full_width, opts.seed, STEPS)
        run('18', phase_psp_validate_checkpoint, psp_algos, opts.seed)
        del psp_algos
        psp_launches = run('19', phase_script_psp)
        run('20', phase_voc, '[20/40]', SCRIPT_MT, 'ssl_mt', 0)
        voc_launches = run('21', phase_voc, '[21/40]', SCRIPT_GCT, 'ssl_gct',
                           BLUR_LAUNCHES_PER_STEP, multi=True,
                           native_augment=True, decoded_cache=True,
                           u8_transfer=True)
        run('22', phase_voc, '[22/40]', SCRIPT_PSP_CCT, 'ssl_cct', 0)
        sreg_launches = run('23', phase_sreg)
        run('24', phase_optimizers, opts.seed, STEPS)
        run('25', phase_sseg_flags, opts.seed, STEPS)
        multi_launches = run('26', phase_multi_step, opts.seed)
        run('27', phase_profile_dir)
        run('28', phase_eager_ingest)
        run('29', phase_bench)
        run('30', phase_serving)
        run('31', phase_rescore, opts.seed)
        visual_launches = run('32', phase_visualize)
        dist_launches = run('33', phase_distributed)
        run('34', phase_gloo, opts.seed)
        spatial_launches = run('35', phase_spatial_train, opts.seed)
        spatial_script_launches, spatial_visual_launches = run(
            '36', phase_spatial_script)
        run('37', phase_spatial_val, opts.seed)
        spatial_psp_launches = run('38', phase_spatial_models, opts.seed)
        run('39', phase_spatial_val_models, opts.seed)
        run('40', phase_bf16, opts.seed)
    except Exception:  # report which phase failed, print no result
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    # the kernel's line covers one GCT step of phase 5: two calls at each of
    # its shapes; its bound is that of the six calls' bytes and operations;
    # ``script_gct`` and ``pspnet_gct`` the same for a step of phase 11 and
    # of phase 19
    def per_step(path):
        step_rows = [r for r in rows if r['path'] == path]
        out = {key: 2 * sum(r[key] for r in step_rows)
               for key in ('ms', 'plain_ms', 'library_ms', 'device_ms',
                           'library_device_ms')}
        terms = [blur_bound_terms_ms(r['shape'][0], r['shape'][1],
                                     r['shape'][2], r['k'])
                 for r in step_rows]
        out['bound_ms'], out['bound_by'] = bound(
            2 * sum(t[0] for t in terms), 2 * sum(t[1] for t in terms))
        out['max_abs_err'] = max(r['max_abs_err'] for r in step_rows)
        return out

    gct_step, script_step = per_step('gct'), per_step('script_gct')
    script_step['launches'] = script_launches
    pspnet_step = per_step('pspnet_gct')
    pspnet_step['launches'] = psp_launches
    # phase 21 runs the DeepLab-v2 GCT script's shapes on VOC data
    voc_step = dict(script_step, launches=voc_launches)
    sreg_step = per_step('sreg_gct')
    sreg_step['launches'] = sreg_launches
    # phase 26's GCT graph run: the harness step's shapes at 8+4 in float32,
    # 9 steps (2 eager, 7 replays of the captured step)
    multi_step = dict(gct_step, launches=multi_launches)
    # phase 32's GCT runs: the debug visualization's six calls, at the
    # whole batch of the script (2+2 @321); launches: every blur of both
    # runs, steps and visualizations
    visualize_step = per_step('visualize_gct')
    visualize_step['launches'] = sum(visual_launches.values())
    # phase 33's distributed GCT runs: the script's shapes, launches of its
    # two runs (eager, and through the CUDA graph)
    distributed_step = dict(script_step, launches=dist_launches)
    # phase 35's GCT under --spatial-train 2 (8+4 @321 in float32): rank
    # 0's strips of rows; launches over its 2 steps on rank 0. Phase 36's
    # GCT script the same at 2+2, launches over its 3 iterations and its
    # visualization on rank 0; the visualization's debug maps on rank 0's
    # strips of the whole batch, launches its own
    spatial_step = per_step('spatial_gct')
    spatial_step['launches'] = spatial_launches
    spatial_script_step = per_step('spatial_script_gct')
    spatial_script_step['launches'] = spatial_script_launches
    spatial_visualize_step = per_step('spatial_visualize_gct')
    spatial_visualize_step['launches'] = spatial_visual_launches
    # phase 38's PSPNet GCT under --spatial-train 2 (2+2 @513 in float32):
    # rank 0's strips of the 513-row maps, launches over its 2 steps
    spatial_psp_step = per_step('spatial_psp_gct')
    spatial_psp_step['launches'] = spatial_psp_launches
    kernel = {
        'name': 'blur_band',
        'route': 'cuda',
        'source': 'pixelssl_tpu_torch/csrc/blur.cu',
        'replaces': 'pixelssl_tpu/ops/blur_pallas.py:49',
        'launches': launches,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': gct_step['ms'],
        'plain_ms': gct_step['plain_ms'],
        'bound_ms': gct_step['bound_ms'],
        'bound_by': gct_step['bound_by'],
        'library_ms': gct_step['library_ms'],
        'device_ms': gct_step['device_ms'],
        'library_device_ms': gct_step['library_device_ms'],
        'launch_floor_ms': floor_ms,
        'per': 'one GCT step of phase 5 at 321 px, batch 4+4: 2x each of '
               'the calls of path gct; launches: its 3 steps. script_gct: '
               'the same for a step of the run_script of phase 11, batch '
               '2+2, from the calls of path script_gct; pspnet_gct: the '
               'same for the PSPNet GCT script of phase 19 at 513 px, batch '
               '2+2, from the calls of path pspnet_gct; voc_gct: the GCT '
               'script on the VOC fixture (phase 21), the shapes of '
               'script_gct; sreg_gct: the same for the sreg demo\'s GCT '
               '(phase 23) at 64 px, batch 1+1, from the calls of path '
               'sreg_gct; multi_step_gct: the GCT run of phase 26 through '
               'train_steps (--steps-per-dispatch 4), shapes of path gct, '
               'launches over its 9 steps, 7 of them CUDA graph replays '
               'that each add the 6 calls the capture recorded; calls of '
               'path large_k: kernels past 129 taps; visualize_gct: the '
               'debug visualization of a GCT step of the script of phase 32 '
               '(2+2 @321, the whole batch), 2x each call of path '
               'visualize_gct, launches over both runs of phase 32 (steps '
               'and visualizations); distributed_gct: the GCT script under '
               '--distributed at world size 1 (phase 33), shapes of '
               'script_gct, launches over its eager and graph runs; '
               'spatial_gct: a GCT step of phase 35 under --spatial-train 2 '
               '(8+4 @321) on rank 0, 2x each call of path spatial_gct '
               '(its strips of rows [r0-R, r1+R); rank 1\'s in path '
               'spatial_gct_rank1), launches over its 2 steps on rank 0; '
               'spatial_script_gct: the same for the GCT script under '
               '--spatial-train 2 (phase 36, 2+2), launches over its 3 '
               'iterations and its visualized one on rank 0; '
               'spatial_visualize_gct: the debug maps of that '
               'visualization (the whole batch, 2+2, on rank 0\'s strips), '
               '2x each call of path spatial_visualize_gct, launches of '
               'the visualization on rank 0; spatial_psp_gct: a PSPNet GCT '
               'step of phase 38 under --spatial-train 2 (2+2 @513) on rank '
               '0, 2x each call of path spatial_psp_gct (its strips of the '
               '513-row maps at k = 33, 65, 129; rank 1\'s in path '
               'spatial_psp_gct_rank1), launches over its 2 steps on rank '
               '0',
        'script_gct': script_step,
        'pspnet_gct': pspnet_step,
        'voc_gct': voc_step,
        'sreg_gct': sreg_step,
        'multi_step_gct': multi_step,
        'visualize_gct': visualize_step,
        'distributed_gct': distributed_step,
        'spatial_gct': spatial_step,
        'spatial_script_gct': spatial_script_step,
        'spatial_visualize_gct': spatial_visualize_step,
        'spatial_psp_gct': spatial_psp_step,
        'calls': rows,
    }
    say('chip_smoke: all 40 phases passed in {0:.1f} s (each phase\'s wall '
        's: {1})'.format(time.perf_counter() - t_start, ', '.join(walls)))
    say(card)
    say(json.dumps({'kernels': [kernel]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
