#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``adell_mri_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``, and no network. Phases, each fatal on
failure:

1. device: the card's name and power limit;
2. build: every CUDA source of the port, compiled with ``nvcc`` into
   ``build/adell_kernels/`` (seconds printed); ptxas must report no spill
   and no serialized ``wgmma`` for the Hopper kernels (conv forward and
   dx in bf16 and 3xTF32, wgrad, attention in bf16 and 3xTF32 with its
   preparation kernel);
3. kernel vs plain: ``conv3d_igemm`` against ``conv3d_igemm_reference``
   at the flagship U-Net's shapes (B=4), bf16 and f32 (TF32 off, as
   everywhere below), in both at shapes that reach every route and edge
   of the wgmma and tf32 convs (UNETR's 256x256x64 16- and 32-channel
   convs, ragged 7x9x5 volumes at 16->16 and 48->24, 256->256, Cin 8: the
   igemm route in bf16, the tf32 route's chunk of 8 in f32, and in f32
   24->24 and 8->8 at ragged volumes), and in bf16 and f32 at the narrow
   route's shapes (the U-Net stems and the 32->1 dx, UNETR's 1->16 at B=1
   and 2, the multi-sequence stems 3->3, 3->32 and their 32->3 dx, ragged
   7x9x5 at 1->16, 3->8 and 24->1), each row with its route read from the
   route counters (f32 within 1e-5 of the output scale; the tf32 route and
   the bf16 narrow one bit-equal over two runs), with times beside
   ``F.conv3d`` (cuDNN, a yardstick the port never calls) and the f32 rows
   beside two bounds: f32 products at the 3xTF32 rate and at the FMA rate;
4. serving: the flagship U-Net in bf16 from seeded random weights serves
   a 256x256x64 case through ``SegmentationInference`` (window 128x128x32,
   stride 0.5, micro-batch 4: 27 tiles in 7 window batches); the kernel's
   launch count must rise by 31 x 7, 29 x 7 of them on the wgmma route and
   2 x 7 (the two Cin=1 stems) on the narrow route, none on the igemm
   route; then the same in f32, the CLI's default precision (seconds per
   case after a warm-up case; 29 x 7 launches on the tf32 route, 2 x 7 on
   the narrow one, none on the igemm one); one window batch is compared
   with the same U-Net on the plain conv path, and every conv shape of
   that batch, bf16 and f32, is timed against its plain version, its
   bounds and the gathered-tile kernel launched straight;
5. CLI: ``python -m adell_mri_torch segmentation predict --dev cuda
   --precision bf16`` on a two-case synthetic NIfTI cohort;
6. intensity kernel vs plain: ``intensity_aug`` (K3, and K2 as its B=1
   call) against ``intensity_aug_reference`` at [4,128,128,32,1], bf16
   and f32: the noise-free chain and the noisy output element by element
   (the plain version draws the kernel's Philox stream), bit-equal over
   two runs, the noise's moments, the sigma=0 sample of a Rician call not
   rectified; every mode (noise off, Gaussian, Rician, and K2) timed with
   L2 warm and cold against its bound;
7. conv backward vs plain: for every stride-1 conv shape of the flagship
   forward at B=4, dx/dW/dbias of ``conv3d_igemm_train`` against autograd
   through ``conv3d_igemm_reference``, f32 (TF32 off) and bf16; the dx
   launches timed against their bound, bf16 and f32; dW (``conv3d_weight_grad``: the
   wgrad kernel on 29 of the 31 classes, the patch product on the stems)
   against its plain version (the patch product) within one bf16 ulp and,
   on the kernel, bit-equal over two runs, timed beside the plain version,
   cuDNN's weight gradient (a yardstick the port never calls) and its
   bound, with the bytes each adds to peak memory, summed per step over
   the kernel's 29 and all 31; in f32 (all 31 on the patch product) beside
   cuDNN's f32 weight gradient (TF32 off) and its 3xTF32 and FMA bounds;
8. training: the flagship U-Net (seed 0, bf16, augmentation on, B=4 at
   128x128x32) takes one warm-up step and 3 timed steps with the launch
   counts reset just before (per step 29 + 2 of 31 forward and 29 + 1 of 30
   dx launches on the wgmma + narrow routes: the stems and the dx of 1->32,
   whose output has one channel, take the narrow one; 29 wgrad launches
   and 2 patch products for dW);
   every parameter gets a finite, non-zero
   gradient; ten steps on one batch without augmentation lower the loss;
   in f32, the CLI's default precision, a warm-up step and 2 timed steps
   with 29 + 29 launches a step on the tf32 route (the stems and the 32->1
   dx on the narrow one, 31 dW patch products), then one step's loss and
   gradient norm match the plain conv path;
9. CLI: ``segmentation train --dev cuda --precision bf16`` on a 4-case
   synthetic cohort at the flagship size (one epoch of 2 steps), then
   ``segmentation predict --dev cuda`` on the checkpoint it wrote;
10. attention kernels vs plain: ``flash_attention_fwd`` (out, m, l),
    ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` against their
    plain versions at q, k, v [1,8,2048,64] and [2,8,2048,64] (UNETR's
    serving and training shapes), a ragged shape (Nq 2050, Nkv 2311),
    head dim 32, either sequence at the edges of the 64-row tiles (1, 63,
    64, 65, 127, 128, 129 tokens against 2048) and B x H of 1 x 1 and
    4 x 8, bf16 and f32 (f32 on the 3xTF32 kernels: the forward held to
    2e-5 of the output scale, m to 1e-4 of its scale and l to 1e-4
    relative, dQ and dK/dV to 1e-4 of the output scale); the forward, dQ
    and dK/dV bit-equal over two runs in both types; the f32 kernels'
    preparation kernel bit-equal to its plain version
    (``flash_tf32x3_image_reference``, all three kinds); timed beside
    their bounds, the plain versions and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls:
    forward, forward + backward, and by difference its backward alone);
11. UNETR serving: ``sample_configs/unetr.yaml`` at full width in bf16
    from seeded weights serves one 256x256x64 case as one window through
    ``SegmentationInference``: 8 forward-attention launches and 9 conv
    launches per case (8 on the wgmma route, the image's 1->16 on the narrow
    one); the same case through the kernels' plain versions
    agrees (within 5e-2 on a probability); then the same in f32, the CLI's
    default precision (8 launches of the 3xTF32 forward, 8 convs on the
    tf32 route and 1 on the narrow one; within 1e-3); seconds per case
    after a warm-up case;
12. UNETR training: B=2 whole volumes, bf16, augmentation on, dropout 0:
    a warm-up step and timed steps with 8 forward, 8 dQ and 8 dK/dV
    launches each, 8 + 1 of 9 conv launches on the wgmma + narrow routes and
    8 of 8 dx on the wgmma route, 8 wgrad launches and 1 patch product
    for dW; one step at the yaml's B=4 with the same launches, its peak
    memory beside B=2's and a finite loss; every parameter gets a finite,
    non-zero gradient; an
    f32 step (B=1; 8 + 8 conv launches on the tf32 route, 8 of each
    attention kernel, dQ and dK/dV on the 3xTF32 ones) matches the plain
    versions in loss and gradient norm, then takes a warm-up step and 3
    timed steps;
    ten steps on one batch lower the loss;
13. CLI: ``segmentation train --segmentation_net_type unetr --dev cuda
    --precision bf16`` with a dropout-0 copy of the yaml on a 4-case
    cohort at 256x256x64 (one epoch of 2 steps at B=2), then ``segmentation
    predict`` on what it wrote;
14. the flagship pipeline: a seeded 6-case cohort at 256x256x64 (two
    cases lesion-free, all in training), then, with the U-Net at full
    width: crop steps (bf16, B=4 pos/neg crops of 128x128x32 through
    ``TrainLoop`` and the augmentation, each launching what phase 8's step
    launches, every crop 128x128x32), timed with the NaN guard off and on
    in turns; ``segmentation train`` (f32, the CLI's default) with
    ``--random_crop_size 128 128 32 --swa --check_nan_loss
    --early_stopping 2 --sliding_window_val --picai_eval`` for 2 epochs,
    then ``--resume_from_last --max_epochs 3`` (it must log that it
    resumed at epoch 2 and write epoch 3); ``segmentation test
    --picai_eval`` in f32 and bf16 (31 K1 launches a case, one
    whole-volume forward; Dice and IoU within 1e-3 in f32 and 5e-2 in bf16
    of the plain path's whole-volume forward of the same checkpoint; AP,
    AUROC and score finite), with its seconds a case and peak memory;
    ``segmentation predict`` with and without ``--extract_lesions`` (the
    candidate map equal to the candidates of the probability map) and
    ``segmentation test_from_predictions`` on its outputs (Dice equal to a
    numpy Dice of the files). The CLIs run in this process, so the launch
    counts are read around each;
15. the full augmentation: every new op (the cubic and nearest resizes,
    the elastic warp of an image and of a label, Gibbs, bias field, blur,
    low resolution, each of the 27 TrivialAugment ops at magnitudes 0.25
    and 1) on one 256x256x64x1 volume on the card against the same op on
    the CPU with the same host draws, under
    ``torch.cuda.set_sync_debug_mode("error")`` (f32 within 1e-5 of the
    output's scale, the spike 1e-4; bf16 within 2 bf16 ulps of the f32 CPU
    result cast to bf16; labels equal but for voxels sampled within 1e-4
    of a half-integer, at most 0.1 %), each timed; the draws and a whole
    prob-1 sample on the card without a host sync; phase 14's crop step
    with its four flags and with all ten, bf16 and f32, in turns (the same
    launches a step, peak memory), a fixed batch's loss lower after six
    ten-flag steps, every gradient finite and every weight's non-zero
    (a conv bias before an instance norm has an exact gradient of 0); 200
    prob-1 samples whose TrivialAugment picks cover the 27 ops;
    ``segmentation
    train`` with the ten flags, ``--folds``, ``--constant_ratio``,
    ``--excluded_ids_from_training_data``, ``--cache_dir`` and
    ``--validation_samples_per_epoch`` on phase 14's cohort (2 epochs of
    one step), run twice: the second reads every sample from the cache;
16. SWIN-UNet and the flash head-dim repair: ``flash_attention`` at q, k,
    v [1,8,2048,16] and [1,8,2048,48] (the D=32 and D=64 kernels on
    zero-padded inputs), bf16 and f32, forward and backward against the
    plain versions at the unpadded head dim (the plain backward on the
    plain forward's rows) with phase 10's tolerances, timed beside the pad
    alone; UNETR (``sample_configs/unetr.yaml`` with
    32 heads of 16) serving one case with 8 forward-attention launches
    (within 5e-2 of the plain path); SWIN-UNet
    (``sample_configs/unet-swin.yaml``) serving the 256x256x64 case as
    phase 4 serves the U-Net, bf16 and f32 (9 x 7 K1 launches: 7 narrow,
    56 wgmma or tf32; within 5e-2 and 1e-3 of the plain path; seconds a
    case, device share, peak memory); its 9 conv classes against
    ``F.conv3d``; dx, dW and dbias at every stride-1 conv shape of a
    training step with deep supervision (B=2) against autograd through
    the plain version, f32 and bf16, at phase 7's tolerances, each call's
    routes read from the counters; training at B=2 on 128x128x32, bf16 and f32 (per step 9
    K1, 8 dx, 8 wgrad + 1 patch product, f32 9 patch products, 1 K3;
    gradients finite and every weight's non-zero; the f32 loss within
    1e-4 and gradient norm within 1e-3 of the plain path at dropout 0; a
    falling loss; with ``deep_supervision`` and
    ``bottleneck_classification`` 4 more K1, dx and dW; steps at the
    yaml's dropout 0.1), with seconds a step, device share and peak
    memory; ``segmentation train --segmentation_net_type swin`` (f32, crops
    of 128x128x32), without and with both heads, then ``predict`` and
    ``test`` on each checkpoint (with the heads, the same K1 launches as
    without: inference runs no head);
17. CatNet (``sample_configs/classification-cat-resnet.yaml`` as it
    stands: four ResNet stages, batch ensembles of 4, batch norm) on
    128x128x32 crops: served in eval with running statistics at B=2, bf16
    and f32 (8 K1 a forward, wgmma or tf32; sigmoid probabilities within
    5e-2 and 1e-3 of the plain path; the f32 forward again with cuDNN's
    default TF32, as the CLI runs its F.conv3d layers, the difference
    logged); its four K1 classes at B=16 (the stem's 32->32 at 128x128x32,
    128->128 at 32x32x8, 256->256 at 16x16x4, 512->512 at 8x8x2): forward,
    dx, dW and dbias against the plain versions at phases 3 and 7's
    tolerances, each route read from the counters, times beside cuDNN and
    the bounds; training at B=16, bf16 and f32 (per step 8 K1, 8 dx, dW on
    6 wgrad launches + 2 patch products in bf16 and 8 patch products in
    f32, 1 K3), the f32 loss within 1e-4, gradient norm within 1e-3 and
    running statistics within 1e-5 of the plain path, seconds a step,
    device share and peak memory, ten bf16 steps with a falling loss;
    ``classification train`` (f32), ``test`` (one JSON line with AUC) and
    ``predict`` on a 6-case cohort, in this process;
18. the U-Net's option space: ``sample_configs/u-net-3d-resnet.yaml`` as
    it stands (``conv_type: resnet``, depth 32 to 256, dropout 0.15)
    serving phase 4's case in bf16 and f32 (launches against the K1 calls
    of one window batch, recorded, times 7; within 5e-2 and 1e-3 of the
    plain path; seconds a case, device share, peak memory); its K1
    classes (the stem's 1->1 pair on the narrow route, 32->32 at
    128x128x32, 64x64x16 and 32x32x8, the bottlenecks' 64->64 and
    128->128, the decoder's) against their plain versions, forward at
    B=4 and dx, dW, dbias at the step's B=2, at phases 3 and 7's
    tolerances, the routes read from the counters, the tf32 and narrow
    ones bit-equal over two runs; training at the yaml's B=2 on
    128x128x32 with the CLI's augmentation, bf16 and f32 (2 timed steps,
    launches against the recorded calls, gradients finite and every
    weight's non-zero, the f32 loss within 1e-4 and gradient norm within
    1e-3 of the plain path with the same dropout draws, ten bf16 steps
    with a falling loss); ``segmentation train``, ``predict``,
    ``test_from_predictions`` and ``test`` (f32 and bf16) on a 4-case
    256x256x64 cohort; the CLI's U-Net
    defaults (identity links, upsampling decoder) at the flagship's width
    with instance and with batch norm, and each other conv type (sae,
    depthwise, convnext, convnextv2, asp) and link type (conv, attention)
    at depth 16, 32, 64 with the ADN's other norms, prelu and uout: one
    f32 step against the plain path (loss, gradient norm, running
    statistics within 1e-5) and one served case each;
20. self-supervised pretraining: ``sample_configs/ssl-resnet.yaml`` (the
    two-view methods' CatNet backbone) and I-JEPA at the factory's
    defaults, from seeded weights on seeded 128x128x32 volumes: the
    two-view step's four K1 classes at B=28 (the stem's 64->64 at
    96x96x24, 128->128, 256->256, 512->512) against the plain versions
    as phase 17 holds its classes; ``flash_attention`` at I-JEPA's head
    dims 48 and 24 (8192 tokens, the D=64 and D=32 kernels on padded
    inputs) against the plain versions at B=2 with phase 10's tolerances,
    each kernel timed at B=28 beside its bound and
    ``F.scaled_dot_product_attention``; VICReg at the yaml's B=28 on
    views of 96x96x24 (``SSLTransforms``) in f32 and bf16 (the f32 step
    against the plain path with ``_step_parity`` at the largest batch it
    fits, every gradient finite and each weight's non-zero but the
    prediction head's, which VICReg does not reach; a warm-up and 2
    timed steps with the launches of the recorded K1 calls, no K3; peak
    memory; ten bf16 steps on one batch of views with a falling loss);
    a BYOL step with its EMA teacher in f32 and bf16 (the shadow a plain
    ``ema_update`` at ``ema_decay_at`` within 1e-6); I-JEPA at B=28
    (8192 tokens), the f32 step against the plain path at B=2 with one
    mask, then f32 and bf16 steps with 10 forward, 6 dQ and 6 dK/dV
    attention launches each; ``ssl predict_folder``'s representation at
    B=1 in bf16 and f32 (within 5e-2 and 1e-3 of the plain path); ``ssl
    train`` (VICReg f32 and bf16, BYOL ``--ema`` bf16, I-JEPA bf16) on a
    6-case cohort at ``--batch_size 3`` and ``ssl predict_folder`` on the
    VICReg checkpoint, their launches against the K1 calls recorded
    around each;
21. the classification CLI's last four net types, from seeded weights:
    the ViT classifier (``classification-vit.yaml``: 10 blocks of 12
    heads of 64, 768 wide) served at B=2 on 256x256x64 (4097 tokens: 10
    K4/K5 launches a forward) in bf16 and f32 against the plain path
    (5e-2, 1e-3), a B=2 step there on the yaml with dropout 0 (10
    forward, 10 dQ, 10 dK/dV launches and a K3 a step; f32 against the
    plain path with ``_step_parity``; five bf16 steps on one batch lower
    the loss), the yaml's own dropout 0.1 at B=4 on 128x128x32 crops
    (513 tokens on the materialised softmax: no attention launch); K4-K7
    at [2,12,4097,64] against their plain versions, timed beside
    ``F.scaled_dot_product_attention`` and their bounds; the factorized
    ViT (the factory's defaults), OrdNet (``classification-cat-
    resnet.yaml``'s structure, 3 classes) and the U-Net encoder
    classifier (``u-net-3d-resnet.yaml``) served at B=2 and trained at
    their batch on 128x128x32 as phase 19 serves and trains (K1, dx, dW
    from the recorded calls); ``classification train``, ``test`` and
    ``predict`` of each net type on 4 cases (the ViT on 256x256x64 with
    dropout 0, OrdNet on three grades with ``--prediction_type
    pre_bias``, the U-Net encoder classifier with a gland mask a case,
    ``--mask_keys``,
    ``--image_masking`` and ``--image_crop_from_mask``), their launches
    against the K1 and flash calls recorded around each;
22. the classification CLI's remaining flags and the
    ``classification_ensemble`` mode, from seeded weights: CatNet with
    the GP head (``classification-cat-resnet.yaml`` with
    ``gaussian_process: true``) served at B=2 (8 K1 a forward) and trained
    at B=16 on 128x128x32 as phase 19 serves and trains (f32 against the
    plain path with ``_step_parity``); its covariance fitted over 3
    batches of 16 with the parameters alone, on the kernels against the
    plain path and a host f64 fit, and ``predictive_logits`` of the
    served crops against the plain path (corrected logits and variances,
    1e-3 of their scale); two micro-steps of gradient accumulation (one
    update) and one step with the backbone frozen, the parameters' moves
    against the plain path (their difference 1e-3 of their norm, or 4
    times the move a 1e-6 input perturbation gives the plain path where
    larger, over the leaves whose gradient is above rounding level) and
    the frozen leaves bit-equal; ``classification
    train`` with ``--calibration_ids``, ``--accumulate_grad_batches 2`` and
    ``--resize_size``, a second run warm-started from it with
    ``--freeze_regex``, ``test`` of both with ``--one_to_one``,
    ``predict`` of both with ``--ensemble mean`` (again on the plain
    path, 1e-3) and with ``--prediction_type set``; ``classification_
    ensemble train``, ``test`` and ``predict`` on two full-width CatNet
    members (predict again on the plain path); every CLI run's launches
    against the K1 calls recorded around it, K3 in the training runs
    with the augmentation and nowhere else.
23.–24. the U-Net with ``ssl-resnet.yaml``'s encoder and its fine-tuning
    CLIs; both MIL models and the ``classification_mil`` CLIs;
25. the deconfounder network over ``classification-cat-resnet.yaml``
    (two categorical confounders of 3 and 2 classes, one continuous)
    served at B=2 and stepped at B=16 on 128x128x32 in bf16 and f32
    against the plain path (``_step_parity`` for the f32 step), 8 K1 a
    forward; SegCatNet over the flagship U-Net at B=2, served against the
    plain path and stepped with every U-Net parameter left bit-equal and
    the heads moved; ``classification_deconfounder train``, ``test`` and
    ``predict`` (again on the plain path, 1e-3) on phase 17's cohort and
    ``classification train --logger_type wandb`` (the warning and the
    metric CSV); ``ssl model_to_export`` of phase 20's VICReg checkpoint
    and ``classification model_to_export`` of phase 17's CatNet and
    phase 21's ViT classifier (4097 tokens), each artifact loaded and run
    on the card against the live model (f32, 1e-5) with the same K1 and
    flash launches;
26. VICRegL (K1, dx and dW: 14 K1 forwards a step), DINO with 4 local
    crops and iBOT (16 flash forwards, 8 dQ and 8 dK/dV a step at 3456
    tokens) and MAE (6 of each: 2048 visible tokens, 8192 in the
    decoder) on ``ssl-resnet.yaml``'s training settings at B=28, f32 and
    bf16: the f32 step against the plain path at B=2 (loss, gradient norm
    and direction, DINO's and iBOT's centres), a warm-up and 2 timed
    steps with their launches, peak memory and the device's busy share;
    ``ssl train`` of DINO with ``--n_local_crops 2`` (bf16) and of
    VICRegL (f32) on 4 volumes, each run's launches against the K1 and
    flash calls recorded around it.

The last lines of standard output are a ``{"kernels": [...]}`` JSON line
and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
WORK_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# f32 products on the tensor cores at f32's accuracy: three TF32 products
# each (3xTF32), a third of the dense TF32 rate of 494.7 TFLOP/s
PEAK_F32_TF32X3 = 494.7e12 / 3
PEAK_BYTES = 3.35e12
CONVS_PER_FORWARD = 31
# dx launches per training step: every stride-1 conv but the stem's first,
# whose input is the image
CONVS_DX_PER_STEP = 30
# of those, the launches on the wgmma route: all but the Cin=1 stems (two
# forward convs) and the dx of 1->32, whose output has one channel; those
# three take the narrow route, and no bf16 conv of a main path the igemm one
CONVS_WGMMA_PER_FORWARD = 29
CONVS_DX_WGMMA_PER_STEP = 29
# in f32 (the CLI's default precision) the same convs take the tf32 route
CONVS_TF32_PER_FORWARD = 29
CONVS_DX_TF32_PER_STEP = 29
CONVS_NARROW_PER_FORWARD = 2
CONVS_DX_NARROW_PER_STEP = 1
# dW per training step: the wgrad kernel takes the classes of the wgmma
# route (29), the stems 1->1 and 1->32 the patch product
CONVS_WGRAD_PER_STEP = 29
CONVS_WGRAD_PATCHES_PER_STEP = 2
WINDOW_BATCHES = 7
TIMED_STEPS = 3
# f32 U-Net steps timed after the warm-up step
F32_TIMED_STEPS = 2
# UNETR (sample_configs/unetr.yaml on 256x256x64): 8 blocks of 8 heads of
# dim 64 over 2048 tokens; 9 stride-1 3x3x3 convs per forward, all but the
# one that reads the image with a dx launch in training
UNETR_BLOCKS = 8
UNETR_HEADS = 8
UNETR_TOKENS = 2048
UNETR_HEAD_DIM = 64
UNETR_CONVS = 9
UNETR_CONVS_DX = 8
# all but the image's 1->16 conv (the narrow route) take the wgmma route,
# every dx does
UNETR_CONVS_WGMMA = 8
UNETR_CONVS_DX_WGMMA = 8
# in f32 the tf32 route takes the same 8 and 8
UNETR_CONVS_TF32 = 8
UNETR_CONVS_DX_TF32 = 8
UNETR_CONVS_NARROW = 1
# dW: the wgrad kernel for the 8 convs of 16 channels and more, the patch
# product for the image's 1->16
UNETR_CONVS_WGRAD = 8
UNETR_CONVS_WGRAD_PATCHES = 1
UNETR_TIMED_STEPS = 2
# sequence lengths around the attention kernels' 64-row tiles
ATTENTION_TILE_EDGES = (1, 63, 64, 65, 127, 128, 129)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=5):
    """``adell_mri_torch.tools.timing.time_ms``, imported at the call so
    that importing this script imports nothing of the package."""
    from adell_mri_torch.tools import timing

    return timing.time_ms(fn, reps)


def time_cold_ms(fn, reps=20, dirty=False):
    """``adell_mri_torch.tools.timing.time_cold_ms``."""
    from adell_mri_torch.tools import timing

    return timing.time_cold_ms(fn, reps, dirty)


def conv_bound(b, spatial, cin, cout, dtype, peak=None):
    """Least time for one stride-1 3x3x3 conv: the larger of its bytes
    (x, w, bias read once, out written once) over HBM bandwidth and its
    FLOPs over ``peak`` (by default the peak rate of the dtype)."""
    vox = b * spatial[0] * spatial[1] * spatial[2]
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (vox * cin + 27 * cin * cout + cout + vox * cout)
    flops = 2 * vox * 27 * cin * cout
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    bound_by = "bytes" if t_bytes > t_flops else "operations"
    return max(t_bytes, t_flops), bound_by


def conv_bounds(b, spatial, cin, cout, name):
    """``conv_bound`` of a conv in ``name`` (bf16 or f32) as row keys: f32
    products at the 3xTF32 rate (``bound_ms``) and at the FMA rate
    (``bound_fma_ms``)."""
    if name == "bfloat16":
        bound, by = conv_bound(b, spatial, cin, cout, name)
        return dict(bound_ms=bound, bound_by=by)
    bound, by = conv_bound(b, spatial, cin, cout, name, PEAK_F32_TF32X3)
    fma, fma_by = conv_bound(b, spatial, cin, cout, name)
    return dict(bound_ms=bound, bound_by=by, bound_fma_ms=fma,
                bound_fma_by=fma_by)


def igemm_direct(x, w, bias):
    """The gathered-tile kernel (``conv3d_igemm_{bf16,f32}_kernel``)
    launched straight through its C entry at a shape the wrappers now route
    elsewhere, to time it; not counted."""
    import torch

    from adell_mri_torch.ops.kernels.build import load_library

    lib = load_library()
    out = torch.empty(x.shape[:4] + (w.shape[-1],), dtype=x.dtype,
                      device=x.device)
    fn = (lib.adell_conv3d_igemm_bf16 if x.dtype == torch.bfloat16
          else lib.adell_conv3d_igemm_f32)
    rc = fn(x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            *x.shape, w.shape[-1],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the gathered-tile conv kernel: cudaError {rc}")
    return out


def _route_counts(fn):
    return (fn.wgmma_launches, fn.tf32_launches, fn.narrow_launches)


def compare_conv(b, spatial, cin, cout, dtype, seed, reps=5, direct=False):
    """Kernel vs plain on the card at one shape: max abs error, its
    tolerance, and the times of kernel, plain version and cuDNN (in f32
    with TF32 off); with ``direct`` also the gathered-tile kernel's time at
    the shape.
    The route is read from the route counters; a tf32 conv and a bf16
    narrow conv run twice and must give the same bits."""
    import torch
    import torch.nn.functional as F

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_igemm,
        conv3d_igemm_reference,
        conv_route,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, *spatial, cin), generator=g, device="cuda").to(dtype)
    w = torch.randn((3, 3, 3, cin, cout), generator=g, device="cuda")
    w = (w / (27 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(dtype)
    route = conv_route(dtype, cin, cout)
    before = _route_counts(conv3d_igemm)
    got = conv3d_igemm(x, w, bias)
    taken = tuple(a - b for a, b in zip(_route_counts(conv3d_igemm), before))
    if taken != (route == "wgmma", route == "tf32", route == "narrow"):
        raise AssertionError(f"{cin}->{cout} {dtype} did not take the "
                             f"{route} route: {taken}")
    want = conv3d_igemm_reference(x, w, bias)
    same = None
    if route == "tf32" or (route == "narrow" and dtype == torch.bfloat16):
        same = torch.equal(got, conv3d_igemm(x, w, bias))
        if not same:
            raise AssertionError(f"{cin}->{cout} {dtype} differs between "
                                 "two runs")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # bf16: both sides sum exact products in f32 and round once, so they
    # differ by at most one bf16 ulp (2^-7 relative); f32: 1e-5 of the
    # output scale, f32 sums (3xTF32 on the tf32 route) against the plain
    # version's in another order, which one TF32 pass (about 3e-4) misses
    tol = 2.0**-7 * max(scale, 1.0) if dtype == torch.bfloat16 else (
        1e-5 * scale)
    xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
    name = str(dtype).split(".")[1]
    bounds = conv_bounds(b, spatial, cin, cout, name)
    row = dict(
        shape=[b, *spatial, cin, cout], dtype=name, route=route,
        max_abs_err=err, bit_equal=same,
        tol=tol, ok=err <= tol,
        ms=time_ms(lambda: conv3d_igemm(x, w, bias), reps),
        plain_ms=time_ms(lambda: conv3d_igemm_reference(x, w, bias), reps),
        library_ms=time_ms(lambda: F.conv3d(xc, wc, bias, padding=1), reps),
        **bounds,
    )
    if direct:
        row["igemm_err"] = float(
            (igemm_direct(x, w, bias).float() - want.float()).abs().max())
        row["igemm_ms"] = time_ms(lambda: igemm_direct(x, w, bias), reps)
    log(
        f"  conv {b}x{'x'.join(map(str, spatial))} {cin}->{cout} {name} "
        f"({route}): "
        f"err {err:.3g} (tol {tol:.3g}"
        + ("" if same is None else ", bit-equal over two runs")
        + f") kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.3f} ms, F.conv3d {row['library_ms']:.3f} "
        f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        + (f", FMA bound {row['bound_fma_ms']:.4f} ms" if "bound_fma_ms"
           in row else "")
        + (f"; the gathered-tile kernel {row['igemm_ms']:.3f} ms" if direct
           else "")
    )
    if not row["ok"]:
        raise AssertionError(f"conv3d_igemm disagrees with plain: {row}")
    return row


class plain_kernels:
    """Within the block the models' stride-1 convs take the plain version
    (autograd through ``F.conv3d``) and their flash attention the plain
    forward (autograd through the materialised softmax) instead of the
    kernels."""

    def __enter__(self):
        import adell_mri_torch.models.layers.vit as vit_mod
        import adell_mri_torch.ops.conv as conv_mod
        from adell_mri_torch.ops.kernels.attention import (
            flash_attention_fwd_reference,
        )
        from adell_mri_torch.ops.kernels.conv import conv3d_igemm_reference

        def plain_attention(q, k, v, scale=None):
            if scale is None:
                scale = q.shape[-1] ** -0.5
            return flash_attention_fwd_reference(q, k, v, scale)[0]

        self.real = (conv_mod.conv3d_igemm_train, vit_mod.flash_attention)
        conv_mod.conv3d_igemm_train = conv3d_igemm_reference
        vit_mod.flash_attention = plain_attention

    def __exit__(self, *exc):
        import adell_mri_torch.models.layers.vit as vit_mod
        import adell_mri_torch.ops.conv as conv_mod

        conv_mod.conv3d_igemm_train, vit_mod.flash_attention = self.real
        return False


def phase_device():
    import torch

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)
    return kind, smi


def phase_build():
    from adell_mri_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s (nvcc {build.build_info['seconds']})")
    build_log = (build.BUILD_DIR / "build.log").read_text()
    log(build_log)
    check_hopper_build(build_log)
    return secs


# the kernels built on wgmma, and the preparation kernel that feeds the
# 3xTF32 attention kernels, whose ptxas lines the build phase checks
HOPPER_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                  "flash_bwd_dkv_bf16_kernel", "flash_fwd_tf32x3_kernel",
                  "flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel",
                  "flash_tf32x3_image_kernel", "conv3d_wgmma_bf16_kernel",
                  "conv3d_wgrad_bf16_kernel", "conv3d_wgmma_tf32x3_kernel")


def check_hopper_build(build_log):
    """ptxas must keep the Hopper kernels whole: no spilled registers, and
    no note (C75xx) that it serialized their ``wgmma`` products or injected
    a wait for their sums, which would undo their overlap without failing
    anything. Every one of them must have its ptxas entries."""
    lines = build_log.splitlines()
    faults = [ln for ln in lines if "wgmma" in ln and "serialized" in ln]
    faults += [ln for ln in lines if "(C75" in ln
               and any(name in ln for name in HOPPER_KERNELS)]
    seen = dict.fromkeys(HOPPER_KERNELS, 0)
    for i, ln in enumerate(lines):
        if "Function properties" not in ln:
            continue
        for name in HOPPER_KERNELS:
            if name in ln:
                seen[name] += 1
                if "0 bytes spill stores, 0 bytes spill loads" \
                        not in lines[i + 1]:
                    faults.append(ln + lines[i + 1])
    missing = [k for k, n in seen.items() if n == 0]
    if faults or missing:
        raise AssertionError("the Hopper kernels did not build as designed:"
                             "\n" + "\n".join(faults)
                             + f"\nno ptxas lines for {missing}")
    log(f"  Hopper kernels: ptxas entries {seen}, no spills, no serialized "
        "wgmma")


def phase_kernels():
    import torch

    from adell_mri_torch.tools.flagship import WINDOW

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[kernel vs plain] flagship shapes, B=4; the edges of the wgmma "
        "and tf32 routes")
    rows = []
    shapes = [
        (WINDOW, 1, 1), (WINDOW, 1, 32), (WINDOW, 32, 32), (WINDOW, 64, 32),
        ((16, 16, 4), 256, 256),
    ]
    for i, (spatial, cin, cout) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(compare_conv(4, spatial, cin, cout, dtype, seed=i))
    # a 64-channel full-size conv, UNETR's 16-wide full-size convs, ragged
    # volumes (a chunk of 16 three times, a Cout padded from 24 to 32), and
    # Cin 8 (bf16: the igemm route; f32: the tf32 route's chunk of 8)
    edges = [
        (4, WINDOW, 64, 64), (1, (256, 256, 64), 32, 16),
        (1, (256, 256, 64), 16, 16), (1, (7, 9, 5), 16, 16),
        (1, (7, 9, 5), 48, 24), (4, WINDOW, 8, 32),
    ]
    for i, (b, spatial, cin, cout) in enumerate(edges):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(compare_conv(b, spatial, cin, cout, dtype,
                                     seed=50 + i))
    # f32 only: the tf32 route's chunks of 8 three times beside an N block
    # padded from 24 to 32, and of 8 into a block of 16
    for i, (b, spatial, cin, cout) in enumerate([(2, (3, 5, 7), 24, 24),
                                                 (1, (7, 9, 5), 8, 8)]):
        rows.append(compare_conv(b, spatial, cin, cout, torch.float32,
                                 seed=60 + i))
    # the narrow route in bf16 and f32 (1->1 and 1->32 are above): the
    # Cout = 1 dx of 1->32, UNETR's image conv at B=1 and 2, multi-sequence
    # stems and their dx, ragged volumes
    narrow = [
        (4, WINDOW, 32, 1), (1, (256, 256, 64), 1, 16),
        (2, (256, 256, 64), 1, 16), (4, WINDOW, 3, 3), (4, WINDOW, 3, 32),
        (4, WINDOW, 32, 3), (1, (7, 9, 5), 1, 16), (1, (7, 9, 5), 3, 8),
        (1, (7, 9, 5), 24, 1),
    ]
    for i, (b, spatial, cin, cout) in enumerate(narrow):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(compare_conv(b, spatial, cin, cout, dtype,
                                     seed=70 + i))
    return rows


def phase_serving(model, case=None):
    """One warm-up case, then the counted case, then two more timed. In
    bf16 29 x 7 conv launches take the wgmma route, in f32 (the CLI's
    default precision) the tf32 route; 2 x 7 the narrow one, none the igemm
    one."""
    import torch

    from adell_mri_torch.ops.kernels import conv as kconv
    from adell_mri_torch.tools.flagship import CASE, make_case, make_inference

    case = make_case(1) if case is None else case
    infer = make_inference(model)
    hopper = ("wgmma" if next(model.parameters()).dtype == torch.bfloat16
              else "tf32")
    secs = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        infer(case)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        out = infer(case)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = kconv.conv3d_igemm.launches
        routed = getattr(kconv.conv3d_igemm, f"{hopper}_launches")
        narrow = kconv.conv3d_igemm.narrow_launches
        counts = _launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            infer(case)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    want = CONVS_PER_FORWARD * WINDOW_BATCHES
    want_routed = CONVS_WGMMA_PER_FORWARD * WINDOW_BATCHES
    want_narrow = CONVS_NARROW_PER_FORWARD * WINDOW_BATCHES
    igemm = launches - routed - narrow
    log(f"[serving] {'x'.join(map(str, CASE))} case, "
        f"{'bf16' if hopper == 'wgmma' else 'f32'}: conv3d_igemm launches "
        f"{launches} (want {want}), {routed} on the {hopper} route (want "
        f"{want_routed}), {narrow} on the narrow route (want {want_narrow}),"
        f" {igemm} on the igemm route (want 0); warm-up {warm:.3f} s, then "
        f"{', '.join(f'{s:.4f}' for s in secs)} s per case")
    if (launches, routed, narrow) != (want, want_routed, want_narrow):
        raise AssertionError(f"conv3d_igemm launched {launches}, "
                             f"{routed} {hopper}, {narrow} narrow, not "
                             f"{want}, {want_routed}, {want_narrow}")
    if tuple(out.shape) != CASE + (1,):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite probabilities")
    lo, hi = float(out.min()), float(out.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"probabilities outside [0, 1]: {lo}, {hi}")
    return dict(launches=launches, **{f"{hopper}_launches": routed},
                narrow_launches=narrow, counts=counts, warmup_s=warm,
                seconds_per_case=secs, prob_range=[lo, hi], case=case)


def _first_window_batch(case):
    import torch

    from adell_mri_torch.inference.sliding_window import sliding_window_grid
    from adell_mri_torch.tools.flagship import CASE, WINDOW

    pos = sliding_window_grid(CASE, WINDOW, stride_frac=0.5)[:4]
    return torch.stack([
        case[tuple(slice(int(p), int(p) + w) for p, w in zip(q, WINDOW))]
        for q in pos
    ])


def conv_recorder(shapes):
    """A forward pre-hook that counts, in ``shapes``, each stride-1 SAME
    3x3x3 conv of the port (``ops.conv.Conv3d``) by its input shape and
    Cout; other modules pass."""
    import adell_mri_torch.ops.conv as conv_mod

    def record(module, inputs):
        if not isinstance(module, conv_mod.Conv3d):
            return
        w = module.weight
        if (tuple(w.shape[:3]) == (3, 3, 3) and module.strides == (1, 1, 1)
                and module.padding == "SAME"):
            key = (tuple(inputs[0].shape), int(w.shape[-1]))
            shapes[key] = shapes.get(key, 0) + 1

    return record


def phase_window_batch(model_bf16, case):
    """One window batch through the U-Net on the kernel and on the plain
    conv path (bf16 and f32), and the conv shapes that batch runs."""
    import torch

    import adell_mri_torch.ops.conv as conv_mod
    from adell_mri_torch.tools.flagship import make_model

    crops = _first_window_batch(case)
    shapes = {}
    record = conv_recorder(shapes)

    rows = []
    # bf16: one-ulp rounding flips in 31 convs, renormalised by the
    # instance norms, move probabilities by well under 5e-2; f32: FMA vs
    # cuDNN summation order only
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        model = model_bf16 if dtype == torch.bfloat16 else make_model(
            0, torch.float32
        )
        hooks = [
            m.register_forward_pre_hook(record)
            for m in model.modules() if isinstance(m, conv_mod.Conv3d)
        ] if dtype == torch.bfloat16 else []
        with torch.inference_mode():
            got = model(crops.to(dtype)).float()
            for h in hooks:
                h.remove()
            with plain_kernels():
                want = model(crops.to(dtype)).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        name = str(dtype).split(".")[1]
        log(f"[window batch] U-Net kernel vs plain conv path, {name}: "
            f"max abs err {err:.3g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"U-Net {name} disagrees: {err} > {tol}")
        rows.append(dict(dtype=name, max_abs_err=err, tol=tol))
    n = sum(shapes.values())
    if n != CONVS_PER_FORWARD:
        raise AssertionError(f"{n} stride-1 3x3x3 convs, not 31")
    return rows, shapes


def sum_rows(rows, count="count", err=("max_abs_err", "tol")):
    """Times and bounds of ``rows`` summed by their ``count``, what bounds
    the most of the summed bound, and the worst error against its
    tolerance."""
    keys = [k for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_fma_ms", "igemm_ms") if k in rows[0]]
    totals = {k: sum(r[k] * r[count] for r in rows) for k in keys}
    by_bytes = sum(r["bound_ms"] * r[count] for r in rows
                   if r["bound_by"] == "bytes")
    totals["bound_by"] = (
        "bytes" if by_bytes > totals["bound_ms"] / 2 else "operations"
    )
    worst = max(rows, key=lambda r: r[err[0]] / r[err[1]])
    totals.update(max_abs_err=worst[err[0]], tol=worst[err[1]],
                  convs=sum(r[count] for r in rows))
    return totals


def phase_path_shapes(shapes):
    """Every conv shape of one window batch, kernel vs plain, timed beside
    the gathered-tile kernel, in bf16 and in f32; totals per dtype over all
    31 and, in f32, over the 29 of the tf32 route."""
    import torch

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        log(f"[main-path convs] one window batch of 4, {name}")
        rows = []
        for i, ((xs, cout), count) in enumerate(sorted(shapes.items())):
            row = compare_conv(xs[0], xs[1:4], xs[4], cout, dtype,
                               seed=100 + i, direct=True)
            row["count"] = count
            rows.append(row)
        totals = sum_rows(rows)
        log(f"  per window batch ({CONVS_PER_FORWARD} convs, {name}): "
            f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} "
            f"ms, F.conv3d {totals['library_ms']:.3f} ms, bound "
            f"{totals['bound_ms']:.4f} ms ({totals['bound_by']}); the "
            f"gathered-tile kernel {totals['igemm_ms']:.3f} ms")
        out[name] = (rows, totals)
    f32_rows = out["float32"][0]
    tf32 = sum_rows([r for r in f32_rows if r["route"] == "tf32"])
    if tf32["convs"] != CONVS_TF32_PER_FORWARD:
        raise AssertionError(f"{tf32['convs']} f32 convs on the tf32 route")
    log(f"  the {tf32['convs']} tf32-route convs of an f32 window batch: "
        f"kernel {tf32['ms']:.3f} ms, F.conv3d (TF32 off) "
        f"{tf32['library_ms']:.3f} ms, bound {tf32['bound_ms']:.4f} ms "
        f"(3xTF32; FMA {tf32['bound_fma_ms']:.4f} ms), the gathered-tile "
        f"kernel {tf32['igemm_ms']:.3f} ms, plain {tf32['plain_ms']:.3f} ms")
    rows, totals = out["bfloat16"]
    return rows, totals, f32_rows, out["float32"][1], tf32


def phase_cli(model):
    """Two synthetic LPS cases, a port checkpoint of ``model``, and the
    predict entry point in a subprocess."""
    import shutil

    import numpy as np

    from adell_mri_torch.data.nifti import read_nifti, write_nifti
    from adell_mri_torch.tools.flagship import CASE, FLAGSHIP, WINDOW
    from adell_mri_torch.train.checkpoints import CheckpointManager

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    rng = np.random.default_rng(2)
    affine = np.array(
        [[-0.6, 0, 0, 10], [0, -0.6, 0, 20], [0, 0, 2.4, -5], [0, 0, 0, 1]]
    )
    src_shapes = {"case_0": (240, 260, 30), "case_1": (250, 230, 28)}
    ds = {}
    for pid, shape in src_shapes.items():
        path = WORK_DIR / f"{pid}.nii.gz"
        write_nifti(str(path), rng.normal(size=shape).astype(np.float32),
                    affine)
        ds[pid] = {"image": str(path)}
    ds_path = WORK_DIR / "ds.json"
    ds_path.write_text(json.dumps(ds))
    metadata = {
        "network_config": FLAGSHIP,
        "transform_arguments": {
            "image_keys": ["image"],
            "target_spacing": [0.6, 0.6, 1.2],
            "target_size": list(CASE),
        },
        "n_classes": 2,
        "net_type": "unet",
    }
    CheckpointManager(
        str(WORK_DIR / "ckpt"), name="segmentation", fold=0,
        metadata=metadata,
    ).save(model.state_dict(), step=0, value=0.0)
    out = WORK_DIR / "pred"
    cmd = [
        sys.executable, "-m", "adell_mri_torch", "segmentation", "predict",
        "--dataset_json", str(ds_path), "--checkpoint_dir",
        str(WORK_DIR / "ckpt"), "--output_path", str(out), "--dev", "cuda",
        "--precision", "bf16", "--sliding_window_size",
        *map(str, WINDOW),
    ]
    t0 = time.perf_counter()
    run = subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        log(run.stdout[-3000:])
        log(run.stderr[-6000:])
        raise RuntimeError(f"predict CLI exited {run.returncode}")
    for pid, shape in src_shapes.items():
        img = read_nifti(str(out / f"{pid}_prob.nii.gz"))
        ok = (
            img.data.shape == shape
            and np.isfinite(img.data).all()
            and img.data.min() >= 0.0
            and img.data.max() <= 1.0
        )
        if not ok:
            raise AssertionError(
                f"{pid}: shape {img.data.shape} (want {shape}), range "
                f"[{img.data.min()}, {img.data.max()}]"
            )
    log(f"[cli] predict --dev cuda --precision bf16: 2 cases written in "
        f"{secs:.2f} s (process start, import and load included)")
    return dict(seconds=secs)


# -- training slice -----------------------------------------------------------

# f32 operations per element of the intensity chain (sub, div, max, log,
# mul, exp, mul, add, mul, add), and per noisy element on top of it:
# Rician two Box-Muller normals (5 each) and the magnitude (7), Gaussian
# one normal and a multiply-add
INTENSITY_OPS = {"chain": 10, "rician": 17, "gaussian": 7}


def intensity_bound(x, sigma, rician):
    """Least time of one fused intensity pass over x: bytes (x read once,
    the output written once, the [B, 6] f32 parameters and the seed) over
    HBM bandwidth against its f32 operations (the noise counted only for
    samples whose sigma is above 0) over the f32 rate."""
    n = x[0].numel()
    nbytes = 2 * x.numel() * x.element_size() + 24 * x.shape[0] + 8
    noisy = int((sigma > 0).sum())
    per = INTENSITY_OPS["rician" if rician else "gaussian"]
    ops = x.numel() * INTENSITY_OPS["chain"] + noisy * n * per
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def _noise_moments(out, clean):
    d = (out.float() - clean.float()).reshape(-1)
    return float(d.mean()), float(d.std())


def _check_noise(name, got, want, clean):
    """The noise of the kernel and of the plain version (one Philox
    stream): their means must agree within 6 standard errors of a
    difference of two means, and their standard deviations within 1 %
    (the element-by-element check is the strict one; this one reads a
    wrong sigma or a wrong normal in the moments)."""
    mg, sg = _noise_moments(got, clean)
    mw, sw = _noise_moments(want, clean)
    n = got.numel()
    tol_mean = 6 * (2.0 ** 0.5) * sw / n ** 0.5
    tol_std = 0.01 * sw
    ok = abs(mg - mw) <= tol_mean and abs(sg - sw) <= tol_std
    log(f"  {name}: noise mean {mg:.3e} vs plain {mw:.3e} (tol "
        f"{tol_mean:.1e}), std {sg:.5f} vs {sw:.5f} (tol {tol_std:.1e})")
    if not ok:
        raise AssertionError(f"{name}: noise moments disagree")
    return dict(mean=mg, plain_mean=mw, tol_mean=tol_mean, std=sg,
                plain_std=sw, tol_std=tol_std)


def _intensity_tol(out):
    """1e-5 in f32 (approximate special functions against libm's) and one
    bf16 ulp of the output's scale in bf16 (both round one f32 result)."""
    import torch

    if out.dtype == torch.float32:
        return 1e-5
    return 2.0**-7 * max(float(out.float().abs().max()), 1.0)


def _noisy_against_plain(name, x, par, seed, rician):
    """One noisy call of the kernel against the plain version with the
    same seed, element by element (``_intensity_tol``), and against a
    second run of itself, bit for bit. Returns the output, the plain
    one, the error and the tolerance."""
    import torch

    from adell_mri_torch.ops.kernels import intensity as ki

    got = ki.intensity_aug(seed, x, par, rician=rician, noise=True)
    again = ki.intensity_aug(seed, x, par, rician=rician, noise=True)
    want = ki.intensity_aug_reference(seed, x, par, rician, True)
    torch.cuda.synchronize()
    tol = _intensity_tol(want)
    err = float((got.float() - want.float()).abs().max())
    kind = "rician" if rician else "gaussian"
    log(f"  {name} {kind}: max abs err {err:.3g} (tol {tol:.3g}) against "
        f"the plain Philox stream")
    if not err <= tol:
        raise AssertionError(f"intensity_aug {name} {kind}: err {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"intensity_aug {name} {kind}: two runs differ")
    return got, want, err, tol


def _k3_against_plain(name, x, par0, par, seed):
    """K3 on ``x`` against its plain version: with ``par0`` (every sigma
    0) without noise and with either noise switched on, and with ``par``
    (noisy samples) with either noise, element by element within
    ``_intensity_tol`` (the plain version draws the kernel's Philox
    stream), bit-equal over two runs, and by the noise's moments
    (``_check_noise``). Returns the clean output, the tolerance, the
    largest error and the moments."""
    import torch

    from adell_mri_torch.ops.kernels import intensity as ki

    clean = ki.intensity_aug_reference(seed, x, par0, False, False)
    tol = _intensity_tol(clean)
    errs = []
    for noise, rician in ((False, False), (True, True), (True, False)):
        got = ki.intensity_aug(seed, x, par0, rician=rician, noise=noise)
        torch.cuda.synchronize()
        errs.append(float((got.float() - clean.float()).abs().max()))
    err = max(errs)
    log(f"  K3 {name} sigma=0: max abs err {err:.3g} (tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"intensity_aug {name} sigma=0: {errs}")
    moments = {}
    for rician in (True, False):
        kind = "rician" if rician else "gaussian"
        got, want, err_n, tol_n = _noisy_against_plain(f"K3 {name}", x, par,
                                                       seed, rician)
        moments[kind] = dict(
            _check_noise(f"K3 {name} {kind}", got, want, clean),
            max_abs_err=err_n, tol=tol_n)
        err = max(err, err_n)
    return clean, tol, err, moments


# the modes of the kernel: (name, noise, rician)
INTENSITY_MODES = (("off", False, False), ("gaussian", True, False),
                   ("rician", True, True))


def _time_intensity(x, par, seed, noise, rician, sigma):
    """One mode of the kernel timed with L2 warm (``time_ms``: repeated
    calls on the same tensors, as the main path finds ``x`` after the
    warp that wrote it) and cold (``time_cold_ms``), beside its bound."""
    from adell_mri_torch.ops.kernels import intensity as ki

    def fn():
        ki.intensity_aug(seed, x, par, rician=rician, noise=noise)

    bound, bound_by = intensity_bound(x, sigma if noise else sigma * 0,
                                      rician)
    return dict(warm_ms=time_ms(fn, 20), cold_ms=time_cold_ms(fn, 20),
                bound_ms=bound, bound_by=bound_by)


def phase_intensity():
    """K3 (and K2 as its B=1 call) against the plain version at the
    flagship batch, bf16 and f32; every mode timed warm and cold."""
    import torch

    from adell_mri_torch.ops.kernels import intensity as ki
    from adell_mri_torch.tools.flagship import BATCH, WINDOW

    log("[intensity vs plain] [4,128,128,32,1]")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    x32 = torch.rand((BATCH,) + WINDOW + (1,), generator=g, device=dev)
    lo = x32.amin(dim=(1, 2, 3, 4))
    hi = x32.amax(dim=(1, 2, 3, 4))
    fixed = torch.tensor(
        [[0.7, 1.0, 0.0], [1.0, 1.05, 0.05], [1.3, 0.95, -0.05],
         [1.5, 1.0, 0.02]], device=dev,
    )
    seed = torch.tensor([1234], dtype=torch.int64, device=dev)
    rows = {}

    def par_for(sig):
        return torch.stack([lo, hi, fixed[:, 0], fixed[:, 1], fixed[:, 2],
                            sig], dim=1).contiguous()

    zero = torch.zeros(BATCH, device=dev)
    noisy = torch.full((BATCH,), 0.02, device=dev)
    ki.fused_intensity_aug.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = x32.to(dtype)
        par = par_for(noisy)
        _, tol, err, moments = _k3_against_plain(name, x, par_for(zero),
                                                 par, seed)
        # one sample without noise beside noisy ones, on data with
        # negative voxels: the Rician magnitude must not rectify it
        xn = (x32 - 0.5).to(dtype)
        lon, hin = xn.float().amin(dim=(1, 2, 3, 4)), xn.float().amax(
            dim=(1, 2, 3, 4))
        parn = torch.stack([lon, hin, torch.ones_like(lon),
                            torch.ones_like(lon), torch.zeros_like(lon),
                            torch.tensor([0.0, 0.02, 0.02, 0.02],
                                         device=dev)], dim=1).contiguous()
        got, _, errn, _ = _noisy_against_plain(
            f"K3 {name} sigma=0 sample beside noisy ones", xn, parn, seed,
            True)
        cleann = ki.intensity_aug_reference(seed, xn, parn, False, False)
        torch.cuda.synchronize()
        err0 = float((got[0].float() - cleann[0].float()).abs().max())
        if not (err0 <= tol and float(got[0].min()) < 0.0
                and float(got[1:].min()) >= 0.0):
            raise AssertionError(
                f"sigma=0 sample of a Rician call changed: err {err0}, "
                f"min {float(got[0].min())}"
            )
        log(f"  K3 {name} sigma=0 sample beside noisy ones: err {err0:.3g},"
            f" min {float(got[0].min()):.3f} (kept negative)")
        # every mode, every sample noisy where the mode has noise; the main
        # path's call is Rician
        modes = {mode: _time_intensity(x, par, seed, noise, rician, noisy)
                 for mode, noise, rician in INTENSITY_MODES}
        for mode, m in modes.items():
            log(f"  K3 {name} {mode}: kernel warm {m['warm_ms']:.5f} ms, "
                f"cold {m['cold_ms']:.5f} ms, bound {m['bound_ms']:.5f} ms "
                f"({m['bound_by']})")
        tp = time_ms(lambda: ki.intensity_aug_reference(seed, x, par, True,
                                                        True), 5)
        rician = modes["rician"]
        log(f"  K3 {name}: plain {tp:.4f} ms")
        # K2: the scalar call on one volume
        x1 = x[0]
        p1 = dict(lo=float(lo[0]), hi=float(hi[0]), gamma=1.3, scale=0.95,
                  shift=-0.05)
        got1 = ki.fused_intensity_aug(7, x1, sigma=0.0, **p1)
        par1 = torch.tensor([[p1["lo"], p1["hi"], p1["gamma"], p1["scale"],
                              p1["shift"], 0.0]], device=dev)
        clean1 = ki.intensity_aug_reference(7, x1[None], par1, False,
                                            False)[0]
        torch.cuda.synchronize()
        err1 = float((got1.float() - clean1.float()).abs().max())
        if not err1 <= tol:
            raise AssertionError(f"fused_intensity_aug {name}: {err1}")
        got1n = ki.fused_intensity_aug(7, x1, sigma=0.02, rician=True, **p1)
        par1n = par1.clone()
        par1n[0, 5] = 0.02
        want1n = ki.intensity_aug_reference(7, x1[None], par1n, True,
                                            True)[0]
        torch.cuda.synchronize()
        err1n = float((got1n.float() - want1n.float()).abs().max())
        if not err1n <= _intensity_tol(want1n):
            raise AssertionError(f"fused_intensity_aug {name} rician: "
                                 f"{err1n}")
        if not torch.equal(got1n, ki.fused_intensity_aug(
                7, x1, sigma=0.02, rician=True, **p1)):
            raise AssertionError(f"fused_intensity_aug {name} rician: two "
                                 f"runs differ")
        m1 = _check_noise(f"K2 {name} rician", got1n, want1n, clean1)
        # the kernel alone: the scalar call's packing of its parameters
        # into device tensors is host work and copies, not the kernel
        k2 = _time_intensity(x1[None], par1n, seed, True, True,
                             par1n[:, 5])
        tp1 = time_ms(lambda: ki.intensity_aug_reference(
            seed, x1[None], par1n, True, True), 5)
        err1 = max(err1, err1n)
        log(f"  K2 {name} (B=1): err {err1:.3g} (tol {tol:.3g}), kernel "
            f"warm {k2['warm_ms']:.5f} ms, cold {k2['cold_ms']:.5f} ms, "
            f"plain {tp1:.4f} ms, bound {k2['bound_ms']:.5f} ms "
            f"({k2['bound_by']})")
        rows[name] = dict(
            k3=dict(max_abs_err=max(err, errn), tol=tol, moments=moments,
                    sigma0_sample_err=err0, ms=rician["cold_ms"],
                    warm_ms=rician["warm_ms"], plain_ms=tp,
                    bound_ms=rician["bound_ms"],
                    bound_by=rician["bound_by"], modes=modes),
            k2=dict(max_abs_err=err1, tol=tol, moments=m1,
                    ms=k2["cold_ms"], warm_ms=k2["warm_ms"], plain_ms=tp1,
                    bound_ms=k2["bound_ms"], bound_by=k2["bound_by"]),
        )
    rows["k2_launches"] = ki.fused_intensity_aug.launches
    return rows


def weight_grad_bound(b, spatial, cin, cout, dtype, peak=None):
    """Least time of dW for one stride-1 3x3x3 conv: x and the cotangent
    read once and dW written once over HBM bandwidth, against 2 V 27 Cin
    Cout FLOP over ``peak`` (by default the peak rate of the dtype)."""
    vox = b * spatial[0] * spatial[1] * spatial[2]
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (vox * cin + vox * cout + 27 * cin * cout)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = (2 * vox * 27 * cin * cout / (peak or PEAK_FLOPS[dtype])
               * 1e3)
    bound_by = "bytes" if t_bytes > t_flops else "operations"
    return max(t_bytes, t_flops), bound_by


def time_weight_grad(x, gy, w):
    """dW of the port (``conv3d_weight_grad``: the wgrad kernel on its
    classes, the patch product on the others), its route read from the
    counters, against its plain version (``conv3d_weight_grad_reference``,
    the patch product) within one bf16 ulp of the scale (f32: 1e-3, the
    summation-order tolerance of phase 7's f32 dW) and, on the kernel's
    route, bit-equal over two runs; timed beside the plain version and
    cuDNN's weight gradient (in f32 with TF32 off), a yardstick the port
    never calls
    (``aten.convolution_backward`` with output mask (False, True, False) on
    channels-last views), with the bytes each of the port's call and the
    plain version adds to the peak of allocated memory."""
    import torch

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_weight_grad,
        conv3d_weight_grad_reference,
        wgrad_route,
    )

    gc, xc = gy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2)
    route = wgrad_route(x.dtype, x.shape[-1], gy.shape[-1])

    def library():
        return torch.ops.aten.convolution_backward(
            gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, False])[1]

    def with_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    counts = (conv3d_weight_grad.launches, conv3d_weight_grad.patch_calls)
    dw, peak = with_peak(lambda: conv3d_weight_grad(x, gy))
    taken = (conv3d_weight_grad.launches - counts[0],
             conv3d_weight_grad.patch_calls - counts[1])
    if taken != (route == "wgmma", route == "patches"):
        raise AssertionError(f"dW {tuple(x.shape)} -> {gy.shape[-1]} did "
                             f"not take the {route} route: {taken}")
    want, plain_peak = with_peak(
        lambda: conv3d_weight_grad_reference(x, gy))
    same = (torch.equal(dw, conv3d_weight_grad(x, gy))
            if route == "wgmma" else None)
    lib_dw = library().permute(2, 3, 4, 1, 0)
    scale = max(float(want.float().abs().max()), 1e-30)
    err = float((dw.float() - want.float()).abs().max())
    # bf16: both sum exact bf16 products in f32 and round once: one ulp
    tol = (2.0**-7 if x.dtype == torch.bfloat16 else 1e-3) * scale
    row = dict(
        dw_route=route, dw_max_abs_err=err, dw_tol=tol, dw_bit_equal=same,
        dw_ms=time_ms(lambda: conv3d_weight_grad(x, gy)),
        dw_plain_ms=time_ms(lambda: conv3d_weight_grad_reference(x, gy)),
        dw_library_ms=time_ms(library),
        dw_peak_bytes=peak, dw_plain_peak_bytes=plain_peak,
        dw_library_rel_diff=float((lib_dw.float() - want.float()).abs().max())
        / scale,
    )
    if not err <= tol or same is False:
        raise AssertionError(f"dW disagrees with its plain version: {row}")
    return row


def log_dw(row):
    """One class's dW line: route, error, times, bound and added peaks."""
    log(f"    dW ({row['dw_route']}): err {row['dw_max_abs_err']:.3g} (tol "
        f"{row['dw_tol']:.3g}"
        + (", bit-equal over two runs" if row["dw_bit_equal"] else "")
        + f") {row['dw_ms']:.4f} ms, patch product "
        f"{row['dw_plain_ms']:.3f} ms, cuDNN {row['dw_library_ms']:.4f} ms "
        f"(rel diff {row['dw_library_rel_diff']:.2g}), bound "
        f"{row['dw_bound_ms']:.4f} ms ({row['dw_bound_by']}), peak "
        f"{row['dw_peak_bytes'] / 1e9:.3f} GB (patch product "
        f"{row['dw_plain_peak_bytes'] / 1e9:.2f} GB)")


def log_dw_totals(totals, step):
    """The per-step dW totals over the kernel's classes and over all."""
    for key, what in (("dw_wgmma", " on the wgrad kernel"), ("dw", "")):
        t = totals[key]
        log(f"  dW of the {step} {t['convs']} convs{what}: "
            f"{t['dw_ms']:.3f} ms, patch product {t['dw_plain_ms']:.3f} ms, "
            f"cuDNN {t['dw_library_ms']:.3f} ms, bound "
            f"{t['dw_bound_ms']:.4f} ms; largest added peak "
            f"{t['dw_peak_bytes'] / 1e9:.3f} GB (patch product "
            f"{t['dw_plain_peak_bytes'] / 1e9:.2f} GB)")


def dw_totals(rows):
    """dW summed over a step's convs (each class times its count): kernel,
    plain version, library and bound ms, the worst error against its
    tolerance, the largest added peaks."""
    out = {k: sum(r[k] * r["count"] for r in rows)
           for k in ("dw_ms", "dw_plain_ms", "dw_library_ms",
                     "dw_bound_ms")}
    by_bytes = sum(r["dw_bound_ms"] * r["count"] for r in rows
                   if r["dw_bound_by"] == "bytes")
    out["dw_bound_by"] = ("bytes" if by_bytes > out["dw_bound_ms"] / 2
                          else "operations")
    worst = max(rows, key=lambda r: r["dw_max_abs_err"] / r["dw_tol"])
    out.update(dw_max_abs_err=worst["dw_max_abs_err"], dw_tol=worst["dw_tol"],
               convs=sum(r["count"] for r in rows),
               dw_peak_bytes=max(r["dw_peak_bytes"] for r in rows),
               dw_plain_peak_bytes=max(r["dw_plain_peak_bytes"]
                                       for r in rows))
    return out


def conv_backward_errors(xs, cout, dtype, seed):
    """dx, dW and dbias of ``conv3d_igemm_train`` (K1's forward and dx, the
    port's dW) against autograd through the plain version
    (``conv3d_igemm_reference``) at input shape ``xs`` and ``cout``, on
    inputs drawn from ``seed``: the inputs ``(x, w, bias, gy)``, the max
    abs errors of dx, dW and dbias and their tolerances."""
    import torch

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_igemm_reference,
        conv3d_igemm_train,
    )

    b, spatial, cin = xs[0], xs[1:4], xs[4]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(xs, generator=g, device="cuda").to(dtype)
    w = torch.randn((3, 3, 3, cin, cout), generator=g, device="cuda")
    w = (w / (27 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=g, device="cuda")).to(dtype)
    gy = torch.randn((b, *spatial, cout), generator=g,
                     device="cuda").to(dtype)
    got, want = [], []
    for fn, out in ((conv3d_igemm_train, got),
                    (conv3d_igemm_reference, want)):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        y = fn(*leaves)
        out.extend(torch.autograd.grad(y, leaves, gy))
    torch.cuda.synchronize()
    errs, tols = [], []
    # f32, TF32 off: dx is the forward's kernel (3xTF32 or narrow), held as
    # phase 3 holds the forward, to 1e-5 of the scale, which one TF32 pass
    # (3e-4) fails; dW (the patch product) and dbias differ in summation
    # order only (1e-3 of the scale). bf16: dx, dW and dbias each round one
    # f32 sum on both sides, so one ulp, 2^-7 of the scale
    rels = ((1e-5, 1e-3, 1e-3) if dtype == torch.float32
            else (2.0**-7,) * 3)
    for gt, wt, rel in zip(got, want, rels):
        scale = max(float(wt.float().abs().max()), 1e-30)
        errs.append(float((gt.float() - wt.float()).abs().max()))
        tols.append(rel * scale)
    return (x, w, bias, gy), errs, tols


def phase_conv_backward(shapes):
    """dx/dW/dbias of the Function against autograd through the plain
    version at every stride-1 conv shape of the flagship forward (B=4),
    the dx launches timed (bf16 and f32), and dW (bf16 and f32) timed
    beside cuDNN's and its bound."""
    import torch
    import torch.nn.functional as F

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_igemm_dx,
        conv3d_igemm_reference,
        conv_route,
    )

    log("[conv backward vs plain] flagship shapes, B=4")
    rows = []
    for i, ((xs, cout), count) in enumerate(sorted(shapes.items())):
        b, spatial, cin = xs[0], xs[1:4], xs[4]
        # the stem's first conv reads the image: no dx on the main path
        dx_count = count - (1 if cin == 1 and cout == 1 else 0)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            (x, w, bias, gy), errs, tols = conv_backward_errors(
                xs, cout, dtype, 200 + i)
            ok = all(e <= t for e, t in zip(errs, tols))
            row = dict(shape=[b, *spatial, cin, cout], dtype=name,
                       dx_route=conv_route(dtype, cout, cin),
                       count=count, dx_count=dx_count,
                       errs=dict(zip(("dx", "dw", "db"), errs)),
                       tols=dict(zip(("dx", "dw", "db"), tols)), ok=ok,
                       dx_err=errs[0], dx_tol=tols[0])
            w_rot = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            gc, wc = gy.permute(0, 4, 1, 2, 3), w_rot.permute(4, 3, 0, 1, 2)
            row.update(
                ms=time_ms(lambda: conv3d_igemm_dx(gy, w)),
                plain_ms=time_ms(lambda: conv3d_igemm_reference(gy, w_rot)),
                library_ms=time_ms(lambda: F.conv3d(gc, wc, padding=1)),
                **conv_bounds(b, spatial, cout, cin, name),
            )
            # dW: bf16 on the wgrad kernel or the patch product; f32 on
            # the patch product, beside cuDNN's f32 weight gradient and two
            # bounds, at 3xTF32 (what a tensor-core kernel could reach) and
            # at FMA's rate
            row.update(time_weight_grad(x, gy, w))
            row["dw_bound_ms"], row["dw_bound_by"] = weight_grad_bound(
                b, spatial, cin, cout, name,
                None if dtype == torch.bfloat16 else PEAK_F32_TF32X3)
            if dtype == torch.float32:
                row["dw_bound_fma_ms"] = weight_grad_bound(
                    b, spatial, cin, cout, name)[0]
            log(f"  {b}x{'x'.join(map(str, spatial))} {cin}->{cout} {name} "
                f"(dx {row['dx_route']}): "
                + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, e, t in
                            zip(("dx", "dw", "db"), errs, tols))
                + f"; dx kernel {row['ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f}, F.conv3d {row['library_ms']:.3f}, "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
            if "dw_ms" in row:
                log_dw(row)
            if not ok:
                raise AssertionError(f"conv backward disagrees: {row}")
            rows.append(row)
    timed = [r for r in rows if r["dtype"] == "bfloat16"]
    totals = sum_rows(timed, "dx_count", ("dx_err", "dx_tol"))
    # f32 (the CLI's default precision): all 30 dx launches, and the 29 on
    # the tf32 route
    f32 = [r for r in rows if r["dtype"] == "float32"]
    totals["f32"] = sum_rows(f32, "dx_count", ("dx_err", "dx_tol"))
    totals["f32_tf32"] = sum_rows(
        [r for r in f32 if r["dx_route"] == "tf32"], "dx_count",
        ("dx_err", "dx_tol"))
    if totals["f32_tf32"]["convs"] != CONVS_DX_TF32_PER_STEP:
        raise AssertionError(f"{totals['f32_tf32']['convs']} f32 dx "
                             "launches on the tf32 route")
    # dW of every conv of a step (the stem's first too), and of those the
    # wgrad kernel takes
    totals["dw"] = dw_totals(timed)
    totals["dw_wgmma"] = dw_totals(
        [r for r in timed if r["dw_route"] == "wgmma"])
    totals["dw_f32"] = dw_totals(f32)
    totals["dw_f32"]["dw_bound_fma_ms"] = sum(
        r["dw_bound_fma_ms"] * r["count"] for r in f32)
    if (totals["dw"]["convs"], totals["dw_wgmma"]["convs"]) != (
            CONVS_PER_FORWARD, CONVS_WGRAD_PER_STEP):
        raise AssertionError(f"dW classes: {totals['dw']['convs']} convs, "
                             f"{totals['dw_wgmma']['convs']} on the kernel")
    log(f"  per training step ({CONVS_DX_PER_STEP} dx launches, bf16): kernel"
        f" {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"F.conv3d {totals['library_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms ({totals['bound_by']})")
    for key, what in (("f32", "all 30"), ("f32_tf32", "the 29 of the tf32 "
                                          "route")):
        t = totals[key]
        log(f"  per training step, f32 dx ({what}): kernel {t['ms']:.3f} "
            f"ms, plain {t['plain_ms']:.3f} ms, F.conv3d (TF32 off) "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"(3xTF32; FMA {t['bound_fma_ms']:.4f} ms)")
    log_dw_totals(totals, "U-Net step's")
    t = totals["dw_f32"]
    log(f"  dW of the U-Net step's {t['convs']} convs, f32 (the patch "
        f"product): {t['dw_ms']:.3f} ms, cuDNN (TF32 off) "
        f"{t['dw_library_ms']:.3f} ms, bound {t['dw_bound_ms']:.4f} ms "
        f"(3xTF32; FMA {t['dw_bound_fma_ms']:.4f} ms)")
    return rows, totals


def unetr_weight_grad(shapes):
    """dW at the stride-1 conv classes of a UNETR training step (B=2,
    bf16), as the step gives them to ``conv3d_weight_grad``: each held
    against its plain version (one ulp; bit-equal over two runs on the
    kernel) and timed beside cuDNN and its bound, with per-step totals
    over the kernel's 8 and all 9."""
    import torch

    rows = []
    for i, ((xs, cout), count) in enumerate(sorted(shapes.items())):
        b, spatial, cin = xs[0], xs[1:4], xs[4]
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(xs, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((3, 3, 3, cin, cout), generator=g, device="cuda")
             / (27 * cin) ** 0.5).to(torch.bfloat16)
        gy = torch.randn((b, *spatial, cout), generator=g,
                         device="cuda").to(torch.bfloat16)
        row = dict(shape=[b, *spatial, cin, cout], count=count)
        row.update(time_weight_grad(x, gy, w))
        row["dw_bound_ms"], row["dw_bound_by"] = weight_grad_bound(
            b, spatial, cin, cout, "bfloat16")
        log(f"  {b}x{'x'.join(map(str, spatial))} {cin}->{cout} x{count}")
        log_dw(row)
        rows.append(row)
        del x, w, gy
    torch.cuda.empty_cache()
    totals = dict(dw=dw_totals(rows), dw_wgmma=dw_totals(
        [r for r in rows if r["dw_route"] == "wgmma"]))
    if (totals["dw"]["convs"], totals["dw_wgmma"]["convs"]) != (
            UNETR_CONVS, UNETR_CONVS_WGRAD):
        raise AssertionError(f"UNETR dW classes: {totals['dw']['convs']} "
                             f"convs, {totals['dw_wgmma']['convs']} on the "
                             "kernel")
    log_dw_totals(totals, "UNETR step's")
    return rows, totals


def narrow_step_row(path_rows, bwd_rows):
    """The narrow route's share of one U-Net training step: its forward
    launches (phase 4's window-batch shapes) and its dx launches (phase
    7's), in bf16, times and bounds summed by count, the worst error
    against its tolerance."""
    parts = [(r, r["count"], r["max_abs_err"], r["tol"]) for r in path_rows
             if r["route"] == "narrow"]
    parts += [(r, r["dx_count"], r["errs"]["dx"], r["tols"]["dx"])
              for r in bwd_rows
              if r["dx_route"] == "narrow" and r["dtype"] == "bfloat16"
              and r["dx_count"]]
    row = {k: sum(r[k] * n for r, n, _, _ in parts)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_bytes = sum(r["bound_ms"] * n for r, n, _, _ in parts
                   if r["bound_by"] == "bytes")
    row["bound_by"] = ("bytes" if by_bytes > row["bound_ms"] / 2
                       else "operations")
    _, _, err, tol = max(parts, key=lambda p: p[2] / p[3])
    row.update(max_abs_err=err, tol=tol, launches_per_step=sum(
        n for _, n, _, _ in parts))
    return row


def _grad_norm(grads):
    import torch

    return float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])))


def phase_training():
    """The flagship trainer on the card: the gradient repair check, the
    counted and timed steps, a loss that falls, and f32 parity with the
    plain conv path, timed after a warm-up step as the bf16 steps are."""
    import torch

    from adell_mri_torch.tools.flagship import (
        BATCH,
        make_train_batch,
        make_trainer,
    )

    batch = make_train_batch(0)
    tr = make_trainer(0, "bf16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(tr.state.params)

    # the repair: every parameter gets a finite, non-zero gradient
    loss, _ = tr.loss_and_metrics(tr.state.params,
                                  tr.transforms.augment(gen, batch))
    grads = torch.autograd.grad(loss, [tr.state.params[k] for k in names])
    bad = [k for k, gr in zip(names, grads)
           if not bool(torch.isfinite(gr).all()) or float(gr.abs().max()) == 0]
    log(f"[training] bf16 gradients: {len(names)} parameters, "
        f"{len(names) - len(bad)} finite and non-zero")
    if bad:
        raise AssertionError(f"zero or non-finite gradients: {bad}")
    del grads, loss

    def step():
        aug = tr.transforms.augment(gen, batch)
        tr.state, metrics = tr.train_step(tr.state, aug)
        return metrics

    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = {k: v for k, v in _launch_counts().items()
                if not k.startswith("flash_")}
    want = dict(conv3d_igemm=CONVS_PER_FORWARD * TIMED_STEPS,
                conv3d_igemm_wgmma=CONVS_WGMMA_PER_FORWARD * TIMED_STEPS,
                conv3d_igemm_tf32=0,
                conv3d_igemm_narrow=CONVS_NARROW_PER_FORWARD * TIMED_STEPS,
                conv3d_igemm_dx=CONVS_DX_PER_STEP * TIMED_STEPS,
                conv3d_igemm_dx_wgmma=CONVS_DX_WGMMA_PER_STEP * TIMED_STEPS,
                conv3d_igemm_dx_tf32=0,
                conv3d_igemm_dx_narrow=CONVS_DX_NARROW_PER_STEP
                * TIMED_STEPS,
                conv3d_weight_grad=CONVS_WGRAD_PER_STEP * TIMED_STEPS,
                conv3d_weight_grad_patches=CONVS_WGRAD_PATCHES_PER_STEP
                * TIMED_STEPS,
                intensity_aug=TIMED_STEPS)
    per_step = {k: v / TIMED_STEPS for k, v in launches.items()}
    med = sorted(secs)[len(secs) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[training] bf16, B={BATCH} at 128x128x32, augmentation on: warm-up "
        f"{warm:.3f} s, then {', '.join(f'{s:.4f}' for s in secs)} s per "
        f"step ({BATCH / med:.2f} volumes/s at the median); launches per "
        f"step {per_step}; losses {losses}; peak memory {peak_gb:.1f} GB")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} (no bf16 "
                             "conv on the igemm route)")
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    del tr

    # ten steps on one batch, no augmentation: the loss falls
    tr = make_trainer(0, "bf16", learning_rate=1e-2)
    before = float(tr.eval_step(tr.state.params, batch)["loss"])
    for _ in range(10):
        tr.state, _ = tr.train_step(tr.state, batch)
    after = float(tr.eval_step(tr.state.params, batch)["loss"])
    log(f"[training] ten steps on one batch (no augmentation, lr 1e-2): "
        f"loss {before:.5f} -> {after:.5f}")
    if not after < before:
        raise AssertionError(f"loss did not fall: {before} -> {after}")
    del tr

    # f32, the CLI's default precision: a warm-up step, then timed steps
    # with the counts reset just before; then one step's loss and gradients
    # on the kernels against the plain conv path
    tr = make_trainer(0, None)
    params = [tr.state.params[k] for k in names]

    def f32_step():
        aug = tr.transforms.augment(gen, batch)
        tr.state, metrics = tr.train_step(tr.state, aug)
        return metrics

    t0 = time.perf_counter()
    f32_step()
    torch.cuda.synchronize()
    f32_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    f32_secs, f32_losses = [], []
    for _ in range(F32_TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = f32_step()
        torch.cuda.synchronize()
        f32_secs.append(time.perf_counter() - t0)
        f32_losses.append(float(metrics["loss"]))
    f32_launches = {k: v for k, v in _launch_counts().items()
                    if not k.startswith("flash_")}
    f32_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f32_med = sorted(f32_secs)[len(f32_secs) // 2]
    f32_per_step = {k: v / F32_TIMED_STEPS for k, v in f32_launches.items()}
    # f32 takes the tf32 route where bf16 takes the wgmma one; its stems
    # and Cout = 1 dx the narrow one; its every dW the patch product
    f32_want = {k: v // TIMED_STEPS * F32_TIMED_STEPS for k, v in want.items()}
    f32_want.update(
        conv3d_igemm_wgmma=0, conv3d_igemm_dx_wgmma=0,
        conv3d_igemm_tf32=CONVS_TF32_PER_FORWARD * F32_TIMED_STEPS,
        conv3d_igemm_dx_tf32=CONVS_DX_TF32_PER_STEP * F32_TIMED_STEPS,
        conv3d_weight_grad=0,
        conv3d_weight_grad_patches=CONVS_PER_FORWARD * F32_TIMED_STEPS)
    log(f"[training] f32, B={BATCH} at 128x128x32, augmentation on: warm-up "
        f"{f32_warm:.3f} s, then {', '.join(f'{s:.4f}' for s in f32_secs)} s "
        f"per step ({BATCH / f32_med:.2f} volumes/s at the median); launches "
        f"per step {f32_per_step}; losses {f32_losses}; peak memory "
        f"{f32_peak_gb:.1f} GB")
    if f32_launches != f32_want:
        raise AssertionError(f"f32 launches {f32_launches}, want {f32_want}")
    if not all(l == l and abs(l) < float("inf") for l in f32_losses):
        raise AssertionError(f"non-finite f32 loss: {f32_losses}")

    _reset_counts()
    loss_k, _ = tr.loss_and_metrics(tr.state.params, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    parity_launches = {k: v for k, v in _launch_counts().items()
                       if not k.startswith("flash_")}
    with plain_kernels():
        loss_p, _ = tr.loss_and_metrics(tr.state.params, batch)
        grads_p = torch.autograd.grad(loss_p, params)
    norm_k, norm_p = _grad_norm(grads_k), _grad_norm(grads_p)
    # the largest gradient difference against the largest gradient, for
    # the record: the two paths do differ (per parameter this would be
    # noise, since a conv bias ahead of an instance norm has a zero
    # gradient)
    worst_rel = max(float((gk - gp).abs().max())
                    for gk, gp in zip(grads_k, grads_p)) / max(
        float(gp.abs().max()) for gp in grads_p)
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_rel = abs(norm_k - norm_p) / norm_p
    log(f"[training] f32 step, kernels ({parity_launches['conv3d_igemm']} "
        f"forward and {parity_launches['conv3d_igemm_dx']} dx launches, "
        f"{parity_launches['conv3d_igemm_tf32']} + "
        f"{parity_launches['conv3d_igemm_dx_tf32']} on the tf32 route; "
        f"{parity_launches['conv3d_weight_grad_patches']} dW patch products)"
        f" vs plain conv path: loss "
        f"{loss_k:.7f} vs {loss_p:.7f} (rel {loss_rel:.2e}, "
        f"tol 1e-4), gradient norm {norm_k:.6g} vs {norm_p:.6g} (rel "
        f"{norm_rel:.2e}, tol 1e-3); largest gradient difference "
        f"{worst_rel:.2e} of the largest gradient")
    one_step = {k: v // F32_TIMED_STEPS for k, v in f32_want.items()}
    one_step["intensity_aug"] = 0
    if parity_launches != one_step:
        raise AssertionError(f"f32 step launches {parity_launches}, want "
                             f"{one_step}")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3):
        raise AssertionError("f32 step disagrees with the plain conv path")
    del tr
    return dict(
        warmup_s=warm, seconds_per_step=secs, volumes_per_s=BATCH / med,
        launches=launches, launches_per_step=per_step, losses=losses,
        peak_memory_gb=peak_gb, n_params=len(names),
        fixed_batch_loss=[before, after],
        f32=dict(warmup_s=f32_warm, seconds_per_step=f32_secs,
                 volumes_per_s=BATCH / f32_med, launches=f32_launches,
                 losses=f32_losses, peak_memory_gb=f32_peak_gb),
        f32_parity=dict(loss=loss_k, plain_loss=loss_p,
                        loss_rel=loss_rel, grad_norm=norm_k,
                        plain_grad_norm=norm_p, grad_norm_rel=norm_rel,
                        worst_param_rel=worst_rel,
                        launches=parity_launches),
    )


def phase_train_cli():
    """A 4-case cohort at the flagship size through ``segmentation train
    --dev cuda`` (one epoch of 2 steps at B=4), then ``segmentation
    predict --dev cuda`` on the checkpoint it wrote, both in this process
    (phase 5 starts the CLI as a process of its own)."""
    import numpy as np

    from adell_mri_torch.data.nifti import read_nifti, write_nifti
    from adell_mri_torch.tools.flagship import FLAGSHIP, WINDOW

    work = WORK_DIR / "train_cli"
    work.mkdir(parents=True)
    rng = np.random.default_rng(3)
    affine = np.diag([-0.5, -0.5, 3.0, 1.0])
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in WINDOW],
                                indexing="ij"), -1)
    ds = {}
    for i in range(4):
        centre = np.asarray(WINDOW) * rng.uniform(0.35, 0.65, 3)
        mask = (((grid - centre) / (np.asarray(WINDOW) / 5)) ** 2).sum(-1)
        mask = (mask <= 1.0).astype(np.float32)
        img = 100 + 80 * mask + 10 * rng.normal(size=WINDOW)
        paths = {}
        for key, data in (("image", img.astype(np.float32)), ("mask", mask)):
            paths[key] = str(work / f"case_{i}_{key}.nii")
            write_nifti(paths[key], data, affine)
        ds[f"case_{i}"] = paths
    (work / "ds.json").write_text(json.dumps(ds))
    # JSON is YAML
    (work / "unet.json").write_text(json.dumps(
        {**FLAGSHIP, "n_channels": 1, "loss_fn": {"dice": {}}}))

    ckpt = work / "ckpt"
    train_s = _cli([
        "segmentation", "train", "--dataset_json", str(work / "ds.json"),
        "--image_keys", "image", "--mask_keys", "mask",
        "--config_file", str(work / "unet.json"),
        "--pad_size", *map(str, WINDOW), "--target_spacing", "0.5", "0.5",
        "3.0", "--batch_size", "4", "--max_epochs", "1",
        "--samples_per_epoch", "8", "--steps_per_epoch", "2",
        "--n_folds", "1", "--augment", "intensity", "noise", "affine",
        "flip", "--precision", "bf16", "--dev", "cuda", "--seed", "0",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(work / "metrics.csv"),
    ])[0]
    fold = ckpt / "segmentation_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    if not (fold / "model.pt").is_file() or meta["n_classes"] != 2:
        raise AssertionError(f"train wrote {sorted(os.listdir(fold))}")
    pred = work / "pred"
    predict_s = _cli([
        "segmentation", "predict", "--dataset_json", str(work / "ds.json"),
        "--checkpoint_dir", str(ckpt), "--output_path", str(pred),
        "--dev", "cuda", "--precision", "bf16", "--sliding_window_size",
        *map(str, WINDOW),
    ])[0]
    for pid in ds:
        img = read_nifti(str(pred / f"{pid}_prob.nii.gz"))
        ok = (img.data.shape == WINDOW and np.isfinite(img.data).all()
              and img.data.min() >= 0.0 and img.data.max() <= 1.0)
        if not ok:
            raise AssertionError(f"{pid}: shape {img.data.shape}, range "
                                 f"[{img.data.min()}, {img.data.max()}]")
    rows = (work / "metrics.csv").read_text().splitlines()
    log(f"[cli] train --dev cuda --precision bf16: 1 epoch of 2 steps at "
        f"B=4 in {train_s:.2f} s; predict on its checkpoint: 4 cases in "
        f"{predict_s:.2f} s (in this process); {len(rows) - 1} metric rows")
    return dict(train_s=train_s, predict_s=predict_s, metric_rows=rows)


# -- transformer slice --------------------------------------------------------

# products per kernel: forward q k^T and p v; dQ adds dO v^T and ds k to
# q k^T; dK/dV q k^T, dO v^T, p^T dO and ds^T q
ATTENTION_PRODUCTS = {"fwd": 2, "bwd_dq": 3, "bwd_dkv": 4}


def attention_bound(kind, b, h, nq, nkv, d, dtype, peak=None):
    """Least time of one attention kernel: its bytes (every input read
    once, every output written once; the row statistics are f32) over HBM
    bandwidth against 2 * Nq * Nkv * D FLOPs per product over ``peak`` (by
    default the peak rate of the dtype)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    q_t, kv_t, rows = b * h * nq * d, b * h * nkv * d, b * h * nq * 4
    nbytes = {
        "fwd": itemsize * (2 * q_t + 2 * kv_t) + 2 * rows,
        "bwd_dq": itemsize * (3 * q_t + 2 * kv_t) + 2 * rows,
        "bwd_dkv": itemsize * (2 * q_t + 4 * kv_t) + 2 * rows,
    }[kind]
    flops = ATTENTION_PRODUCTS[kind] * 2 * b * h * nq * nkv * d
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    bound_by = "bytes" if t_bytes > t_flops else "operations"
    return max(t_bytes, t_flops), bound_by


def compare_attention(shape, dtype, seed, timed):
    """The three kernels against their plain versions on the card at one
    shape (B, H, Nq, Nkv, D); with ``timed`` also their device times, the
    plain versions' and ``F.scaled_dot_product_attention``'s."""
    import torch
    import torch.nn.functional as F

    from adell_mri_torch.ops.kernels import attention as ka

    b, h, nq, nkv, d = shape
    name = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(n):
        return torch.randn((b, h, n, d), generator=gen,
                           device="cuda").to(dtype)

    q, k, v, g = draw(nq), draw(nkv), draw(nkv), draw(nq)
    scale = d ** -0.5
    out, m, l = ka.flash_attention_fwd(q, k, v)
    w_out, w_m, w_l = ka.flash_attention_fwd_reference(q, k, v, scale)
    # both backward sides take the plain forward's rows
    lse, delta = ka.backward_rows(w_out, w_m, w_l, g)
    dq = ka.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale)
    dk, dv = ka.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    w_dq = ka.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, scale)
    w_dk, w_dv = ka.flash_attention_bwd_dkv_reference(
        q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()

    def err_of(got, want):
        return float((got.float() - want.float()).abs().max())

    def scale_of(want, floor):
        return max(float(want.float().abs().max()), floor)

    # f32: summation order only (2e-5 of the scale forward, 1e-4 backward,
    # whose sums run over both sequences). bf16: kernel and plain version
    # both round p and ds to bf16 once before the second product (the
    # kernel against its running maximum, the plain version against the
    # final one) and the result once: one bf16 ulp, 2^-7 of the scale.
    # m is a maximum of f32 sums of exact products, l a sum of exp: 1e-4.
    # With a single key the softmax is constant, so dq and dk vanish in exact
    # arithmetic and what either side returns is the f32 rounding of
    # dp - delta: their scale has a floor of 1e-2 of dv's, far below it at
    # every other shape.
    bf16 = dtype == torch.bfloat16
    rel_f, rel_b = (2.0**-7, 2.0**-7) if bf16 else (2e-5, 1e-4)
    grad_floor = 1e-2 * scale_of(w_dv, 1e-30)
    checks = {
        "out": (err_of(out, w_out), rel_f * scale_of(w_out, 1.0)),
        "m": (err_of(m, w_m), 1e-4 * scale_of(w_m, 1.0)),
        "l": (float(((l - w_l) / w_l).abs().max()), 1e-4),
        "dq": (err_of(dq, w_dq), rel_b * scale_of(w_dq, grad_floor)),
        "dk": (err_of(dk, w_dk), rel_b * scale_of(w_dk, grad_floor)),
        "dv": (err_of(dv, w_dv), rel_b * scale_of(w_dv, 1e-30)),
    }
    ok = all(e <= t for e, t in checks.values())
    row = dict(shape=list(shape), dtype=name, ok=ok,
               errs={n: e for n, (e, _) in checks.items()},
               tols={n: t for n, (_, t) in checks.items()})
    log(f"  attention B={b} H={h} Nq={nq} Nkv={nkv} D={d} {name}: "
        + ", ".join(f"{n} {e:.3g} (tol {t:.3g})"
                    for n, (e, t) in checks.items()))
    if not ok:
        raise AssertionError(f"attention kernels disagree with plain: {row}")
    if not timed:
        return row

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(*leaves)
        torch.autograd.grad(y, leaves, g)

    with torch.no_grad():
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    lib_both = time_ms(sdpa_fwd_bwd)
    # the library's backward alone (dQ, dK and dV in one call), by difference
    lib_bwd = lib_both - lib_fwd
    args = (q, k, v, g, lse, delta, scale)
    times = {
        "fwd": dict(
            ms=time_ms(lambda: ka.flash_attention_fwd(q, k, v)),
            plain_ms=time_ms(
                lambda: ka.flash_attention_fwd_reference(q, k, v, scale)),
            library_ms=lib_fwd,
            max_abs_err=checks["out"][0], tol=checks["out"][1]),
        "bwd_dq": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dq(*args)),
            plain_ms=time_ms(
                lambda: ka.flash_attention_bwd_dq_reference(*args)),
            library_ms=lib_both, library_bwd_ms=lib_bwd,
            max_abs_err=checks["dq"][0], tol=checks["dq"][1]),
        "bwd_dkv": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dkv(*args)),
            plain_ms=time_ms(
                lambda: ka.flash_attention_bwd_dkv_reference(*args)),
            library_ms=lib_both, library_bwd_ms=lib_bwd,
            max_abs_err=max(checks["dk"][0], checks["dv"][0]),
            tol=min(checks["dk"][1], checks["dv"][1])),
    }
    for kind, t in times.items():
        # f32 products at f32's accuracy: 3xTF32 at the least, FMA beside
        t["bound_ms"], t["bound_by"] = attention_bound(
            kind, b, h, nq, nkv, d, name, None if bf16 else PEAK_F32_TF32X3)
        if not bf16:
            t["bound_fma_ms"], t["bound_fma_by"] = attention_bound(
                kind, b, h, nq, nkv, d, name)
        log(f"    {kind}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"{t['library_ms']:.4f} ms ("
            f"{'forward' if kind == 'fwd' else 'forward + backward'}"
            + ("" if kind == "fwd" else f"; backward alone {lib_bwd:.4f} ms")
            + f"), bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    both = times["bwd_dq"]["ms"] + times["bwd_dkv"]["ms"]
    log(f"    bwd_dq + bwd_dkv: {both:.4f} ms against the library's "
        f"backward alone {lib_bwd:.4f} ms ({both / lib_bwd:.2f}x)")
    row["times"] = times
    return row


def attention_twice(shape, seed, dtype):
    """The forward, dQ and dK/dV run twice on the same inputs must give the
    same bits: every output element has one owner, nothing is atomic."""
    import torch

    from adell_mri_torch.ops.kernels import attention as ka

    b, h, nq, nkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (
        torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
        for n in (nq, nkv, nkv, nq)
    )
    scale = d ** -0.5
    runs = []
    for _ in range(2):
        out, m, l = ka.flash_attention_fwd(q, k, v, scale)
        lse, delta = ka.backward_rows(out, m, l, g)
        runs.append((out, m, l,
                     ka.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
                     *ka.flash_attention_bwd_dkv(
                         q, k, v, g, lse, delta, scale)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    name = str(dtype).split(".")[1]
    log(f"  attention B={b} H={h} Nq={nq} Nkv={nkv} D={d} {name} twice: "
        f"out, m, l, dq, dk, dv bit-equal: {same}")
    if not same:
        raise AssertionError(f"attention kernels differ between two runs at "
                             f"{shape} {name}")
    return dict(shape=list(shape), dtype=name, bit_equal=same)


def attention_images(shape, seed):
    """The 3xTF32 kernels' preparation kernel (``adell_flash_image_f32``,
    which each f32 forward, dQ and dK/dV call launches before its kernel)
    against its plain version, ``flash_tf32x3_image_reference``: the same
    bits, of all three kinds (K and V for dQ; Q, dO, lse and delta for
    dK/dV; K and V^T for the forward)."""
    import torch

    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.ops.kernels.build import load_library

    b, h, nq, nkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda")
                  for n in (nq, nkv, nkv, nq))
    lse, delta = (torch.randn((b, h, nq, 1), generator=gen, device="cuda")
                  for _ in range(2))
    row = dict(shape=list(shape))
    for kind, (a, bb, n) in enumerate(((k, v, nkv), (q, g, nq),
                                       (k, v, nkv))):
        want = ka.flash_tf32x3_image_reference(kind, a, bb, lse, delta)
        got = torch.full_like(want, float("nan"))
        rc = load_library().adell_flash_image_f32(
            kind, a.data_ptr(), bb.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), got.data_ptr(), b * h, n, d,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        row[f"kind{kind}_equal"] = rc == 0 and torch.equal(got, want)
    log(f"  3xTF32 images B={b} H={h} Nq={nq} Nkv={nkv} D={d}: K, V "
        f"bit-equal to the plain version: {row['kind0_equal']}; Q, dO, lse, "
        f"delta: {row['kind1_equal']}; the forward's K, V^T: "
        f"{row['kind2_equal']}")
    if not all(row[f"kind{i}_equal"] for i in range(3)):
        raise AssertionError(f"3xTF32 images differ from plain: {row}")
    return row


def phase_attention():
    """Phase 10. Returns every row and the timed rows at the serving (B=1)
    and training (B=2) shapes, by dtype."""
    import torch

    log("[attention vs plain] UNETR's shapes, a ragged one, head dim 32, "
        "the edges of the 64-row tiles, B x H of 1 x 1 and 4 x 8")
    rows, main = [], {"bfloat16": {}, "float32": {}}
    main_shape = (UNETR_HEADS, UNETR_TOKENS, UNETR_TOKENS, UNETR_HEAD_DIM)
    cases = [
        ((1,) + main_shape, True), ((2,) + main_shape, True),
        ((1, UNETR_HEADS, 2050, 2311, UNETR_HEAD_DIM), False),
        ((1, 6, UNETR_TOKENS, UNETR_TOKENS, 32), False),
    ]
    # untimed: either sequence at the edges of a tile against 2048 tokens,
    # head dim 32 ragged, a grid that leaves the card idle and one that
    # overfills a wave of blocks
    for n in ATTENTION_TILE_EDGES:
        cases.append(((1, 2, n, UNETR_TOKENS, UNETR_HEAD_DIM), False))
        cases.append(((1, 2, UNETR_TOKENS, n, UNETR_HEAD_DIM), False))
    cases += [
        ((1, 3, 2050, 2311, 32), False),
        ((1, 1, UNETR_TOKENS, UNETR_TOKENS, UNETR_HEAD_DIM), False),
        ((4, 8, UNETR_TOKENS, UNETR_TOKENS, UNETR_HEAD_DIM), False),
        ((4, 8, 1000, 1100, 32), False),
    ]
    for i, (shape, timed) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            row = compare_attention(shape, dtype, 300 + i, timed)
            rows.append(row)
            if timed:
                main[row["dtype"]][shape[0]] = row["times"]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(attention_twice((2,) + main_shape, 400, dtype))
        rows.append(attention_twice((1, 3, 2050, 2311, 32), 401, dtype))
    rows.append(attention_images((2,) + main_shape, 402))
    rows.append(attention_images((1, 3, 2050, 2311, 32), 403))
    return rows, main


def _launch_counts():
    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.ops.kernels import conv as kconv
    from adell_mri_torch.ops.kernels import intensity as ki

    return dict(
        flash_attention_fwd=ka.flash_attention_fwd.launches,
        flash_attention_bwd_dq=ka.flash_attention_bwd_dq.launches,
        flash_attention_bwd_dkv=ka.flash_attention_bwd_dkv.launches,
        conv3d_igemm=kconv.conv3d_igemm.launches,
        conv3d_igemm_wgmma=kconv.conv3d_igemm.wgmma_launches,
        conv3d_igemm_tf32=kconv.conv3d_igemm.tf32_launches,
        conv3d_igemm_narrow=kconv.conv3d_igemm.narrow_launches,
        conv3d_igemm_dx=kconv.conv3d_igemm_dx.launches,
        conv3d_igemm_dx_wgmma=kconv.conv3d_igemm_dx.wgmma_launches,
        conv3d_igemm_dx_tf32=kconv.conv3d_igemm_dx.tf32_launches,
        conv3d_igemm_dx_narrow=kconv.conv3d_igemm_dx.narrow_launches,
        conv3d_weight_grad=kconv.conv3d_weight_grad.launches,
        conv3d_weight_grad_patches=kconv.conv3d_weight_grad.patch_calls,
        intensity_aug=ki.intensity_aug.launches,
    )


def _reset_counts():
    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.ops.kernels import conv as kconv
    from adell_mri_torch.ops.kernels import intensity as ki

    for fn in (ka.flash_attention_fwd, ka.flash_attention_bwd_dq,
               ka.flash_attention_bwd_dkv, kconv.conv3d_igemm,
               kconv.conv3d_igemm_dx, ki.intensity_aug):
        fn.launches = 0
    for fn in (kconv.conv3d_igemm, kconv.conv3d_igemm_dx):
        fn.wgmma_launches = 0
        fn.tf32_launches = 0
        fn.narrow_launches = 0
    kconv.conv3d_weight_grad.launches = 0
    kconv.conv3d_weight_grad.patch_calls = 0


def phase_unetr_serving(dtype):
    """Phase 11, in bf16 or f32 (the CLI's default precision): one warm-up
    case, the counted case, two more timed, and the same case through the
    kernels' plain versions."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CASE,
        make_case,
        make_inference,
        make_model,
    )

    bf16 = dtype == torch.bfloat16
    model = make_model(0, dtype, name="unetr")
    infer = make_inference(model, "unetr")
    case = make_case(1)
    secs = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        infer(case)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        out = infer(case)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = _launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            infer(case)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with plain_kernels():
            want = infer(case)
        torch.cuda.synchronize()
    want_launches = dict.fromkeys(launches, 0)
    # f32 convs take the tf32 route where bf16 ones take the wgmma one
    want_launches.update({
        "flash_attention_fwd": UNETR_BLOCKS, "conv3d_igemm": UNETR_CONVS,
        "conv3d_igemm_narrow": UNETR_CONVS_NARROW,
        "conv3d_igemm_wgmma" if bf16 else "conv3d_igemm_tf32":
            UNETR_CONVS_WGMMA if bf16 else UNETR_CONVS_TF32})
    err = float((out - want).abs().max())
    lo, hi = float(out.min()), float(out.max())
    # bf16: one-ulp rounding flips in 8 attention blocks and 9 convs,
    # renormalised by layer and instance norms, move a probability by well
    # under 5e-2 (the U-Net's window-batch tolerance); f32: the kernels
    # hold 2e-5 (attention) and 1e-5 (convs) of their scales against the
    # plain versions, which leaves a probability far inside the U-Net's f32
    # window-batch tolerance, 1e-3
    tol = 5e-2 if bf16 else 1e-3
    log(f"[unetr serving] {'bf16' if bf16 else 'f32'}, "
        f"{'x'.join(map(str, CASE))} case, one window: "
        f"launches {launches}; warm-up {warm:.3f} s, then "
        f"{', '.join(f'{s:.4f}' for s in secs)} s per case; kernels vs "
        f"plain versions: max abs err {err:.3g} (tol {tol})")
    if launches != want_launches:
        raise AssertionError(f"launches {launches}, want {want_launches}")
    if tuple(out.shape) != CASE + (1,):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()) or lo < 0.0 or hi > 1.0:
        raise AssertionError(f"probabilities not in [0, 1]: {lo}, {hi}")
    if not err <= tol:
        raise AssertionError(f"UNETR disagrees with its plain path: {err}")
    return dict(launches=launches, warmup_s=warm, seconds_per_case=secs,
                prob_range=[lo, hi], max_abs_err=err, tol=tol)


def phase_unetr_training():
    """Phase 12: the UNETR trainer on the card."""
    import torch
    import yaml

    from adell_mri_torch.tools.flagship import (
        CASE,
        UNETR_BATCH,
        UNETR_YAML,
        make_train_batch,
        make_trainer,
    )

    batch = make_train_batch(0, batch=UNETR_BATCH, shape=CASE)
    tr = make_trainer(0, "bf16", name="unetr")
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(tr.state.params)

    # the step's conv classes, recorded from its forward
    shapes = {}
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        conv_recorder(shapes))
    try:
        loss, _ = tr.loss_and_metrics(tr.state.params,
                                      tr.transforms.augment(gen, batch))
    finally:
        hook.remove()
    grads = torch.autograd.grad(loss, [tr.state.params[k] for k in names])
    bad = [k for k, gr in zip(names, grads)
           if not bool(torch.isfinite(gr).all()) or float(gr.abs().max()) == 0]
    log(f"[unetr training] bf16 gradients: {len(names)} parameters, "
        f"{len(names) - len(bad)} finite and non-zero")
    if bad:
        raise AssertionError(f"zero or non-finite gradients: {bad}")
    del grads, loss
    log(f"[unetr dW vs plain] the step's conv classes, B={UNETR_BATCH}, "
        "bf16")
    dw_rows, dw_step = unetr_weight_grad(shapes)

    def step():
        aug = tr.transforms.augment(gen, batch)
        tr.state, metrics = tr.train_step(tr.state, aug)
        return metrics

    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, losses = [], []
    for _ in range(UNETR_TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = _launch_counts()
    per_step = dict(
        flash_attention_fwd=UNETR_BLOCKS, flash_attention_bwd_dq=UNETR_BLOCKS,
        flash_attention_bwd_dkv=UNETR_BLOCKS, conv3d_igemm=UNETR_CONVS,
        conv3d_igemm_wgmma=UNETR_CONVS_WGMMA, conv3d_igemm_tf32=0,
        conv3d_igemm_narrow=UNETR_CONVS_NARROW,
        conv3d_igemm_dx=UNETR_CONVS_DX,
        conv3d_igemm_dx_wgmma=UNETR_CONVS_DX_WGMMA, conv3d_igemm_dx_tf32=0,
        conv3d_igemm_dx_narrow=0, conv3d_weight_grad=UNETR_CONVS_WGRAD,
        conv3d_weight_grad_patches=UNETR_CONVS_WGRAD_PATCHES,
        intensity_aug=1,
    )
    want = {k: v * UNETR_TIMED_STEPS for k, v in per_step.items()}
    med = sorted(secs)[len(secs) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[unetr training] bf16, B={UNETR_BATCH} at "
        f"{'x'.join(map(str, CASE))}, augmentation on, dropout 0: warm-up "
        f"{warm:.3f} s, then {', '.join(f'{s:.4f}' for s in secs)} s per "
        f"step ({UNETR_BATCH / med:.2f} volumes/s at the median); launches "
        f"in {UNETR_TIMED_STEPS} steps {launches}; losses {losses}; peak "
        f"memory {peak_gb:.1f} GB")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    # one step at the yaml's batch size (4), dropout 0 as above
    big_batch = yaml.safe_load(UNETR_YAML.read_text())["batch_size"]
    big = make_train_batch(1, batch=big_batch, shape=CASE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    aug = tr.transforms.augment(gen, big)
    tr.state, metrics = tr.train_step(tr.state, aug)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    big_loss = float(metrics["loss"])
    big_peak = torch.cuda.max_memory_allocated() / 1e9
    big_launches = _launch_counts()
    log(f"[unetr training] one step at the yaml's B={big_batch}: "
        f"{big_s:.4f} s, loss {big_loss:.5f}, peak memory {big_peak:.2f} GB "
        f"(B={UNETR_BATCH}: {peak_gb:.2f} GB); launches {big_launches}")
    if big_launches != per_step:
        raise AssertionError(f"B={big_batch} launches {big_launches}, want "
                             f"{per_step}")
    if not abs(big_loss) < float("inf"):
        raise AssertionError(f"B={big_batch} loss {big_loss}")
    del tr, big, aug

    tr = make_trainer(0, "bf16", learning_rate=1e-2, name="unetr")
    before = float(tr.eval_step(tr.state.params, batch)["loss"])
    for _ in range(10):
        tr.state, _ = tr.train_step(tr.state, batch)
    after = float(tr.eval_step(tr.state.params, batch)["loss"])
    log(f"[unetr training] ten steps on one batch (no augmentation, lr "
        f"1e-2): loss {before:.5f} -> {after:.5f}")
    if not after < before:
        raise AssertionError(f"loss did not fall: {before} -> {after}")
    del tr

    # one f32 step on the kernels against the plain versions, on one
    # volume: the f32 dW patch tensor of the widest full-size conv is
    # 14.5 GB a sample
    tr = make_trainer(0, None, name="unetr")
    one = {k: v[:1] for k, v in batch.items()}
    params = [tr.state.params[k] for k in names]
    _reset_counts()
    loss_k, _ = tr.loss_and_metrics(tr.state.params, one)
    grads_k = torch.autograd.grad(loss_k, params)
    f32_launches = _launch_counts()
    with plain_kernels():
        loss_p, _ = tr.loss_and_metrics(tr.state.params, one)
        grads_p = torch.autograd.grad(loss_p, params)
    norm_k, norm_p = _grad_norm(grads_k), _grad_norm(grads_p)
    worst_rel = max(float((gk - gp).abs().max())
                    for gk, gp in zip(grads_k, grads_p)) / max(
        float(gp.abs().max()) for gp in grads_p)
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_rel = abs(norm_k - norm_p) / norm_p
    log(f"[unetr training] f32 step (B=1), kernels ({f32_launches}) vs "
        f"plain versions: loss {loss_k:.7f} vs {loss_p:.7f} (rel "
        f"{loss_rel:.2e}, tol 1e-4), gradient norm {norm_k:.6g} vs "
        f"{norm_p:.6g} (rel {norm_rel:.2e}, tol 1e-3); largest gradient "
        f"difference {worst_rel:.2e} of the largest gradient")
    # f32 takes the tf32 route where bf16 takes the wgmma one, and its dW
    # the patch product; the image's 1->16 takes the narrow one
    if f32_launches != {**per_step, "intensity_aug": 0,
                        "conv3d_igemm_wgmma": 0,
                        "conv3d_igemm_dx_wgmma": 0,
                        "conv3d_igemm_tf32": UNETR_CONVS_TF32,
                        "conv3d_igemm_dx_tf32": UNETR_CONVS_DX_TF32,
                        "conv3d_weight_grad": 0,
                        "conv3d_weight_grad_patches": UNETR_CONVS}:
        raise AssertionError(f"f32 step launches {f32_launches}")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3):
        raise AssertionError("f32 step disagrees with the plain versions")

    # the f32 step timed (the CLI's default precision): a warm-up, then
    # UNETR_TIMED_STEPS steps at B=1, augmentation on
    def f32_step():
        aug = tr.transforms.augment(gen, one)
        tr.state, metrics = tr.train_step(tr.state, aug)
        return float(metrics["loss"])

    t0 = time.perf_counter()
    f32_step()
    torch.cuda.synchronize()
    f32_warm = time.perf_counter() - t0
    f32_secs, f32_losses = [], []
    for _ in range(UNETR_TIMED_STEPS):
        t0 = time.perf_counter()
        f32_losses.append(f32_step())
        torch.cuda.synchronize()
        f32_secs.append(time.perf_counter() - t0)
    log(f"[unetr training] f32, B=1, augmentation on: warm-up "
        f"{f32_warm:.3f} s, then {', '.join(f'{x:.4f}' for x in f32_secs)} "
        f"s per step; losses {f32_losses}")
    if not all(abs(x) < float("inf") for x in f32_losses):
        raise AssertionError(f"non-finite f32 loss: {f32_losses}")
    del tr
    return dict(
        warmup_s=warm, seconds_per_step=secs,
        volumes_per_s=UNETR_BATCH / med, launches=launches, losses=losses,
        peak_memory_gb=peak_gb, n_params=len(names),
        dw_classes=dw_rows, dw_per_step=dw_step,
        yaml_batch=dict(batch=big_batch, seconds=big_s, loss=big_loss,
                        peak_memory_gb=big_peak, launches=big_launches),
        fixed_batch_loss=[before, after],
        f32_parity=dict(loss=loss_k, plain_loss=loss_p, loss_rel=loss_rel,
                        grad_norm=norm_k, plain_grad_norm=norm_p,
                        grad_norm_rel=norm_rel, worst_param_rel=worst_rel,
                        launches=f32_launches),
        f32_steps=dict(batch=1, warmup_s=f32_warm, seconds_per_step=f32_secs,
                       losses=f32_losses),
    )


def phase_unetr_cli():
    """Phase 13: a 4-case cohort at 256x256x64 through ``segmentation train
    --segmentation_net_type unetr --dev cuda`` with a dropout-0 copy of
    ``sample_configs/unetr.yaml`` (one epoch of 2 steps at B=2), then
    ``segmentation predict --dev cuda`` of one case on the checkpoint it
    wrote, both in this process."""
    import numpy as np
    import yaml

    from adell_mri_torch.data.nifti import read_nifti, write_nifti
    from adell_mri_torch.tools.flagship import CASE, UNETR_YAML

    work = WORK_DIR / "unetr_cli"
    work.mkdir(parents=True)
    rng = np.random.default_rng(4)
    affine = np.diag([-0.5, -0.5, 3.0, 1.0])
    axes = [np.arange(s, dtype=np.float32) for s in CASE]
    ds = {}
    for i in range(4):
        centre = np.asarray(CASE) * rng.uniform(0.35, 0.65, 3)
        radii = np.asarray(CASE) / 5
        dist = sum(
            (((a - c) / r) ** 2).reshape(
                [-1 if j == d else 1 for j in range(3)])
            for d, (a, c, r) in enumerate(zip(axes, centre, radii))
        )
        mask = (dist <= 1.0).astype(np.float32)
        img = (100 + 80 * mask + 10 * rng.standard_normal(
            CASE, dtype=np.float32)).astype(np.float32)
        paths = {}
        for key, data in (("image", img), ("mask", mask)):
            paths[key] = str(work / f"case_{i}_{key}.nii")
            write_nifti(paths[key], data, affine)
        ds[f"case_{i}"] = paths
    (work / "ds.json").write_text(json.dumps(ds))
    config = yaml.safe_load(UNETR_YAML.read_text())
    # with dropout on, attention in training mode leaves the kernels
    config["dropout_rate"] = 0.0
    (work / "unetr.yaml").write_text(yaml.safe_dump(config))

    ckpt = work / "ckpt"
    train_s = _cli([
        "segmentation", "train", "--segmentation_net_type", "unetr",
        "--dataset_json", str(work / "ds.json"),
        "--image_keys", "image", "--mask_keys", "mask",
        "--config_file", str(work / "unetr.yaml"),
        "--pad_size", *map(str, CASE), "--target_spacing", "0.5", "0.5",
        "3.0", "--batch_size", "2", "--max_epochs", "1",
        "--samples_per_epoch", "4", "--steps_per_epoch", "2",
        "--n_folds", "1", "--augment", "intensity", "noise", "affine",
        "flip", "--precision", "bf16", "--dev", "cuda", "--seed", "0",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(work / "metrics.csv"),
    ])[0]
    fold = ckpt / "segmentation_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    if not (fold / "model.pt").is_file() or meta["net_type"] != "unetr":
        raise AssertionError(f"train wrote {sorted(os.listdir(fold))}, "
                             f"net_type {meta.get('net_type')}")
    pred = work / "pred"
    # one case: predict's path is the same for each, and writing a
    # 256x256x64 NIfTI on the host took most of the 52 s four cases took
    predict_s = _cli([
        "segmentation", "predict", "--dataset_json", str(work / "ds.json"),
        "--checkpoint_dir", str(ckpt), "--output_path", str(pred),
        "--dev", "cuda", "--precision", "bf16", "--prediction_ids", "case_0",
    ])[0]
    for pid in ["case_0"]:
        img = read_nifti(str(pred / f"{pid}_prob.nii.gz"))
        ok = (img.data.shape == CASE and np.isfinite(img.data).all()
              and img.data.min() >= 0.0 and img.data.max() <= 1.0)
        if not ok:
            raise AssertionError(f"{pid}: shape {img.data.shape}, range "
                                 f"[{img.data.min()}, {img.data.max()}]")
    rows = (work / "metrics.csv").read_text().splitlines()
    log(f"[unetr cli] train --segmentation_net_type unetr --dev cuda "
        f"--precision bf16: 1 epoch of 2 steps at B=2 in {train_s:.2f} s; "
        f"predict on its checkpoint: 1 case in {predict_s:.2f} s (in this "
        f"process); {len(rows) - 1} metric rows")
    return dict(train_s=train_s, predict_s=predict_s, metric_rows=rows)


# -- the flagship pipeline ---------------------------------------------------

PIPELINE_CASES = 6
PIPELINE_LESION_FREE = 2
# crop steps an epoch when the crop step is counted and timed
CROP_STEPS = 4
# turns of the crop step without and with the NaN guard
GUARD_TURNS = 2
# whole-volume test forwards, kernels against the plain path: 1e-3 in f32
# and 5e-2 in bf16 on the probabilities (max abs difference; the
# tolerances of phases 4 and 11) and on the test CLI's Dice and IoU
TEST_TOL = {"f32": 1e-3, "bf16": 5e-2}


def _pipeline_cohort(work, case, lesion_free, n_cases=PIPELINE_CASES):
    """``n_cases`` NIfTIs at ``case`` (uncompressed, so that writing them is
    quick): per case one or two bright ellipsoids (the mask) over noise,
    none for ``lesion_free``."""
    import numpy as np

    from adell_mri_torch.data.nifti import write_nifti

    rng = np.random.default_rng(7)
    affine = np.diag([-0.5, -0.5, 3.0, 1.0])
    axes = [np.arange(s, dtype=np.float32) for s in case]
    ds = {}
    for i in range(n_cases):
        pid = f"case_{i}"
        mask = np.zeros(case, np.float32)
        if pid not in lesion_free:
            for _ in range(int(rng.integers(1, 3))):
                centre = np.asarray(case) * rng.uniform(0.25, 0.75, 3)
                radii = np.asarray(case) * rng.uniform(0.06, 0.12)
                dist = sum(
                    (((a - c) / r) ** 2).reshape(
                        [-1 if j == d else 1 for j in range(3)])
                    for d, (a, c, r) in enumerate(zip(axes, centre, radii)))
                mask[dist <= 1.0] = 1.0
        img = (100 + 80 * mask + 10 * rng.standard_normal(
            case, dtype=np.float32)).astype(np.float32)
        paths = {}
        for key, data in (("image", img), ("mask", mask.astype(np.uint8))):
            paths[key] = str(work / f"{pid}_{key}.nii")
            write_nifti(paths[key], data, affine)
        ds[pid] = paths
    (work / "ds.json").write_text(json.dumps(ds))
    return ds


class _crop_shapes:
    """Within the block every augmented batch's image shape is recorded
    (``SegmentationTransforms.augment`` read, not changed)."""

    def __enter__(self):
        from adell_mri_torch.transforms.pipeline import SegmentationTransforms

        self.shapes, self.real = [], SegmentationTransforms.augment
        real, shapes = self.real, self.shapes

        def augment(tr, generator, batch):
            out = real(tr, generator, batch)
            shapes.append(tuple(out["image"].shape))
            return out

        SegmentationTransforms.augment = augment
        return self

    def __exit__(self, *exc):
        from adell_mri_torch.transforms.pipeline import SegmentationTransforms

        SegmentationTransforms.augment = self.real
        return False


def _cli(args, counts=True):
    """One in-process run of ``python -m adell_mri_torch`` with the launch
    counts set to 0 just before it: (seconds, standard output, counts)."""
    import contextlib
    import io

    import torch

    from adell_mri_torch.__main__ import main as cli_main

    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_main(list(args))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return secs, out.getvalue(), _launch_counts()


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def _step_want(precision):
    """The launches of one U-Net training step (phase 8's) in ``precision``:
    bf16 on the wgmma route and the wgrad kernel, f32 on the tf32 route and
    the patch product; the stems and the 32->1 dx narrow; one K3."""
    bf16 = precision == "bf16"
    return dict(
        conv3d_igemm=CONVS_PER_FORWARD,
        conv3d_igemm_wgmma=CONVS_WGMMA_PER_FORWARD if bf16 else 0,
        conv3d_igemm_tf32=0 if bf16 else CONVS_TF32_PER_FORWARD,
        conv3d_igemm_narrow=CONVS_NARROW_PER_FORWARD,
        conv3d_igemm_dx=CONVS_DX_PER_STEP,
        conv3d_igemm_dx_wgmma=CONVS_DX_WGMMA_PER_STEP if bf16 else 0,
        conv3d_igemm_dx_tf32=0 if bf16 else CONVS_DX_TF32_PER_STEP,
        conv3d_igemm_dx_narrow=CONVS_DX_NARROW_PER_STEP,
        conv3d_weight_grad=CONVS_WGRAD_PER_STEP if bf16 else 0,
        conv3d_weight_grad_patches=(CONVS_WGRAD_PATCHES_PER_STEP if bf16
                                    else CONVS_PER_FORWARD),
        intensity_aug=1)


def _crop_step(ds, pids, case, window, smi):
    """The flagship trainer (bf16) on pos/neg crops: a batch of 4 padded
    volumes through ``TrainLoop`` and ``SegmentationTransforms.augment``,
    counted against phase 8's step and timed with the NaN guard off and
    on, in turns."""
    import torch

    from adell_mri_torch.data.loader import safe_collate
    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS, make_trainer
    from adell_mri_torch.train.loop import TrainLoop
    from adell_mri_torch.train.nan_guard import NaNGuard
    from adell_mri_torch.transforms.pipeline import (
        AugmentPolicy,
        SegmentationTransforms,
    )

    transforms = SegmentationTransforms(
        image_keys=["image"], label_keys=["mask"],
        target_spacing=[0.5, 0.5, 3.0], target_size=case, crop_size=window,
        augmentations=AugmentPolicy.from_flags(
            AUGMENT_FLAGS, scale_range=0.0, flip_axes=(0, 1, 2)))
    load = transforms.load_fn()
    t0 = time.perf_counter()
    batch = safe_collate([load({**ds[p], "identifier": p}) for p in pids])
    load_s = time.perf_counter() - t0
    loader = [batch] * CROP_STEPS
    tr = make_trainer(0, "bf16", device="cuda")
    loops = {
        # the augment is looked up at each call, so _crop_shapes sees it
        guard: TrainLoop(tr.train_step,
                         augment_fn=lambda g, b: transforms.augment(g, b),
                         device="cuda", max_epochs=1, nan_guard=(
                             NaNGuard(str(WORK_DIR / "nan_dumps"))
                             if guard else None))
        for guard in (False, True)}

    def epoch(guard):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, hist = loops[guard].fit(tr.state, loader)
        torch.cuda.synchronize()
        if not all(abs(v) < float("inf") for v in hist[0].values()):
            raise AssertionError(f"non-finite crop-step metrics {hist}")
        return (time.perf_counter() - t0) / CROP_STEPS

    warmup_s = epoch(False) * CROP_STEPS
    with _crop_shapes() as shapes:
        _reset_counts()
        epoch(False)
        counts = {k: v for k, v in _launch_counts().items()
                  if not k.startswith("flash_")}
    want = {k: v * CROP_STEPS for k, v in _step_want("bf16").items()}
    crop = (len(pids),) + tuple(window) + (1,)
    if counts != want or set(shapes.shapes) != {crop}:
        raise AssertionError(f"crop steps launched {counts}, want {want} "
                             f"(phase 8's step); crops {set(shapes.shapes)}")
    secs = {False: [], True: []}
    for turn in range(GUARD_TURNS):
        for guard in ((False, True) if turn % 2 == 0 else (True, False)):
            secs[guard].append(epoch(guard))
    log(f"[flagship] {smi}: crop step (bf16, B={len(pids)} pos/neg crops "
        f"of {'x'.join(map(str, window))} from "
        f"{'x'.join(map(str, case))}, host batch copy and augmentation "
        f"included), s a step in turns: without the NaN guard "
        f"{', '.join(f'{s:.4f}' for s in secs[False])}; with it "
        f"{', '.join(f'{s:.4f}' for s in secs[True])}; launches a step "
        f"{ {k: v // CROP_STEPS for k, v in counts.items()} }")
    del tr, loops
    return dict(counts=counts, seconds_without_guard=secs[False],
                seconds_with_guard=secs[True], crop_shape=list(crop),
                load_s=load_s, warmup_s=warmup_s)


def _plain_metrics(ckpt, ds, pids, precision):
    """The test CLI's whole-volume forward of the same checkpoint on each
    loaded case, once on the kernels and once on the plain path: the plain
    path's mean Dice and IoU, and the largest difference between the two
    probability maps over all cases."""
    import numpy as np
    import torch

    from adell_mri_torch.config.factories import get_segmentation_network
    from adell_mri_torch.train.checkpoints import CheckpointManager
    from adell_mri_torch.transforms.pipeline import SegmentationTransforms

    mngr = CheckpointManager(str(ckpt), name="segmentation", fold=0)
    meta = mngr.load_metadata()
    t_args = meta["transform_arguments"]
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = get_segmentation_network(
        "unet", meta["network_config"], n_classes=2,
        image_size=t_args["target_size"])
    model.load_state_dict(mngr.load_state_dict())
    model = model.to(device="cuda", dtype=dtype).eval()
    load = SegmentationTransforms(
        image_keys=["image"], label_keys=["mask"],
        target_spacing=t_args["target_spacing"],
        target_size=t_args["target_size"]).load_fn()
    dices, ious, errs, ranges = [], [], [], []
    with torch.inference_mode():
        for pid in pids:
            sample = load({**ds[pid], "identifier": pid})
            x = torch.from_numpy(sample["image"]).to("cuda", dtype)[None]
            got = model(x)[0].float()
            with plain_kernels():
                want = model(x)[0].float()
            if got.shape != want.shape or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError(f"{pid}: kernel forward {got.shape}, "
                                     f"plain {want.shape}, or non-finite")
            errs.append(float((got - want).abs().max()))
            ranges.append((float(want.min()), float(want.max())))
            # binary: one sigmoid channel, thresholded at 0.5 (in numpy
            # here, not through the port's metrics)
            p = want.cpu().numpy()[..., 0] > 0.5
            t = np.asarray(sample["label"]) > 0.5
            inter, union = (p & t).sum(), (p | t).sum()
            dices.append(1.0 if union == 0
                         else float(2 * inter / (p.sum() + t.sum())))
            ious.append(1.0 if union == 0 else float(inter / union))
    return dict(dice=float(np.mean(dices)), iou=float(np.mean(ious)),
                prob_err=max(errs), prob_errs=errs, prob_ranges=ranges)


def phase_flagship_pipeline(smi, case=None, window=None):
    """Phase 14: the flagship U-Net at full width through the whole
    segmentation pipeline on a seeded 6-case cohort at 256x256x64."""
    import logging
    import shutil

    import numpy as np
    import torch

    from adell_mri_torch.data.nifti import read_nifti, reorient_to_ras
    from adell_mri_torch.entrypoints.segmentation.train import get_folds
    from adell_mri_torch.eval.lesion import extract_lesion_candidates
    from adell_mri_torch.tools.flagship import CASE, FLAGSHIP, WINDOW

    case = tuple(case or CASE)
    window = tuple(window or WINDOW)
    work = WORK_DIR / "flagship_pipeline"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pids = [f"case_{i}" for i in range(PIPELINE_CASES)]
    train_pids, val_pids = get_folds(pids, 1, 0)[0]
    # the lesion-free cases train; the validation case has a lesion
    lesion_free = train_pids[:PIPELINE_LESION_FREE]
    t0 = time.perf_counter()
    ds = _pipeline_cohort(work, case, lesion_free)
    cohort_s = time.perf_counter() - t0
    (work / "unet.json").write_text(json.dumps(
        {**FLAGSHIP, "n_channels": 1, "loss_fn": {"dice": {}}}))
    out = {"cohort_s": cohort_s, "val_pids": val_pids,
           "lesion_free": lesion_free}

    t0 = time.perf_counter()
    out["crop_step"] = _crop_step(ds, train_pids[:4], case, window, smi)
    out["crop_step"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    ckpt = work / "ckpt"
    fold = ckpt / "segmentation_fold0"
    metrics_csv = work / "metrics.csv"
    train_args = [
        "segmentation", "train", "--dataset_json", str(work / "ds.json"),
        "--image_keys", "image", "--mask_keys", "mask", "--config_file",
        str(work / "unet.json"), "--pad_size", *map(str, case),
        "--random_crop_size", *map(str, window), "--target_spacing", "0.5",
        "0.5", "3.0", "--batch_size", "4", "--n_folds", "1", "--augment",
        "intensity", "noise", "affine", "flip", "--swa", "--check_nan_loss",
        "--early_stopping", "2", "--sliding_window_val", "--picai_eval",
        "--dev", "cuda", "--seed", "0", "--checkpoint_dir", str(ckpt),
        "--metric_path", str(metrics_csv),
    ]
    with _crop_shapes() as shapes:
        train_s, _, train_counts = _cli(train_args + ["--max_epochs", "2"])
    last = torch.load(fold / "last.pt", map_location="cpu",
                      weights_only=True)
    rows = metrics_csv.read_text().splitlines()
    if (last["epoch"] != 2 or last["ema_params"] is None
            or not any(r.startswith("V_AP,") for r in rows)
            or set(shapes.shapes) != {(4,) + window + (1,)}):
        raise AssertionError(
            f"train: last epoch {last['epoch']}, SWA shadow "
            f"{last['ema_params'] is not None}, crops {set(shapes.shapes)}, "
            f"metric rows {rows[:3]}...")

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    train_logger = logging.getLogger(
        "adell_mri_torch.entrypoints.segmentation.train")
    train_logger.addHandler(handler)
    try:
        resume_s, _, resume_counts = _cli(
            train_args + ["--max_epochs", "3", "--resume_from_last"])
    finally:
        train_logger.removeHandler(handler)
    last = torch.load(fold / "last.pt", map_location="cpu",
                      weights_only=True)
    if ("fold 0: resuming from epoch 2" not in records
            or last["epoch"] != 3):
        raise AssertionError(f"resume: logged {records}, last epoch "
                             f"{last['epoch']} (want 3)")
    torch.cuda.empty_cache()
    out.update(train_s=train_s, resume_s=resume_s,
               train_counts=train_counts, resume_counts=resume_counts,
               resume_log=records)

    test = {}
    for precision in ("f32", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        secs, text, counts = _cli([
            "segmentation", "test", "--dataset_json", str(work / "ds.json"),
            "--checkpoint_dir", str(ckpt), "--dev", "cuda", "--picai_eval",
            "--precision", "32" if precision == "f32" else "bf16",
            "--metric_path", str(work / f"test_{precision}.csv")])
        peak = torch.cuda.max_memory_allocated()
        res = _last_json(text)
        t0 = time.perf_counter()
        plain = _plain_metrics(ckpt, ds, pids, precision)
        plain_s = time.perf_counter() - t0
        dice, iou = plain["dice"], plain["iou"]
        err = max(abs(res["dice"] - dice), abs(res["iou"] - iou))
        tol = TEST_TOL[precision]
        test[precision] = dict(result=res, seconds=secs,
                               seconds_per_case=secs / res["n_cases"],
                               peak_bytes=peak, counts=counts,
                               plain_dice=dice, plain_iou=iou,
                               plain_s=plain_s, max_abs_err=err,
                               prob_max_abs_err=plain["prob_err"],
                               prob_errs=plain["prob_errs"],
                               prob_ranges=plain["prob_ranges"], tol=tol)
        log(f"[flagship] test {precision}: whole-volume probabilities, "
            f"kernels vs plain path, max abs err per case "
            f"{', '.join(f'{e:.3g}' for e in plain['prob_errs'])} (tol "
            f"{tol}); plain range {plain['prob_ranges']}")
        if (res["n_cases"] != PIPELINE_CASES
                or counts["conv3d_igemm"]
                != CONVS_PER_FORWARD * PIPELINE_CASES
                or not plain["prob_err"] <= tol
                or not err <= tol
                or not all(np.isfinite(res[k])
                           for k in ("AP", "auroc", "score"))):
            raise AssertionError(
                f"test {precision}: {res}, plain dice {dice} iou {iou}, "
                f"probabilities max abs err {plain['prob_err']} "
                f"(tolerance {tol}), K1 launches "
                f"{counts['conv3d_igemm']} for {res['n_cases']} cases "
                f"(want {CONVS_PER_FORWARD} a case)")
        torch.cuda.empty_cache()
    out["test"] = test

    served = val_pids + [p for p in pids if p not in val_pids][:1]
    preds = {}
    for kind, extra in (("prob", []), ("lesions", ["--extract_lesions"])):
        secs, _, counts = _cli([
            "segmentation", "predict", "--dataset_json",
            str(work / "ds.json"), "--checkpoint_dir", str(ckpt),
            "--output_path", str(work / f"pred_{kind}"), "--dev", "cuda",
            "--sliding_window_size", *map(str, window), "--prediction_ids",
            *served, *extra])
        preds[kind] = dict(seconds=secs, counts=counts)
    pred_ds = {}
    for pid in served:
        prob_path = work / "pred_prob" / f"{pid}_prob.nii.gz"
        prob = read_nifti(str(prob_path)).data
        cand = read_nifti(str(work / "pred_lesions" / f"{pid}_prob.nii.gz"))
        want = extract_lesion_candidates(prob, threshold="dynamic")[0]
        if not np.array_equal(cand.data, want):
            raise AssertionError(f"{pid}: --extract_lesions map differs "
                                 "from the candidates of the probability "
                                 "map")
        pred_ds[pid] = {**ds[pid], "pred": str(prob_path)}
    (work / "ds_pred.json").write_text(json.dumps(pred_ds))
    tfp_s, text, _ = _cli([
        "segmentation", "test_from_predictions", "--dataset_json",
        str(work / "ds_pred.json"), "--ground_truth_key", "mask",
        "--prediction_key", "pred", "--prediction_mode", "probs",
        "--picai_eval"])
    agg = _last_json(text)
    dices = []
    for pid in served:
        p = reorient_to_ras(read_nifti(pred_ds[pid]["pred"])).data > 0.5
        t = reorient_to_ras(read_nifti(pred_ds[pid]["mask"])).data > 0.5
        denom = p.sum() + t.sum()
        dices.append(1.0 if denom == 0 else 2 * (p & t).sum() / denom)
    if abs(agg["dice"] - float(np.mean(dices))) > 1e-9:
        raise AssertionError(f"test_from_predictions dice {agg['dice']}, "
                             f"numpy {np.mean(dices)}")
    out.update(predict=preds, test_from_predictions=dict(
        seconds=tfp_s, aggregate=agg, numpy_dice=float(np.mean(dices))))

    # one whole-volume forward on the kernels, after a warm-up
    from adell_mri_torch.config.factories import get_segmentation_network
    from adell_mri_torch.train.checkpoints import CheckpointManager

    model = get_segmentation_network("unet", FLAGSHIP, n_classes=2)
    model.load_state_dict(CheckpointManager(
        str(ckpt), name="segmentation", fold=0).load_state_dict())
    model = model.to("cuda").eval()
    x = torch.rand((1,) + case + (1,), device="cuda")
    fwd = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            fwd.append(time.perf_counter() - t0)
    out["test_forward_s"] = fwd[1:]
    del model
    torch.cuda.empty_cache()
    t32, t16 = test["f32"], test["bf16"]
    log(f"[flagship] {smi}: test f32 {t32['seconds_per_case']:.3f} s a case "
        f"(CLI wall / {t32['result']['n_cases']} cases, host load "
        f"included), whole-volume forward "
        f"{', '.join(f'{s:.4f}' for s in fwd[1:])} s, peak memory "
        f"{t32['peak_bytes'] / 1e9:.2f} GB; bf16 "
        f"{t16['seconds_per_case']:.3f} s a case, peak "
        f"{t16['peak_bytes'] / 1e9:.2f} GB")
    log(f"[flagship] {smi}: train (2 epochs) {train_s:.2f} s, resume (epoch "
        f"3) {resume_s:.2f} s, test f32 {t32['seconds']:.2f} s, bf16 "
        f"{t16['seconds']:.2f} s, predict {preds['prob']['seconds']:.2f} "
        f"and {preds['lesions']['seconds']:.2f} s with --extract_lesions, "
        f"test_from_predictions {tfp_s:.2f} s (in process, one build)")
    log(f"[flagship] test f32 {t32['result']} (plain dice "
        f"{t32['plain_dice']:.6f}, iou {t32['plain_iou']:.6f}); bf16 "
        f"{t16['result']} (plain {t16['plain_dice']:.6f}, "
        f"{t16['plain_iou']:.6f}); test_from_predictions {agg}")
    return out


# -- the full augmentation ---------------------------------------------------

# phase 15's per-op checks, the card against the CPU on the same draws: f32
# within 1e-5 of the output's scale (the k-space spike 1e-4 of max|out|),
# bf16 within 2 bf16 ulps of the f32 CPU result cast to bf16, an ulp taken
# at |ref| but no smaller than at 2^-10 of the output's scale (values that
# cancel to near zero keep the f32 error of the scale); nearest-warped
# labels equal except voxels sampled within 1e-4 of a half-integer, at most
# 0.1 % of them
AUG_F32_TOL = 1e-5
AUG_SPIKE_TOL = 1e-4
AUG_BF16_ULPS = 2
AUG_ULP_FLOOR = 2.0 ** -10
LABEL_HALF_TOL = 1e-4
LABEL_FLIP_SHARE = 1e-3
AUG_MAGNITUDES = (0.25, 1.0)
# ten-flag steps after which the loss of one fixed ten-flag batch must have
# fallen, at this learning rate (each step's own batch is drawn afresh, so
# its loss is noisy)
LOSS_STEPS = 6
LOSS_LR = 0.2
# prob-1 calls whose workhorse picks must cover the 27 ops (seed 0 of the
# host generator covers them, the rarest 3 times)
HISTOGRAM_CALLS = 200
# turns of the four- and ten-flag crop steps
FLAG_TURNS = 2


def _bf16_ulps(got, ref, scale):
    """Largest |got - ref| in bf16 ulps of ``ref``, |ref| floored at
    ``AUG_ULP_FLOOR * scale``."""
    import torch

    r = ref.float().abs().clamp_min(AUG_ULP_FLOOR * scale)
    ulp = torch.exp2(torch.floor(torch.log2(r)) - 7)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def _aug_op_cases(x, label):
    """(name, host inputs, function, spike) of every op phase 15 holds on
    the volume ``x`` [*S, 1] and its ``label`` [*S]: the resizes, the
    elastic warp (image, label), the pipeline's Gibbs, bias field, blur and
    low resolution, and each workhorse op at each magnitude. The draws are
    made on the host from a seed; the first input is the volume, except
    for the resizes."""
    import torch

    from adell_mri_torch.models.layers.multi_resolution import resize_volume
    from adell_mri_torch.transforms import augment as A
    from adell_mri_torch.transforms import intensity as I
    from adell_mri_torch.transforms import spatial as S

    case = tuple(x.shape[:-1])
    g = torch.Generator().manual_seed(15)
    grid = torch.randn((3, 4, 4, 4), generator=g) * 2.0
    mat = S.random_affine_matrix(g, case, rotate_range=(0.39, 0.39, 0.2),
                                 shear_range=0.1)
    keep = (torch.rand((8, 8, 8, 1), generator=g) > 0.2).float()

    def warp(vol, m, grd, method="linear"):
        out = S.warp_affine(vol, m, method=method,
                            displacement=S.elastic_displacement(grd, case))
        return out.to(vol.dtype)

    cases = [
        ("resize_cubic", (grid,),
         lambda c: resize_volume(c, (3,) + case, "cubic"), False),
        ("resize_nearest", (keep,),
         lambda k: resize_volume(k, case + (1,), "nearest"), False),
        ("elastic_warp", (x, mat, grid), warp, False),
        ("elastic_warp_label", (label[..., None], mat, grid),
         lambda v, m, grd: warp(v, m, grd, "nearest"), False),
        ("gibbs", (x, torch.tensor(0.55)), I.truncate_kspace, False),
        ("bias_field", (x, torch.randn((4, 4, 4, 1), generator=g) * 0.3),
         I.apply_bias_field, False),
        ("blur", (x, torch.tensor(1.1)), I.gaussian_smooth, False),
        ("lowres", (x, torch.tensor(0.85)), I.low_resolution_at, False),
    ]
    wh = A.AugmentationWorkhorse(ndim=3)
    for name, op in zip(wh.names, wh.ops):
        draws = op.draw(g, x)
        for mag in AUG_MAGNITUDES:
            cases.append((
                f"{name}@{mag}", (x, torch.tensor(mag)) + tuple(draws),
                op.core, name == "spike_noise"))
    return cases


def _label_flips(got, want, mat, grid, case):
    """Voxels where the card's nearest-warped label differs from the
    CPU's, and how many of them are not sampled within LABEL_HALF_TOL of a
    half-integer (coordinates from the CPU)."""
    import torch

    from adell_mri_torch.transforms import spatial as S

    coords = S.affine_coords(mat, case) + S.elastic_displacement(grid, case)
    frac = (coords - torch.floor(coords) - 0.5).abs()
    near = (frac < LABEL_HALF_TOL).any(0)
    diff = (got.cpu() != want)[..., 0]
    return int(diff.sum()), int((diff & ~near).sum())


def _op_ms(fn):
    """``time_ms`` of ``fn``, of one call where five queued calls fill the
    card's launch queue (a warp launches about 150 kernels, and the host
    blocks when the queue is full)."""
    try:
        return time_ms(fn)
    except RuntimeError:
        return time_ms(fn, reps=1)


def _aug_ops_on_card(x, label, smi):
    """Each op of ``_aug_op_cases`` on the card against the CPU, f32 and
    bf16, run under ``set_sync_debug_mode("error")`` (with each op's draw
    on the card and one whole prob-1 ``_augment_one``), then timed. ``x``
    [*S, 1] and ``label`` [*S] are a loaded case of the cohort."""
    import torch

    from adell_mri_torch.transforms import augment as A
    from adell_mri_torch.transforms import pipeline as P

    case = tuple(x.shape[:-1])
    rows, faults = [], []
    for name, args, fn, spike in _aug_op_cases(x, label):
        vol = name not in ("resize_cubic", "resize_nearest")
        for dtype in ((torch.float32, torch.bfloat16) if vol
                      else (torch.float32,)):
            if name == "elastic_warp_label" and dtype != torch.float32:
                continue
            cpu_args = ((args[0].to(dtype),) + args[1:]) if vol else args
            ref = fn(*((cpu_args[0].float(),) + cpu_args[1:]))
            gpu_args = tuple(a.to("cuda") for a in cpu_args)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn(*gpu_args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            scale = max(float(ref.abs().max()), 1e-30)
            row = dict(name=name, dtype=str(dtype).split(".")[-1],
                       shape=list(got.shape),
                       ms=_op_ms(lambda: fn(*gpu_args)))
            if got.dtype != dtype or got.shape != ref.shape:
                faults.append(f"{name} {dtype}: {got.dtype} {got.shape}")
            if name == "elastic_warp_label":
                flips, far = _label_flips(got, ref, args[1], args[2], case)
                row.update(label_flips=flips, flips_far_from_half=far,
                           tol=LABEL_FLIP_SHARE * got.numel())
                if far or flips > row["tol"]:
                    faults.append(f"{name}: {flips} flips, {far} away from "
                                  "a half-integer")
            elif dtype == torch.float32:
                tol = (AUG_SPIKE_TOL if spike else AUG_F32_TOL) * scale
                err = float((got.cpu() - ref).abs().max())
                row.update(max_abs_err=err, tol=tol, scale=scale)
                if not err <= tol:
                    faults.append(f"{name} f32: {err:.3g} > {tol:.3g}")
            else:
                ulps = _bf16_ulps(got.cpu(), ref.to(dtype), scale)
                row.update(max_ulps=ulps, tol=AUG_BF16_ULPS)
                if not ulps <= AUG_BF16_ULPS:
                    faults.append(f"{name} bf16: {ulps:.3g} ulps")
            rows.append(row)
    # the draws on the card and a whole prob-1 sample, also without a sync
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, label = x.to("cuda"), label.to("cuda")
    wh = A.AugmentationWorkhorse(ndim=3)
    policy = P.AugmentPolicy.from_flags(
        P.FLAGS, prob=1.0, distort_prob=1.0, lowres_prob=1.0, blur_prob=1.0,
        scale_range=0.0, flip_axes=(0, 1, 2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for op in wh.ops:
            op.draw(gen, x)
        img, lab, _ = P._augment_one(gen, x, label, policy, wh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool(torch.isfinite(img).all()):
        faults.append("a prob-1 sample is not finite")
    worst32 = max((r for r in rows if "max_abs_err" in r),
                  key=lambda r: r["max_abs_err"] / r["tol"])
    worst16 = max((r for r in rows if "max_ulps" in r),
                  key=lambda r: r["max_ulps"])
    log(f"[augment] {smi}: {len(rows)} op checks at "
        f"{'x'.join(map(str, case))}x1 under set_sync_debug_mode('error'); "
        f"f32 worst {worst32['name']} {worst32['max_abs_err']:.3g} "
        f"(tol {worst32['tol']:.3g}); bf16 worst {worst16['name']} "
        f"{worst16['max_ulps']:.3g} ulps")
    for r in rows:
        log(f"  {r['name']:<24} {r['dtype']:<9} {r['ms']:.4f} ms " + ", ".join(
            f"{k} {r[k]:.3g}" for k in ("max_abs_err", "max_ulps",
                                        "label_flips") if k in r))
    if faults:
        raise AssertionError("augmentation ops on the card: "
                             + "; ".join(faults))
    return rows


def _flag_steps(batch, case, window, precision, smi):
    """The flagship crop step with phase 14's four flags and with all ten,
    in turns, launches counted (the same a step), peak memory read; then
    every parameter's gradient through a ten-flag batch finite and every
    weight's non-zero, and that batch's loss lower after six ten-flag
    steps. (A conv bias that an instance norm follows has a gradient of
    exactly zero in exact arithmetic; only rounding leaves it non-zero, and
    in f32 the stem's one bias has read exactly 0.)"""
    import torch

    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS, make_trainer
    from adell_mri_torch.train.loop import TrainLoop
    from adell_mri_torch.transforms.pipeline import (
        FLAGS,
        AugmentPolicy,
        SegmentationTransforms,
    )

    def transforms(flags):
        return SegmentationTransforms(
            image_keys=["image"], label_keys=["mask"], target_size=case,
            crop_size=window, seed=0, augmentations=AugmentPolicy.from_flags(
                flags, scale_range=0.0, flip_axes=(0, 1, 2)))

    tfs = {"four": transforms(AUGMENT_FLAGS), "ten": transforms(FLAGS)}
    loader = [batch] * CROP_STEPS
    tr = make_trainer(0, precision, device="cuda")
    loops = {n: TrainLoop(tr.train_step, augment_fn=t.augment,
                          device="cuda", max_epochs=1)
             for n, t in tfs.items()}

    def epoch(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, hist = loops[n].fit(tr.state, loader)
        torch.cuda.synchronize()
        if not all(abs(v) < float("inf") for v in hist[0].values()):
            raise AssertionError(f"non-finite {n}-flag metrics {hist}")
        return (time.perf_counter() - t0) / CROP_STEPS

    out = {}
    for n in tfs:
        epoch(n)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        epoch(n)
        counts = {k: v for k, v in _launch_counts().items()
                  if not k.startswith("flash_")}
        out[n] = dict(counts=counts, seconds=[],
                      peak_bytes=torch.cuda.max_memory_allocated())
    want = {k: v * CROP_STEPS for k, v in _step_want(precision).items()}
    if out["ten"]["counts"] != want or out["four"]["counts"] != want:
        raise AssertionError(
            f"{precision} crop steps launched {out['ten']['counts']} (ten "
            f"flags), {out['four']['counts']} (four), want {want}")
    for turn in range(FLAG_TURNS):
        for n in (("four", "ten") if turn % 2 == 0 else ("ten", "four")):
            out[n]["seconds"].append(epoch(n))
    del loops, tr

    # a loss that falls, and the gradients
    tr = make_trainer(1, precision, device="cuda", learning_rate=LOSS_LR)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev_batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()
                 if hasattr(v, "dtype") and v.dtype.kind != "U"}
    names = list(tr.state.params)
    fixed = tfs["ten"].augment(gen, dev_batch)
    loss, _ = tr.loss_and_metrics(tr.state.params, fixed)
    grads = torch.autograd.grad(loss, [tr.state.params[k] for k in names])
    bad = [k for k, gr in zip(names, grads)
           if not bool(torch.isfinite(gr).all())
           or (k.endswith(".weight") and float(gr.abs().max()) == 0)]
    before = float(loss.detach())
    del grads, loss
    losses = []
    for _ in range(LOSS_STEPS):
        tr.state, metrics = tr.train_step(tr.state,
                                          tfs["ten"].augment(gen, dev_batch))
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        after = float(tr.loss_and_metrics(tr.state.params, fixed)[0])
    del tr, fixed
    out.update(losses=losses, fixed_batch_loss=[before, after],
               bad_gradients=bad, n_parameters=len(names))
    if (bad or not all(abs(v) < float("inf") for v in losses + [after])
            or not after < before):
        raise AssertionError(f"{precision} ten-flag steps: losses {losses}, "
                             f"fixed batch {before} -> {after}, non-finite "
                             f"gradients or zero weight gradients {bad}")
    med = {n: statistics.median(out[n]["seconds"]) for n in tfs}
    log(f"[augment] {smi}: crop step ({precision}, B={batch['image'].shape[0]}"
        f" pos/neg crops of {'x'.join(map(str, window))} from "
        f"{'x'.join(map(str, case))}), s a step in turns: four flags "
        f"{', '.join(f'{s:.4f}' for s in out['four']['seconds'])}; ten "
        f"{', '.join(f'{s:.4f}' for s in out['ten']['seconds'])} (median "
        f"{med['ten'] / med['four']:.2f}x); peak "
        f"{out['four']['peak_bytes'] / 1e9:.2f} and "
        f"{out['ten']['peak_bytes'] / 1e9:.2f} GB; launches a step "
        f"{ {k: v // CROP_STEPS for k, v in out['ten']['counts'].items()} }; "
        f"ten-flag losses {', '.join(f'{v:.4f}' for v in losses)}, a fixed "
        f"batch's {before:.5f} -> {after:.5f}; "
        f"{len(names)} gradients finite, every weight's non-zero")
    return out


def _workhorse_histogram(case):
    """HISTOGRAM_CALLS prob-1 samples at ``case`` through
    ``draw_augment`` and ``apply_augment``: the op each picked, and every
    output finite."""
    import torch

    from adell_mri_torch.transforms import augment as A
    from adell_mri_torch.transforms import pipeline as P

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(case + (1,), device="cuda", generator=gen)
    label = (x[..., 0] > 0.7).float()
    wh = A.AugmentationWorkhorse(ndim=3, seed=0)
    policy = P.AugmentPolicy.from_flags(
        P.FLAGS, prob=1.0, distort_prob=1.0, lowres_prob=1.0, blur_prob=1.0,
        scale_range=0.0, flip_axes=(0, 1, 2))
    picks, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HISTOGRAM_CALLS):
        draws = P.draw_augment(gen, x, policy, wh)
        picks.append(draws["trivial"][0][0])
        img, _, _ = P.apply_augment(x, label, policy, draws, wh)
        finite &= torch.isfinite(img).all()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / HISTOGRAM_CALLS
    hist = {name: picks.count(i) for i, name in enumerate(wh.names)}
    if min(hist.values()) == 0 or not bool(finite):
        raise AssertionError(f"workhorse picks {hist}, finite {bool(finite)}")
    log(f"[augment] {HISTOGRAM_CALLS} prob-1 samples at "
        f"{'x'.join(map(str, case))}: {secs:.4f} s a sample; every op "
        f"picked, {min(hist.values())} to {max(hist.values())} times")
    return dict(histogram=hist, seconds_per_sample=secs)


def phase_full_augmentation(smi, case=None, window=None):
    """Phase 15: every augmentation flag on the card, on phase 14's cohort
    and shapes; then ``segmentation train`` with every data key, twice, so
    that the second run reads the disk cache."""
    import logging
    import shutil

    import torch

    from adell_mri_torch.data.loader import safe_collate
    from adell_mri_torch.entrypoints.segmentation.train import get_folds
    from adell_mri_torch.tools.flagship import CASE, WINDOW
    from adell_mri_torch.transforms.pipeline import (
        FLAGS,
        SegmentationTransforms,
    )

    case = tuple(case or CASE)
    window = tuple(window or WINDOW)
    work = WORK_DIR / "flagship_pipeline"
    ds = json.loads((work / "ds.json").read_text())
    pids = sorted(ds)
    load = SegmentationTransforms(
        image_keys=["image"], label_keys=["mask"],
        target_spacing=[0.5, 0.5, 3.0], target_size=case,
        crop_size=window).load_fn()
    train_pids, val_pids = get_folds(pids, 1, 0)[0]
    # the per-op checks on the validation case (it has a lesion)
    sample = load({**ds[val_pids[0]], "identifier": val_pids[0]})
    out = {"ops": _aug_ops_on_card(torch.from_numpy(sample["image"]),
                                   torch.from_numpy(sample["label"]), smi)}
    torch.cuda.empty_cache()

    batch = safe_collate([load({**ds[p], "identifier": p})
                          for p in train_pids[:4]])
    out["steps"] = {p: _flag_steps(batch, case, window, p, smi)
                    for p in ("bf16", "f32")}
    torch.cuda.empty_cache()
    out["workhorse"] = _workhorse_histogram(case)
    torch.cuda.empty_cache()

    cache = work / "cache"
    shutil.rmtree(cache, ignore_errors=True)
    excluded = train_pids[0]
    args = [
        "segmentation", "train", "--dataset_json", str(work / "ds.json"),
        "--image_keys", "image", "--mask_keys", "mask", "--config_file",
        str(work / "unet.json"), "--pad_size", *map(str, case),
        "--random_crop_size", *map(str, window), "--target_spacing", "0.5",
        "0.5", "3.0", "--batch_size", "2", "--augment", *FLAGS,
        "--folds", ",".join(val_pids), "--constant_ratio", "0.5",
        "--excluded_ids_from_training_data", excluded, "--cache_dir",
        str(cache), "--validation_samples_per_epoch", "1", "--max_epochs",
        "2", "--steps_per_epoch", "1", "--dev", "cuda", "--seed", "0",
        "--metric_path", str(work / "metrics_ten.csv"),
    ]
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    train_logger = logging.getLogger(
        "adell_mri_torch.entrypoints.segmentation.train")
    train_logger.addHandler(handler)
    runs = []
    try:
        for run in range(2):
            ckpt = work / f"ckpt_ten_{run}"
            records.clear()
            secs, _, counts = _cli(args + ["--checkpoint_dir", str(ckpt)])
            meta = json.loads(
                (ckpt / "segmentation_fold0" / "metadata.json").read_text())
            cached = [m for m in records if "disk cache" in m]
            runs.append(dict(seconds=secs, counts=counts, cache_log=cached,
                             train_pids=meta["train_pids"],
                             val_pids=meta["val_pids"]))
    finally:
        train_logger.removeHandler(handler)
    first, second = runs
    want_train = [p for p in pids if p not in val_pids and p != excluded]
    if (first["train_pids"] != want_train
            or first["val_pids"] != val_pids
            or second["train_pids"] != want_train
            or not first["cache_log"] or not second["cache_log"]
            or first["cache_log"][0].endswith(" 0 written")
            or not second["cache_log"][0].endswith(" 0 written")
            or " 0 read" in second["cache_log"][0]
            or not first["counts"]["conv3d_igemm"]
            or not first["counts"]["intensity_aug"]):
        raise AssertionError(f"train CLI with the data keys: {runs}, want "
                             f"train {want_train}, val {val_pids}")
    out["train_cli"] = runs
    log(f"[augment] {smi}: train CLI, ten flags, --folds, --constant_ratio, "
        f"--excluded_ids_from_training_data, --cache_dir, "
        f"--validation_samples_per_epoch: {first['seconds']:.2f} s then "
        f"{second['seconds']:.2f} s ({first['cache_log'][0]}; "
        f"{second['cache_log'][0]}); train {first['train_pids']}, val "
        f"{first['val_pids']}")
    return out


# -- phase 16: SWIN-UNet and the flash head-dim repair -----------------------

# the repaired flash dispatch's head dims (zero-padded to 32 and 64) and the
# UNETR served with 32 heads of 16 in place of the yaml's 8 of 64
FLASH_PAD_DIMS = (16, 48)
UNETR_PADDED_HEADS = 32
# SWIN-UNet (sample_configs/unet-swin.yaml) at 128x128x32: the stem 1->32
# (narrow route) and 8 decoder convs (wgmma in bf16, tf32 in f32) a
# forward; a step's dx of the 8 decoder convs, their 8 dW on the wgrad
# kernel in bf16 and the stem's on the patch product (f32: all 9 on it);
# deep supervision adds 4 ds_conv of each
SWIN_CONVS = 9
SWIN_CONVS_NARROW = 1
SWIN_CONVS_DX = 8
SWIN_DS_CONVS = 4
SWIN_TIMED_STEPS = 2
SWIN_CLI_CASES = 4


def _swin_want(precision, ds=False, step=True):
    """Launches of one SWIN-UNet forward (``step=False``) or training step
    in ``precision``, with or without the deep-supervision convs."""
    bf16 = precision == "bf16"
    extra = SWIN_DS_CONVS if ds else 0
    wide = SWIN_CONVS - SWIN_CONVS_NARROW + extra
    dx = (SWIN_CONVS_DX + extra) if step else 0
    want = dict.fromkeys(_launch_counts(), 0)
    want.update(
        conv3d_igemm=SWIN_CONVS + extra,
        conv3d_igemm_wgmma=wide if bf16 else 0,
        conv3d_igemm_tf32=0 if bf16 else wide,
        conv3d_igemm_narrow=SWIN_CONVS_NARROW,
        conv3d_igemm_dx=dx,
        conv3d_igemm_dx_wgmma=dx if bf16 else 0,
        conv3d_igemm_dx_tf32=0 if bf16 else dx,
    )
    if step:
        want.update(
            conv3d_weight_grad=wide if bf16 else 0,
            conv3d_weight_grad_patches=(SWIN_CONVS_NARROW if bf16
                                        else SWIN_CONVS + extra),
            intensity_aug=1)
    return want


def _device_share(fn):
    """(device-busy seconds, wall seconds) of one call of ``fn`` under
    ``torch.profiler``: the kernels' own device time over the host clock
    around the call, which ends in a synchronise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the device's activity alone: with the host's ops traced too, sorting
    # a CLI run's events took seconds a call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # summed over the profiler's raw events: key_averages() builds an event
    # tree in Python first, which took up to 15 s after a CLI run of many
    # kernels for the same sum
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_async()) / 1e9
    return busy, wall


def _flash_repair():
    """Phase 16 (a): ``flash_attention`` at head dims 16 and 48 (the
    kernels' 32 and 64, zero-padded) against the plain versions at the
    unpadded head dim, bf16 and f32, with phase 10's tolerances; the pad
    copy's cost; then UNETR served with head dim 16 on the forward
    kernel."""
    import torch

    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.tools.flagship import (
        CASE,
        make_case,
        make_inference,
        make_model,
    )

    rows = []
    for d in FLASH_PAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            gen = torch.Generator(device="cuda").manual_seed(d)
            q, k, v, g = (torch.randn((1, 8, 2048, d), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(4))
            scale = d ** -0.5
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ka.flash_attention(*leaves)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
            out = out.detach()
            # the plain side is the plain forward and backward at the
            # unpadded head dim, the backward on the plain forward's rows
            # as in phase 10: nothing of it comes from a kernel
            dp = ka.padded_head_dim(d)
            padded = [ka._pad_head(t, dp) for t in (q, k, v)]
            w_out, w_m, w_l = ka.flash_attention_fwd_reference(q, k, v, scale)
            lse, delta = ka.backward_rows(w_out, w_m, w_l, g)
            w_dq = ka.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                       delta, scale)
            w_dk, w_dv = ka.flash_attention_bwd_dkv_reference(
                q, k, v, g, lse, delta, scale)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            rel_f, rel_b = (2.0**-7, 2.0**-7) if bf16 else (2e-5, 1e-4)
            checks = {}
            for n, got, want, rel in (("out", out, w_out, rel_f),
                                      ("dq", dq, w_dq, rel_b),
                                      ("dk", dk, w_dk, rel_b),
                                      ("dv", dv, w_dv, rel_b)):
                if got.shape != want.shape:
                    raise AssertionError(f"D={d} {n}: {tuple(got.shape)}")
                scale_n = max(float(want.float().abs().max()),
                              1.0 if n == "out" else 1e-30)
                checks[n] = (float((got.float() - want.float()).abs().max()),
                             rel * scale_n)
            with torch.no_grad():
                ms = time_ms(lambda: ka.flash_attention(q, k, v))
                kernel_ms = time_ms(lambda: ka.flash_attention_fwd(
                    *padded, scale))
                pad_ms = time_ms(lambda: [ka._pad_head(t, dp)
                                          for t in (q, k, v)])
            row = dict(d=d, padded_d=dp, dtype=name,
                       errs={n: e for n, (e, _) in checks.items()},
                       tols={n: t for n, (_, t) in checks.items()},
                       ms=ms, kernel_ms=kernel_ms, pad_ms=pad_ms)
            rows.append(row)
            log(f"[flash repair] [1,8,2048,{d}] {name} on the D={dp} "
                "kernels: " + ", ".join(
                    f"{n} {e:.3g} (tol {t:.3g})"
                    for n, (e, t) in checks.items())
                + f"; forward {ms:.4f} ms, of it the kernel on padded "
                f"inputs {kernel_ms:.4f} ms; the pad of q, k, v alone "
                f"{pad_ms:.4f} ms")
            if not all(e <= t for e, t in checks.values()):
                raise AssertionError(f"padded flash disagrees: {row}")

    overrides = {"n_heads": UNETR_PADDED_HEADS}
    model = make_model(0, torch.bfloat16, name="unetr", overrides=overrides)
    head_dim = model.TransformerBlockStack_0.block_0.MultiHeadAttention_0
    if head_dim.head_dim != 16:
        raise AssertionError(f"UNETR head dim {head_dim.head_dim}")
    infer = make_inference(model, "unetr")
    case = make_case(1)
    with torch.inference_mode():
        infer(case)
        torch.cuda.synchronize()
        _reset_counts()
        got = infer(case)
        torch.cuda.synchronize()
        launches = _launch_counts()
        with plain_kernels():
            want = infer(case)
    err = float((got - want).abs().max())
    log(f"[flash repair] UNETR (unetr.yaml, {UNETR_PADDED_HEADS} heads of "
        f"16), bf16, one {'x'.join(map(str, CASE))} case: launches "
        f"{launches}; kernels vs "
        f"plain versions: max abs err {err:.3g} (tol 5e-2)")
    if launches["flash_attention_fwd"] != UNETR_BLOCKS:
        raise AssertionError(f"head dim 16: launches {launches}")
    if not err <= 5e-2:
        raise AssertionError(f"UNETR at head dim 16 disagrees: {err}")
    del model, infer
    return dict(rows=rows, unetr=dict(launches=launches, max_abs_err=err,
                                      tol=5e-2))


def _swin_serving(dtype, smi):
    """Phase 16 (b): SWIN-UNet serves the 256x256x64 case (window
    128x128x32, stride 0.5, micro-batch 4), launches counted, seconds a
    case, device share and peak memory, against the plain path."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CASE,
        make_case,
        make_inference,
        make_model,
    )

    bf16 = dtype == torch.bfloat16
    precision = "bf16" if bf16 else "32"
    model = make_model(0, dtype, name="swin")
    infer = make_inference(model, "swin")
    case = make_case(1)
    secs = []
    with torch.inference_mode():
        infer(case)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = infer(case)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            infer(case)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        busy, wall = _device_share(lambda: infer(case))
        with plain_kernels():
            want = infer(case)
        torch.cuda.synchronize()
    per = _swin_want(precision, step=False)
    want_launches = {k: v * WINDOW_BATCHES for k, v in per.items()}
    err = float((out - want).abs().max())
    lo, hi = float(out.min()), float(out.max())
    # as phases 4 and 11: bf16 rounding flips renormalised by the layer and
    # instance norms, within 5e-2; f32 within 1e-3
    tol = 5e-2 if bf16 else 1e-3
    log(f"[swin serving] {smi}: {precision}, "
        f"{'x'.join(map(str, CASE))} case, {WINDOW_BATCHES} window batches: "
        f"launches {launches}; {', '.join(f'{s:.4f}' for s in secs)} s per "
        f"case; device busy {busy:.4f} of {wall:.4f} s "
        f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; kernels vs "
        f"plain path: max abs err {err:.3g} (tol {tol})")
    if launches != want_launches:
        raise AssertionError(f"launches {launches}, want {want_launches}")
    if tuple(out.shape) != CASE + (1,) or not bool(torch.isfinite(out).all()
                                                  ) or lo < 0 or hi > 1:
        raise AssertionError(f"SWIN output {tuple(out.shape)} [{lo}, {hi}]")
    if not err <= tol:
        raise AssertionError(f"SWIN-UNet disagrees with its plain path: {err}")
    del model, infer
    return dict(launches=launches, seconds_per_case=secs, device_busy_s=busy,
                wall_s=wall, peak_memory_gb=peak_gb, max_abs_err=err, tol=tol)


def _swin_conv_classes():
    """The stride-1 3x3x3 conv classes of one SWIN-UNet window batch of 4,
    each kernel against its plain version and timed beside ``F.conv3d`` in
    bf16 and f32 (phase 3's ``compare_conv``)."""
    import torch

    from adell_mri_torch.tools.flagship import WINDOW, make_model

    shapes = {}
    model = make_model(0, torch.bfloat16, name="swin")
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        conv_recorder(shapes))
    try:
        with torch.inference_mode():
            model(torch.rand((4,) + WINDOW + (1,), device="cuda",
                             dtype=torch.bfloat16))
    finally:
        hook.remove()
    del model
    if sum(shapes.values()) != SWIN_CONVS:
        raise AssertionError(f"SWIN forward ran {shapes}")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        log(f"[swin convs] one window batch of 4, {name}")
        rows = []
        for i, ((xs, cout), count) in enumerate(sorted(shapes.items())):
            row = compare_conv(xs[0], xs[1:4], xs[4], cout, dtype,
                               seed=300 + i)
            row["count"] = count
            rows.append(row)
        totals = sum_rows(rows)
        log(f"  per window batch ({totals['convs']} convs, {name}): kernel "
            f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
            f"F.conv3d {totals['library_ms']:.3f} ms, bound "
            f"{totals['bound_ms']:.4f} ms ({totals['bound_by']})")
        out[name] = dict(rows=rows, totals=totals)
    return out


def _swin_conv_backward():
    """Phase 16 (b): dx, dW and dbias of every stride-1 3x3x3 conv shape of
    a SWIN-UNet training step with deep supervision (B=2 at 128x128x32:
    the stem, the 8 decoder convs and the 4 ``ds_conv``), each against
    autograd through its plain version as phase 7 holds the flagship's
    (``conv_backward_errors``), f32 and bf16, with the routes each call
    took read from the counters."""
    import torch

    from adell_mri_torch.ops.kernels.conv import conv_route, wgrad_route
    from adell_mri_torch.tools.flagship import SWIN_BATCH, WINDOW, make_model

    shapes = {}
    model = make_model(0, torch.float32, name="swin",
                       overrides={"deep_supervision": True})
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        conv_recorder(shapes))
    try:
        with torch.inference_mode():
            model(torch.rand((SWIN_BATCH,) + WINDOW + (1,), device="cuda"))
    finally:
        hook.remove()
    del model
    if sum(shapes.values()) != SWIN_CONVS + SWIN_DS_CONVS:
        raise AssertionError(f"SWIN step's convs {shapes}")
    log(f"[swin conv backward vs plain] the step's shapes, B={SWIN_BATCH}")

    def routed(counter, route):
        return {counter: 1, **({} if route == "igemm"
                               else {f"{counter}_{route}": 1})}

    rows = []
    for i, ((xs, cout), count) in enumerate(sorted(shapes.items())):
        cin = xs[4]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            dw_route = wgrad_route(dtype, cin, cout)
            want = {**routed("conv3d_igemm", conv_route(dtype, cin, cout)),
                    **routed("conv3d_igemm_dx", conv_route(dtype, cout, cin)),
                    ("conv3d_weight_grad" if dw_route == "wgmma"
                     else "conv3d_weight_grad_patches"): 1}
            before = _launch_counts()
            _, errs, tols = conv_backward_errors(xs, cout, dtype, 400 + i)
            taken = {k: n - before[k] for k, n in _launch_counts().items()
                     if n != before[k]}
            row = dict(shape=list(xs) + [cout], dtype=name, count=count,
                       dx_route=conv_route(dtype, cout, cin),
                       dw_route=dw_route, launches=taken,
                       errs=dict(zip(("dx", "dw", "db"), errs)),
                       tols=dict(zip(("dx", "dw", "db"), tols)))
            log(f"  {'x'.join(map(str, xs[:4]))} {cin}->{cout} x{count} "
                f"{name} (dx {row['dx_route']}, dW {dw_route}): "
                + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, e, t in
                            zip(("dx", "dw", "db"), errs, tols)))
            if taken != want:
                raise AssertionError(f"routes {taken}, want {want}: {row}")
            if not all(e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"SWIN conv backward disagrees: {row}")
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def _swin_training(smi):
    """Phase 16 (b): SWIN-UNet training steps at B=2 on 128x128x32, the
    yaml's loss, the CLI's augmentation: launches, seconds a step, device
    share and peak memory in bf16 and f32; gradients finite and every
    weight's non-zero; f32 loss and gradient norm against the plain path
    (dropout 0); a falling loss; deep supervision's launches; steps at the
    yaml's dropout 0.1."""
    import torch

    from adell_mri_torch.tools.flagship import (
        SWIN_BATCH,
        WINDOW,
        make_train_batch,
        make_trainer,
    )

    batch = make_train_batch(0, batch=SWIN_BATCH, shape=WINDOW)
    out = {}
    for precision in ("bf16", "32"):
        tr = make_trainer(0, precision, name="swin")
        gen = torch.Generator(device="cuda").manual_seed(0)
        names = list(tr.state.params)
        params = [tr.state.params[k] for k in names]
        loss, _ = tr.loss_and_metrics(tr.state.params,
                                      tr.transforms.augment(gen, batch))
        grads = torch.autograd.grad(loss, params)
        bad = [k for k, gr in zip(names, grads)
               if not bool(torch.isfinite(gr).all())
               or (k.endswith(".weight") and float(gr.abs().max()) == 0)]
        if bad:
            raise AssertionError(f"{precision}: zero or non-finite "
                                 f"gradients {bad}")
        del grads, loss
        parity = None
        if precision == "32":
            loss_k, _ = tr.loss_and_metrics(tr.state.params, batch)
            grads_k = torch.autograd.grad(loss_k, params)
            with plain_kernels():
                loss_p, _ = tr.loss_and_metrics(tr.state.params, batch)
                grads_p = torch.autograd.grad(loss_p, params)
            norm_k, norm_p = _grad_norm(grads_k), _grad_norm(grads_p)
            loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
            parity = dict(loss=loss_k, plain_loss=loss_p,
                          loss_rel=abs(loss_k - loss_p) / abs(loss_p),
                          grad_norm=norm_k, plain_grad_norm=norm_p,
                          grad_norm_rel=abs(norm_k - norm_p) / norm_p)
            del grads_k, grads_p
            log(f"[swin training] f32 step (B={SWIN_BATCH}), kernels vs "
                f"plain path: loss {loss_k:.7f} vs {loss_p:.7f} (rel "
                f"{parity['loss_rel']:.2e}, tol 1e-4), gradient norm "
                f"{norm_k:.6g} vs {norm_p:.6g} (rel "
                f"{parity['grad_norm_rel']:.2e}, tol 1e-3)")
            if not (parity["loss_rel"] <= 1e-4
                    and parity["grad_norm_rel"] <= 1e-3):
                raise AssertionError("f32 SWIN step disagrees with plain")

        def step():
            aug = tr.transforms.augment(gen, batch)
            tr.state, metrics = tr.train_step(tr.state, aug)
            return float(metrics["loss"])

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        secs, losses = [], []
        for _ in range(SWIN_TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, wall = _device_share(step)
        want = {k: v * SWIN_TIMED_STEPS
                for k, v in _swin_want(precision).items()}
        log(f"[swin training] {smi}: {precision}, B={SWIN_BATCH} at "
            f"{'x'.join(map(str, WINDOW))}, augmentation on, dropout 0: "
            f"{', '.join(f'{x:.4f}' for x in secs)} s per step; device busy "
            f"{busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); peak "
            f"{peak_gb:.2f} GB; launches in {SWIN_TIMED_STEPS} steps "
            f"{launches}; losses {losses}; {len(names)} gradients finite, "
            "every weight's non-zero")
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        if not all(abs(x) < float("inf") for x in losses):
            raise AssertionError(f"non-finite loss {losses}")
        out[precision] = dict(seconds_per_step=secs, losses=losses,
                              launches=launches, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall,
                              parity=parity)
        del tr

    tr = make_trainer(0, "bf16", learning_rate=1e-2, name="swin")
    before = float(tr.eval_step(tr.state.params, batch)["loss"])
    for _ in range(10):
        tr.state, _ = tr.train_step(tr.state, batch)
    after = float(tr.eval_step(tr.state.params, batch)["loss"])
    log(f"[swin training] ten steps on one batch (bf16, no augmentation, "
        f"lr 1e-2): loss {before:.5f} -> {after:.5f}")
    if not after < before:
        raise AssertionError(f"loss did not fall: {before} -> {after}")
    out["fixed_batch_loss"] = [before, after]
    del tr

    # both heads on: deep supervision's convs, the class loss
    heads = {"deep_supervision": True, "bottleneck_classification": True}
    for precision in ("bf16", "32"):
        tr = make_trainer(0, precision, name="swin", overrides=heads)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tr.train_step(tr.state, tr.transforms.augment(gen, batch))
        torch.cuda.synchronize()
        _reset_counts()
        tr.state, metrics = tr.train_step(tr.state,
                                          tr.transforms.augment(gen, batch))
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = _swin_want(precision, ds=True)
        log(f"[swin training] {precision} step with --deep_supervision "
            f"--bottleneck_classification: loss {float(metrics['loss']):.5f}"
            f", class loss {float(metrics['loss_class_loss']):.5f}; "
            f"launches {launches}")
        if launches != want:
            raise AssertionError(f"heads launches {launches}, want {want}")
        out[f"heads_{precision}"] = dict(
            launches=launches, loss=float(metrics["loss"]),
            class_loss=float(metrics["loss_class_loss"]))
        del tr

    # the yaml's dropout (0.1): attention and the ADNs drop in training
    for precision in ("bf16", "32"):
        tr = make_trainer(0, precision, name="swin",
                          overrides={"dropout_rate": 0.1})
        gen = torch.Generator(device="cuda").manual_seed(0)
        losses = []
        for _ in range(2):
            tr.state, metrics = tr.train_step(
                tr.state, tr.transforms.augment(gen, batch))
            losses.append(float(metrics["loss"]))
        log(f"[swin training] {precision}, dropout 0.1: losses {losses}")
        if not all(abs(x) < float("inf") for x in losses):
            raise AssertionError(f"dropout 0.1 losses {losses}")
        out[f"dropout_{precision}"] = losses
        del tr
    return out


def _swin_cli(smi):
    """Phase 16 (c): ``segmentation train --segmentation_net_type swin``
    (f32, the yaml, random crops of 128x128x32 from 256x256x64 volumes, 3
    training cases and 1 validation case: one epoch of one step at B=2
    and one whole-volume validation forward), without and with the two
    heads, then
    ``predict`` (sliding window) and ``test`` on each checkpoint, in this
    process so the launches are read around each."""
    import numpy as np

    from adell_mri_torch.data.nifti import read_nifti
    from adell_mri_torch.tools.flagship import CASE, SWIN_YAML, WINDOW

    work = WORK_DIR / "swin_cli"
    work.mkdir(parents=True)
    ds = _pipeline_cohort(work, CASE, (), n_cases=SWIN_CLI_CASES)
    out = {}
    for tag, heads in (("plain", []), ("heads", [
            "--deep_supervision", "--bottleneck_classification"])):
        ckpt = work / f"ckpt_{tag}"
        train_s, _, train_counts = _cli([
            "segmentation", "train", "--segmentation_net_type", "swin",
            "--dataset_json", str(work / "ds.json"), "--image_keys",
            "image", "--mask_keys", "mask", "--config_file", str(SWIN_YAML),
            "--pad_size", *map(str, CASE), "--random_crop_size",
            *map(str, WINDOW), "--target_spacing", "0.5", "0.5", "3.0",
            "--batch_size", "2", "--max_epochs", "1", "--n_folds", "1",
            "--augment", "intensity", "noise",
            "affine", "flip", "--dev", "cuda", "--seed", "0",
            "--checkpoint_dir", str(ckpt), "--metric_path",
            str(work / f"metrics_{tag}.csv"), *heads])
        fold = ckpt / "segmentation_fold0"
        meta = json.loads((fold / "metadata.json").read_text())
        if (meta["net_type"] != "swin"
                or meta["network_config"]["deep_supervision"] != bool(heads)):
            raise AssertionError(f"swin train wrote {meta}")
        pred = work / f"pred_{tag}"
        predict_s, _, predict_counts = _cli([
            "segmentation", "predict", "--dataset_json",
            str(work / "ds.json"), "--checkpoint_dir", str(ckpt),
            "--output_path", str(pred), "--dev", "cuda",
            "--sliding_window_size", *map(str, WINDOW)])
        for pid in ds:
            img = read_nifti(str(pred / f"{pid}_prob.nii.gz")).data
            if (img.shape != CASE or not np.isfinite(img).all()
                    or img.min() < 0 or img.max() > 1):
                raise AssertionError(f"{pid}: {img.shape} [{img.min()}, "
                                     f"{img.max()}]")
        test_s, text, test_counts = _cli([
            "segmentation", "test", "--dataset_json", str(work / "ds.json"),
            "--checkpoint_dir", str(ckpt), "--dev", "cuda",
            "--metric_path", str(work / f"test_{tag}.csv")])
        result = _last_json(text)
        if result["n_cases"] != SWIN_CLI_CASES or not 0 <= result["dice"] <= 1:
            raise AssertionError(f"swin test: {result}")
        # f32: every wide conv on the tf32 route, none on the igemm one
        for name, counts in (("train", train_counts),
                             ("predict", predict_counts),
                             ("test", test_counts)):
            wide = counts["conv3d_igemm"] - counts["conv3d_igemm_narrow"]
            if not counts["conv3d_igemm_tf32"] == wide > 0:
                raise AssertionError(f"{tag} {name} launches {counts}")
        log(f"[swin cli] {smi}: {tag}: train (f32, one step at B=2 and "
            f"one validation case) {train_s:.2f} s, launches {train_counts}"
            f"; predict "
            f"{len(ds)} cases {predict_s:.2f} s ({predict_counts}); test "
            f"{test_s:.2f} s ({test_counts}): {result}")
        # inference runs no head: the same launches as without them
        if tag == "heads" and (predict_counts, test_counts) != (
                out["plain"]["predict_counts"], out["plain"]["test_counts"]):
            raise AssertionError(f"predict or test ran the heads: "
                                 f"{predict_counts}, {test_counts}")
        out[tag] = dict(train_s=train_s, predict_s=predict_s, test_s=test_s,
                        train_counts=train_counts,
                        predict_counts=predict_counts,
                        test_counts=test_counts, test=result)
    return out


def phase_swin(smi):
    """Phase 16: the flash head-dim repair, SWIN-UNet served and trained at
    the yaml's width against the plain path, its conv classes, its
    CLIs."""
    t0 = time.perf_counter()
    import torch

    out = dict(flash=_flash_repair())
    out["serving"] = {"bf16": _swin_serving(torch.bfloat16, smi),
                      "f32": _swin_serving(torch.float32, smi)}
    out["convs"] = _swin_conv_classes()
    out["conv_backward"] = _swin_conv_backward()
    out["training"] = _swin_training(smi)
    out["cli"] = _swin_cli(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"[swin] phase 16: {out['seconds']:.1f} s")
    return out


# -- phase 17: CatNet, the CLI's default classifier -----------------------------

# a prostate crop (tools/flagship.py's WINDOW); the yaml's batch; the
# served micro-batch
CATNET_SHAPE = (128, 128, 32)
CATNET_BATCH = 16
CATNET_SERVE_BATCH = 2
# the stride-1 3x3x3 convs of a CatNet forward: the stem's Conv_1 (32->32
# at 128x128x32) and the 3x3x3 bottleneck convs of stages 2-4 (3 at
# 128->128, 32x32x8; 2 at 256->256, 16x16x4; 2 at 512->512, 8x8x2): the
# wgmma route in bf16, tf32 in f32; a step's 8 dx alike; dW on the wgrad
# kernel in bf16 but for the two 512->512 (Cout > 256: the patch product),
# all 8 on the patch product in f32. The 7^3 stem and stage 1's 5^3 convs
# are F.conv3d.
CATNET_CONVS = 8
CATNET_WGRAD_PATCHES_BF16 = 2
CATNET_CLASSES = (
    ((CATNET_BATCH,) + CATNET_SHAPE + (32,), 32, 1),
    ((CATNET_BATCH, 32, 32, 8, 128), 128, 3),
    ((CATNET_BATCH, 16, 16, 4, 256), 256, 2),
    ((CATNET_BATCH, 8, 8, 2, 512), 512, 2),
)
CATNET_TIMED_STEPS = 2
CATNET_CLI_CASES = 6
CATNET_CLI_BATCH = 2


def _catnet_want(precision, step=True):
    """Launches of one CatNet forward (``step=False``) or training step in
    ``precision``."""
    bf16 = precision == "bf16"
    want = dict.fromkeys(_launch_counts(), 0)
    want.update(conv3d_igemm=CATNET_CONVS,
                conv3d_igemm_wgmma=CATNET_CONVS if bf16 else 0,
                conv3d_igemm_tf32=0 if bf16 else CATNET_CONVS)
    if step:
        want.update(
            conv3d_igemm_dx=CATNET_CONVS,
            conv3d_igemm_dx_wgmma=CATNET_CONVS if bf16 else 0,
            conv3d_igemm_dx_tf32=0 if bf16 else CATNET_CONVS,
            conv3d_weight_grad=(CATNET_CONVS - CATNET_WGRAD_PATCHES_BF16
                                if bf16 else 0),
            conv3d_weight_grad_patches=(CATNET_WGRAD_PATCHES_BF16 if bf16
                                        else CATNET_CONVS),
            intensity_aug=1)
    return want


def _catnet_weights(model, dtype):
    """The model's weights by name, the parameters in ``dtype`` and the
    running statistics f32 (the port's precision policy)."""
    from adell_mri_torch.models.layers.adn import batch_stats

    stats = set(batch_stats(model))
    return {k: v if k in stats else v.to(dtype)
            for k, v in model.state_dict().items()}


def _cudnn_kernels(fn):
    """The device kernels of ``fn()`` that are not the port's own (no
    ``conv3d_`` in the name) and hold "conv", "gemm", "fprop" or "xmma" in
    their names: cuDNN's convolutions and cuBLAS's products, under the
    profiler. A TF32 one carries "tf32" in its name (e.g.
    ``sm80_xmma_fprop_implicit_gemm_tf32f32_...``), an f32 FMA one
    "f32f32" and "ffma"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({
        e.key for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and "conv3d_" not in e.key
        and any(t in e.key.lower() for t in ("conv", "gemm", "fprop",
                                             "xmma"))})


def _cudnn_tf32_reading(forward, logits, feats, stem):
    """The f32 CatNet forward with cuDNN's TF32 on (set on
    ``torch.backends.cudnn.allow_tf32`` and restored after), as a process
    that has not turned it off runs it, against ``logits`` and ``feats``
    (TF32 off): how far the probabilities, the pooled features and the
    output of ``stem()`` (the 7^3 stem conv alone) move, and the names of
    cuDNN's kernels either way. Fails if a kernel named for TF32 runs with
    TF32 off: the f32 checks would not be f32."""
    import torch

    kernels_off = _cudnn_kernels(forward)
    stem_off = stem()
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        kernels_on = _cudnn_kernels(forward)
        on_logits = forward()
        on_feats = forward(return_features=True)
        stem_on = stem()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    if any("tf32" in k.lower() for k in kernels_off):
        raise AssertionError(f"TF32 kernels with TF32 off: {kernels_off}")
    return dict(
        probabilities=float((torch.sigmoid(on_logits)
                             - torch.sigmoid(logits)).abs().max()),
        features=float((on_feats - feats).abs().max())
        / max(float(feats.abs().max()), 1e-30),
        stem=float((stem_on - stem_off).abs().max())
        / max(float(stem_off.abs().max()), 1e-30),
        kernels_off=kernels_off, kernels_on=kernels_on)


def _catnet_serving(smi, tf32_defaults):
    """Phase 17 (a): CatNet in eval, with running statistics from two
    training forwards, on B=2 crops in bf16 and f32: launches (8 K1 a
    forward, by route), seconds a forward, peak memory, sigmoid
    probabilities against the plain path (f32 within 1e-3, bf16 5e-2, as
    phases 4 and 11), with TF32 off for cuDNN and matmuls (phase 3's
    switches); then the f32 forward with cuDNN's TF32 on, the CLI's
    default, for the F.conv3d layers (the 7^3 stem and stage 1's 5^3
    convs), against TF32 off (``_cudnn_tf32_reading``)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        make_catnet_batch,
        make_served_classifier,
    )

    model = make_served_classifier(0)
    x = make_catnet_batch(1, batch=4, shape=CATNET_SHAPE)["image"][
        :CATNET_SERVE_BATCH]
    out = {"tf32_defaults": tf32_defaults}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        precision = "bf16" if bf16 else "32"
        weights = _catnet_weights(model, dtype)

        def forward(**kwargs):
            return torch.func.functional_call(
                model, weights, (x.to(dtype),), kwargs).float()

        secs = []
        with torch.inference_mode():
            forward()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            logits = forward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            feats = forward(return_features=True)
            with plain_kernels():
                plain = forward()
                plain_feats = forward(return_features=True)
            tf32 = None if bf16 else _cudnn_tf32_reading(
                forward, logits, feats,
                lambda: model.ResNetBackbone_0.Conv_0(x.float()))
        probs, want = torch.sigmoid(logits), torch.sigmoid(plain)
        err = float((probs - want).abs().max())
        tol = 5e-2 if bf16 else 1e-3
        # the pooled backbone features too, relative to their scale: a
        # random network's probabilities move little with its input
        feat_err = float((feats - plain_feats).abs().max()) / max(
            float(plain_feats.abs().max()), 1e-30)
        log(f"[catnet serving] {smi}: {precision}, B={CATNET_SERVE_BATCH} "
            f"at {'x'.join(map(str, CATNET_SHAPE))}: launches {launches}; "
            f"{', '.join(f'{s:.4f}' for s in secs)} s a forward; peak "
            f"{peak_gb:.2f} GB; probabilities {probs.flatten().tolist()}, "
            f"kernels vs plain path max abs err {err:.3g} (tol {tol}), "
            f"pooled features {feat_err:.3g} of their scale (tol {tol})"
            + ("" if tf32 is None else
               f"; with cuDNN's TF32 on (the CLI's default {tf32_defaults}) "
               f"the probabilities move {tf32['probabilities']:.3g}, the "
               f"pooled features {tf32['features']:.3g} and the stem "
               f"conv's output {tf32['stem']:.3g} of their scales; "
               f"cuDNN's kernels with TF32 off {tf32['kernels_off']}, on "
               f"{tf32['kernels_on']}"))
        if launches != _catnet_want(precision, step=False):
            raise AssertionError(f"launches {launches}")
        if tuple(logits.shape) != (CATNET_SERVE_BATCH, 1) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"CatNet logits {tuple(logits.shape)}")
        if not (err <= tol and feat_err <= tol):
            raise AssertionError(f"CatNet disagrees with its plain path: "
                                 f"{err}, features {feat_err}")
        out[precision] = dict(launches=launches, seconds=secs,
                              peak_memory_gb=peak_gb, max_abs_err=err,
                              feature_rel_err=feat_err,
                              tol=tol, probabilities=probs.tolist(),
                              cudnn_tf32=tf32)
    del model
    torch.cuda.empty_cache()
    return out


def _catnet_conv_classes(classes=CATNET_CLASSES, seed=500):
    """Phase 17 (b): the stride-1 3x3x3 conv classes of a CatNet step at
    B=16 (or ``classes``: (input shape, Cout, count) each), bf16 and f32:
    the forward (phase 3's ``compare_conv``: error,
    two runs bit-equal on the tf32 route, times beside F.conv3d and the
    bound), dx, dW and dbias against autograd through the plain version
    (phase 7's ``conv_backward_errors``), each call's route read from the
    counters, and dx and dW timed beside cuDNN's and their bounds."""
    import torch

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_igemm_dx,
        conv_route,
        wgrad_route,
    )

    def routed(counter, route):
        return {counter: 1, **({} if route == "igemm"
                               else {f"{counter}_{route}": 1})}

    rows = []
    for i, (xs, cout, count) in enumerate(classes):
        b, spatial, cin = xs[0], xs[1:4], xs[4]
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            row = compare_conv(b, spatial, cin, cout, dtype, seed=seed + i)
            dw_route = wgrad_route(dtype, cin, cout)
            want = {**routed("conv3d_igemm", conv_route(dtype, cin, cout)),
                    **routed("conv3d_igemm_dx", conv_route(dtype, cout, cin)),
                    ("conv3d_weight_grad" if dw_route == "wgmma"
                     else "conv3d_weight_grad_patches"): 1}
            before = _launch_counts()
            (x, w, _, gy), errs, tols = conv_backward_errors(
                xs, cout, dtype, seed + 20 + i)
            taken = {k: n - before[k] for k, n in _launch_counts().items()
                     if n != before[k]}
            if taken != want:
                raise AssertionError(f"routes {taken}, want {want}")
            if not all(e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"CatNet conv backward disagrees: "
                                     f"{errs} {tols}")
            gc, xc = gy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2)
            dx_bound, dx_by = conv_bound(b, spatial, cout, cin, name,
                                         None if dtype == torch.bfloat16
                                         else PEAK_F32_TF32X3)
            row.update(
                count=count, dx_route=conv_route(dtype, cout, cin),
                errs=dict(zip(("dx", "dw", "db"), errs)),
                tols=dict(zip(("dx", "dw", "db"), tols)),
                dx_ms=time_ms(lambda: conv3d_igemm_dx(gy, w)),
                dx_library_ms=time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                        False, [0, 0, 0], 1, [True, False, False])[0]),
                dx_bound_ms=dx_bound, dx_bound_by=dx_by,
                **time_weight_grad(x, gy, w))
            row["dw_bound_ms"], row["dw_bound_by"] = weight_grad_bound(
                b, spatial, cin, cout, name,
                None if dtype == torch.bfloat16 else PEAK_F32_TF32X3)
            log(f"    x{count}: dx ({row['dx_route']}) err "
                f"{errs[0]:.3g} (tol {tols[0]:.3g}) {row['dx_ms']:.4f} ms, "
                f"cuDNN {row['dx_library_ms']:.4f} ms, bound "
                f"{dx_bound:.4f} ms; dbias err {errs[2]:.3g} (tol "
                f"{tols[2]:.3g})")
            log_dw(row)
            rows.append(row)
            del x, w, gy, gc, xc, wc
            torch.cuda.empty_cache()
    return rows


def _stats_errors(got, want):
    """The running statistics ``got`` against ``want`` (by name, each a
    batch norm's ``.mean`` or ``.var``): the largest error as a share of
    its layer's scale (the variance's largest value; for the mean, the
    larger of its largest magnitude and the layer's largest standard
    deviation, the spread its error is made in), the layer it is in, and
    the largest error as a share of each statistic's own largest
    magnitude."""
    worst, where, own = 0.0, None, 0.0
    for k, v in want.items():
        layer = k.rsplit(".", 1)[0]
        var_max = float(want[layer + ".var"].abs().max())
        scale = (var_max if k.endswith(".var")
                 else max(float(v.abs().max()), var_max ** 0.5))
        err = float((got[k] - v).abs().max())
        own = max(own, err / max(float(v.abs().max()), 1e-30))
        if err / scale > worst:
            worst, where = err / scale, k
    return worst, where, own


def _step_batch_stats(tr, batch):
    """Each batch norm's batch statistics in a training forward of the
    step of ``tr`` on ``batch``, on the kernels and on the plain path (f32,
    the step's own forward) and on the plain path in f64 (the reference;
    the members and dropout masks drawn alike on all three). They are
    recovered from the running statistics the forward returns, from a zero
    prior: those are 0.1 x the batch's, rounded once, and ``(new - 0.9
    prior) / 0.1`` in f64 divides no rounding of the prior's share. Per
    layer and statistic, as shares of the layer's scale (the reference's
    largest batch standard deviation for the mean, its largest batch
    variance for the variance): kernels against plain, and each against
    the reference."""
    import torch

    from adell_mri_torch.models.layers.adn import pop_batch_stats
    from adell_mri_torch.models.layers.dropout import seed_dropout

    prior = {k: torch.zeros_like(v) for k, v in tr.state.variables.items()}
    weights = {**tr.state.weights(), **prior}
    runs = {}
    with torch.no_grad():
        for name, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", plain_kernels), ("f64", plain_kernels)):
            seed_dropout(tr.model, torch.Generator(
                device="cuda").manual_seed(9))
            with ctx():
                if name == "f64":
                    tr.model.train()
                    torch.func.functional_call(
                        tr.model, {k: v.double() for k, v in weights.items()},
                        (batch["image"].double(),))
                    runs[name] = pop_batch_stats(tr.model)
                else:
                    runs[name] = tr.loss_and_metrics(
                        weights, batch)[1]["_variables"]

    def recovered(name, k):
        return (runs[name][k].double() - 0.9 * prior[k].double()) / (1 - 0.9)

    rows = []
    for k in runs["f64"]:
        if not k.endswith(".mean"):
            continue
        layer = k[: -len(".mean")]
        var = recovered("f64", layer + ".var")
        scale = dict(mean=float(var.max()) ** 0.5, var=float(var.max()))
        row = dict(layer=layer)
        for stat in ("mean", "var"):
            got = {n: recovered(n, f"{layer}.{stat}")
                   for n in ("kernels", "plain", "f64")}
            row[stat] = {
                f"{a}_{b}": float((got[a] - got[b]).abs().max())
                / scale[stat]
                for a, b in (("kernels", "plain"), ("kernels", "f64"),
                             ("plain", "f64"))}
        rows.append(row)
    return rows


def _catnet_intensity(images):
    """K3 against its plain version (``_k3_against_plain``) at the shapes
    CatNet's paths give it, the step's B=16 and the CLI's B=2 at
    128x128x32, in f32 (the main path's) and bf16, with the classification
    policy's ranges: gamma drawn in its range, a shift of up to 0.1 of
    each sample's standard deviation, sigma 0 or the policy's noise."""
    import torch

    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS
    from adell_mri_torch.transforms.pipeline import AugmentPolicy

    policy = AugmentPolicy.classification(AUGMENT_FLAGS, CATNET_SHAPE)
    dev = images.device
    g = torch.Generator(device=dev).manual_seed(11)
    seed = torch.tensor([4321], dtype=torch.int64, device=dev)
    out = {}
    for b in (CATNET_BATCH, CATNET_CLI_BATCH):
        x32 = images[:b].contiguous()
        red = tuple(range(1, x32.dim()))
        u = torch.rand((3, b), generator=g, device=dev)
        lo_g, hi_g = policy.gamma_range
        gamma = lo_g + (hi_g - lo_g) * u[0]
        scale = 1.0 + policy.scale_delta * (2 * u[1] - 1)
        shift = (policy.shift_delta * (2 * u[2] - 1)
                 * x32.std(dim=red, correction=0))
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            lo, hi = x.float().amin(dim=red), x.float().amax(dim=red)

            def par_for(sigma):
                return torch.stack(
                    [lo, hi, gamma, scale, shift,
                     torch.full((b,), sigma, device=dev)], dim=1
                ).contiguous()

            name = (f"{str(dtype).split('.')[1]} "
                    f"[{b},{','.join(map(str, CATNET_SHAPE))},1]")
            _, tol, err, moments = _k3_against_plain(
                name, x, par_for(0.0), par_for(policy.noise_std), seed)
            out[name] = dict(max_abs_err=err, tol=tol, moments=moments)
    return out


def _catnet_training(smi):
    """Phase 17 (c): K3 against its plain version at the step's and the
    CLI's shapes (``_catnet_intensity``); CatNet training steps at B=16 on
    128x128x32 in bf16 and f32: the f32 loss, gradient norm and running
    statistics against the plain path (1e-4, 1e-3, 1e-5 of the layer's
    running scale; the members and dropout masks drawn alike on both),
    and each batch norm's batch statistics (``_step_batch_stats``: the
    kernels against the plain path within 1e-5 of the layer's scale
    beyond the plain path's own distance from the f64 reference), launches
    by route, seconds a step with the augmentation, device share and peak
    memory; ten bf16 steps on one batch with a falling loss."""
    import torch

    from adell_mri_torch.tools.flagship import (
        AUGMENT_FLAGS,
        make_catnet_batch,
        make_catnet_trainer,
    )

    batch = make_catnet_batch(2, batch=CATNET_BATCH, shape=CATNET_SHAPE)
    out = dict(intensity=_catnet_intensity(batch["image"]))
    for precision in ("bf16", "32"):
        tr = make_catnet_trainer(0, precision)
        parity = (_step_parity(tr, batch, "catnet")
                  if precision == "32" else None)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            aug = tr.transforms.augment(gen, batch)
            tr.state, metrics = tr.train_step(tr.state, aug)
            return float(metrics["loss"])

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        secs, losses = [], []
        for _ in range(CATNET_TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, wall = _device_share(step)
        want = {k: v * CATNET_TIMED_STEPS
                for k, v in _catnet_want(precision).items()}
        log(f"[catnet training] {smi}: {precision}, B={CATNET_BATCH} at "
            f"{'x'.join(map(str, CATNET_SHAPE))}, augmentation "
            f"{' '.join(AUGMENT_FLAGS)}: "
            f"{', '.join(f'{x:.4f}' for x in secs)} s per step; device busy "
            f"{busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); peak "
            f"{peak_gb:.2f} GB; launches in {CATNET_TIMED_STEPS} steps "
            f"{launches}; losses {losses}")
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        if not all(abs(x) < float("inf") for x in losses):
            raise AssertionError(f"non-finite loss {losses}")
        out[precision] = dict(seconds_per_step=secs, losses=losses,
                              launches=launches, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall,
                              parity=parity)
        del tr
        torch.cuda.empty_cache()

    tr = make_catnet_trainer(0, "bf16", learning_rate=1e-2)
    losses = []
    for _ in range(10):
        tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))
    log(f"[catnet training] ten steps on one batch (bf16, no augmentation, "
        f"lr 1e-2): losses {', '.join(f'{x:.5f}' for x in losses)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    out["fixed_batch_losses"] = losses
    del tr
    torch.cuda.empty_cache()
    return out


def _catnet_cli(smi):
    """Phase 17 (d): ``classification train`` (f32, the yaml, 5 training
    cases at B=2 for 2 epochs and 1 validation case), then ``test`` and
    ``predict`` on its checkpoint, on 6 cases at 128x128x32 (3 with
    bright ellipsoids, label 1), in this process so the launches are read
    around each."""
    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS, CATNET_YAML

    work = WORK_DIR / "catnet_cli"
    work.mkdir(parents=True)
    negatives = ("case_1", "case_3", "case_5")
    ds = _pipeline_cohort(work, CATNET_SHAPE, negatives,
                          n_cases=CATNET_CLI_CASES)
    for pid, entry in ds.items():
        entry["label"] = int(pid not in negatives)
    (work / "ds.json").write_text(json.dumps(ds))
    ckpt = work / "ckpt"
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda",
              "--checkpoint_dir", str(ckpt)]
    train_s, _, train_counts = _cli([
        "classification", "train", *common, "--image_keys", "image",
        "--config_file", str(CATNET_YAML),
        "--pad_size", *map(str, CATNET_SHAPE),
        "--target_spacing", "0.5", "0.5", "3.0",
        "--batch_size", str(CATNET_CLI_BATCH),
        "--max_epochs", "2", "--n_folds", "1", "--augment", *AUGMENT_FLAGS,
        "--seed", "0", "--metric_path", str(work / "metrics.csv")])
    meta = json.loads((ckpt / "classification_fold0" /
                       "metadata.json").read_text())
    if meta["net_type"] != "cat" or meta["network_config"][
            "batch_ensemble"] != 4:
        raise AssertionError(f"classification train wrote {meta}")
    test_s, text, test_counts = _cli([
        "classification", "test", *common,
        "--metric_path", str(work / "test.csv")])
    result = _last_json(text)
    if result["n_cases"] != CATNET_CLI_CASES or not 0 <= result["auc"] <= 1:
        raise AssertionError(f"classification test: {result}")
    pred = work / "pred.json"
    predict_s, _, predict_counts = _cli([
        "classification", "predict", *common, "--output_path", str(pred)])
    probs = json.loads(pred.read_text())
    if sorted(probs) != sorted(ds) or not all(
            0 <= p <= 1 for p in probs.values()):
        raise AssertionError(f"classification predict: {probs}")
    # f32: every K1 on the tf32 route; the training steps augment (K3)
    for name, counts in (("train", train_counts), ("test", test_counts),
                         ("predict", predict_counts)):
        if not counts["conv3d_igemm_tf32"] == counts["conv3d_igemm"] > 0:
            raise AssertionError(f"{name} launches {counts}")
    if not (train_counts["intensity_aug"] > 0
            and test_counts["conv3d_igemm"]
            == CATNET_CONVS * CATNET_CLI_CASES
            == predict_counts["conv3d_igemm"]):
        raise AssertionError(f"launches {train_counts} {test_counts} "
                             f"{predict_counts}")
    log(f"[catnet cli] {smi}: train (f32, 2 epochs of 2 steps at B=2 and "
        f"one validation case) {train_s:.2f} s, launches {train_counts}; "
        f"test {test_s:.2f} s ({test_counts}): {result}; predict "
        f"{len(probs)} cases {predict_s:.2f} s ({predict_counts}): {probs}")
    return dict(train_s=train_s, test_s=test_s, predict_s=predict_s,
                train_counts=train_counts, test_counts=test_counts,
                predict_counts=predict_counts, test=result,
                predictions=probs)


def phase_catnet(smi, tf32_defaults):
    """Phase 17: CatNet (``classification-cat-resnet.yaml``) served and
    trained at the yaml's width and depth against the plain path, its K1
    classes at B=16, its CLIs."""
    t0 = time.perf_counter()
    out = dict(serving=_catnet_serving(smi, tf32_defaults))
    out["convs"] = _catnet_conv_classes()
    out["training"] = _catnet_training(smi)
    out["cli"] = _catnet_cli(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"[catnet] phase 17: {out['seconds']:.1f} s")
    return out


# -- phase 18: the U-Net's option space ---------------------------------------

RESNET_TIMED_STEPS = 2
RESNET_CLI_CASES = 4
# the other conv and link types at a small depth, on the flagship's keys;
# the ADN's other norms, prelu and uout ride along
OPTION_DEPTH = dict(depth=[16, 32, 64], kernel_sizes=[3, 3, 3],
                    strides=[2, 2, 2])
OPTION_VARIANTS = {
    "sae_prelu": dict(conv_type="sae", activation_fn="prelu"),
    "depthwise_uout": dict(conv_type="depthwise", dropout_type="uout",
                           dropout_param=0.1),
    "convnext_group": dict(conv_type="convnext", norm_type="group"),
    "convnextv2_layer": dict(conv_type="convnextv2", norm_type="layer"),
    "asp_instance_affine": dict(conv_type="asp",
                                norm_type="instance_affine"),
    "link_conv": dict(link_type="conv"),
    "link_attention_upsample": dict(link_type="attention",
                                    upscale_type="upsample",
                                    interpolation="nearest"),
}
# the CLI's U-Net defaults: a yaml without the two keys builds identity
# links and an upsampling decoder (config/factories.py)
CLI_DEFAULTS = {"link_type": "identity", "upscale_type": "upsample"}


class _k1_calls:
    """Within the block every stride-1 SAME 3x3x3 undilated conv (K1's
    class) that a forward runs is recorded as (input shape, Cout, whether its input
    takes a gradient: the step then launches its dx); ``kinds`` holds
    each call's (input dtype, whether autograd records it: a training
    step's)."""

    def __enter__(self):
        import torch

        import adell_mri_torch.ops.conv as conv_mod

        self.calls, self.kinds = [], []

        def record(module, inputs):
            # a depthwise conv of one channel is an ordinary conv: K1's
            # gate takes it as ops/conv.py:conv3d takes every conv
            if not (isinstance(module, conv_mod.Conv3d) or (
                    isinstance(module, conv_mod.DwConv)
                    and module.weight.shape[-1] == 1)):
                return
            w = module.weight
            if (tuple(w.shape[:3]) == (3, 3, 3)
                    and module.strides == (1, 1, 1)
                    and module.padding == "SAME"
                    and getattr(module, "dilation", (1, 1, 1)) == (1, 1, 1)
                    and getattr(module, "groups", 1) == 1):
                self.calls.append((tuple(inputs[0].shape), int(w.shape[-1]),
                                   bool(inputs[0].requires_grad)))
                self.kinds.append((inputs[0].dtype, torch.is_grad_enabled()))

        self.hook = torch.nn.modules.module.register_module_forward_pre_hook(
            record)
        return self

    def __exit__(self, *exc):
        self.hook.remove()
        return False


def _calls_want(calls, dtype, step):
    """The launches ``calls`` (``_k1_calls``) make in ``dtype``: K1 by
    ``conv_route``; in a step also its dx where the input takes a
    gradient, dW on ``wgrad_route`` and one K3."""
    from adell_mri_torch.ops.kernels.conv import conv_route, wgrad_route

    want = dict.fromkeys(_launch_counts(), 0)

    def add(counter, route):
        want[counter] += 1
        if route != "igemm":
            want[f"{counter}_{route}"] += 1

    for xs, cout, needs_dx in calls:
        cin = xs[-1]
        add("conv3d_igemm", conv_route(dtype, cin, cout))
        if step:
            if needs_dx:
                add("conv3d_igemm_dx", conv_route(dtype, cout, cin))
            want["conv3d_weight_grad" if wgrad_route(dtype, cin, cout)
                 == "wgmma" else "conv3d_weight_grad_patches"] += 1
    if step:
        want["intensity_aug"] = 1
    return want


def _recorded_want(rec):
    """The launches the calls ``rec`` (``_k1_calls``) recorded make, each
    on its own dtype's routes: those autograd recorded as a training
    step's (K1, dx where the input takes a gradient, dW; ``intensity_aug``
    then 1, not a count of steps), the others as forwards alone."""
    want = dict.fromkeys(_launch_counts(), 0)
    groups = {}
    for call, kind in zip(rec.calls, rec.kinds):
        groups.setdefault(kind, []).append(call)
    for (dtype, step), calls in groups.items():
        for k, v in _calls_want(calls, dtype, step).items():
            want[k] = max(want[k], v) if k == "intensity_aug" else want[k] + v
    return want


def _scaled(want, n):
    return {k: v * n for k, v in want.items()}


def _option_serving(smi, dtype, name="unet", overrides=None, tag="resnet",
                    model=None):
    """The 256x256x64 case served as phase 4 serves it (window 128x128x32,
    stride 0.5, micro-batch 4: 7 window batches) with the U-Net ``name``
    and ``overrides`` (or ``model``): launches against those of one window
    batch times 7, seconds a case, device share and peak memory; the same
    case through the plain path within 5e-2 (bf16) or 1e-3 (f32)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CASE,
        WINDOW,
        make_case,
        make_inference,
        make_model,
    )

    bf16 = dtype == torch.bfloat16
    precision = "bf16" if bf16 else "32"
    model = model if model is not None else make_model(
        0, dtype, name=name, overrides=overrides)
    infer = make_inference(model, name)
    case = make_case(1)
    with torch.inference_mode(), _k1_calls() as rec:
        model(torch.zeros((4,) + WINDOW + (1,), device="cuda", dtype=dtype),
              heads=False)
    want = _scaled(_calls_want(rec.calls, dtype, step=False), WINDOW_BATCHES)
    secs = []
    with torch.inference_mode():
        infer(case)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = infer(case)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, wall = _device_share(lambda: infer(case))
        with plain_kernels():
            plain = infer(case)
        torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    lo, hi = float(out.min()), float(out.max())
    tol = 5e-2 if bf16 else 1e-3
    log(f"[options serving] {smi}: {tag}, {precision}: "
        f"{len(rec.calls)} K1 convs a window batch; launches {launches}; "
        f"{', '.join(f'{s:.4f}' for s in secs)} s per case; device busy "
        f"{busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); peak "
        f"{peak_gb:.2f} GB; kernels vs plain path: max abs err {err:.3g} "
        f"(tol {tol})")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    if tuple(out.shape) != CASE + (1,) or not bool(
            torch.isfinite(out).all()) or lo < 0 or hi > 1:
        raise AssertionError(f"{tag} output {tuple(out.shape)} [{lo}, {hi}]")
    if not err <= tol:
        raise AssertionError(f"{tag} disagrees with its plain path: {err}")
    del model, infer
    torch.cuda.empty_cache()
    return dict(launches=launches, convs_per_window_batch=len(rec.calls),
                seconds_per_case=secs, device_busy_s=busy, wall_s=wall,
                peak_memory_gb=peak_gb, max_abs_err=err, tol=tol)


def _seeded(tr, seed=0):
    """The trainer's model's dropout and uout layers handed a generator
    seeded with ``seed``: two calls draw the same masks."""
    import torch

    from adell_mri_torch.models.layers.dropout import seed_dropout

    seed_dropout(tr.model, torch.Generator(device="cuda").manual_seed(seed))


def _option_step(tr, batch, gen, precision, tag, n=1, extra=None):
    """``n`` training steps (the CLI's augmentation) counted from 0 against
    the launches the recorded K1 calls of the step make, and ``extra``
    launches a step (the attention kernels'); seconds each."""
    import torch

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    with _k1_calls() as rec:
        tr.state, _ = tr.train_step(tr.state, tr.transforms.augment(
            gen, batch))
    torch.cuda.synchronize()
    want = _calls_want(rec.calls, dtype, step=True)
    for k, v in (extra or {}).items():
        want[k] += v
    want = _scaled(want, n)
    _reset_counts()
    secs, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.state, metrics = tr.train_step(tr.state, tr.transforms.augment(
            gen, batch))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _launch_counts()
    if launches != want:
        raise AssertionError(f"{tag} step launches {launches}, want {want}")
    if not all(abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    return dict(launches=launches, k1_convs=len(rec.calls),
                dx=sum(c[2] for c in rec.calls), seconds_per_step=secs,
                losses=losses)


def _resnet_conv_classes():
    """The resnet U-Net's K1 classes: each class of a served window batch
    (B=4) against its plain version in bf16 and f32 (phase 3's
    ``compare_conv``: the route from the counters, the tf32 and the narrow
    bf16 convs bit-equal over two runs), and dx, dW and dbias of each
    class of a B=2 training step against autograd through the plain
    version (phase 7's tolerances; dx bit-equal over two runs on the tf32
    and narrow routes), each call's routes read from the counters."""
    import torch

    from adell_mri_torch.ops.kernels.conv import (
        conv3d_igemm_train,
        conv_route,
        wgrad_route,
    )
    from adell_mri_torch.tools.flagship import (
        RESNET_BATCH,
        WINDOW,
        make_model,
    )

    model = make_model(0, torch.float32, name="resnet")
    with torch.inference_mode(), _k1_calls() as rec:
        model(torch.zeros((4,) + WINDOW + (1,), device="cuda"))
    serve = {}
    for xs, cout, _ in rec.calls:
        serve[(xs, cout)] = serve.get((xs, cout), 0) + 1
    model.train()
    with _k1_calls() as rec:
        model(torch.rand((RESNET_BATCH,) + WINDOW + (1,), device="cuda"))
    step = {}
    for xs, cout, _ in rec.calls:
        step[(xs, cout)] = step.get((xs, cout), 0) + 1
    del model
    torch.cuda.empty_cache()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        log(f"[resnet convs] one window batch of 4, {name}")
        rows = []
        for i, ((xs, cout), count) in enumerate(sorted(serve.items())):
            row = compare_conv(xs[0], xs[1:4], xs[4], cout, dtype,
                               seed=500 + i)
            row["count"] = count
            rows.append(row)
        totals = sum_rows(rows)
        log(f"  per window batch ({totals['convs']} convs, {name}): kernel "
            f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
            f"F.conv3d {totals['library_ms']:.3f} ms, bound "
            f"{totals['bound_ms']:.4f} ms ({totals['bound_by']})")
        out[name] = dict(rows=rows, totals=totals)
    log(f"[resnet conv backward vs plain] the step's classes, "
        f"B={RESNET_BATCH}")

    def routed(counter, route):
        return {counter: 1, **({} if route == "igemm"
                               else {f"{counter}_{route}": 1})}

    bwd = []
    for i, ((xs, cout), count) in enumerate(sorted(step.items())):
        cin = xs[4]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            dx_route = conv_route(dtype, cout, cin)
            dw_route = wgrad_route(dtype, cin, cout)
            want = {**routed("conv3d_igemm", conv_route(dtype, cin, cout)),
                    **routed("conv3d_igemm_dx", dx_route),
                    ("conv3d_weight_grad" if dw_route == "wgmma"
                     else "conv3d_weight_grad_patches"): 1}
            before = _launch_counts()
            inputs, errs, tols = conv_backward_errors(xs, cout, dtype,
                                                      600 + i)
            taken = {k: n - before[k] for k, n in _launch_counts().items()
                     if n != before[k]}
            x, w, bias, gy = inputs
            twice = []
            for _ in range(2):
                leaf = x.clone().requires_grad_()
                twice.append(torch.autograd.grad(
                    conv3d_igemm_train(leaf, w, bias), leaf, gy)[0])
            same = torch.equal(*twice)
            row = dict(shape=list(xs) + [cout], dtype=name, count=count,
                       dx_route=dx_route, dw_route=dw_route,
                       launches=taken, dx_bit_equal=same,
                       errs=dict(zip(("dx", "dw", "db"), errs)),
                       tols=dict(zip(("dx", "dw", "db"), tols)))
            log(f"  {'x'.join(map(str, xs[:4]))} {cin}->{cout} x{count} "
                f"{name} (dx {dx_route}, dW {dw_route}): "
                + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, e, t in
                            zip(("dx", "dw", "db"), errs, tols))
                + f"; dx bit-equal over two runs: {same}")
            if taken != want:
                raise AssertionError(f"routes {taken}, want {want}: {row}")
            if not all(e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"resnet conv backward disagrees: {row}")
            if not same and (dx_route == "tf32" or (
                    dx_route == "narrow" and dtype == torch.bfloat16)):
                raise AssertionError(f"dx differs between two runs: {row}")
            bwd.append(row)
            del inputs, twice
    torch.cuda.empty_cache()
    out["backward"] = bwd
    return out


def _resnet_training(smi):
    """``u-net-3d-resnet.yaml`` trained at its B=2 on 128x128x32 with its
    dropout (0.15) and loss, the CLI's augmentation, bf16 and f32: a
    warm-up step, then 2 steps with the launches counted from 0 (K1, dx,
    dW and K3 as the recorded K1 calls of a step make them), seconds a
    step, device share and peak memory; every gradient finite and every
    weight's non-zero; the f32 loss and gradient norm against the plain
    path with the same dropout draws; ten bf16 steps on one batch without
    augmentation lower the loss."""
    import torch

    from adell_mri_torch.tools.flagship import (
        RESNET_BATCH,
        WINDOW,
        make_train_batch,
        make_trainer,
    )

    batch = make_train_batch(0, batch=RESNET_BATCH, shape=WINDOW)
    out = {}
    for precision in ("bf16", "32"):
        tr = make_trainer(0, precision, name="resnet")
        _seeded(tr)
        gen = torch.Generator(device="cuda").manual_seed(0)
        names = list(tr.state.params)
        loss, _ = tr.loss_and_metrics(tr.state.params,
                                      tr.transforms.augment(gen, batch))
        grads = torch.autograd.grad(loss, [tr.state.params[k]
                                           for k in names])
        bad = [k for k, gr in zip(names, grads)
               if not bool(torch.isfinite(gr).all())
               or (k.endswith(".weight") and float(gr.abs().max()) == 0)]
        if bad:
            raise AssertionError(f"{precision}: zero or non-finite "
                                 f"gradients {bad}")
        del grads, loss
        parity = (_step_parity(tr, batch, "resnet")
                  if precision == "32" else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = _option_step(tr, batch, gen, precision, "resnet",
                             n=RESNET_TIMED_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def step():
            tr.state, _ = tr.train_step(tr.state, tr.transforms.augment(
                gen, batch))

        busy, wall = _device_share(step)
        log(f"[resnet training] {smi}: {precision}, B={RESNET_BATCH} at "
            f"{'x'.join(map(str, WINDOW))}, augmentation on, dropout 0.15: "
            f"{', '.join(f'{x:.4f}' for x in steps['seconds_per_step'])} s "
            f"per step; device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; "
            f"{steps['k1_convs']} K1 and {steps['dx']} dx a step; launches "
            f"in {RESNET_TIMED_STEPS} steps {steps['launches']}; losses "
            f"{steps['losses']}; {len(names)} gradients finite, every "
            "weight's non-zero")
        out[precision] = dict(steps, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall, parity=parity)
        del tr
        torch.cuda.empty_cache()
    tr = make_trainer(0, "bf16", learning_rate=1e-2, name="resnet",
                      overrides={"dropout_param": 0.0})
    before = float(tr.eval_step(tr.state.params, batch)["loss"])
    for _ in range(10):
        tr.state, _ = tr.train_step(tr.state, batch)
    after = float(tr.eval_step(tr.state.params, batch)["loss"])
    log(f"[resnet training] ten steps on one batch (bf16, no augmentation, "
        f"dropout 0, lr 1e-2): loss {before:.5f} -> {after:.5f}")
    if not after < before:
        raise AssertionError(f"loss did not fall: {before} -> {after}")
    out["fixed_batch_loss"] = [before, after]
    del tr
    torch.cuda.empty_cache()
    return out


def _resnet_cli(smi):
    """``segmentation train`` with ``u-net-3d-resnet.yaml`` as it stands
    (f32, random crops of 128x128x32 from 256x256x64 volumes, B=2, one
    epoch, the CLI's augmentation), then ``predict`` (sliding window),
    ``test_from_predictions`` on its files and ``test`` on its
    checkpoint, on 4 cases, in this process so the launches are read
    around each; ``test`` again with ``--precision bf16``."""
    import numpy as np

    from adell_mri_torch.data.nifti import read_nifti
    from adell_mri_torch.tools.flagship import (
        AUGMENT_FLAGS,
        CASE,
        RESNET_YAML,
        WINDOW,
    )

    work = WORK_DIR / "resnet_cli"
    work.mkdir(parents=True)
    ds = _pipeline_cohort(work, CASE, (), n_cases=RESNET_CLI_CASES)
    ckpt = work / "ckpt"
    train_s, _, train_counts = _cli([
        "segmentation", "train", "--dataset_json", str(work / "ds.json"),
        "--image_keys", "image", "--mask_keys", "mask", "--config_file",
        str(RESNET_YAML), "--pad_size", *map(str, CASE),
        "--random_crop_size", *map(str, WINDOW), "--target_spacing", "0.5",
        "0.5", "3.0", "--batch_size", "2", "--max_epochs", "1",
        "--n_folds", "1", "--augment",
        *AUGMENT_FLAGS, "--dev", "cuda", "--seed", "0", "--checkpoint_dir",
        str(ckpt), "--metric_path", str(work / "metrics.csv")])
    meta = json.loads((ckpt / "segmentation_fold0" /
                       "metadata.json").read_text())
    if meta["network_config"]["conv_type"] != "resnet":
        raise AssertionError(f"train wrote {meta}")
    pred = work / "pred"
    predict_s, _, predict_counts = _cli([
        "segmentation", "predict", "--dataset_json", str(work / "ds.json"),
        "--checkpoint_dir", str(ckpt), "--output_path", str(pred), "--dev",
        "cuda", "--sliding_window_size", *map(str, WINDOW)])
    for pid in ds:
        img = read_nifti(str(pred / f"{pid}_prob.nii.gz")).data
        if (img.shape != CASE or not np.isfinite(img).all()
                or img.min() < 0 or img.max() > 1):
            raise AssertionError(f"{pid}: {img.shape} [{img.min()}, "
                                 f"{img.max()}]")
    pred_ds = {pid: {**entry, "pred": str(pred / f"{pid}_prob.nii.gz")}
               for pid, entry in ds.items()}
    (work / "ds_pred.json").write_text(json.dumps(pred_ds))
    tfp_s, text, _ = _cli([
        "segmentation", "test_from_predictions", "--dataset_json",
        str(work / "ds_pred.json"), "--ground_truth_key", "mask",
        "--prediction_key", "pred", "--prediction_mode", "probs"])
    from_predictions = _last_json(text)
    if not 0 <= from_predictions["dice"] <= 1:
        raise AssertionError(f"test_from_predictions: {from_predictions}")
    tests = {}
    for precision in ("32", "bf16"):
        secs, text, counts = _cli([
            "segmentation", "test", "--dataset_json", str(work / "ds.json"),
            "--checkpoint_dir", str(ckpt), "--dev", "cuda", "--precision",
            precision, "--metric_path", str(work / f"test_{precision}.csv")])
        result = _last_json(text)
        if (result["n_cases"] != RESNET_CLI_CASES
                or not 0 <= result["dice"] <= 1):
            raise AssertionError(f"resnet test: {result}")
        tests[precision] = dict(seconds=secs, counts=counts, result=result)
    for name, counts in (("train", train_counts),
                         ("predict", predict_counts),
                         ("test", tests["32"]["counts"])):
        wide = counts["conv3d_igemm"] - counts["conv3d_igemm_narrow"]
        if not counts["conv3d_igemm_tf32"] == wide > 0:
            raise AssertionError(f"resnet {name} launches {counts}")
    bf = tests["bf16"]["counts"]
    if not bf["conv3d_igemm_wgmma"] == (bf["conv3d_igemm"]
                                        - bf["conv3d_igemm_narrow"]) > 0:
        raise AssertionError(f"resnet bf16 test launches {bf}")
    log(f"[resnet cli] {smi}: train (f32, one epoch at B=2) {train_s:.2f} "
        f"s, launches {train_counts}; predict {len(ds)} cases "
        f"{predict_s:.2f} s ({predict_counts}); test_from_predictions "
        f"{tfp_s:.2f} s: {from_predictions}; test f32 "
        f"{tests['32']['seconds']:.2f} s ({tests['32']['counts']}): "
        f"{tests['32']['result']}; test bf16 {tests['bf16']['seconds']:.2f} "
        f"s: {tests['bf16']['result']}")
    return dict(train_s=train_s, predict_s=predict_s, train_counts=train_counts,
                predict_counts=predict_counts, test=tests,
                test_from_predictions=dict(seconds=tfp_s,
                                           result=from_predictions))


def _option_variants(smi):
    """The CLI's U-Net defaults (identity links, upsampling decoder) at the
    flagship's full width, with instance norm and with batch norm (f32, the
    CLI's default): a served case and a step against the plain path (the
    batch-norm net serves with the statistics its step moved); then each
    other conv and link type at depth 16, 32, 64 (``OPTION_VARIANTS``),
    served and stepped once against the plain path. Biases and GRN's
    gamma are drawn from the seed too: at 0, a convnextv2 unit on the
    one-channel image has NaN gradients, in the JAX package as in the port
    (GRN's square root at 0 behind a LayerNorm over one channel)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        WINDOW,
        make_train_batch,
        make_trainer,
    )

    out = {}
    batch = make_train_batch(0, batch=2, shape=WINDOW)
    variants = {"defaults": dict(CLI_DEFAULTS),
                "defaults_batch_norm": dict(CLI_DEFAULTS, norm_type="batch"),
                **{k: dict(OPTION_DEPTH, **v)
                   for k, v in OPTION_VARIANTS.items()}}
    for tag, overrides in variants.items():
        tr = make_trainer(0, "32", overrides=overrides)
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():
            for name, p in tr.state.params.items():
                if name.endswith((".bias", ".gamma")):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen,
                                             device=p.device))
        parity = _step_parity(tr, batch, tag)
        _seeded(tr)
        step = _option_step(tr, batch, gen, "32", tag)
        model = tr.model.eval()
        model.load_state_dict({k: v.detach() for k, v in
                               tr.state.state_dict().items()})
        serving = _option_serving(smi, torch.float32, overrides=overrides,
                                  tag=tag, model=model)
        log(f"[options] {tag}: step {step['seconds_per_step'][0]:.4f} s, "
            f"{step['k1_convs']} K1 and {step['dx']} dx, launches "
            f"{step['launches']}; served case "
            f"{serving['seconds_per_case'][-1]:.4f} s")
        out[tag] = dict(overrides=overrides, parity=parity, step=step,
                        serving=serving)
        del tr, model
        torch.cuda.empty_cache()
    return out


def phase_unet_options(smi):
    """Phase 18: ``u-net-3d-resnet.yaml`` served, trained and run through
    the CLIs at full width against the plain path, its K1 classes; the
    CLI's U-Net defaults and batch norm at full width; each other conv and
    link type at a small depth."""
    t0 = time.perf_counter()
    import torch

    out = dict(serving={
        "bf16": _option_serving(smi, torch.bfloat16, name="resnet"),
        "f32": _option_serving(smi, torch.float32, name="resnet")})
    out["convs"] = _resnet_conv_classes()
    out["training"] = _resnet_training(smi)
    out["cli"] = _resnet_cli(smi)
    out["variants"] = _option_variants(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"[unet options] phase 18: {out['seconds']:.1f} s")
    return out


# -- phase 19: the sample configs' other classifiers --------------------------

# served micro-batch and training batches as phase 17's; the standalone
# ConvNeXt has no yaml, so it trains at the CLI's default batch of 4
CLASSIFIER_NAMES = ("vgg", "catnet_convnext", "convnext")
CLASSIFIER_TIMED_STEPS = 2
# the ConvNeXt CatNet's bf16 B=16 step takes 17.2-17.3 s on an NVIDIA H100
# 80GB HBM3 at 700 W (nearly all of it cuDNN's input gradient of the
# depthwise convs, F.conv3d), so it is timed once
CLASSIFIER_SLOW_BF16 = ("catnet_convnext",)
# since phase 21 joined the script, the ConvNeXt CatNet trains at a third of
# the yaml's depth (its four stages' widths, kernels and pools, 2, 2, 3 and
# 2 blocks instead of 6, 6, 9 and 6), to keep the script within its time
# limit; it is served at the yaml's depth
CLASSIFIER_TRAIN_OVERRIDES = {"catnet_convnext": {"resnet_structure": [
    [32, 64, [7, 7, 5], 2], [64, 128, [7, 7, 5], 2],
    [128, 256, [5, 5, 3], 3], [256, 512, 3, 2]]}}
CLINICAL_KEYS = ("age", "psa")


def _vgg_classes(first_depth=16, n_blocks=4, batch=16):
    """VGG's stride-1 3x3x3 convs (``vggnet-net.yaml``: the factory's
    first depth 16 and four blocks) at the yaml's B=16 on 128x128x32, as
    (input shape, Cout, count): each block's two convs at its input's
    size, the stem's 1->16 on the narrow route, the rest on wgmma (bf16)
    or tf32 (f32)."""
    classes, cin = [], 1
    for i in range(n_blocks):
        d = first_depth * 2 ** i
        xs = (batch,) + tuple(n // 2 ** i for n in CATNET_SHAPE)
        classes += [(xs + (cin,), d, 1), (xs + (d,), 2 * d, 1)]
        cin = 2 * d
    return tuple(classes)


VGG_CLASSES = _vgg_classes()


def _classifier_serving(smi, name, flash=None):
    """Phase 19 (a), 21: the classifier ``name`` (``tools/flagship.py``'s
    ``CLASSIFIERS``) in eval, with the running statistics of two training
    forwards, on B=2 inputs of its size (crops of 128x128x32, the ViT's
    whole 256x256x64 volumes) in bf16 and f32: launches against those the
    K1 calls of the forward make (``_k1_calls``) and ``flash`` (the
    attention kernels' launches a forward), seconds a forward, device
    share, peak memory, and the probabilities and pooled features against
    the plain path (bf16 5e-2, f32 1e-3, as phase 17)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CLASSIFIER_CLASSES,
        CLASSIFIERS,
        classifier_shape,
        make_catnet_batch,
        make_served_classifier,
    )

    model = make_served_classifier(0, name=name)
    shape = classifier_shape(name)
    x = make_catnet_batch(1, batch=4, shape=shape)["image"][
        :CATNET_SERVE_BATCH]
    # OrdNet's n - 1 cumulative logits; one logit for two classes
    n_classes = CLASSIFIER_CLASSES.get(name, 2)
    n_out = (n_classes - 1 if CLASSIFIERS[name][0] == "ord"
             else 1 if n_classes == 2 else n_classes)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        precision = "bf16" if bf16 else "32"
        weights = _catnet_weights(model, dtype)

        def forward(**kwargs):
            return torch.func.functional_call(
                model, weights, (x.to(dtype),), kwargs).float()

        with torch.inference_mode():
            with _k1_calls() as rec:
                forward()
            torch.cuda.synchronize()
            want = _calls_want(rec.calls, dtype, step=False)
            for k, v in (flash or {}).items():
                want[k] += v
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            secs = []
            t0 = time.perf_counter()
            logits = forward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            busy, wall = _device_share(forward)
            feats = forward(return_features=True)
            with plain_kernels():
                plain = forward()
                plain_feats = forward(return_features=True)
        err = float((torch.sigmoid(logits) - torch.sigmoid(plain))
                    .abs().max())
        feat_err = float((feats - plain_feats).abs().max()) / max(
            float(plain_feats.abs().max()), 1e-30)
        tol = 5e-2 if bf16 else 1e-3
        log(f"[classifiers serving] {smi}: {name}, {precision}, "
            f"B={CATNET_SERVE_BATCH} at {'x'.join(map(str, shape))}: "
            f"{len(rec.calls)} K1 convs a forward; launches {launches}; "
            f"{', '.join(f'{s:.4f}' for s in secs)} s a forward; device "
            f"busy {busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); "
            f"peak {peak_gb:.2f} GB; probabilities "
            f"{torch.sigmoid(logits).flatten().tolist()}, kernels vs plain "
            f"path max abs err {err:.3g} (tol {tol}), pooled features "
            f"{feat_err:.3g} of their scale (tol {tol})")
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, want {want}")
        if tuple(logits.shape) != (CATNET_SERVE_BATCH, n_out) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{name} logits {tuple(logits.shape)}")
        if not (err <= tol and feat_err <= tol):
            raise AssertionError(f"{name} disagrees with its plain path: "
                                 f"{err}, features {feat_err}")
        out[precision] = dict(launches=launches, k1_convs=len(rec.calls),
                              seconds=secs, device_busy_s=busy, wall_s=wall,
                              peak_memory_gb=peak_gb, max_abs_err=err,
                              feature_rel_err=feat_err, tol=tol)
    del model
    torch.cuda.empty_cache()
    return out


# an f32 quantity of the kernels against the plain path (phases 4 and 17's
# probability tolerance), as a share of its scale
GP_F32_TOL = 1e-3
# a leaf's gradient at rounding level: its largest element below this
# share of the largest of all (the CPU tests' rule)
ROUNDING_GRADIENT = 1e-5
# the input perturbation that measures how far f32 rounding can move a
# step's gradient (about a 3xTF32 product's error, a share of the input's
# spread; at B=16 the GP CatNet's moves by 3.5e-3 of its norm), and the
# multiple of that move the kernels' path may take (its K1 route rounds
# in every forward and dx conv of the step)
PERTURBATION = 1e-6
SPREAD_FACTOR = 4


def _perturbed(batch):
    """``batch`` with each of its images (``image``, ``view1``, ``view2``)
    moved by ``PERTURBATION`` of its spread (seeded noise, one seed a
    key)."""
    import torch

    out = dict(batch)
    for i, key in enumerate(k for k in ("image", "view1", "view2")
                            if k in batch):
        x = batch[key]
        noise = torch.randn(x.shape, device=x.device, dtype=x.dtype,
                            generator=torch.Generator(
                                device=x.device).manual_seed(5 + i))
        out[key] = x + PERTURBATION * x.std() * noise
    return out


def _direction(kernels, plain, perturbed, handed):
    """How far the kernels' path moves a step's leaves (``kernels``: name
    -> a gradient or a parameter move) from the plain path's (``plain``),
    against how far the plain path moves them itself when its input is
    ``_perturbed`` (``perturbed``): over the leaves whose plain-path
    gradient (``handed``: name -> its largest element) is at least
    ``ROUNDING_GRADIENT`` of the largest, ``||kernels - plain|| /
    ||plain||`` and the same share of ``perturbed``; the bound is
    ``GP_F32_TOL`` or ``SPREAD_FACTOR`` times that share, whichever is
    larger."""
    largest = max(handed.values())
    held = [n for n, g in handed.items() if g >= ROUNDING_GRADIENT * largest]

    def share(a, b):
        """||a - b|| / ||b|| over the held leaves, the norm of b and the
        leaves that add most to the difference."""
        diff = {n: float(((a[n] - b[n]).double() ** 2).sum()) for n in held}
        norm = sum(float((b[n].double() ** 2).sum()) for n in held) ** 0.5
        return (sum(diff.values()) ** 0.5 / norm, norm,
                sorted(diff, key=diff.get, reverse=True)[:3])

    rel, norm_p, worst = share(kernels, plain)
    spread = share(perturbed, plain)[0]
    return dict(move_difference=rel, plain_move_norm=norm_p, worst=worst,
                perturbed_move_difference=spread,
                bound=max(GP_F32_TOL, SPREAD_FACTOR * spread),
                held=len(held), excluded=sorted(set(handed) - set(held)),
                largest_gradient=largest)


def _step_parity(tr, batch, tag, batch_stats_tol=1e-5):
    """One f32 step on the kernels against the plain path with the same
    members and dropout masks: loss within 1e-4 and gradient norm within
    1e-3 (relative); the gradient's direction by ``_direction`` (the
    kernels' gradient against the plain path's, within 1e-3 of its norm
    or 4 times the move a 1e-6 perturbation of the input gives the plain
    path's, over the leaves above rounding level); where the model has
    batch norms, the running
    statistics within 1e-5 of their layer's scale (``_stats_errors``) and
    each batch norm's batch statistics within ``batch_stats_tol`` of the
    layer's scale beyond the plain path's own distance from f64
    (``_step_batch_stats``). Phases 17 to 21 and 23 hold their f32 steps
    so, at 1e-5 but for phase 21's U-Net encoder classifier
    (``BATCH_STATS_TOL``)."""
    import torch

    names = list(tr.state.params)
    params = [tr.state.params[k] for k in names]
    runs = []
    for ctx, b in ((contextlib.nullcontext, batch), (plain_kernels, batch),
                   (plain_kernels, _perturbed(batch))):
        _seeded(tr, 9)
        with ctx():
            loss, metrics = tr.loss_and_metrics(tr.state.weights(), b)
            # a leaf the loss does not reach (VICReg's prediction head,
            # I-JEPA's target encoder) has no gradient on either path
            grads = {n: g.detach() for n, g in zip(names, torch.autograd.grad(
                loss, params, allow_unused=True)) if g is not None}
        runs.append((float(loss.detach()), _grad_norm(list(grads.values())),
                     metrics.get("_variables", {}), grads))
        del grads, loss
    (loss_k, norm_k, stats_k, grads_k), (loss_p, norm_p, stats_p,
                                         grads_p) = runs[:2]
    direction = _direction(grads_k, grads_p, runs[2][3], {
        n: float(g.abs().max()) for n, g in grads_p.items()})
    del runs
    out = dict(loss=loss_k, plain_loss=loss_p,
               loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               grad_norm=norm_k, plain_grad_norm=norm_p,
               grad_norm_rel=abs(norm_k - norm_p) / norm_p,
               stats=len(stats_p), direction=direction)
    excess = [(0.0, None, None)]
    if stats_p:
        out["stats_rel"], out["stats_worst"], out["stats_rel_own_max"] = (
            _stats_errors(stats_k, stats_p))
        out["batch_stats"] = rows = _step_batch_stats(tr, batch)
        excess = [(r[st]["kernels_plain"] - r[st]["plain_f64"], st,
                   r["layer"]) for r in rows for st in ("mean", "var")]
        out["batch_stats_excess"] = max(excess)[0]
    log(f"  {tag}: f32 step, kernels vs plain path: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (rel {out['loss_rel']:.2e}, tol 1e-4), gradient norm "
        f"{norm_k:.6g} vs {norm_p:.6g} (rel {out['grad_norm_rel']:.2e}, tol "
        f"1e-3); gradient direction over {direction['held']} leaves: "
        f"difference {direction['move_difference']:.3g} of the plain "
        f"gradient's norm (largest in {direction['worst']}), the plain "
        f"path's on the input moved by {PERTURBATION} of its spread "
        f"{direction['perturbed_move_difference']:.3g}, bound "
        f"{direction['bound']:.3g}; {len(direction['excluded'])} leaves "
        f"below {ROUNDING_GRADIENT} of the largest gradient "
        f"{direction['largest_gradient']:.6g} left out"
        + (f"; {len(stats_p)} running statistics within "
           f"{out['stats_rel']:.2e} of their layer's scale (tol "
           f"1e-5; worst {out['stats_worst']}); batch statistics "
           f"largest excess over plain vs f64 {max(excess)[0]:.2e}"
           f" ({max(excess)[1]} of {max(excess)[2]}, tol "
           f"{batch_stats_tol:g})"
           if stats_p else ""))
    if not (out["loss_rel"] <= 1e-4 and out["grad_norm_rel"] <= 1e-3
            and direction["move_difference"] <= direction["bound"]
            and direction["plain_move_norm"] > 0
            and out.get("stats_rel", 0.0) <= 1e-5
            and max(excess)[0] <= batch_stats_tol
            and set(stats_k) == set(stats_p)):
        raise AssertionError(f"{tag}: f32 step disagrees with plain: {out}")
    return out


def _classifier_training(smi, name, overrides=None, flash=None,
                         parity_batch=None, batch_stats_tol=1e-5):
    """Phase 19 (b), 21: the classifier ``name`` trained at its batch
    (``CLASSIFIERS``: the yaml's 16 or 2, else the CLI's 4) on inputs of
    its size (crops of 128x128x32, the ViT's 256x256x64 volumes) with the
    CLI's augmentation and ``overrides`` of its config: the f32 step
    against the plain path (``_step_parity``, ``batch_stats_tol``;
    on ``parity_batch`` samples where given), then 2 bf16 steps and 1 f32 step with the launches
    counted from 0 against those the recorded K1 calls of a step make
    (``_option_step``: K1, dx, dW, K3) and ``flash`` (the attention
    kernels' a step), seconds a step, device share and peak memory
    (``CLASSIFIER_SLOW_BF16``: one bf16 step timed)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CLASSIFIER_CLASSES,
        CLASSIFIERS,
        classifier_shape,
        make_catnet_batch,
        make_catnet_trainer,
    )

    b = CLASSIFIERS[name][2]
    shape = classifier_shape(name)
    n_classes = CLASSIFIER_CLASSES.get(name, 2)
    batch = make_catnet_batch(2, batch=b, shape=shape, n_classes=n_classes)
    parity_inputs = batch if parity_batch is None else make_catnet_batch(
        2, batch=parity_batch, shape=shape, n_classes=n_classes)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_catnet_trainer(0, precision, name=name,
                                 overrides=overrides)
        parity = (_step_parity(tr, parity_inputs, name, batch_stats_tol)
                  if precision == "32" else None)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = (CLASSIFIER_TIMED_STEPS if precision == "bf16"
                 and name not in CLASSIFIER_SLOW_BF16 else 1)
        steps = _option_step(tr, batch, gen, precision, name, n=timed,
                             extra=flash)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def step():
            tr.state, _ = tr.train_step(tr.state, tr.transforms.augment(
                gen, batch))

        busy, wall = _device_share(step)
        log(f"[classifiers training] {smi}: {name}, {precision}, B={b} at "
            f"{'x'.join(map(str, shape))}, augmentation on: "
            f"{', '.join(f'{x:.4f}' for x in steps['seconds_per_step'])} s "
            f"per step; device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; "
            f"{steps['k1_convs']} K1 and {steps['dx']} dx a step; launches "
            f"{steps['launches']}; losses {steps['losses']}")
        out[precision] = dict(steps, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall, parity=parity,
                              batch=b)
        del tr
        torch.cuda.empty_cache()
    return out


def _clinical_cli(smi, name, precision, work, ds_path):
    """``classification train`` (the yaml of ``name``, ``--precision``,
    ``--clinical_feature_keys age psa``, one epoch at B=2 with the CLI's
    augmentation), then ``test`` and ``predict`` on its checkpoint, in
    this process, each under ``torch.profiler`` (``_device_share``) with
    the launch counts set to 0 just before it: wall seconds, device share,
    peak memory, launches."""
    import torch

    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS, CLASSIFIERS

    net_type, yaml_path, _ = CLASSIFIERS[name]
    ckpt = work / f"ckpt_{name}"
    common = ["--dataset_json", str(ds_path), "--dev", "cuda",
              "--checkpoint_dir", str(ckpt), "--precision", precision]
    runs = {}
    for what, args in (
            ("train", [
                "classification", "train", *common, "--image_keys", "image",
                "--classification_net_type", net_type,
                "--config_file", str(yaml_path),
                "--pad_size", *map(str, CATNET_SHAPE),
                "--target_spacing", "0.5", "0.5", "3.0",
                "--batch_size", str(CATNET_CLI_BATCH), "--max_epochs", "1",
                "--n_folds", "1", "--augment", *AUGMENT_FLAGS, "--seed", "0",
                "--clinical_feature_keys", *CLINICAL_KEYS,
                "--metric_path", str(work / f"metrics_{name}.csv")]),
            ("test", ["classification", "test", *common, "--metric_path",
                      str(work / f"test_{name}.csv")]),
            ("predict", ["classification", "predict", *common,
                         "--output_path", str(work / f"pred_{name}.json")])):
        got = []
        torch.cuda.reset_peak_memory_stats()
        with _k1_calls() as rec:
            busy, wall = _device_share(lambda: got.append(_cli(args)))
        secs, text, counts = got[0]
        runs[what] = dict(seconds=secs, device_busy_s=busy, wall_s=wall,
                          peak_memory_gb=torch.cuda.max_memory_allocated()
                          / 1e9, counts=counts, text=text,
                          want=_recorded_want(rec))
    meta = json.loads((ckpt / "classification_fold0" /
                       "metadata.json").read_text())
    result = _last_json(runs["test"].pop("text"))
    probs = json.loads((work / f"pred_{name}.json").read_text())
    runs["train"].pop("text")
    runs["predict"].pop("text")
    if (meta["transform_arguments"]["clinical_feature_keys"]
            != list(CLINICAL_KEYS) or len(meta["clinical_feature_means"])
            != len(CLINICAL_KEYS)):
        raise AssertionError(f"{name} train wrote {meta}")
    if result["n_cases"] != CATNET_CLI_CASES or not 0 <= result["auc"] <= 1:
        raise AssertionError(f"{name} test: {result}")
    if len(probs) != CATNET_CLI_CASES or not all(
            0 <= p <= 1 for p in probs.values()):
        raise AssertionError(f"{name} predict: {probs}")
    # each recorded K1 call on its own dtype's route: the training steps'
    # with their dx and dW, the validation callback's (f32 master weights,
    # as the JAX callback applies them: a bf16 run's callback takes the
    # tf32 route), test's and predict's forwards alone; K3 in the steps
    for what, run in runs.items():
        c, want = run["counts"], run.pop("want")
        steps = want.pop("intensity_aug")
        if not (c["conv3d_igemm"] > 0 and (c["intensity_aug"] > 0) == (
                steps > 0) and {k: v for k, v in c.items()
                                if k != "intensity_aug"} == want):
            raise AssertionError(f"{name} {what} launches {c}, want {want}")
    t = runs["train"]["counts"]
    if not (t["conv3d_igemm_dx"] > 0 and t["conv3d_weight_grad"]
            + t["conv3d_weight_grad_patches"] > 0
            and t["conv3d_igemm_" + ("tf32" if precision == "32"
                                     else "wgmma")] > 0):
        raise AssertionError(f"{name} train launches {t}")
    if runs["test"]["counts"]["conv3d_igemm"] != runs["predict"]["counts"][
            "conv3d_igemm"]:
        raise AssertionError(f"{name} test and predict launches differ")
    log(f"[classifiers cli] {smi}: {name}, {precision}, clinical features "
        f"{', '.join(CLINICAL_KEYS)} (means {meta['clinical_feature_means']},"
        f" stds {meta['clinical_feature_stds']}): "
        + "; ".join(f"{what} {r['seconds']:.2f} s under the profiler, "
                    f"device busy {r['device_busy_s']:.2f} s "
                    f"({100 * r['device_busy_s'] / r['wall_s']:.1f} %), peak "
                    f"{r['peak_memory_gb']:.2f} GB, launches {r['counts']}"
                    for what, r in runs.items())
        + f"; test {result}; predictions {probs}")
    return dict(runs, test_result=result, predictions=probs,
                feature_means=meta["clinical_feature_means"],
                feature_stds=meta["clinical_feature_stds"])


def _classifier_clis(smi):
    """Phase 19 (d): the clinical-feature CLIs on 6 cases at 128x128x32 (3
    with bright ellipsoids, label 1; age and psa drawn from a seed): the
    ConvNeXt CatNet in f32 (the CLI's default) and VGG in bf16."""
    import numpy as np

    work = WORK_DIR / "classifier_cli"
    work.mkdir(parents=True)
    negatives = ("case_1", "case_3", "case_5")
    ds = _pipeline_cohort(work, CATNET_SHAPE, negatives,
                          n_cases=CATNET_CLI_CASES)
    rng = np.random.default_rng(19)
    for pid, entry in ds.items():
        entry["label"] = int(pid not in negatives)
        entry["age"] = float(rng.uniform(45, 80))
        entry["psa"] = float(rng.uniform(2, 20))
    ds_path = work / "ds_clinical.json"
    ds_path.write_text(json.dumps(ds))
    return {name: _clinical_cli(smi, name, precision, work, ds_path)
            for name, precision in (("catnet_convnext", "32"),
                                    ("vgg", "bf16"))}


def phase_classifiers(smi):
    """Phase 19: VGG (``vggnet-net.yaml``), the ConvNeXt CatNet
    (``classification-cat-convnext.yaml``) and the standalone ConvNeXt
    served and trained at full width against the plain path, VGG's K1
    classes, and the CLIs with clinical features."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = {}
    for name in CLASSIFIER_NAMES:
        out[name] = dict(serving=_classifier_serving(smi, name))
        lap(f"{name}_serving")
    log("[classifiers] VGG's K1 classes at B=16")
    out["vgg"]["convs"] = _catnet_conv_classes(VGG_CLASSES, seed=700)
    lap("vgg_convs")
    for name in CLASSIFIER_NAMES:
        out[name]["training"] = _classifier_training(
            smi, name, overrides=CLASSIFIER_TRAIN_OVERRIDES.get(name))
        lap(f"{name}_training")
    out["cli"] = _classifier_clis(smi)
    lap("cli")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[classifiers] phase 19: {out['seconds']:.1f} s ({laps})")
    return out


# -- phase 20: self-supervised pretraining ------------------------------------

SSL_TIMED_STEPS = 2
SSL_LOSS_STEPS = 10
SSL_LOSS_LR = 1e-3
SSL_BATCH = 28
# the f32 step parity runs the two-view step at the yaml's 28 (a plain
# path out of memory there fails the phase); I-JEPA's plain attention
# materialises [B, 4, 8192, 8192] f32 scores (2.1 GB a layer at B=2, 30 GB
# at 28), so it is held at B=2
IJEPA_PARITY_BATCH = 2
SSL_CLI_CASES = 6
SSL_CLI_BATCH = 3
SSL_CLI_SHAPE = (128, 128, 32)
SSL_CLI_CROP = (96, 96, 24)
# I-JEPA's head dims (encoders 192 / 4, predictor 96 / 4) at 8192 tokens:
# checked against the plain versions at B=2, timed at the yaml's 28
SSL_FLASH_DIMS = (48, 24)
SSL_FLASH_TOKENS = 8192
SSL_FLASH_HEADS = 4
SSL_FLASH_CHECK_BATCH = 2
# the K1 classes of a two-view forward at B=28 on 96x96x24 views: the
# stem's 64->64 and each bottleneck's 3x3x3 (input shape, Cout, count)
SSL_CLASSES = (
    ((SSL_BATCH, 96, 96, 24, 64), 64, 1),
    ((SSL_BATCH, 24, 24, 12, 128), 128, 2),
    ((SSL_BATCH, 12, 12, 12, 256), 256, 2),
    ((SSL_BATCH, 6, 6, 6, 512), 512, 2),
)


def _ijepa_flash_want(model, steps=1):
    """The attention launches of ``steps`` I-JEPA steps: a forward a block
    of the context encoder, the predictor and the target encoder (run
    without gradient), dQ and dK/dV a block of the first two."""
    trained = model.context_encoder.n_blocks + model.predictor.n_blocks
    return {"flash_attention_fwd": steps * (
                trained + model.target_encoder.n_blocks),
            "flash_attention_bwd_dq": steps * trained,
            "flash_attention_bwd_dkv": steps * trained}


def _ssl_want(rec, flash=None):
    """The launches of the K1 calls ``rec`` recorded (``_recorded_want``:
    K1, dx where the input takes a gradient, dW in a training step;
    forwards alone without gradient, the teachers'), with no K3 (the
    views take no intensity chain), and ``flash``."""
    want = _recorded_want(rec)
    want["intensity_aug"] = 0
    want.update(flash or {})
    return want


def _ssl_input(tr, batch, gen):
    """A step's batch: the two views of ``batch`` (``SSLTransforms``), or
    the volumes themselves for I-JEPA."""
    return batch if tr.transforms is None else tr.transforms.augment(
        gen, batch)


def _ssl_steps(tr, batch, gen, tag, n):
    """A recorded warm-up step, then ``n`` steps counted from 0 against
    the launches the recorded calls make (I-JEPA: its attention's);
    seconds and losses a step."""
    import torch

    with _k1_calls() as rec:
        tr.state, _ = tr.train_step(tr.state, _ssl_input(tr, batch, gen))
    torch.cuda.synchronize()
    flash = (_ijepa_flash_want(tr.model) if tr.transforms is None
             else None)
    want = _scaled(_ssl_want(rec, flash), n)
    _reset_counts()
    secs, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.state, metrics = tr.train_step(tr.state,
                                          _ssl_input(tr, batch, gen))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _launch_counts()
    if launches != want:
        raise AssertionError(f"{tag} step launches {launches}, want {want}")
    if not all(abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    return dict(launches=launches, k1_convs=len(rec.calls),
                dx=sum(c[2] for c in rec.calls), seconds_per_step=secs,
                losses=losses)


def _ssl_gradients(tr, views, unreached_prefix):
    """Every parameter's gradient of one kernel step: finite, each weight's
    non-zero, and none for the leaves the loss does not reach (VICReg's
    prediction head, ``unreached_prefix``), which the step hands zeros."""
    import torch

    names = list(tr.state.params)
    loss, _ = tr.loss_and_metrics(tr.state.weights(), views)
    grads = torch.autograd.grad(loss, [tr.state.params[k] for k in names],
                                allow_unused=True)
    unreached = [k for k, g in zip(names, grads) if g is None]
    bad = [k for k, g in zip(names, grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    zero = [k for k, g in zip(names, grads) if g is not None
            and k.endswith(".weight") and not bool((g != 0).any())]
    want = [k for k in names if k.startswith(unreached_prefix)]
    if bad or zero or unreached != want:
        raise AssertionError(f"gradients: non-finite {bad}, zero weights "
                             f"{zero}, unreached {unreached} (want {want})")
    return dict(n_params=len(names), unreached=unreached)


def _ssl_two_view(smi):
    """Phase 20 (a): VICReg on ``ssl-resnet.yaml`` at the yaml's B=28,
    views of 96x96x24 cropped from 128x128x32 volumes, f32 then bf16: the
    f32 step against the plain path at B=28 (``_step_parity``: the
    running statistics and each batch norm's batch statistics included)
    and every gradient
    (``_ssl_gradients``); a warm-up and 2 timed steps with the launches
    of the recorded K1 calls, peak memory and device share; in bf16 ten
    steps on one batch of views with a falling loss."""
    import torch

    from adell_mri_torch.tools.flagship import make_ssl_batch, make_ssl_trainer

    batch = make_ssl_batch(2)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_ssl_trainer(0, precision)
        gen = torch.Generator(device="cuda").manual_seed(0)
        parity = grads = None
        if precision == "32":
            views = tr.transforms.augment(gen, batch)
            # the statistics' f64 forward reads "image": the view1 forward
            views["image"] = views["view1"]
            parity = dict(_step_parity(tr, views, f"vicreg B={SSL_BATCH}"),
                          batch=SSL_BATCH)
            grads = _ssl_gradients(tr, views, "pred_")
            del views
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = _ssl_steps(tr, batch, gen, f"vicreg {precision}",
                           SSL_TIMED_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def step():
            tr.state, _ = tr.train_step(tr.state, tr.transforms.augment(
                gen, batch))

        busy, wall = _device_share(step)
        log(f"[ssl vicreg] {smi}: {precision}, B={SSL_BATCH} views of "
            "96x96x24 from 128x128x32: "
            f"{', '.join(f'{x:.4f}' for x in steps['seconds_per_step'])} s "
            f"per step; device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; "
            f"{steps['k1_convs']} K1 and {steps['dx']} dx a step; launches "
            f"{steps['launches']}; losses {steps['losses']}")
        out[precision] = dict(steps, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall,
                              parity=parity, gradients=grads)
        del tr
        torch.cuda.empty_cache()
    tr = make_ssl_trainer(0, "bf16", learning_rate=SSL_LOSS_LR)
    views = tr.transforms.augment(
        torch.Generator(device="cuda").manual_seed(1), batch)
    losses = []
    for _ in range(SSL_LOSS_STEPS):
        tr.state, metrics = tr.train_step(tr.state, views)
        losses.append(float(metrics["loss"]))
    log(f"[ssl vicreg] bf16, {SSL_LOSS_STEPS} steps on one batch of views "
        f"at lr {SSL_LOSS_LR}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"vicreg loss did not fall: {losses}")
    out["loss_steps"] = losses
    del tr, views, batch
    torch.cuda.empty_cache()
    return out


def _ssl_byol(smi):
    """Phase 20 (b): BYOL with its EMA teacher at B=28, f32 then bf16: a
    warm-up step, then one step with the launches of its recorded K1
    calls (the teacher's forwards on the shadow: forward launches alone),
    and the shadow after it equal to a plain ``ema_update`` of the one
    before towards the new parameters at ``ema_decay_at`` of the step
    count before its increment (1e-6 of each leaf's scale)."""
    import torch

    from adell_mri_torch.tools.flagship import make_ssl_batch, make_ssl_trainer
    from adell_mri_torch.train.ema import ema_decay_at, ema_update

    batch = make_ssl_batch(2)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_ssl_trainer(0, precision, "byol")
        gen = torch.Generator(device="cuda").manual_seed(0)
        views = tr.transforms.augment(gen, batch)
        # a first step moves the parameters away from the shadow
        tr.state, _ = tr.train_step(tr.state, views)
        st = tr.state
        before = {k: v.clone() for k, v in st.ema_params.items()}
        decay = ema_decay_at(st.step, st.ema_decay, st.ema_final_decay,
                             st.ema_n_steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _k1_calls() as rec:
            t0 = time.perf_counter()
            tr.state, metrics = tr.train_step(tr.state, views)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = _ssl_want(rec)
        with torch.no_grad():
            shadow = ema_update(before, tr.state.params, decay)
            err = max(float((tr.state.ema_params[k] - v).abs().max())
                      / max(float(v.abs().max()), 1e-30)
                      for k, v in shadow.items())
            moved = max(float((tr.state.ema_params[k] - tr.state.params[k])
                              .abs().max()) for k in shadow)
        loss = float(metrics["loss"])
        log(f"[ssl byol] {smi}: {precision}, B={SSL_BATCH}: {secs:.4f} s a "
            f"step, peak {peak_gb:.2f} GB, loss {loss:.6f}; decay "
            f"{decay:.6f}; shadow vs plain ema_update {err:.3g} (tol 1e-6); "
            f"shadow to parameters {moved:.3g}; launches {launches}")
        if launches != want:
            raise AssertionError(f"byol launches {launches}, want {want}")
        if not (err <= 1e-6 and moved > 0):
            raise AssertionError(f"byol shadow {err}, {moved}")
        out[precision] = dict(seconds=secs, peak_memory_gb=peak_gb,
                              launches=launches, decay=decay,
                              shadow_rel_err=err, tol=1e-6, loss=loss)
        del tr, views
        torch.cuda.empty_cache()
    return out


def _ssl_ijepa(smi):
    """Phase 20 (c): I-JEPA at the factory's defaults on B=28 volumes of
    128x128x32 (8192 tokens), f32 then bf16: the f32 step against the
    plain path at B=2 with one mask (the plain attention materialises
    the scores), then a warm-up and 2 timed steps with 10 forward, 6 dQ
    and 6 dK/dV attention launches each, peak memory and device share."""
    import torch

    from adell_mri_torch.models.ssl.masking import block_masking
    from adell_mri_torch.tools.flagship import make_ssl_batch, make_ssl_trainer

    batch = make_ssl_batch(3)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_ssl_trainer(0, precision, "ijepa")
        parity = None
        if precision == "32":
            mask = block_masking(
                torch.Generator(device="cuda").manual_seed(5), tr.model.grid)
            parity = _step_parity(tr, {
                "image": batch["image"][:IJEPA_PARITY_BATCH], "mask": mask},
                f"ijepa B={IJEPA_PARITY_BATCH}")
            parity["batch"] = IJEPA_PARITY_BATCH
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = _ssl_steps(tr, batch, None, f"ijepa {precision}",
                           SSL_TIMED_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def step():
            tr.state, _ = tr.train_step(tr.state, batch)

        busy, wall = _device_share(step)
        log(f"[ssl ijepa] {smi}: {precision}, B={SSL_BATCH} at 128x128x32 "
            f"({SSL_FLASH_TOKENS} tokens): "
            f"{', '.join(f'{x:.4f}' for x in steps['seconds_per_step'])} s "
            f"per step; device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; launches "
            f"{steps['launches']}; losses {steps['losses']}")
        out[precision] = dict(steps, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall,
                              parity=parity)
        del tr
        torch.cuda.empty_cache()
    return out


def _ssl_serving(smi):
    """Phase 20 (d): ``ssl predict_folder``'s representation (the eval
    backbone's pooled features, running statistics of two training
    forwards) at B=1 on 128x128x32, bf16 and f32: launches against the
    recorded K1 calls, seconds, device share, peak memory, and the
    features against the plain path within 5e-2 and 1e-3 of their
    scale."""
    import torch

    from adell_mri_torch.tools.flagship import make_served_ssl, make_ssl_batch

    model = make_served_ssl(0)
    x = make_ssl_batch(4, batch=1)["image"]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        precision = "bf16" if bf16 else "32"
        weights = _catnet_weights(model, dtype)

        def forward():
            return torch.func.functional_call(
                model, weights, (x.to(dtype),),
                {"ret": "representation"}).float()

        with torch.inference_mode():
            with _k1_calls() as rec:
                forward()
            torch.cuda.synchronize()
            want = _ssl_want(rec)
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            secs = []
            t0 = time.perf_counter()
            feats = forward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            busy, wall = _device_share(forward)
            with plain_kernels():
                plain = forward()
        err = float((feats - plain).abs().max()) / max(
            float(plain.abs().max()), 1e-30)
        tol = 5e-2 if bf16 else 1e-3
        log(f"[ssl serving] {smi}: {precision}, B=1 at 128x128x32: "
            f"{len(rec.calls)} K1 convs; launches {launches}; "
            f"{', '.join(f'{s:.4f}' for s in secs)} s a case; device busy "
            f"{busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); peak "
            f"{peak_gb:.2f} GB; representation {tuple(feats.shape)} vs "
            f"plain path {err:.3g} of its scale (tol {tol})")
        if launches != want:
            raise AssertionError(f"ssl serving launches {launches}, want "
                                 f"{want}")
        if tuple(feats.shape) != (1, model.backbone.n_features) or not bool(
                torch.isfinite(feats).all()) or not err <= tol:
            raise AssertionError(f"ssl representation {tuple(feats.shape)}"
                                 f", err {err}")
        out[precision] = dict(launches=launches, k1_convs=len(rec.calls),
                              seconds=secs, device_busy_s=busy, wall_s=wall,
                              peak_memory_gb=peak_gb, rel_err=err, tol=tol)
    del model
    torch.cuda.empty_cache()
    return out


def _ssl_flash():
    """Phase 20 (e): ``flash_attention`` at I-JEPA's head dims (48 on the
    D=64 kernels, 24 on the D=32 ones, zero-padded) and 8192 tokens, bf16
    and f32: forward and backward against the plain versions at the
    unpadded head dim at B=2 (phase 10's tolerances), then each kernel
    timed on the padded inputs at the yaml's B=28 beside its bound (the
    unpadded work) and ``F.scaled_dot_product_attention`` (forward, and
    forward + backward)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from adell_mri_torch.ops.kernels import attention as ka

    rows = []
    h, n = SSL_FLASH_HEADS, SSL_FLASH_TOKENS
    for d in SSL_FLASH_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            bf16 = dtype == torch.bfloat16
            gen = torch.Generator(device="cuda").manual_seed(d)
            q, k, v, g = (torch.randn((SSL_FLASH_CHECK_BATCH, h, n, d),
                                      generator=gen, device="cuda")
                          .to(dtype) for _ in range(4))
            scale = d ** -0.5
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            got = ka.flash_attention(*leaves)
            grads = torch.autograd.grad(got, leaves, g)
            w_out, w_m, w_l = ka.flash_attention_fwd_reference(q, k, v,
                                                               scale)
            lse, delta = ka.backward_rows(w_out, w_m, w_l, g)
            w_dq = ka.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                       delta, scale)
            w_dk, w_dv = ka.flash_attention_bwd_dkv_reference(
                q, k, v, g, lse, delta, scale)
            rel_f, rel_b = (2.0**-7, 2.0**-7) if bf16 else (2e-5, 1e-4)
            checks = {}
            for part, a, b, rel in (("out", got.detach(), w_out, rel_f),
                                    ("dq", grads[0], w_dq, rel_b),
                                    ("dk", grads[1], w_dk, rel_b),
                                    ("dv", grads[2], w_dv, rel_b)):
                s = max(float(b.float().abs().max()), 1e-30)
                checks[part] = (float((a.float() - b.float()).abs().max()),
                                rel * s)
            del q, k, v, g, leaves, got, grads, w_out, w_dq, w_dk, w_dv
            torch.cuda.empty_cache()
            # timed at the yaml's batch, each kernel on the padded inputs
            dp = ka.padded_head_dim(d)
            q, k, v, g = (torch.randn((SSL_BATCH, h, n, d), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(4))
            qp, kp, vp, gp = (ka._pad_head(t, dp) for t in (q, k, v, g))
            # the library without its materialising fallback, which needs
            # 30 GB a score matrix here
            fused = sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                 SDPBackend.EFFICIENT_ATTENTION])
            with torch.no_grad():
                out, m, l = ka.flash_attention_fwd(qp, kp, vp, scale)
                lse, delta = ka.backward_rows(out, m, l, gp)
                ms = {
                    "fwd": time_ms(lambda: ka.flash_attention_fwd(
                        qp, kp, vp, scale)),
                    "bwd_dq": time_ms(lambda: ka.flash_attention_bwd_dq(
                        qp, kp, vp, gp, lse, delta, scale)),
                    "bwd_dkv": time_ms(lambda: ka.flash_attention_bwd_dkv(
                        qp, kp, vp, gp, lse, delta, scale)),
                }
                with fused:
                    lib_fwd = time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v))
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))

            def library_both():
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION]):
                    o = F.scaled_dot_product_attention(lq, lk, lv)
                torch.autograd.grad(o, [lq, lk, lv], g)

            lib_both = time_ms(library_both)
            peak = None if bf16 else PEAK_F32_TF32X3
            bounds = {kind: attention_bound(kind, SSL_BATCH, h, n, n, d,
                                            name, peak) for kind in ms}
            row = dict(d=d, padded_d=dp, dtype=name,
                       check_batch=SSL_FLASH_CHECK_BATCH, batch=SSL_BATCH,
                       heads=h, tokens=n,
                       errs={p: e for p, (e, _) in checks.items()},
                       tols={p: t for p, (_, t) in checks.items()},
                       ms=ms, bound_ms={kk: b[0] for kk, b in bounds.items()},
                       bound_by={kk: b[1] for kk, b in bounds.items()},
                       library_fwd_ms=lib_fwd, library_fwd_bwd_ms=lib_both,
                       library_bwd_ms=lib_both - lib_fwd)
            rows.append(row)
            log(f"[ssl flash] [{SSL_FLASH_CHECK_BATCH},{h},{n},{d}] {name} "
                f"on the D={dp} kernels: " + ", ".join(
                    f"{p} {e:.3g} (tol {t:.3g})"
                    for p, (e, t) in checks.items())
                + f"; at B={SSL_BATCH}: " + ", ".join(
                    f"{kk} {ms[kk]:.4f} ms (bound {bounds[kk][0]:.4f} ms, "
                    f"{bounds[kk][1]})" for kk in ms)
                + f"; F.scaled_dot_product_attention forward "
                f"{lib_fwd:.4f} ms, forward + backward {lib_both:.4f} ms")
            if not all(e <= t for e, t in checks.values()):
                raise AssertionError(f"I-JEPA flash disagrees: {row}")
            del q, k, v, g, qp, kp, vp, gp, lq, lk, lv, out, m, l, lse, delta
            torch.cuda.empty_cache()
    return rows


def _ssl_cli(smi):
    """Phase 20 (f): ``ssl train`` on a seeded 6-case 128x128x32 cohort at
    ``--batch_size 3`` (one epoch of 2 steps; with ``drop_last`` the
    yaml's 28 gives none on 6 cases): VICReg in f32 on
    ``--random_crop_size 96 96 24`` (phase 23's encoder checkpoint), BYOL
    with ``--ema`` in bf16, I-JEPA
    in bf16 on the whole volume; then ``ssl predict_folder`` on the f32
    VICReg checkpoint. In this process, each under ``torch.profiler``
    with the launch counts set to 0 just before it, against the launches
    of the K1 calls recorded around it (I-JEPA: 10 forward, 6 dQ and 6
    dK/dV attention launches a step)."""
    import os

    import torch

    from adell_mri_torch.tools.flagship import SSL_YAML

    work = WORK_DIR / "ssl_cli"
    work.mkdir(parents=True)
    ds = _pipeline_cohort(work, SSL_CLI_SHAPE, (), n_cases=SSL_CLI_CASES)
    folder = work / "folder"
    folder.mkdir()
    for entry in ds.values():
        os.symlink(entry["image"], folder / os.path.basename(entry["image"]))
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda",
              "--image_keys", "image", "--config_file", str(SSL_YAML),
              "--pad_size", *map(str, SSL_CLI_SHAPE),
              "--target_spacing", "0.5", "0.5", "3.0",
              "--batch_size", str(SSL_CLI_BATCH), "--max_epochs", "1",
              "--seed", "0"]
    crop = ["--random_crop_size", *map(str, SSL_CLI_CROP)]
    runs = {}
    steps = SSL_CLI_CASES // SSL_CLI_BATCH
    # VICReg's bf16 CLI run is not repeated: BYOL's holds the CLI's bf16
    # path, VICReg's f32 run the method's, and the bf16 VICReg steps
    # (``_ssl_two_view``) the method's bf16 step
    for tag, method, precision, extra in (
            ("vicreg_f32", "vicreg", "32", crop),
            ("byol_bf16", "byol", "bf16", crop + ["--ema"]),
            ("ijepa_bf16", "ijepa", "bf16", [])):
        args = ["ssl", "train", *common, "--ssl_method", method,
                "--precision", precision, "--checkpoint_dir",
                str(work / f"ckpt_{tag}"), "--metric_path",
                str(work / f"metrics_{tag}.csv"), *extra]
        runs[tag] = _ssl_cli_run(args, method, steps)
    feats_path = work / "features.json"
    runs["predict_folder_f32"] = _ssl_cli_run(
        ["ssl", "predict_folder", "--checkpoint_dir",
         str(work / "ckpt_vicreg_f32"), "--input_folder", str(folder),
         "--output_path", str(feats_path), "--dev", "cuda"], "vicreg", 0)
    meta = json.loads((work / "ckpt_vicreg_f32" / "ssl_vicreg_fold0" /
                       "metadata.json").read_text())
    if meta["ssl_method"] != "vicreg" or meta["transform_arguments"][
            "crop_size"] != list(SSL_CLI_CROP):
        raise AssertionError(f"ssl train wrote {meta}")
    feats = json.loads(feats_path.read_text())
    if len(feats) != SSL_CLI_CASES or not all(
            len(v["features"]) == 512 and all(
                abs(f) < float("inf") for f in v["features"])
            for v in feats.values()):
        raise AssertionError(f"predict_folder wrote {len(feats)} cases")
    for tag, run in runs.items():
        c = run["counts"]
        if not (c == run["want"] and (c["conv3d_igemm"] > 0 or tag.startswith(
                "ijepa")) and c["intensity_aug"] == 0):
            raise AssertionError(f"ssl {tag} launches {c}, want "
                                 f"{run['want']}")
        run.pop("want")
    for tag in ("vicreg_f32", "byol_bf16"):
        c = runs[tag]["counts"]
        route = "tf32" if tag.endswith("f32") else "wgmma"
        if not (c["conv3d_igemm_dx"] > 0 and c[f"conv3d_igemm_{route}"] > 0
                and c["conv3d_weight_grad"] + c["conv3d_weight_grad_patches"]
                > 0):
            raise AssertionError(f"ssl {tag} launches {c}")
    log(f"[ssl cli] {smi}: " + "; ".join(
        f"{tag} {r['seconds']:.2f} s under the profiler, device busy "
        f"{r['device_busy_s']:.2f} s "
        f"({100 * r['device_busy_s'] / r['wall_s']:.1f} %), peak "
        f"{r['peak_memory_gb']:.2f} GB, launches {r['counts']}"
        for tag, r in runs.items())
        + f"; features of {len(feats)} cases, 512 each")
    return dict(runs, metadata_keys=sorted(meta),
                features_cases=len(feats))


def _ssl_cli_run(args, method, steps):
    """One CLI run (``_cli``) under ``_device_share`` with its K1 calls
    recorded: seconds, device share, peak memory, counts and the
    launches they should be."""
    import torch

    from adell_mri_torch.tools.flagship import make_ssl_model

    got = []
    torch.cuda.reset_peak_memory_stats()
    with _k1_calls() as rec:
        busy, wall = _device_share(lambda: got.append(_cli(args)))
    secs, _, counts = got[0]
    flash = (_ijepa_flash_want(make_ssl_model(0, "ijepa", "cpu"), steps)
             if method == "ijepa" else None)
    return dict(seconds=secs, device_busy_s=busy, wall_s=wall,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                counts=counts, want=_ssl_want(rec, flash))


def phase_ssl(smi):
    """Phase 20: self-supervised pretraining on ``ssl-resnet.yaml`` (VICReg
    and BYOL with its EMA teacher) and I-JEPA at full width, the served
    representation, the SSL K1 classes and I-JEPA's attention shapes, and
    the ``ssl`` CLIs."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = {}
    log(f"[ssl] the two-view step's K1 classes at B={SSL_BATCH}")
    out["convs"] = _catnet_conv_classes(SSL_CLASSES, seed=800)
    lap("convs")
    out["flash"] = _ssl_flash()
    lap("flash")
    out["two_view"] = _ssl_two_view(smi)
    lap("two_view")
    out["byol"] = _ssl_byol(smi)
    lap("byol")
    out["ijepa"] = _ssl_ijepa(smi)
    lap("ijepa")
    out["serving"] = _ssl_serving(smi)
    lap("serving")
    out["cli"] = _ssl_cli(smi)
    lap("cli")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[ssl] phase 20: {out['seconds']:.1f} s ({laps})")
    return out



# -- phase 21: the classification CLI's last four net types -------------------

VIT_BLOCKS = 10  # classification-vit.yaml: 10 blocks of 12 heads of 64
VIT_HEADS = 12
VIT_HEAD_DIM = 64
VIT_TOKENS = 4097  # 256x256x64 in 16x16x4 patches and the class token
VIT_LOSS_STEPS = 5
# each kernel a forward (served, or a block's forward in a step) and a step
VIT_FLASH_FORWARD = {"flash_attention_fwd": VIT_BLOCKS}
VIT_FLASH_STEP = {"flash_attention_fwd": VIT_BLOCKS,
                  "flash_attention_bwd_dq": VIT_BLOCKS,
                  "flash_attention_bwd_dkv": VIT_BLOCKS}
NEW_CLASSIFIERS = ("factorized_vit", "ord", "unet_classifier")
# the U-Net encoder classifier's f32 step is held against the plain path on
# 4 samples, its steps timed at the yaml's 2: with two samples its head's
# batch norms set every feature to +-1 whatever the two values' distance,
# and the step is ill-conditioned (on an NVIDIA H100 80GB HBM3 at 700 W: a
# gradient norm of 2.8e5, the kernels 7.6e-4 in loss and 25 % in gradient
# norm off the plain path; at 4 samples a norm of 201, 1.5e-6 and 6.4e-5)
PARITY_BATCH = {"unet_classifier": 4}
# its head normalises the pooled output of 14 K1 convs (3xTF32, each within
# 1e-5 of its scale) and instance norms over those 4 samples: the served
# pooled features already differ from the plain path's by 1.6e-5 of their
# scale in f32, and the plain path's own batch variances there lie 1.45e-5
# of the layer's scale from f64 (NVIDIA H100 80GB HBM3, 700 W), above the
# 1e-5 the other classifiers' heads meet; so their excess over that
# distance is held at 5e-5
BATCH_STATS_TOL = {"unet_classifier": 5e-5}
NEW_CLI_CASES = 4
NEW_CLI_BATCH = 2


class _flash_calls:
    """Within the block every ``MultiHeadAttention`` forward that takes
    the flash branch (no bias: the ViT blocks pass none; no active
    dropout; ``[B, N, C]`` with at least ``FLASH_MIN_TOKENS`` tokens) is
    recorded as whether autograd records it (a training step's, which
    then launches its dQ and dK/dV)."""

    def __enter__(self):
        import torch

        import adell_mri_torch.models.layers.vit as vit_mod

        self.calls = []

        def record(module, inputs):
            if not isinstance(module, vit_mod.MultiHeadAttention):
                return
            q_in = inputs[0]
            dropping = module.dropout is not None and module.training
            if (module.use_flash and not dropping and q_in.dim() == 3
                    and q_in.shape[1] >= vit_mod.FLASH_MIN_TOKENS):
                self.calls.append(torch.is_grad_enabled() and (
                    q_in.requires_grad or module.q.weight.requires_grad))

        self.hook = torch.nn.modules.module.register_module_forward_pre_hook(
            record)
        return self

    def __exit__(self, *exc):
        self.hook.remove()
        return False

    def want(self):
        steps = sum(self.calls)
        return {"flash_attention_fwd": len(self.calls),
                "flash_attention_bwd_dq": steps,
                "flash_attention_bwd_dkv": steps}


def _vit_attention():
    """K4-K7 at the ViT classifier's shape, q, k, v [2,12,4097,64] (the
    last 64-row tile of q and of k and v holds one row), in bf16 and f32:
    against their plain versions and timed beside them,
    ``F.scaled_dot_product_attention`` and the bound (phase 10's
    ``compare_attention``)."""
    import torch

    shape = (CATNET_SERVE_BATCH, VIT_HEADS, VIT_TOKENS, VIT_TOKENS,
             VIT_HEAD_DIM)
    log(f"[vit attention] q, k, v [{CATNET_SERVE_BATCH},{VIT_HEADS},"
        f"{VIT_TOKENS},{VIT_HEAD_DIM}]")
    return {str(dtype).split(".")[1]: compare_attention(shape, dtype, 2100,
                                                        timed=True)
            for dtype in (torch.bfloat16, torch.float32)}


def _vit_loss_steps(smi):
    """``VIT_LOSS_STEPS`` bf16 steps of the dropout-0 ViT classifier on one
    B=2 batch of 256x256x64 volumes without augmentation: finite losses,
    the last below the first."""
    import torch

    from adell_mri_torch.tools.flagship import (
        classifier_shape,
        make_catnet_batch,
        make_catnet_trainer,
    )

    batch = make_catnet_batch(3, batch=CATNET_SERVE_BATCH,
                              shape=classifier_shape("vit"))
    tr = make_catnet_trainer(0, "bf16", name="vit",
                             overrides={"dropout_rate": 0.0})
    losses = []
    for _ in range(VIT_LOSS_STEPS):
        tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    log(f"[vit loss] {smi}: bf16, B={CATNET_SERVE_BATCH} at 256x256x64, "
        f"one batch, no augmentation: losses {losses}")
    if not (all(abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"vit bf16 steps do not lower the loss: "
                             f"{losses}")
    del tr
    torch.cuda.empty_cache()
    return losses


def _new_cli(smi, tag, train_args, common, work, predict_types):
    """``classification train`` (``train_args``), then ``test`` and
    ``predict`` (each of ``predict_types``) on its checkpoint, in this
    process, each under ``torch.profiler`` (``_device_share``) with the
    launch counts set to 0 just before it: wall seconds, device share,
    peak memory and launches, the launches held against those of the K1
    calls (``_k1_calls``: K1, dx and dW in a step) and the flash calls
    (``_flash_calls``) each run recorded, with K3 in the train run
    alone."""
    import torch

    runs = {}
    jobs = [("train", ["classification", "train", *common, *train_args]),
            ("test", ["classification", "test", *common, "--metric_path",
                      str(work / f"test_{tag}.csv")])]
    jobs += [(f"predict_{kind}", [
        "classification", "predict", *common, "--prediction_type", kind,
        "--output_path", str(work / f"pred_{tag}_{kind}.json")])
        for kind in predict_types]
    for what, args in jobs:
        got = []
        torch.cuda.reset_peak_memory_stats()
        with _k1_calls() as rec, _flash_calls() as frec:
            busy, wall = _device_share(lambda: got.append(_cli(args)))
        secs, text, counts = got[0]
        want = _recorded_want(rec)
        want.update(frec.want())
        # K3 in the train run's steps (--augment intensity), whether or not
        # the network runs K1
        want.pop("intensity_aug")
        if not ((counts["intensity_aug"] > 0) == (what == "train") and {
                k: v for k, v in counts.items() if k != "intensity_aug"}
                == want):
            raise AssertionError(f"{tag} {what} launches {counts}, want "
                                 f"{want} and K3 {what == 'train'}")
        runs[what] = dict(seconds=secs, device_busy_s=busy, wall_s=wall,
                          peak_memory_gb=torch.cuda.max_memory_allocated()
                          / 1e9, counts=counts, text=text,
                          flash_calls=len(frec.calls))
    result = _last_json(runs["test"]["text"])
    for run in runs.values():
        run.pop("text")
    preds = {kind: json.loads((work / f"pred_{tag}_{kind}.json").read_text())
             for kind in predict_types}
    return runs, result, preds


def _new_clis(smi):
    """Phase 21 (e): ``classification train``, ``test`` and ``predict``
    for each new net type on 4 seeded cases (2 with bright ellipsoids,
    label 1; their masks): the ViT classifier on a copy of
    ``classification-vit.yaml`` with dropout 0 at 256x256x64 in f32 (the
    flash kernels in train, test and predict), the factorized ViT at the
    factory's defaults in bf16, OrdNet on
    ``classification-cat-resnet.yaml`` with three grades in f32
    (``--prediction_type pre_bias`` too) and the U-Net encoder classifier
    on ``u-net-3d-resnet.yaml`` in bf16 with ``--mask_keys gland
    --image_masking --image_crop_from_mask`` (a centred ellipsoid a case),
    all at B=2 for one epoch
    with the CLI's augmentation, 128x128x32 but the ViT's."""
    import yaml

    from adell_mri_torch.tools.flagship import (
        AUGMENT_FLAGS,
        CASE,
        CATNET_YAML,
        CLASSIFIERS,
        RESNET_YAML,
    )

    import numpy as np

    from adell_mri_torch.data.nifti import write_nifti

    work = WORK_DIR / "new_classifier_cli"
    work.mkdir(parents=True)
    negatives = ("case_1", "case_3", "case_5")
    cohorts = {}
    for shape in (CATNET_SHAPE, CASE):
        d = work / "x".join(map(str, shape))
        d.mkdir()
        ds = _pipeline_cohort(d, shape, negatives, n_cases=NEW_CLI_CASES)
        # a gland mask for every case (masking by an empty lesion mask
        # would zero the whole image): a centred ellipsoid over half of
        # each axis, shifted a voxel a case, as the cohort's affine has it
        axes = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                           indexing="ij")
        for i, (pid, entry) in enumerate(sorted(ds.items())):
            entry["label"] = int(pid not in negatives)
            entry["grade"] = i % 3
            gland = sum(((a - n / 2 - i) / (n / 4)) ** 2
                        for a, n in zip(axes, shape)) <= 1.0
            entry["gland"] = str(d / f"{pid}_gland.nii")
            write_nifti(entry["gland"], gland.astype(np.uint8),
                        np.diag([-0.5, -0.5, 3.0, 1.0]))
        (d / "ds_cls.json").write_text(json.dumps(ds))
        cohorts[shape] = d / "ds_cls.json"
    vit_yaml = work / "vit_dropout0.yaml"
    vit_cfg = yaml.safe_load(CLASSIFIERS["vit"][1].read_text())
    vit_yaml.write_text(yaml.safe_dump({**vit_cfg, "dropout_rate": 0.0}))
    # the factory's defaults: a config of no network key
    factorized_yaml = work / "factorized_vit.yaml"
    factorized_yaml.write_text(yaml.safe_dump({"learning_rate": 1e-3}))
    jobs = {
        "vit": ("vit", vit_yaml, CASE, "32", [], ["probability"]),
        "factorized_vit": ("factorized_vit", factorized_yaml, CATNET_SHAPE,
                           "bf16", [], ["probability"]),
        "ord": ("ord", CATNET_YAML, CATNET_SHAPE, "32",
                ["--label_keys", "grade", "--possible_labels", "0", "1",
                 "2"], ["probability", "pre_bias"]),
        "unet": ("unet", RESNET_YAML, CATNET_SHAPE, "bf16",
                 ["--mask_keys", "gland", "--image_masking",
                  "--image_crop_from_mask"], ["probability"]),
    }
    out = {}
    for tag, (net_type, yaml_path, shape, precision, extra,
              kinds) in jobs.items():
        ckpt = work / f"ckpt_{tag}"
        common = ["--dataset_json", str(cohorts[shape]), "--dev", "cuda",
                  "--checkpoint_dir", str(ckpt), "--precision", precision]
        train_args = [
            "--image_keys", "image", "--classification_net_type", net_type,
            "--config_file", str(yaml_path),
            "--pad_size", *map(str, shape),
            "--target_spacing", "0.5", "0.5", "3.0",
            "--batch_size", str(NEW_CLI_BATCH), "--max_epochs", "1",
            "--n_folds", "1", "--augment", *AUGMENT_FLAGS, "--seed", "0",
            "--metric_path", str(work / f"metrics_{tag}.csv"), *extra]
        runs, result, preds = _new_cli(smi, tag, train_args, common, work,
                                       kinds)
        meta = json.loads((ckpt / "classification_fold0" /
                           "metadata.json").read_text())
        n_classes = 3 if tag == "ord" else 2
        t_args = meta["transform_arguments"]
        if (meta["net_type"] != net_type or meta["n_classes"] != n_classes
                or t_args["image_masking"] != (tag == "unet")
                or t_args["image_crop_from_mask"] != (tag == "unet")):
            raise AssertionError(f"{tag} train wrote {meta}")
        if result["n_cases"] != NEW_CLI_CASES or not 0 <= result["auc"] <= 1:
            raise AssertionError(f"{tag} test: {result}")
        probs = preds["probability"]
        ok = len(probs) == NEW_CLI_CASES and all(
            (abs(sum(v) - 1) < 1e-4 and len(v) == 3) if n_classes == 3
            else 0 <= v <= 1 for v in probs.values())
        if "pre_bias" in preds:
            ok = ok and all(len(v) == 1 and abs(v[0]) < float("inf")
                            for v in preds["pre_bias"].values())
        if not ok:
            raise AssertionError(f"{tag} predict: {preds}")
        t = runs["train"]["counts"]
        if tag == "vit" and not (t["flash_attention_bwd_dq"] > 0 and runs[
                "test"]["counts"]["flash_attention_fwd"]
                == VIT_BLOCKS * NEW_CLI_CASES):
            raise AssertionError(f"vit CLI launches {runs}")
        if tag in ("ord", "unet") and not (
                t["conv3d_igemm"] > 0 and t["conv3d_igemm_dx"] > 0
                and t["conv3d_weight_grad"]
                + t["conv3d_weight_grad_patches"] > 0):
            raise AssertionError(f"{tag} train launches {t}")
        log(f"[new classifiers cli] {smi}: {tag} ({net_type}, {precision}"
            f", {'x'.join(map(str, shape))}): "
            + "; ".join(f"{what} {r['seconds']:.2f} s under the profiler, "
                        f"device busy {r['device_busy_s']:.2f} s "
                        f"({100 * r['device_busy_s'] / r['wall_s']:.1f} %), "
                        f"peak {r['peak_memory_gb']:.2f} GB, launches "
                        f"{r['counts']}" for what, r in runs.items())
            + f"; test {result}; predictions {preds}")
        out[tag] = dict(runs, test_result=result, predictions=preds,
                        precision=precision)
    return out


def phase_new_classifiers(smi):
    """Phase 21: the classification CLI's last four net types at full
    width: the ViT classifier (``classification-vit.yaml``) served on
    256x256x64 (4097 tokens: 10 forward launches), trained there with
    dropout 0 (10 forward, 10 dQ, 10 dK/dV launches a step; f32 against
    the plain path, bf16 steps lowering the loss) and with its own dropout
    0.1 at B=4 on 128x128x32 crops (513 tokens, the materialised softmax:
    no attention launch); K4-K7 at [2,12,4097,64]; the factorized ViT,
    OrdNet and the U-Net encoder classifier served at B=2 and trained at
    their batch on 128x128x32 (K1, dx, dW); the CLIs."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = {"vit": dict(serving=_classifier_serving(
        smi, "vit", flash=VIT_FLASH_FORWARD))}
    lap("vit_serving")
    out["vit"]["training"] = _classifier_training(
        smi, "vit", overrides={"dropout_rate": 0.0}, flash=VIT_FLASH_STEP)
    out["vit"]["loss_steps"] = _vit_loss_steps(smi)
    lap("vit_training")
    out["vit_crops"] = dict(training=_classifier_training(smi, "vit_crops"))
    lap("vit_crops_training")
    out["attention"] = _vit_attention()
    lap("vit_attention")
    for name in NEW_CLASSIFIERS:
        out[name] = dict(serving=_classifier_serving(smi, name),
                         training=_classifier_training(
                             smi, name, parity_batch=PARITY_BATCH.get(name),
                             batch_stats_tol=BATCH_STATS_TOL.get(name,
                                                                 1e-5)))
        lap(name)
    out["cli"] = _new_clis(smi)
    lap("cli")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[new classifiers] phase 21: {out['seconds']:.1f} s ({laps})")
    return out


# -- phase 22: the GP head, warm starts, accumulation, ensembles -------------

GP_NAME = "catnet_gp"
GP_COV_BATCHES = 3
# the CLI runs' cohort: 2 of 6 cases calibrate and stay out of the folds
GP_CALIBRATION = "case_4,case_5"
GP_RESIZE = (112, 112, 28)
ENSEMBLE_MEMBERS = 2


def _gp_covariance(smi):
    """Phase 22 (b): the GP CatNet's covariance fitted on the card as
    ``classification train`` fits it (the parameters alone: each batch's
    statistics, f32) over ``GP_COV_BATCHES`` batches of B=16 at
    128x128x32, on the kernels and on the plain path, and in f64 on the
    host from the kernels' features; ``predictive_logits`` of the served
    B=2 crops (running statistics) with each covariance: the corrected
    logits and the predictive variances ``phi cov phi`` each against the
    plain path's as a share of their own scale (the served logits are
    small, so their probabilities lie within about 1e-3 of 0.5 whatever
    the correction). The K1 launches of the fit against those its
    recorded calls make."""
    import torch

    from adell_mri_torch.models.layers.adn import batch_statistics_mode
    from adell_mri_torch.models.layers.gaussian_process import (
        fit_covariance,
        predictive_logits,
    )
    from adell_mri_torch.tools.flagship import (
        make_catnet_batch,
        make_served_classifier,
    )

    model = make_served_classifier(0, name=GP_NAME)
    batches = [make_catnet_batch(30 + i, batch=CATNET_BATCH,
                                 shape=CATNET_SHAPE)["image"]
               for i in range(GP_COV_BATCHES)]
    x = make_catnet_batch(1, batch=4, shape=CATNET_SHAPE)["image"][
        :CATNET_SERVE_BATCH]

    def fit():
        with torch.no_grad(), batch_statistics_mode(model):
            phis = torch.cat([model(b, return_phi=True)[1]
                              for b in batches])
        return fit_covariance(phis), phis

    def served(cov):
        with torch.no_grad():
            logits, phi = model(x, return_phi=True)
        var = ((phi.double() @ cov.double()) * phi.double()).sum(-1)
        return logits, predictive_logits(logits, phi, cov), var

    def share(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _k1_calls() as rec:
        cov, phis = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    want = _recorded_want(rec)
    logits, corrected, var = served(cov)
    with plain_kernels():
        cov_p, _ = fit()
        logits_p, corrected_p, var_p = served(cov_p)
    cov64 = fit_covariance(phis.double().cpu())
    errs = dict(
        covariance=share(cov, cov_p),
        covariance_f64=share(cov.double().cpu(), cov64),
        corrected_logits=share(corrected, corrected_p),
        variance=share(var, var_p))
    shrink = (corrected / logits).flatten().tolist()
    log(f"[gp] {smi}: covariance over {GP_COV_BATCHES} batches of "
        f"B={CATNET_BATCH} at {'x'.join(map(str, CATNET_SHAPE))} (f32, the "
        f"parameters alone) {fit_s:.3f} s, launches {launches}; kernels vs "
        f"plain {errs['covariance']:.3g} of its scale, card vs host f64 "
        f"{errs['covariance_f64']:.3g} (tol {GP_F32_TOL}); served B=2 "
        f"logits {logits.flatten().tolist()} times {shrink} after the "
        f"mean-field correction (variances {var.tolist()}); kernels vs "
        f"plain, as a share of their scale: corrected logits "
        f"{errs['corrected_logits']:.3g}, variances "
        f"{errs['variance']:.3g} (tol {GP_F32_TOL})")
    if launches != want or launches["conv3d_igemm_tf32"] != (
            CATNET_CONVS * GP_COV_BATCHES):
        raise AssertionError(f"GP fit launches {launches}, want {want}")
    if not (all(v <= GP_F32_TOL for v in errs.values())
            and bool(torch.isfinite(cov).all())
            and all(0 < s < 1 for s in shrink)):
        raise AssertionError(f"GP covariance: {errs}, shrink {shrink}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, fit_s=fit_s, errors=errs, tol=GP_F32_TOL,
                shrink=shrink, variances=var.tolist())


def _update_parity(tag, setup, batch, steps, want_updates):
    """``steps`` f32 training steps (no augmentation) of a fresh GP CatNet
    trainer (Nesterov SGD: a move is linear in the gradients), its
    optimizer changed by ``setup(tr)``, on the kernels and on the plain
    path with the same members and dropout masks, and on the plain path
    again with the input moved by ``PERTURBATION`` of its spread: the
    launches of the kernels' run against those its recorded K1 calls
    make, the optimizer's update count, and the difference of the
    parameters' moves from the plain path's as a share of their norm,
    over the leaves whose gradient on the plain path is above rounding
    level (the largest element of the sum of the gradients the optimizer
    was handed at least ``ROUNDING_GRADIENT`` of the largest of all; the
    biases ahead of the batch norms, whose true gradient is zero, fall
    below it and are reported). The bound is ``GP_F32_TOL``, or
    ``SPREAD_FACTOR`` times the share by which the perturbed input moves
    the plain path's moves where that is larger: at B=16 this network's
    f32 gradient moves by 3.5e-3 of its norm under such a perturbation,
    so no two f32 paths agree within 1e-3 there. The parameters
    ``setup`` froze bit-equal to their start on all three."""
    import torch

    from adell_mri_torch.tools.flagship import make_catnet_trainer

    perturbed = _perturbed(batch)
    runs = {}
    for path, ctx, b in (("kernels", contextlib.nullcontext, batch),
                         ("plain", plain_kernels, batch),
                         ("perturbed", plain_kernels, perturbed)):
        tr = make_catnet_trainer(0, "32", name=GP_NAME)
        frozen = setup(tr.state.tx, tr.state.params)
        start = {k: v.detach().clone() for k, v in tr.state.params.items()}
        handed = {k: torch.zeros_like(v) for k, v in start.items()}
        step = tr.state.tx.step

        def recording(grads, params, step=step, handed=handed):
            for k, g in grads.items():
                handed[k] += g.detach()
            return step(grads, params)

        tr.state.tx.step = recording
        torch.cuda.synchronize()
        _reset_counts()
        with ctx(), _k1_calls() as rec:
            for i in range(steps):
                _seeded(tr, 9 + i)
                tr.state, _ = tr.train_step(tr.state, b)
        torch.cuda.synchronize()
        want = dict(_recorded_want(rec), intensity_aug=0)
        runs[path] = dict(
            launches=_launch_counts(), want=want, updates=tr.state.tx.count,
            moves={k: v.detach() - start[k]
                   for k, v in tr.state.params.items()},
            handed={k: float(g.abs().max()) for k, g in handed.items()},
            frozen_equal=all(torch.equal(tr.state.params[k], start[k])
                             for k in frozen), frozen=len(frozen))
        del tr
        torch.cuda.empty_cache()
    k, p, q = runs["kernels"], runs["plain"], runs["perturbed"]
    d = _direction(k["moves"], p["moves"], q["moves"], p["handed"])
    rel, norm_p, worst = d["move_difference"], d["plain_move_norm"], d["worst"]
    spread, bound, excluded = (d["perturbed_move_difference"], d["bound"],
                               d["excluded"])
    largest = d["largest_gradient"]
    log(f"  {tag}: {steps} f32 steps at B={CATNET_BATCH}: {k['updates']} "
        f"update(s), launches {k['launches']}; the parameters' moves over "
        f"{d['held']} leaves, kernels vs plain: difference {rel:.3g} of "
        f"the plain moves' norm {norm_p:.6g} (largest in {worst}); the "
        f"plain path's moves on the input moved by {PERTURBATION} of its "
        f"spread: {spread:.3g}; bound {bound:.3g}; {len(excluded)} leaves "
        f"left out, their gradient below {ROUNDING_GRADIENT} of the "
        f"largest {largest:.6g}: {excluded}; {k['frozen']} frozen leaves "
        f"unchanged: "
        f"{all(r['frozen_equal'] for r in runs.values())}")
    if not (k["launches"] == k["want"] and k["updates"] == p["updates"]
            == q["updates"] == want_updates and rel <= bound and norm_p > 0
            and all(r["frozen_equal"] for r in runs.values())):
        raise AssertionError(f"{tag}: {rel} (bound {bound}), "
                             f"{k['launches']} vs {k['want']}, updates "
                             f"{k['updates']}")
    return dict(launches=k["launches"], updates=k["updates"],
                plain_move_norm=norm_p, move_difference=rel,
                perturbed_move_difference=spread, bound=bound,
                held=d["held"], excluded=excluded, frozen=k["frozen"])


def _gp_optimizer_steps(smi):
    """Phase 22 (c): two micro-steps of ``accumulate_gradients(k=2)`` (one
    update), and one step with the backbone frozen (``freeze_wrap`` of
    ``freeze_mask_by_regex(["ResNetBackbone_0"])``), against the plain
    path (``_update_parity``)."""
    from adell_mri_torch.tools.flagship import make_catnet_batch
    from adell_mri_torch.train.checkpoints import freeze_mask_by_regex
    from adell_mri_torch.train.optim import accumulate_gradients, freeze_wrap

    batch = make_catnet_batch(2, batch=CATNET_BATCH, shape=CATNET_SHAPE)

    def accumulate(tx, params):
        accumulate_gradients(tx, 2)
        return []

    def freeze(tx, params):
        mask = freeze_mask_by_regex(params, ["ResNetBackbone_0"])
        freeze_wrap(tx, mask)
        return [k for k, t in mask.items() if not t]

    return dict(accumulation=_update_parity("accumulation", accumulate,
                                            batch, 2, 1),
                frozen=_update_parity("frozen backbone", freeze, batch, 1,
                                      1))


def _counted_cli(args):
    """``_cli`` with the K1 calls recorded around it: (seconds, standard
    output, launches, the launches those calls make)."""
    with _k1_calls() as rec:
        secs, text, counts = _cli(args)
    return secs, text, counts, _recorded_want(rec)


def _check_cli_launches(tag, counts, want, steps):
    """Every K1, dx and dW launch the recorded calls make, and K3 where
    training steps with the augmentation ran (``steps``) and nowhere
    else."""
    want = dict(want, intensity_aug=counts["intensity_aug"])
    if not (counts["conv3d_igemm"] > 0 and counts == want
            and (counts["intensity_aug"] > 0) == steps):
        raise AssertionError(f"{tag} launches {counts}, want {want}")


def _gp_clis(smi):
    """Phase 22 (d): on 6 cases at 128x128x32 (3 with bright ellipsoids,
    label 1), f32: ``classification train`` of the GP CatNet with
    ``--calibration_ids`` (2 cases), ``--accumulate_grad_batches 2`` and
    ``--resize_size``, 2 epochs at B=2 with the augmentation; a second
    run warm-started from it (``--checkpoint``) with ``--freeze_regex
    ResNetBackbone_0``, 1 epoch; ``test`` of both with ``--one_to_one`` on
    two ID groups; ``predict`` of both with ``--ensemble mean`` (the GP
    correction from each run's covariance), again on the plain path
    (within ``GP_F32_TOL``), and ``--prediction_type set``. Each run's
    launches against those of the K1 calls recorded around it."""
    import numpy as np
    import torch
    import yaml

    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS, CATNET_YAML

    work = WORK_DIR / "gp_cli"
    work.mkdir(parents=True)
    negatives = ("case_1", "case_3", "case_5")
    ds = _pipeline_cohort(work, CATNET_SHAPE, negatives,
                          n_cases=CATNET_CLI_CASES)
    for pid, entry in ds.items():
        entry["label"] = int(pid not in negatives)
    (work / "ds.json").write_text(json.dumps(ds))
    config = yaml.safe_load(CATNET_YAML.read_text())
    gp_yaml = work / "gp.yaml"
    gp_yaml.write_text(yaml.safe_dump({**config, "gaussian_process": True}))
    runs, out = [work / "run_1", work / "run_2"], {}
    folds = [str(r / "classification_fold0") for r in runs]
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda"]
    train = ["classification", "train", *common, "--image_keys", "image",
             "--config_file", str(gp_yaml),
             "--pad_size", *map(str, CATNET_SHAPE),
             "--target_spacing", "0.5", "0.5", "3.0",
             "--batch_size", str(CATNET_CLI_BATCH), "--n_folds", "1",
             "--augment", *AUGMENT_FLAGS, "--seed", "0"]
    for tag, args, steps in (
            ("train", train + [
                "--checkpoint_dir", str(runs[0]), "--max_epochs", "2",
                "--resize_size", *map(str, GP_RESIZE),
                "--accumulate_grad_batches", "2",
                "--calibration_ids", GP_CALIBRATION,
                "--metric_path", str(work / "m1.csv")], True),
            ("warm_start", train + [
                "--checkpoint_dir", str(runs[1]), "--max_epochs", "1",
                "--checkpoint", folds[0], "--freeze_regex",
                "ResNetBackbone_0", "--metric_path", str(work / "m2.csv")],
             True),
            ("test", ["classification", "test", *common, "--checkpoint_dir",
                      str(runs[0]), "--checkpoint", *folds, "--one_to_one",
                      "--test_ids", "case_0,case_1,case_2",
                      "case_3,case_4,case_5", "--metric_path",
                      str(work / "t.csv")], False),
            ("predict_ensemble", ["classification", "predict", *common,
                                  "--checkpoint_dir", str(runs[0]),
                                  "--checkpoint", *folds, "--ensemble",
                                  "mean", "--output_path",
                                  str(work / "ens.json")], False),
            ("predict_set", ["classification", "predict", *common,
                             "--checkpoint_dir", str(runs[0]),
                             "--prediction_type", "set", "--output_path",
                             str(work / "set.json")], False)):
        secs, text, counts, want = _counted_cli(args)
        _check_cli_launches(f"gp {tag}", counts, want, steps)
        out[tag] = dict(seconds=secs, counts=counts)
        if tag == "test":
            out[tag]["results"] = json.loads(
                [ln for ln in text.splitlines() if ln.startswith("[")][-1])
    meta = json.loads((runs[0] / "classification_fold0" / "metadata.json")
                      .read_text())
    cov = [np.load(Path(f) / "gp_covariance.npy") for f in folds]
    conf = json.loads((Path(folds[0]) / "conformal.json").read_text())
    weights = [torch.load(Path(f) / "model.pt", weights_only=True)
               for f in folds]
    frozen = [k for k in weights[1] if k.startswith("ResNetBackbone_0.")
              and not k.endswith((".mean", ".var"))]
    ens = json.loads((work / "ens.json").read_text())
    sets = json.loads((work / "set.json").read_text())
    with plain_kernels():
        _cli(["classification", "predict", *common, "--checkpoint_dir",
              str(runs[0]), "--checkpoint", *folds, "--ensemble", "mean",
              "--output_path", str(work / "ens_plain.json")])
    plain = json.loads((work / "ens_plain.json").read_text())
    err = max(abs(r["predictions"][pid] - q["predictions"][pid])
              for r, q in zip(ens, plain) for pid in r["predictions"])
    calib = set(GP_CALIBRATION.split(","))
    checks = dict(
        metadata=meta["transform_arguments"]["resize_size"] == list(
            GP_RESIZE) and not calib & set(meta["train_pids"]
                                           + meta["val_pids"]),
        covariance=all(c.shape == (256, 256) and np.isfinite(c).all()
                       and np.allclose(c, c.T, atol=1e-5) for c in cov),
        conformal=conf["n_calibration"] == 2 and 0 < conf["q_hat"] <= 1,
        frozen=bool(frozen) and all(torch.equal(weights[0][k],
                                                weights[1][k])
                                    for k in frozen),
        test=[r["iteration"] for r in out["test"]["results"]] == [0, 1],
        ensemble=len(ens) == 3 and ens[-1]["checkpoint"] == "ensemble"
        and err <= GP_F32_TOL,
        sets=sorted(sets) == sorted(ds) and all(
            v and set(v) <= {0, 1} for v in sets.values()))
    log(f"[gp cli] {smi}: "
        + "; ".join(f"{tag} {r['seconds']:.2f} s, launches {r['counts']}"
                    for tag, r in out.items())
        + f"; conformal {conf}; {len(frozen)} frozen leaves kept; ensemble "
        f"record {ens[-1]['predictions']}, kernels vs plain path {err:.3g} "
        f"(tol {GP_F32_TOL}); sets {sets}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"gp CLIs: {checks}")
    return dict(runs=out, conformal=conf, ensemble=ens[-1], sets=sets,
                ensemble_plain_err=err)


def _ensemble_clis(smi):
    """Phase 22 (e): ``classification_ensemble train`` (f32) of
    ``ENSEMBLE_MEMBERS`` CatNets of ``classification-cat-resnet.yaml``
    as it stands (batch ensembles of 4, batch norm; the parameters alone
    in every step) on the phase's 6 cases, 2 epochs at B=2, then
    ``test`` and ``predict``, and ``predict`` again on the plain path
    (within ``GP_F32_TOL``); the launches against those of the recorded
    K1 calls, no K3 (the ensemble trains without augmentation)."""
    from adell_mri_torch.tools.flagship import CATNET_YAML

    work = WORK_DIR / "gp_cli"
    ck = work / "ensemble"
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda",
              "--checkpoint_dir", str(ck)]
    out = {}
    for tag, args in (
            ("train", ["classification_ensemble", "train", *common,
                       "--image_keys", "image", "--config_files",
                       *[str(CATNET_YAML)] * ENSEMBLE_MEMBERS,
                       "--pad_size", *map(str, CATNET_SHAPE),
                       "--target_spacing", "0.5", "0.5", "3.0",
                       "--batch_size", str(CATNET_CLI_BATCH),
                       "--max_epochs", "2", "--seed", "0", "--metric_path",
                       str(work / "me.csv")]),
            ("test", ["classification_ensemble", "test", *common,
                      "--metric_path", str(work / "te.csv")]),
            ("predict", ["classification_ensemble", "predict", *common,
                         "--output_path", str(work / "pe.json")])):
        secs, text, counts, want = _counted_cli(args)
        _check_cli_launches(f"ensemble {tag}", counts, want, False)
        out[tag] = dict(seconds=secs, counts=counts)
        if tag == "test":
            out[tag]["results"] = _last_json(text)
    probs = json.loads((work / "pe.json").read_text())
    with plain_kernels():
        _cli(["classification_ensemble", "predict", *common,
              "--output_path", str(work / "pe_plain.json")])
    plain = json.loads((work / "pe_plain.json").read_text())
    err = max(abs(probs[k] - plain[k]) for k in probs)
    meta = json.loads((ck / "ensemble_fold0" / "metadata.json").read_text())
    log(f"[ensemble cli] {smi}: "
        + "; ".join(f"{tag} {r['seconds']:.2f} s, launches {r['counts']}"
                    for tag, r in out.items())
        + f"; test {out['test']['results']}; predictions {probs}, kernels "
        f"vs plain path {err:.3g} (tol {GP_F32_TOL})")
    if not (meta["n_members"] == ENSEMBLE_MEMBERS
            and all(c["batch_ensemble"] == 4 for c in meta["member_configs"])
            and out["test"]["results"]["n_cases"] == CATNET_CLI_CASES
            and len(probs) == CATNET_CLI_CASES and err <= GP_F32_TOL
            and all(0 <= p <= 1 for p in probs.values())):
        raise AssertionError(f"ensemble CLIs: {meta}, {out}, {err}")
    return dict(runs=out, predictions=probs, plain_err=err)


def phase_gp_ensemble(smi):
    """Phase 22: the classification CLI's remaining flags and the
    ``classification_ensemble`` mode at the yaml's width: the GP CatNet
    served (B=2) and trained (B=16) as phase 19 serves and trains, its
    covariance and mean-field correction, accumulation and freezing, the
    CLIs, the ensemble's CLIs."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = dict(serving=_classifier_serving(smi, GP_NAME))
    lap("serving")
    out["training"] = _classifier_training(smi, GP_NAME)
    lap("training")
    out["covariance"] = _gp_covariance(smi)
    lap("covariance")
    out["optimizer"] = _gp_optimizer_steps(smi)
    lap("optimizer")
    out["cli"] = _gp_clis(smi)
    lap("cli")
    out["ensemble_cli"] = _ensemble_clis(smi)
    lap("ensemble_cli")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[gp and ensembles] phase 22: {out['seconds']:.1f} s ({laps})")
    return out


# -- phase 23: the U-Net fine-tuned from an SSL-pretrained encoder ------------

FINETUNE_NAME = "encoder_unet"
FINETUNE_TIMED_STEPS = 2
FINETUNE_CLI_CASES = 6
FINETUNE_CLI_BATCH = 2
FINETUNE_RESIZE = (112, 112, 28)
# the stem's first conv stays as the SSL run left it
FINETUNE_FROZEN = "encoder_backbone/Conv_0"
FINETUNE_LR_ENCODER = "0.0001"


def _finetune_training(smi):
    """Phase 23 (b): the encoder U-Net trained at the flagship's B=4 on
    128x128x32 with the CLI's augmentation, f32 and bf16: the f32 step
    against the plain path (``_step_parity``), then 2 bf16 steps and 1
    f32 step with the launches counted from 0 against those the recorded
    K1 calls of a step make (``_option_step``: K1, dx, dW, K3), seconds a
    step, device share and peak memory; K3 against its plain version at
    the batch's shape (``_k3_against_plain``, sigma 0 and the noise's
    moments)."""
    import torch

    from adell_mri_torch.tools.flagship import (
        BATCH,
        WINDOW,
        make_train_batch,
        make_trainer,
    )

    batch = make_train_batch(0, batch=BATCH, shape=WINDOW)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_trainer(0, precision, name=FINETUNE_NAME)
        parity = (_step_parity(tr, batch, FINETUNE_NAME)
                  if precision == "32" else None)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = _option_step(tr, batch, gen, precision, FINETUNE_NAME,
                             n=FINETUNE_TIMED_STEPS if precision == "bf16"
                             else 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def step():
            tr.state, _ = tr.train_step(tr.state, tr.transforms.augment(
                gen, batch))

        busy, wall = _device_share(step)
        log(f"[finetune training] {smi}: {precision}, B={BATCH} at "
            f"{'x'.join(map(str, WINDOW))}, augmentation on: "
            f"{', '.join(f'{x:.4f}' for x in steps['seconds_per_step'])} s "
            f"per step; device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %); peak {peak_gb:.2f} GB; "
            f"{steps['k1_convs']} K1 and {steps['dx']} dx a step; launches "
            f"{steps['launches']}; losses {steps['losses']}")
        out[precision] = dict(steps, peak_memory_gb=peak_gb,
                              device_busy_s=busy, wall_s=wall, parity=parity)
        del tr
        torch.cuda.empty_cache()
    out["intensity"] = _finetune_intensity(batch["image"])
    return out


def _finetune_intensity(images):
    """K3 against its plain version at the encoder U-Net's step shape
    ([4,128,128,32,1], f32 and bf16) with the segmentation policy's
    ranges (gamma in its range, a shift of up to its share of each
    sample's standard deviation, sigma 0 or its noise)."""
    import torch

    from adell_mri_torch.tools.flagship import AUGMENT_FLAGS
    from adell_mri_torch.transforms.pipeline import AugmentPolicy

    policy = AugmentPolicy.from_flags(AUGMENT_FLAGS, scale_range=0.0,
                                      flip_axes=(0, 1, 2))
    dev = images.device
    b = images.shape[0]
    red = tuple(range(1, images.dim()))
    u = torch.rand((3, b), generator=torch.Generator(device=dev).manual_seed(
        12), device=dev)
    lo_g, hi_g = policy.gamma_range
    par_draws = (lo_g + (hi_g - lo_g) * u[0],
                 1.0 + policy.scale_delta * (2 * u[1] - 1),
                 policy.shift_delta * (2 * u[2] - 1)
                 * images.std(dim=red, correction=0))
    seed = torch.tensor([1234], dtype=torch.int64, device=dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = images.to(dtype).contiguous()
        lo, hi = x.float().amin(dim=red), x.float().amax(dim=red)

        def par_for(sigma):
            return torch.stack([lo, hi, *par_draws,
                                torch.full((b,), sigma, device=dev)],
                               dim=1).contiguous()

        name = (f"{str(dtype).split('.')[1]} "
                f"[{b},{','.join(map(str, x.shape[1:-1]))},1]")
        _, tol, err, moments = _k3_against_plain(
            name, x, par_for(0.0), par_for(policy.noise_std), seed)
        out[name] = dict(max_abs_err=err, tol=tol, moments=moments)
    return out


def _finetune_clis(smi, encoder):
    """Phase 23 (c): on 6 cases at 128x128x32, ``segmentation train`` of
    the U-Net with ``--res_config_file sample_configs/ssl-resnet.yaml
    --encoder_checkpoint`` (phase 20's f32 VICReg run), ``--lr_encoder``,
    ``--freeze_regex encoder_backbone/Conv_0`` and
    ``--accumulate_grad_batches 2``, one epoch of 2 steps at B=2 (one
    update): in bf16 with the intensity augmentation, and in f32 with
    ``--resize_size``; ``predict --mc_iterations 2`` and ``test`` (the
    cases resized as in training) on the f32 run. In this process, each
    run's launches counted from 0 against those its recorded K1 calls
    make (K3 where the augmentation ran). The warm start loads a
    non-zero number of leaves, the frozen ones stay bit-equal to the SSL
    checkpoint's, the rest of the encoder moves."""
    import numpy as np
    import torch
    import yaml

    from adell_mri_torch.data.nifti import read_nifti
    from adell_mri_torch.tools.flagship import (
        FLAGSHIP,
        SSL_YAML,
        WINDOW,
        make_model,
    )
    from adell_mri_torch.train.checkpoints import (
        ENCODER_SOURCES,
        subtree_warm_start,
    )

    work = WORK_DIR / "finetune_cli"
    work.mkdir(parents=True)
    ds = _pipeline_cohort(work, WINDOW, (), n_cases=FINETUNE_CLI_CASES)
    unet_yaml = work / "unet.yaml"
    unet_yaml.write_text(yaml.safe_dump(
        {**FLAGSHIP, "norm_type": "batch", "learning_rate": 0.01,
         "loss_fn": {"dice": {}}}))
    loaded = subtree_warm_start(
        make_model(0, torch.float32, name=FINETUNE_NAME), str(encoder),
        "encoder_backbone", ENCODER_SOURCES)
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda"]
    train = ["segmentation", "train", *common, "--image_keys", "image",
             "--mask_keys", "mask", "--config_file", str(unet_yaml),
             "--pad_size", *map(str, WINDOW), "--target_spacing", "0.5",
             "0.5", "3.0", "--batch_size", str(FINETUNE_CLI_BATCH),
             "--n_folds", "1", "--max_epochs", "1", "--seed", "0",
             "--res_config_file", str(SSL_YAML), "--encoder_checkpoint",
             str(encoder), "--lr_encoder", FINETUNE_LR_ENCODER,
             "--freeze_regex", FINETUNE_FROZEN,
             "--accumulate_grad_batches", "2"]
    runs = {p: work / f"run_{p}" for p in ("bf16", "f32")}
    pred = work / "pred"
    out = {}
    for tag, args, steps in (
            ("train_bf16", train + [
                "--precision", "bf16", "--augment", "intensity", "noise",
                "--checkpoint_dir", str(runs["bf16"]),
                "--metric_path", str(work / "m_bf16.csv")], True),
            ("train_f32", train + [
                "--resize_size", *map(str, FINETUNE_RESIZE),
                "--checkpoint_dir", str(runs["f32"]),
                "--metric_path", str(work / "m_f32.csv")], False),
            ("predict_mc_f32", ["segmentation", "predict", *common,
                            "--checkpoint_dir", str(runs["f32"]),
                            "--output_path", str(pred), "--mc_iterations",
                            "2", "--prediction_ids", "case_0", "case_1"],
             False),
            ("test_resized_f32", ["segmentation", "test", *common,
                              "--checkpoint_dir", str(runs["f32"]),
                              "--metric_path", str(work / "t.csv")],
             False)):
        secs, text, counts, want = _counted_cli(args)
        _check_cli_launches(f"finetune {tag}", counts, want, steps)
        out[tag] = dict(seconds=secs, counts=counts)
        if tag == "test_resized_f32":
            out[tag]["result"] = _last_json(text)
    source = torch.load(encoder / "model.pt", weights_only=True)
    checks = {"loaded": loaded}
    for p, run in runs.items():
        got = torch.load(run / "segmentation_fold0" / "model.pt",
                         weights_only=True)

        def kept(k):
            """The leaf ``k`` of the encoder as the SSL run left it."""
            return torch.equal(got[k], source[k.replace(
                "encoder_backbone.", "backbone.ResNetBackbone_0.")])

        frozen = [k for k in got if k.startswith("encoder_backbone.Conv_0.")]
        moved = [k for k in got if k.startswith("encoder_backbone.Residual")
                 and k.endswith(".weight")]
        checks[p] = dict(frozen=len(frozen),
                         frozen_equal=all(kept(k) for k in frozen),
                         moved=sum(not kept(k) for k in moved))
    meta = json.loads((runs["f32"] / "segmentation_fold0" / "metadata.json")
                      .read_text())
    probs = [read_nifti(str(pred / f"case_{i}_prob.nii.gz")).data
             for i in range(2)]
    result = out["test_resized_f32"]["result"]
    ok = (loaded > 0 and all(checks[p]["frozen"] == 2
                             and checks[p]["frozen_equal"]
                             and checks[p]["moved"] > 0 for p in runs)
          and meta["transform_arguments"]["resize_size"] == list(
              FINETUNE_RESIZE)
          and meta["network_config"]["strides"] == [
              2, [2, 2, 1], [2, 2, 1], [2, 2, 2], [2, 2, 2]]
          and all(q.shape == WINDOW and np.isfinite(q).all()
                  and 0 <= q.min() and q.max() <= 1 for q in probs)
          and result["n_cases"] == FINETUNE_CLI_CASES
          and 0 <= result["dice"] <= 1
          and out["train_bf16"]["counts"]["intensity_aug"] > 0)
    log(f"[finetune cli] {smi}: encoder warm start from {encoder.name} "
        f"loads {loaded} leaves; " + "; ".join(
            f"{tag} {r['seconds']:.2f} s, launches {r['counts']}"
            for tag, r in out.items())
        + f"; frozen and moved leaves {checks}; test {result}")
    if not ok:
        raise AssertionError(f"finetune CLIs: {checks}, {result}, "
                             f"{meta['network_config']}")
    return dict(out, checks=checks, ds_cases=len(ds))


def phase_finetune(smi, encoder):
    """Phase 23: the U-Net fine-tuned from an SSL-pretrained ResNet encoder
    (``encoder_unet``: ``ssl-resnet.yaml``'s backbone under
    ``encoder_backbone``) at the flagship's window: served (bf16, f32) as
    phase 18 serves, trained (bf16, f32) with the f32 step against the
    plain path, K3 at its batch, and ``segmentation train`` from phase
    20's SSL checkpoint with the fine-tuning flags, ``predict
    --mc_iterations`` and ``test`` on a resized run."""
    import torch

    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = dict(serving={p: _option_serving(smi, dtype, name=FINETUNE_NAME,
                                           tag=FINETUNE_NAME)
                        for p, dtype in (("bf16", torch.bfloat16),
                                         ("32", torch.float32))})
    lap("serving")
    out["training"] = _finetune_training(smi)
    lap("training")
    out["cli"] = _finetune_clis(smi, encoder)
    lap("cli")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[finetune] phase 23: {out['seconds']:.1f} s ({laps})")
    return out


# -- phase 24: classification_mil ---------------------------------------------

MIL_METHODS = ("standard", "transformer")
MIL_SERVE_BATCH = 2
MIL_TIMED_STEPS = 2
MIL_CLI_CASES = 4
MIL_CLI_BATCH = 2


def _mil_paths(smi):
    """Phase 24 (a): each MIL model of ``transformable-transformer.yaml``
    (the CLI's defaults: a 2D VGG slice encoder, instance norm) served at
    B=2 and trained at the CLI's B=4 on 256x256x64 volumes (128 and 256
    slices of 256x256 through the encoder, 64 tokens a volume), bf16 and
    f32: no hand kernel launches (the 2D convs are ``F.conv2d``, as XLA's
    conv computes them in the JAX package, and 64 tokens are below
    ``FLASH_MIN_TOKENS``), seconds a forward and a step, device share and
    peak memory; the bf16 forward within 5e-2 of the f32 one's
    probabilities; the losses finite."""
    import torch

    from adell_mri_torch.tools.flagship import (
        CASE,
        MIL_BATCH,
        make_catnet_batch,
        make_mil_trainer,
    )

    batch = make_catnet_batch(3, batch=MIL_BATCH, shape=CASE)
    served = batch["image"][:MIL_SERVE_BATCH]
    zero = dict.fromkeys(_launch_counts(), 0)
    out = {}
    for method in MIL_METHODS:
        probs = {}
        for precision in ("32", "bf16"):
            dtype = torch.bfloat16 if precision == "bf16" else torch.float32
            tr = make_mil_trainer(0, precision, method)
            model = tr.model
            weights = {k: v.to(dtype) for k, v in tr.state.params.items()}
            with torch.inference_mode():
                torch.func.functional_call(model.eval(), weights,
                                           (served.to(dtype),))
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                logits = torch.func.functional_call(
                    model, weights, (served.to(dtype),))
                torch.cuda.synchronize()
                serve_s = time.perf_counter() - t0
            serve_launches = _launch_counts()
            probs[precision] = torch.sigmoid(logits.float())
            tr.state, _ = tr.train_step(tr.state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            secs, losses = [], []
            for _ in range(MIL_TIMED_STEPS):
                t0 = time.perf_counter()
                tr.state, metrics = tr.train_step(tr.state, batch)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            launches = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9

            def step():
                tr.state, _ = tr.train_step(tr.state, batch)

            busy, wall = _device_share(step)
            log(f"[mil] {smi}: {method}, {precision}: served B="
                f"{MIL_SERVE_BATCH} at {'x'.join(map(str, CASE))} in "
                f"{serve_s:.4f} s; B={MIL_BATCH} steps "
                f"{', '.join(f'{x:.4f}' for x in secs)} s; device busy "
                f"{busy:.4f} of {wall:.4f} s ({100 * busy / wall:.1f} %); "
                f"peak {peak_gb:.2f} GB; losses {losses}; launches "
                f"{launches}")
            if not (launches == zero and serve_launches == zero
                    and all(abs(x) < float("inf") for x in losses)):
                raise AssertionError(f"mil {method} {precision}: launches "
                                     f"{launches}, losses {losses}")
            out[f"{method}_{precision}"] = dict(
                serve_s=serve_s, seconds_per_step=secs, losses=losses,
                launches=launches, serve_launches=serve_launches,
                peak_memory_gb=peak_gb, device_busy_s=busy, wall_s=wall)
            del tr, model, weights
            torch.cuda.empty_cache()
        err = float((probs["bf16"] - probs["32"]).abs().max())
        log(f"[mil] {method}: bf16 vs f32 served probabilities {err:.3g} "
            "(tol 5e-2)")
        if not err <= 5e-2:
            raise AssertionError(f"mil {method}: bf16 vs f32 {err}")
        out[f"{method}_bf16_vs_f32"] = err
    return out


def _mil_clis(smi):
    """Phase 24 (b): on 4 cases at 256x256x64 (2 with bright ellipsoids,
    label 1), ``classification_mil train`` with
    ``transformable-transformer.yaml`` for each ``--mil_method`` (one
    epoch at B=2), a second ``standard`` run warm-started from the first
    (``--module_paths``) with ``--freeze_module``; ``test`` of each,
    ``predict`` of both standard runs with ``--ensemble mean`` and of the
    transformer in bf16. In this process: no hand kernel launches; the
    frozen slice encoder bit-equal to the first run's; the metrics and
    the probabilities finite."""
    import math

    import torch

    from adell_mri_torch.tools.flagship import CASE, MIL_YAML

    work = WORK_DIR / "mil_cli"
    work.mkdir(parents=True)
    negatives = ("case_1", "case_3", "case_5")
    ds = _pipeline_cohort(work, CASE, negatives, n_cases=MIL_CLI_CASES)
    for pid, entry in ds.items():
        entry["label"] = int(pid not in negatives)
    (work / "ds.json").write_text(json.dumps(ds))
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda"]
    runs = {t: work / f"run_{t}" for t in
            ("standard", "transformer", "frozen")}
    folds = {t: str(r / "mil_fold0") for t, r in runs.items()}

    def train(tag, method, *extra):
        return ["classification_mil", "train", *common, "--image_keys",
                "image", "--config_file", str(MIL_YAML), "--pad_size",
                *map(str, CASE), "--target_spacing", "0.5", "0.5", "3.0",
                "--batch_size", str(MIL_CLI_BATCH), "--n_folds", "1",
                "--max_epochs", "1", "--seed", "0", "--mil_method", method,
                "--checkpoint_dir", str(runs[tag]), "--metric_path",
                str(work / f"m_{tag}.csv"), *extra]

    out, zero = {}, dict.fromkeys(_launch_counts(), 0)
    for tag, args in (
            ("train_standard", train("standard", "standard")),
            ("train_transformer", train("transformer", "transformer")),
            ("train_frozen", train("frozen", "standard", "--module_paths",
                                   folds["standard"], "--freeze_module")),
            ("test_standard", ["classification_mil", "test", *common,
                               "--checkpoint_dir", str(runs["standard"]),
                               "--metric_path", str(work / "t1.csv")]),
            ("test_transformer", ["classification_mil", "test", *common,
                                  "--checkpoint_dir",
                                  str(runs["transformer"]),
                                  "--metric_path", str(work / "t2.csv")]),
            ("predict_ensemble", ["classification_mil", "predict", *common,
                                  "--checkpoint_dir", str(runs["standard"]),
                                  "--checkpoint", folds["standard"],
                                  folds["frozen"], "--ensemble", "mean",
                                  "--output_path", str(work / "ens.json")]),
            ("predict_bf16", ["classification_mil", "predict", *common,
                              "--checkpoint_dir", str(runs["transformer"]),
                              "--precision", "bf16", "--output_path",
                              str(work / "bf16.json")])):
        secs, text, counts = _cli(args)
        if counts != zero:
            raise AssertionError(f"mil {tag} launches {counts}")
        out[tag] = dict(seconds=secs, counts=counts)
        if tag.startswith("test"):
            out[tag]["result"] = _last_json(text)
    weights = {t: torch.load(Path(folds[t]) / "model.pt", weights_only=True)
               for t in ("standard", "frozen")}
    module = [k for k in weights["frozen"] if k.startswith("module.")]
    ens = json.loads((work / "ens.json").read_text())
    bf16 = json.loads((work / "bf16.json").read_text())
    checks = dict(
        frozen=len(module) == 12 and all(torch.equal(
            weights["standard"][k], weights["frozen"][k]) for k in module),
        tests=all(out[t]["result"]["n_cases"] == MIL_CLI_CASES
                  for t in ("test_standard", "test_transformer")),
        ensemble=len(ens) == 3 and all(
            0 <= v <= 1 for r in ens for v in r["predictions"].values()),
        bf16=len(bf16) == MIL_CLI_CASES and all(
            0 <= v <= 1 and not math.isnan(v) for v in bf16.values()))
    log(f"[mil cli] {smi}: " + "; ".join(
        f"{tag} {r['seconds']:.2f} s" + (f" {r['result']}" if "result" in r
                                         else "")
        for tag, r in out.items()) + f"; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"mil CLIs: {checks}")
    return dict(out, checks=checks)


def phase_mil(smi):
    """Phase 24: ``classification_mil`` on
    ``transformable-transformer.yaml``: both MIL models served and
    trained in bf16 and f32, and the mode's CLIs."""
    t0 = time.perf_counter()
    out = dict(paths=_mil_paths(smi))
    t1 = time.perf_counter()
    out["cli"] = _mil_clis(smi)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = {"paths": t1 - t0,
                              "cli": out["seconds"] - (t1 - t0)}
    log(f"[mil] phase 24: {out['seconds']:.1f} s "
        f"({out['seconds_by_part']})")
    return out


# -- phase 25: the deconfounder, SegCatNet, the exporters ---------------------

DECONF_CATS = (3, 2)   # classes of the two categorical confounders
DECONF_FEATURES = 64   # the CLI's --n_features_deconfounder default
DECONF_CLI_BATCH = 2
SEGCAT_BATCH = 2
EXPORT_BATCH = 2
LOGGER_WARNING = "wandb not installed; falling back to CSV only"
# the served deconfounder's and SegCatNet's logits (and surrogates) on the
# kernels against the plain path, as a share of their scale: about 3.5
# and 2 times the largest readings on an H100 80GB HBM3 at 700 W (f32
# 6.4e-6 to 1.4e-5; bf16 1.7e-2 to 1.06e-1, the largest on the 3-class
# surrogate, a few bf16 steps of its small logits)
SERVED_LOGIT_TOL = {"bf16": 2e-1, "32": 5e-5}


def _deconf_batch(seed, batch):
    """``make_catnet_batch`` at 128x128x32 with the two categorical
    confounders (``DECONF_CATS`` classes) and one continuous one, drawn
    from ``seed`` on the card."""
    import torch

    from adell_mri_torch.tools.flagship import make_catnet_batch

    out = make_catnet_batch(seed, batch=batch, shape=CATNET_SHAPE)
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    for i, n in enumerate(DECONF_CATS):
        out[f"cat_conf_{i}"] = torch.randint(0, n, (batch,), generator=g,
                                             device="cuda")
    out["cont_conf"] = torch.randn((batch, 1), generator=g, device="cuda")
    return out


def _deconf_trainer(precision):
    """The deconfounder CLI's model over ``classification-cat-resnet.yaml``
    (``build_deconfounder_model``: its ``resnet_structure``, instance norm,
    the default pools; 2 categorical confounders of 3 and 2 classes, 1
    continuous) from seed 0, with the CLI's step (the parameters alone,
    ``--deconfounder_weight`` 1) in ``precision`` and AdamW."""
    import torch

    from adell_mri_torch.config.parsing import parse_config_cat
    from adell_mri_torch.entrypoints.classification.train import (
        parameters_alone,
    )
    from adell_mri_torch.entrypoints.classification_deconfounder.train import (
        build_deconfounder_model,
        make_deconfounder_step,
    )
    from adell_mri_torch.tools.flagship import CATNET_YAML, Trainer
    from adell_mri_torch.train.optim import get_optimizer
    from adell_mri_torch.train.schedules import cosine_annealing_with_warmup
    from adell_mri_torch.train.state import TrainState
    from adell_mri_torch.train.steps import make_eval_step, make_train_step

    torch.manual_seed(0)
    model = build_deconfounder_model(
        parse_config_cat(str(CATNET_YAML))["network"], DECONF_CATS, 1, 2,
        n_features=DECONF_FEATURES).cuda()
    schedule = cosine_annealing_with_warmup(1e-3, t_max=100)
    state = TrainState.create(
        model, lambda p: get_optimizer("adamw", learning_rate=schedule,
                                       params=p))

    def step(train):
        return parameters_alone(make_deconfounder_step(
            model, 2, 1.0, train, precision), model, train)

    return Trainer(state, make_train_step(step(True)),
                   make_eval_step(step(False)), step(True), None, model)


def _against_plain(forward, tol):
    """``forward()`` (f32 outputs: the logit, then any surrogates' logits
    or values) on the kernels and on the plain path: each output's largest
    difference as a share of the plain output's largest magnitude. The
    logits themselves, not their sigmoid or softmax: an untrained network's
    logits are small, and its probabilities would flatten their
    differences."""
    import torch

    with torch.inference_mode():
        got = forward()
        with plain_kernels():
            want = forward()
    got, want = ([got], [want]) if torch.is_tensor(got) else (got, want)
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]
    if not max(errs) <= tol:
        raise AssertionError(f"kernels vs plain path {errs} (tol {tol})")
    return errs, got


def _deconfounder_paths(smi):
    """Phase 25 (a): the deconfounder network served at B=2 (bf16, f32:
    the logit and the surrogates' logits and value against the plain path
    as a share of their scale, ``SERVED_LOGIT_TOL``;
    ``CATNET_CONVS`` K1 launches a forward) and trained at the yaml's B=16
    on 128x128x32: the f32 step against the plain path (``_step_parity``),
    then one step in each precision with its launches held to the K1 calls
    it records (K1, dx, dW; no augmentation, so no K3), seconds, device
    share and peak memory."""
    import torch

    out = {}
    serve = _deconf_batch(1, SEGCAT_BATCH)["image"]
    batch = _deconf_batch(2, CATNET_BATCH)
    for precision in ("32", "bf16"):
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        tr = _deconf_trainer(precision)
        model = tr.model.eval()
        weights = {k: v.to(dtype) for k, v in model.state_dict().items()}

        def forward():
            logits, cats, cont, _ = torch.func.functional_call(
                model, weights, (serve.to(dtype),))
            return [t.float() for t in (logits, *cats, cont)]

        with torch.inference_mode():
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _k1_calls() as rec, torch.inference_mode():
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = _calls_want(rec.calls, dtype, step=False)
        if not (launches == want and len(rec.calls) == CATNET_CONVS):
            raise AssertionError(f"deconfounder forward launches {launches}, "
                                 f"want {want}")
        tol = SERVED_LOGIT_TOL[precision]
        errs, _ = _against_plain(forward, tol)
        serving = dict(launches=launches, seconds=secs, peak_memory_gb=peak,
                       errors=errs, tol=tol)
        parity = (_step_parity(tr, batch, "deconfounder")
                  if precision == "32" else None)
        tr.model.train()
        with _k1_calls() as rec:
            tr.state, _ = tr.train_step(tr.state, batch)
        want = _calls_want(rec.calls, dtype, step=True)
        want["intensity_aug"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        tr.state, metrics = tr.train_step(tr.state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = _launch_counts()
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        if launches != want or not abs(loss) < float("inf"):
            raise AssertionError(f"deconfounder step launches {launches}, "
                                 f"want {want}; loss {loss}")

        def one_step():
            tr.state, _ = tr.train_step(tr.state, batch)

        busy, wall = _device_share(one_step)
        log(f"[deconfounder] {smi}: {precision}: served B={SEGCAT_BATCH} "
            f"{secs:.4f} s, peak {peak:.2f} GB, launches "
            f"{serving['launches']}, kernels vs plain {errs} of their "
            f"scale (tol {tol}); step B={CATNET_BATCH} "
            f"{step_s:.4f} s, device busy {busy:.4f} of {wall:.4f} s "
            f"({100 * busy / wall:.1f} %), peak {step_peak:.2f} GB, "
            f"launches {launches}, loss {loss:.5f}, decorrelation "
            f"{float(metrics['decorrelation']):.5f}")
        out[precision] = dict(
            serving=serving, parity=parity,
            training=dict(launches=launches, seconds_per_step=[step_s],
                          loss=loss, peak_memory_gb=step_peak,
                          device_busy_s=busy, wall_s=wall))
        del tr, model, weights
        torch.cuda.empty_cache()
    return out


def _segcatnet_paths(smi):
    """Phase 25 (b): SegCatNet over the flagship U-Net (``FLAGSHIP``, seed
    0) at B=2 on 128x128x32: served in bf16 and f32 against the plain path
    (the logit as a share of its scale, ``SERVED_LOGIT_TOL``) with the
    launches of its recorded K1 calls (the U-Net's 31 and the ResNet
    tower's); one f32 step (binary logistic loss, Adam over every
    parameter) whose launches are the U-Net calls' forwards and the
    tower's forward, dx and dW, after which every U-Net parameter has no
    gradient and is bit-equal and every head parameter whose gradient is
    above rounding level (``ROUNDING_GRADIENT`` of the largest) has
    moved."""
    import torch
    import torch.nn.functional as F

    from adell_mri_torch.models.classification.nets import SegCatNet
    from adell_mri_torch.models.segmentation.unet import UNet
    from adell_mri_torch.tools.flagship import FLAGSHIP, make_catnet_batch

    torch.manual_seed(0)
    model = SegCatNet(UNet(**FLAGSHIP)).cuda()
    batch = make_catnet_batch(3, batch=SEGCAT_BATCH, shape=CATNET_SHAPE)
    x = batch["image"]
    out = {}
    model.eval()
    with _k1_calls() as unet_rec, torch.inference_mode():
        model.unet(x, return_features=True)
    n_unet = len(unet_rec.calls)
    for precision in ("32", "bf16"):
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        weights = _catnet_weights(model, dtype)

        def forward():
            return torch.func.functional_call(
                model, weights, (x.to(dtype),)).float()

        with torch.inference_mode():
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _k1_calls() as rec, torch.inference_mode():
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = _calls_want(rec.calls, dtype, step=False)
        if launches != want or len(rec.calls) <= n_unet:
            raise AssertionError(f"segcatnet forward launches {launches}, "
                                 f"want {want}")
        tol = SERVED_LOGIT_TOL[precision]
        errs, _ = _against_plain(forward, tol)
        out[precision] = dict(launches=launches, seconds=secs,
                              peak_memory_gb=peak, errors=errs, tol=tol,
                              k1_calls=len(rec.calls), unet_calls=n_unet)
        log(f"[segcatnet] {smi}: {precision} served B={SEGCAT_BATCH}: "
            f"{secs:.4f} s, peak {peak:.2f} GB, {len(rec.calls)} K1 calls "
            f"({n_unet} the U-Net's), launches {launches}, kernels vs "
            f"plain {errs} of its scale (tol {tol})")
    model.train()
    unet_before = {k: v.detach().clone()
                   for k, v in model.unet.named_parameters()}
    heads_before = {k: v.detach().clone() for k, v in model.named_parameters()
                    if not k.startswith("unet.")}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _k1_calls() as rec:
        t0 = time.perf_counter()
        logits = model(x)[:, 0]
        loss = F.binary_cross_entropy_with_logits(logits, batch["label"])
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = _calls_want(rec.calls[:n_unet], torch.float32, step=False)
    for k, v in _calls_want(rec.calls[n_unet:], torch.float32,
                            step=True).items():
        want[k] += v
    want["intensity_aug"] = 0
    grads = [k for k, p in model.unet.named_parameters()
             if p.grad is not None]
    moved_unet = [k for k, p in model.unet.named_parameters()
                  if not torch.equal(p.detach(), unet_before[k])]
    params = dict(model.named_parameters())
    moved = [k for k, v in heads_before.items()
             if not torch.equal(params[k].detach(), v)]
    # the head parameters whose gradient is above rounding level must move
    largest = max(float(params[k].grad.abs().max()) for k in heads_before
                  if params[k].grad is not None)
    live = [k for k in heads_before if params[k].grad is not None
            and float(params[k].grad.abs().max())
            >= ROUNDING_GRADIENT * largest]
    log(f"[segcatnet] {smi}: f32 step B={SEGCAT_BATCH}: {secs:.4f} s, peak "
        f"{peak:.2f} GB, launches {launches}, loss {loss:.5f}; U-Net "
        f"parameters with a gradient {len(grads)}, moved {len(moved_unet)} "
        f"of {len(unet_before)}; head parameters moved {len(moved)} of "
        f"{len(heads_before)} ({len(live)} with a gradient above "
        f"{ROUNDING_GRADIENT} of the largest)")
    if launches != want:
        raise AssertionError(f"segcatnet step launches {launches}, want "
                             f"{want}")
    if grads or moved_unet or not live or set(live) - set(moved):
        raise AssertionError(f"segcatnet step: U-Net gradients {grads}, "
                             f"moved {moved_unet}; heads moved {moved}")
    out["step_f32"] = dict(launches=launches, seconds=secs,
                           peak_memory_gb=peak, loss=loss,
                           unet_parameters=len(unet_before),
                           heads_moved=len(moved),
                           heads_parameters=len(heads_before))
    del model, opt
    torch.cuda.empty_cache()
    return out


def _deconfounder_clis(smi):
    """Phase 25 (c): on phase 17's 6 cases at 128x128x32, with a
    categorical confounder of 3 values and one of 2 and a continuous one:
    ``classification_deconfounder train`` (the yaml, f32, one epoch at B=2
    and one validation case), ``test`` and ``predict`` on its checkpoint,
    then ``predict`` again on the plain path (the probabilities and the
    continuous surrogates within 1e-3); ``classification train
    --logger_type wandb`` (the yaml, one epoch at B=2) warns and writes
    its metric CSV. Where wandb is installed its ``init`` needs an
    account and the network, which a smoke run must not use, so the run
    hides it (``sys.modules["wandb"] = None``: the import fails, as where
    it is not installed). Every run's launches against the K1 calls
    recorded around it, no K3 (no augmentation)."""
    import logging

    from adell_mri_torch.tools.flagship import CATNET_YAML

    work = WORK_DIR / "deconfounder_cli"
    work.mkdir(parents=True)
    ds = json.loads((WORK_DIR / "catnet_cli" / "ds.json").read_text())
    for i, pid in enumerate(sorted(ds)):
        ds[pid].update(scanner="abc"[i % 3], site="xy"[i // 3 % 2],
                       age=50.0 + 3 * i)
    (work / "ds.json").write_text(json.dumps(ds))
    ckpt = work / "ckpt"
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda",
              "--checkpoint_dir", str(ckpt)]
    runs = {}
    runs["train"] = _counted_cli([
        "classification_deconfounder", "train", *common,
        "--image_keys", "image", "--cat_confounder_keys", "scanner", "site",
        "--cont_confounder_keys", "age", "--config_file", str(CATNET_YAML),
        "--pad_size", *map(str, CATNET_SHAPE),
        "--target_spacing", "0.5", "0.5", "3.0",
        "--batch_size", str(DECONF_CLI_BATCH), "--max_epochs", "1",
        "--n_folds", "1", "--seed", "0",
        "--metric_path", str(work / "metrics.csv")])
    meta = json.loads((ckpt / "deconfounder_fold0" / "metadata.json")
                      .read_text())
    if meta["cat_confounder_cards"] != list(DECONF_CATS) or meta[
            "n_features_deconfounder"] != DECONF_FEATURES:
        raise AssertionError(f"deconfounder train wrote {meta}")
    runs["test"] = _counted_cli([
        "classification_deconfounder", "test", *common,
        "--metric_path", str(work / "test.csv")])
    result = _last_json(runs["test"][1])
    if result["n_cases"] != CATNET_CLI_CASES or not 0 <= result["auc"] <= 1:
        raise AssertionError(f"deconfounder test: {result}")
    preds = {}
    for tag in ("predict", "predict_plain"):
        path = work / f"{tag}.json"
        ctx = plain_kernels if tag == "predict_plain" else (
            contextlib.nullcontext)
        with ctx():
            runs[tag] = _counted_cli([
                "classification_deconfounder", "predict", *common,
                "--output_path", str(path)])
        preds[tag] = json.loads(path.read_text())
    got, want = preds["predict"], preds["predict_plain"]
    errs = [max(abs(got[p]["prediction"] - want[p]["prediction"]),
                *(abs(a - b) for a, b in zip(got[p]["cont_surrogates"],
                                             want[p]["cont_surrogates"])))
            for p in want]
    agree = sum(got[p]["cat_surrogates"] == want[p]["cat_surrogates"]
                for p in want)
    if sorted(got) != sorted(ds) or not max(errs) <= 1e-3 or not all(
            0 <= v["prediction"] <= 1 and len(v["cat_surrogates"]) == 2
            for v in got.values()):
        raise AssertionError(f"deconfounder predict {got} vs plain {want}")
    handler = logging.Handler(logging.WARNING)
    warned = []
    handler.emit = lambda record: warned.append(record.getMessage())
    metric_log = logging.getLogger("adell_mri_torch.train.logging_utils")
    metric_log.addHandler(handler)
    hidden = sys.modules.get("wandb", False)
    sys.modules["wandb"] = None
    try:
        runs["logger_train"] = _counted_cli([
            "classification", "train", *common[:4],
            "--checkpoint_dir", str(work / "ckpt_logger"),
            "--image_keys", "image", "--config_file", str(CATNET_YAML),
            "--pad_size", *map(str, CATNET_SHAPE),
            "--target_spacing", "0.5", "0.5", "3.0",
            "--batch_size", str(DECONF_CLI_BATCH), "--max_epochs", "1",
            "--n_folds", "1", "--seed", "0", "--logger_type", "wandb",
            "--metric_path", str(work / "metrics_logger.csv")])
    finally:
        metric_log.removeHandler(handler)
        if hidden is False:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = hidden
    rows = (work / "metrics_logger.csv").read_text().splitlines()
    if warned != [LOGGER_WARNING] or len(rows) < 2:
        raise AssertionError(f"--logger_type wandb: warnings {warned}, "
                             f"{len(rows)} CSV lines")
    out = {}
    for tag, (secs, _, counts, want_counts) in runs.items():
        if tag == "predict_plain":
            if counts["conv3d_igemm"]:
                raise AssertionError(f"plain predict launched {counts}")
        else:
            _check_cli_launches(f"deconfounder {tag}", counts, want_counts,
                                steps=False)
        out[tag] = dict(seconds=secs, counts=counts)
    log(f"[deconfounder cli] {smi}: " + "; ".join(
        f"{tag} {r['seconds']:.2f} s, launches {r['counts']}"
        for tag, r in out.items())
        + f"; test {result}; predictions vs plain path max {max(errs):.3g} "
        f"(tol 1e-3), categorical surrogates agree in {agree} of "
        f"{len(want)}; --logger_type wandb warned {warned} and wrote "
        f"{len(rows) - 1} metric rows")
    return dict(runs=out, test_result=result, predict_vs_plain=max(errs),
                cat_surrogates_agree=agree, logger_warnings=warned,
                logger_csv_rows=len(rows) - 1)


def _served_export(tag, args, build, x, flash=0):
    """``args`` (an exporter CLI) writes an artifact, which is loaded here
    and run on ``x``: its output against the live model's (``build()``,
    its forward as the artifact's) within 1e-5 of their scale (f32), its
    launches equal to the live model's, which equal those of the live
    model's recorded K1 calls and ``flash`` attention forwards; the
    export itself launches nothing."""
    import torch

    from adell_mri_torch.train.export import adell_ops, load_exported

    secs, _, counts = _cli(args)
    if any(counts.values()):
        raise AssertionError(f"{tag} export launched {counts}")
    path = args[args.index("--output_path") + 1]
    load_s = time.perf_counter()
    fn, meta = load_exported(path)
    ops = adell_ops(torch.export.load(path))
    load_s = time.perf_counter() - load_s
    live = build()
    with torch.inference_mode():
        fn(x)
        live(x)
    torch.cuda.synchronize()
    _reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = fn(x)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = _launch_counts()
    _reset_counts()
    with _k1_calls() as rec, torch.inference_mode():
        t0 = time.perf_counter()
        want = live(x)
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
    live_launches = _launch_counts()
    calls_want = _calls_want(rec.calls, torch.float32, step=False)
    calls_want["flash_attention_fwd"] = flash
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)
    log(f"[export] {tag}: export {secs:.2f} s ({os.path.getsize(path)} "
        f"bytes, ops {ops}), load {load_s:.2f} s; artifact {run_s:.4f} s, "
        f"live {live_s:.4f} s a forward of {tuple(x.shape)}; launches "
        f"{launches}, live {live_launches}; artifact vs live "
        f"{err:.3g} of the scale (tol 1e-5); sidecar {sorted(meta)}")
    if not (launches == live_launches == calls_want and err <= 1e-5
            and list(meta["input_shape"]) == list(x.shape)
            and (launches["conv3d_igemm"] > 0 or flash)):
        raise AssertionError(f"{tag} artifact: launches {launches}, live "
                             f"{live_launches}, want {calls_want}; error "
                             f"{err}; sidecar {meta}")
    return dict(export_s=secs, load_s=load_s, seconds=run_s,
                live_seconds=live_s, launches=launches, max_rel_err=err,
                ops=ops, bytes=os.path.getsize(path))


def _exports(smi):
    """Phase 25 (d): ``ssl model_to_export`` of phase 20's f32 VICReg
    checkpoint and ``classification model_to_export`` of phase 17's
    CatNet (``model_to_torchscript``, the other spelling; the parameters
    alone, as the JAX exporter applies them: batch statistics of the
    batch) and of phase 21's ViT classifier at 256x256x64 (4097 tokens),
    each at B=2 in f32 on the card (``_served_export``)."""
    import torch

    from adell_mri_torch.config.factories import (
        get_classification_network,
        get_ssl_network,
    )
    from adell_mri_torch.models.layers.adn import batch_statistics_mode
    from adell_mri_torch.tools.flagship import CASE, make_catnet_batch
    from adell_mri_torch.train.checkpoints import CheckpointManager

    work = WORK_DIR / "exports"
    work.mkdir(parents=True)
    out = {}

    def loaded(root, name, make):
        mngr = CheckpointManager(str(root), name=name, fold=0)
        meta = mngr.load_metadata()
        model = make(meta)
        model.load_state_dict(mngr.load_state_dict())
        return model.cuda().eval()

    ssl_root = WORK_DIR / "ssl_cli" / "ckpt_vicreg_f32"
    out["ssl"] = _served_export(
        "ssl vicreg", ["ssl", "model_to_export", "--checkpoint_dir",
                       str(ssl_root), "--output_path",
                       str(work / "ssl.pt2"), "--batch_size",
                       str(EXPORT_BATCH), "--dev", "cuda"],
        lambda: loaded(ssl_root, "ssl_vicreg", lambda m: get_ssl_network(
            "vicreg", m["network_config"], image_size=tuple(
                m["transform_arguments"]["target_size"]))),
        make_catnet_batch(6, batch=EXPORT_BATCH, shape=SSL_CLI_SHAPE)[
            "image"])

    def classifier(root, shape):
        model = loaded(root, "classification",
                       lambda m: get_classification_network(
                           m["net_type"], m["network_config"],
                           n_classes=m["n_classes"], image_size=shape))

        def forward(x):
            with batch_statistics_mode(model):
                return model(x)

        return forward

    for tag, root, shape, flash, mode in (
            ("catnet", WORK_DIR / "catnet_cli" / "ckpt", CATNET_SHAPE, 0,
             "model_to_torchscript"),
            ("vit", WORK_DIR / "new_classifier_cli" / "ckpt_vit", CASE,
             VIT_BLOCKS, "model_to_export")):
        out[tag] = _served_export(
            f"classification {tag}", [
                "classification", mode, "--checkpoint_dir", str(root),
                "--output_path", str(work / f"{tag}.pt2"), "--batch_size",
                str(EXPORT_BATCH), "--dev", "cuda"],
            lambda root=root, shape=shape: classifier(root, shape),
            make_catnet_batch(7, batch=EXPORT_BATCH, shape=shape)["image"],
            flash=flash)
    torch.cuda.empty_cache()
    return out


def phase_deconfounder_export(smi):
    """Phase 25: the deconfounder network and SegCatNet at full width, the
    ``classification_deconfounder`` CLIs and the experiment logger's CSV
    fallback, and the exported artifacts of an SSL encoder, a CatNet and
    the ViT classifier run on the card."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(part):
        now = time.perf_counter()
        laps[part] = now - last[0]
        last[0] = now

    out = {"deconfounder": _deconfounder_paths(smi)}
    lap("deconfounder")
    out["segcatnet"] = _segcatnet_paths(smi)
    lap("segcatnet")
    out["cli"] = _deconfounder_clis(smi)
    lap("cli")
    out["exports"] = _exports(smi)
    lap("exports")
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = laps
    log(f"[deconfounder, segcatnet, export] phase 25: "
        f"{out['seconds']:.1f} s ({laps})")
    return out


# -- phase 26: VICRegL, DINO with local crops, iBOT and MAE --------------------

SSL_NEW_METHODS = ("vicregl", "dino", "ibot", "mae")
SSL_NEW_PARITY_BATCH = 2
SSL_NEW_TIMED_STEPS = 2
SSL_NEW_CLI_CASES = 4
SSL_NEW_CLI_BATCH = 2
# the attention launches of one step (forward, dQ, dK/dV): DINO and iBOT
# run the teacher's two views (forwards alone) and the student's two (with
# gradient) through 4 blocks at 3456 tokens (DINO's 432-token local crops
# take the materialised softmax); MAE its 4 encoder blocks at 2048 visible
# tokens and 2 decoder blocks at 8192
SSL_NEW_FLASH = {"dino": (16, 8, 8), "ibot": (16, 8, 8), "mae": (6, 6, 6)}
# K1 forwards of one VICRegL step: the backbone's 7 convs on each view
SSL_VICREGL_K1 = 14


def _method_batch(tr, method, volumes, gen):
    """A step's batch for ``method`` from ``volumes`` (``image``): the
    views (with their matrices for VICRegL, DINO's local crops), or the
    volumes for MAE; iBOT's masks and MAE's noise drawn into it, so that
    the kernels' and the plain path's runs of one batch take the same
    draws."""
    import torch

    from adell_mri_torch.models.layers.vit import patchify

    if method == "mae":
        n = patchify(volumes["image"][:1], tr.model.patch).shape[1]
        return {"image": volumes["image"], "noise": torch.rand(
            (volumes["image"].shape[0], n), generator=gen, device="cuda")}
    batch = tr.transforms.augment(gen, volumes)
    if method == "ibot":
        for i in ("1", "2"):
            batch[f"masks{i}"] = tr.model.draw_masks(batch[f"view{i}"], gen)
    return batch


def _centred_parity(tr, batch, tag):
    """``_step_parity`` of a step whose metrics carry DINO's or iBOT's
    centres: the step's new centres on the kernels within 1e-4 of their
    scale of the plain path's, beside the loss, gradient norm and
    direction."""
    import dataclasses

    seen = []

    def loss_and_metrics(params, b, ema_params=None):
        loss, metrics = tr.loss_and_metrics(params, b, ema_params)
        metrics = dict(metrics)
        seen.append(metrics.pop("_variables", {}))
        return loss, metrics

    out = _step_parity(dataclasses.replace(
        tr, loss_and_metrics=loss_and_metrics), batch, tag)
    errs = {k: float((v - seen[1][k]).abs().max()) / max(
        float(seen[1][k].abs().max()), 1e-30) for k, v in seen[0].items()}
    log(f"  {tag}: centres vs plain path {errs} of their scale (tol 1e-4)")
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"{tag}: centres disagree with plain: {errs}")
    out["centres_rel"] = errs
    return out


def _method_steps(smi, method):
    """Phase 26 (a): ``method`` on ``ssl-resnet.yaml``'s training settings
    (B=28; views of 96x96x24 from 128x128x32 volumes, DINO with 4 local
    crops of 48x48x12; MAE on the volumes), f32 then bf16: the f32 step
    against the plain path at B=2 (``_step_parity``; DINO's and iBOT's
    centres too), then, on one batch of views, a recorded warm-up step
    and 2 timed steps with the launches of the recorded K1 and flash calls
    (pinned: ``SSL_VICREGL_K1``, ``SSL_NEW_FLASH``), peak memory and the
    device's busy share of the second timed step."""
    import torch

    from adell_mri_torch.tools.flagship import make_ssl_batch, make_ssl_trainer

    volumes = make_ssl_batch(26)
    out = {}
    for precision in ("32", "bf16"):
        tr = make_ssl_trainer(0, precision, method)
        gen = torch.Generator(device="cuda").manual_seed(26)
        parity = None
        if precision == "32":
            small = {"image": volumes["image"][:SSL_NEW_PARITY_BATCH]}
            parity = _centred_parity(
                tr, _method_batch(tr, method, small, gen),
                f"{method} B={SSL_NEW_PARITY_BATCH}")
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = _method_batch(tr, method, volumes, gen)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        with _k1_calls() as rec, _flash_calls() as frec:
            tr.state, _ = tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        flash = frec.want()
        pinned = dict(zip(flash, SSL_NEW_FLASH.get(method, (0, 0, 0))))
        k1 = len(rec.calls)
        if flash != pinned or k1 != (SSL_VICREGL_K1 if method == "vicregl"
                                     else 0):
            raise AssertionError(f"{method}: a step records {flash} flash "
                                 f"and {k1} K1 calls, want {pinned}")
        want = _scaled(_ssl_want(rec, flash), SSL_NEW_TIMED_STEPS)
        _reset_counts()
        losses = []

        def step():
            tr.state, metrics = tr.train_step(tr.state, batch)
            losses.append(float(metrics["loss"]))

        # the last timed step runs under the profiler (the device alone is
        # traced) and gives the busy share
        secs = []
        for _ in range(SSL_NEW_TIMED_STEPS - 1):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        busy, wall = _device_share(step)
        secs.append(wall)
        launches = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        centres = {k: float(v.abs().max()) for k, v in
                   tr.state.variables.items() if "center" in k}
        log(f"[ssl {method}] {smi}: {precision}, B={SSL_BATCH}: "
            f"{', '.join(f'{x:.4f}' for x in secs)} s per step (the batch's "
            f"views drawn once, {batch_s:.3f} s); device busy {busy:.4f} of "
            f"{wall:.4f} s ({100 * busy / wall:.1f} %); peak {peak_gb:.2f} "
            f"GB; {k1} K1 and {sum(c[2] for c in rec.calls)} dx a step, "
            f"flash {flash}; launches {launches}; losses {losses}; largest "
            f"centre element {centres}")
        if launches != want:
            raise AssertionError(f"{method} {precision} step launches "
                                 f"{launches}, want {want}")
        if not all(abs(x) < float("inf") for x in losses) or not all(
                0 < v < float("inf") for v in centres.values()):
            raise AssertionError(f"{method}: losses {losses}, centres "
                                 f"{centres}")
        out[precision] = dict(
            launches=launches, k1_convs=k1, flash_per_step=flash,
            seconds_per_step=secs, batch_s=batch_s, losses=losses,
            peak_memory_gb=peak_gb, device_busy_s=busy, wall_s=wall,
            parity=parity)
        del tr, batch
        torch.cuda.empty_cache()
    return out


def _method_clis(smi):
    """Phase 26 (b): ``ssl train`` in this process on a seeded 4-case
    128x128x32 cohort at ``--batch_size 2`` (one epoch of 2 steps on
    ``--random_crop_size 96 96 24``): DINO with ``--n_local_crops 2`` in
    bf16 and VICRegL in f32, each under ``torch.profiler`` with the
    launch counts set to 0 just before it, against the launches of the K1
    and flash calls recorded around it; the checkpoints hold DINO's centre
    and VICRegL's untouched running statistics."""
    import torch

    from adell_mri_torch.tools.flagship import SSL_YAML

    work = WORK_DIR / "ssl_methods_cli"
    work.mkdir(parents=True)
    _pipeline_cohort(work, SSL_CLI_SHAPE, (), n_cases=SSL_NEW_CLI_CASES)
    common = ["--dataset_json", str(work / "ds.json"), "--dev", "cuda",
              "--image_keys", "image", "--config_file", str(SSL_YAML),
              "--pad_size", *map(str, SSL_CLI_SHAPE),
              "--target_spacing", "0.5", "0.5", "3.0",
              "--batch_size", str(SSL_NEW_CLI_BATCH), "--max_epochs", "1",
              "--seed", "0", "--random_crop_size", *map(str, SSL_CLI_CROP)]
    runs = {}
    for tag, method, precision, extra in (
            ("dino_bf16", "dino", "bf16", ["--n_local_crops", "2"]),
            ("vicregl_f32", "vicregl", "32", [])):
        ckpt = work / f"ckpt_{tag}"
        args = ["ssl", "train", *common, "--ssl_method", method,
                "--precision", precision, "--checkpoint_dir", str(ckpt),
                "--metric_path", str(work / f"metrics_{tag}.csv"), *extra]
        got = []
        torch.cuda.reset_peak_memory_stats()
        with _k1_calls() as rec, _flash_calls() as frec:
            busy, wall = _device_share(lambda: got.append(_cli(args)))
        secs, _, counts = got[0]
        want = _ssl_want(rec, frec.want())
        last = torch.load(ckpt / f"ssl_{method}_fold0" / "last.pt",
                          weights_only=True)
        variables = last["variables"]
        kept = (float(variables["dino_center"].abs().max()) > 0
                if method == "dino" else all(
                    bool((v == (0.0 if k.endswith(".mean") else 1.0)).all())
                    for k, v in variables.items()))
        runs[tag] = dict(seconds=secs, device_busy_s=busy, wall_s=wall,
                         peak_memory_gb=torch.cuda.max_memory_allocated()
                         / 1e9, counts=counts, step=last["step"])
        if not (counts == want and last["step"] == SSL_NEW_CLI_CASES //
                SSL_NEW_CLI_BATCH and kept):
            raise AssertionError(f"ssl {tag}: launches {counts}, want "
                                 f"{want}; step {last['step']}; variables "
                                 f"as expected {kept}")
        flash_on = counts["flash_attention_fwd"] > 0
        k1_on = counts["conv3d_igemm"] > 0 and counts[
            "conv3d_igemm_dx"] > 0
        if not (flash_on if method == "dino" else k1_on):
            raise AssertionError(f"ssl {tag}: no kernel launched {counts}")
    log(f"[ssl methods cli] {smi}: " + "; ".join(
        f"{tag} {r['seconds']:.2f} s under the profiler, device busy "
        f"{r['device_busy_s']:.2f} s "
        f"({100 * r['device_busy_s'] / r['wall_s']:.1f} %), peak "
        f"{r['peak_memory_gb']:.2f} GB, launches {r['counts']}"
        for tag, r in runs.items()))
    return runs


def phase_ssl_methods(smi):
    """Phase 26: VICRegL, DINO with local crops, iBOT and MAE at full
    width on ``ssl-resnet.yaml``'s training settings, f32 and bf16, and
    the ``ssl train`` CLI for DINO and VICRegL."""
    t0 = time.perf_counter()
    out = {"seconds_by_part": {}}
    for method in SSL_NEW_METHODS:
        t = time.perf_counter()
        out[method] = _method_steps(smi, method)
        out["seconds_by_part"][method] = time.perf_counter() - t
    t = time.perf_counter()
    out["cli"] = _method_clis(smi)
    out["seconds_by_part"]["cli"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0
    log(f"[ssl methods] phase 26: {out['seconds']:.1f} s "
        f"({out['seconds_by_part']})")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "adell_mri_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no adell_mri_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from adell_mri_torch.tools.flagship import make_model

    t_start = time.perf_counter()
    # wall seconds of each phase, by its number
    phase_s, last = {}, [t_start]

    def lap(*phases):
        now = time.perf_counter()
        phase_s["+".join(map(str, phases))] = now - last[0]
        last[0] = now

    # what the CLI runs with: phase 3 turns TF32 off for the rest of the
    # script
    tf32_defaults = dict(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32)
    kind, smi = phase_device()
    build_s = phase_build()
    lap(1, 2)
    kernel_rows = phase_kernels()
    lap(3)
    model = make_model(0, torch.bfloat16)
    serving = phase_serving(model)
    case = serving.pop("case")
    # the CLI's default precision, f32
    serving_f32 = phase_serving(make_model(0, torch.float32), case)
    serving_f32.pop("case")
    window_rows, shapes = phase_window_batch(model, case)
    path_rows, totals, f32_path_rows, f32_totals, tf32_totals = (
        phase_path_shapes(shapes))
    lap(4)
    cli = phase_cli(model)
    lap(5)
    intensity_rows = phase_intensity()
    lap(6)
    bwd_rows, dx_totals = phase_conv_backward(shapes)
    lap(7)
    training = phase_training()
    lap(8)
    train_cli = phase_train_cli()
    lap(9)
    attention_rows, attention = phase_attention()
    lap(10)
    unetr_serving = phase_unetr_serving(torch.bfloat16)
    # the CLI's default precision, f32
    unetr_serving_f32 = phase_unetr_serving(torch.float32)
    lap(11)
    unetr_training = phase_unetr_training()
    lap(12)
    unetr_cli = phase_unetr_cli()
    lap(13)
    pipeline = phase_flagship_pipeline(smi)
    lap(14)
    augmentation = phase_full_augmentation(smi)
    lap(15)
    swin = phase_swin(smi)
    lap(16)
    catnet = phase_catnet(smi, tf32_defaults)
    lap(17)
    options = phase_unet_options(smi)
    lap(18)
    classifiers = phase_classifiers(smi)
    lap(19)
    ssl = phase_ssl(smi)
    lap(20)
    new_classifiers = phase_new_classifiers(smi)
    lap(21)
    gp_ensemble = phase_gp_ensemble(smi)
    lap(22)
    # phase 20's f32 VICReg run on ssl-resnet.yaml is the encoder checkpoint
    finetune = phase_finetune(smi, WORK_DIR / "ssl_cli" / "ckpt_vicreg_f32"
                              / "ssl_vicreg_fold0")
    lap(23)
    mil = phase_mil(smi)
    lap(24)
    deconf = phase_deconfounder_export(smi)
    lap(25)
    ssl_methods = phase_ssl_methods(smi)
    lap(26)
    log(f"[phases] wall s: {phase_s}")

    def entry(name, source, replaces, launches, row, per, library_ms):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "tol": row["tol"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms, "per": per,
            **({"warm_ms": row["warm_ms"]} if "warm_ms" in row else {}),
        }

    # launches of each main path, counted from 0 just before it was driven;
    # the f32 paths are the CLI's default precision
    by_path = {
        "unet_serving": serving["counts"],
        "unet_serving_f32": serving_f32["counts"],
        "unet_training": training["launches"],
        "unet_training_f32": training["f32"]["launches"],
        "unetr_serving": unetr_serving["launches"],
        "unetr_serving_f32": unetr_serving_f32["launches"],
        "unetr_training": unetr_training["launches"],
        "unetr_training_f32": unetr_training["f32_parity"]["launches"],
        # phase 14: crop steps (bf16), the train CLI and its resume (f32),
        # test in f32 and bf16, predict with and without --extract_lesions
        "flagship_crop_steps": pipeline["crop_step"]["counts"],
        "flagship_train_f32": pipeline["train_counts"],
        "flagship_resume_f32": pipeline["resume_counts"],
        "flagship_test_f32": pipeline["test"]["f32"]["counts"],
        "flagship_test_bf16": pipeline["test"]["bf16"]["counts"],
        "flagship_predict_f32": pipeline["predict"]["prob"]["counts"],
        "flagship_predict_lesions_f32":
            pipeline["predict"]["lesions"]["counts"],
        # phase 15: crop steps with four and with ten flags, bf16 and f32,
        # and the train CLI with every data key, then again from the cache
        **{f"augment_crop_steps_{n}_flags_{p}": augmentation["steps"][p][n][
            "counts"] for p in ("bf16", "f32") for n in ("four", "ten")},
        "augment_train_cli_f32": augmentation["train_cli"][0]["counts"],
        "augment_train_cli_cached_f32":
            augmentation["train_cli"][1]["counts"],
        # phase 16: UNETR at head dim 16 (bf16), SWIN-UNet's served case
        # and steps (bf16, f32, with the heads) and its CLIs (f32)
        "unetr_head_dim_16": swin["flash"]["unetr"]["launches"],
        "swin_serving": swin["serving"]["bf16"]["launches"],
        "swin_serving_f32": swin["serving"]["f32"]["launches"],
        "swin_training": swin["training"]["bf16"]["launches"],
        "swin_training_f32": swin["training"]["32"]["launches"],
        "swin_heads_step": swin["training"]["heads_bf16"]["launches"],
        "swin_heads_step_f32": swin["training"]["heads_32"]["launches"],
        **{f"swin_{what}_{tag}_f32": swin["cli"][tag][f"{what}_counts"]
           for tag in ("plain", "heads")
           for what in ("train", "predict", "test")},
        # phase 17: CatNet served (B=2) and trained (B=16) in bf16 and f32,
        # and its CLIs (f32)
        "catnet_serving": catnet["serving"]["bf16"]["launches"],
        "catnet_serving_f32": catnet["serving"]["32"]["launches"],
        "catnet_training": catnet["training"]["bf16"]["launches"],
        "catnet_training_f32": catnet["training"]["32"]["launches"],
        **{f"catnet_{what}_f32": catnet["cli"][f"{what}_counts"]
           for what in ("train", "test", "predict")},
        # phase 18: u-net-3d-resnet.yaml served (bf16, f32) and trained (3
        # steps each), its CLIs; the CLI's U-Net defaults with instance and
        # batch norm, and each other conv and link type: a step and a
        # served case each (f32)
        "resnet_serving": options["serving"]["bf16"]["launches"],
        "resnet_serving_f32": options["serving"]["f32"]["launches"],
        "resnet_training": options["training"]["bf16"]["launches"],
        "resnet_training_f32": options["training"]["32"]["launches"],
        "resnet_train_f32": options["cli"]["train_counts"],
        "resnet_predict_f32": options["cli"]["predict_counts"],
        "resnet_test_f32": options["cli"]["test"]["32"]["counts"],
        "resnet_test_bf16": options["cli"]["test"]["bf16"]["counts"],
        **{f"unet_{tag}_{what}_f32": v[what]["launches"]
           for tag, v in options["variants"].items()
           for what in ("step", "serving")},
        # phase 19: VGG, the ConvNeXt CatNet and the standalone ConvNeXt
        # served (B=2) and trained (2 bf16 steps, 1 f32 step) in bf16 and
        # f32, and the CLIs with clinical features (the ConvNeXt CatNet in
        # f32, VGG in bf16)
        **{f"{name}_{what}{'' if p == 'bf16' else '_f32'}":
           classifiers[name][what][p]["launches"]
           for name in CLASSIFIER_NAMES for what in ("serving", "training")
           for p in ("bf16", "32")},
        **{f"{name}_clinical_{what}_{precision}":
           classifiers["cli"][name][what]["counts"]
           for name, precision in (("catnet_convnext", "f32"),
                                   ("vgg", "bf16"))
           for what in ("train", "test", "predict")},
        # phase 20: VICReg (2 steps each) and I-JEPA (2 steps each) at B=28
        # in bf16 and f32, a BYOL step in each, the served representation
        # (bf16, f32), and the ssl CLIs
        "ssl_vicreg_training": ssl["two_view"]["bf16"]["launches"],
        "ssl_vicreg_training_f32": ssl["two_view"]["32"]["launches"],
        "ssl_byol_step": ssl["byol"]["bf16"]["launches"],
        "ssl_byol_step_f32": ssl["byol"]["32"]["launches"],
        "ssl_ijepa_training": ssl["ijepa"]["bf16"]["launches"],
        "ssl_ijepa_training_f32": ssl["ijepa"]["32"]["launches"],
        "ssl_serving": ssl["serving"]["bf16"]["launches"],
        "ssl_serving_f32": ssl["serving"]["32"]["launches"],
        **{f"ssl_train_{tag}": ssl["cli"][tag]["counts"]
           for tag in ("vicreg_f32", "byol_bf16", "ijepa_bf16")},
        "ssl_predict_folder_f32": ssl["cli"]["predict_folder_f32"]["counts"],
        # phase 21: the ViT classifier served (B=2, 256x256x64) and trained
        # with dropout 0 there (2 bf16 steps and its 5 on one batch, 1 f32
        # step) and with its dropout 0.1 on crops; the factorized ViT,
        # OrdNet and the U-Net encoder classifier served (B=2) and trained
        # (2 bf16 steps, 1 f32 step); the CLIs of the four net types
        **{f"{name}_{what}{'' if p == 'bf16' else '_f32'}":
           new_classifiers[name][what][p]["launches"]
           for name in ("vit",) + NEW_CLASSIFIERS
           for what in ("serving", "training") for p in ("bf16", "32")},
        **{f"vit_crops_training{'' if p == 'bf16' else '_f32'}":
           new_classifiers["vit_crops"]["training"][p]["launches"]
           for p in ("bf16", "32")},
        **{f"{tag}_cli_{what}_{'f32' if run['precision'] == '32' else 'bf16'}":
           run[what]["counts"]
           for tag, run in new_classifiers["cli"].items()
           for what in run if what == "train" or what == "test"
           or what.startswith("predict_")},
        # phase 22: the GP CatNet served (B=2) and trained (2 bf16 steps, 1
        # f32 step at B=16), its covariance fitted over 3 batches, two
        # accumulated micro-steps and a frozen step (f32), its CLIs (f32:
        # train, the warm-started run, test, predict with --ensemble and
        # with sets) and the ensemble's CLIs (f32)
        **{f"catnet_gp_{what}{'' if p == 'bf16' else '_f32'}":
           gp_ensemble[what][p]["launches"]
           for what in ("serving", "training") for p in ("bf16", "32")},
        "catnet_gp_covariance_f32": gp_ensemble["covariance"]["launches"],
        **{f"catnet_gp_{what}_f32": run["launches"]
           for what, run in gp_ensemble["optimizer"].items()},
        **{f"{tag}_{what}_f32": run["counts"]
           for part, tag in (("cli", "gp_cli"),
                             ("ensemble_cli", "ensemble_cli"))
           for what, run in gp_ensemble[part]["runs"].items()},
        # phase 23: the encoder U-Net served (bf16, f32) and trained (2
        # bf16 steps, 1 f32 step), its CLIs (train in bf16 and f32, predict
        # with MC dropout and test in f32)
        **{f"encoder_unet_{what}{'' if p == 'bf16' else '_f32'}":
           finetune[what][p]["launches"]
           for what in ("serving", "training") for p in ("bf16", "32")},
        **{f"finetune_{tag}": run["counts"]
           for tag, run in finetune["cli"].items()
           if isinstance(run, dict) and "counts" in run},
        # phase 24: the MIL models served and trained (bf16, f32) and the
        # classification_mil CLIs, which launch no hand kernel
        **{f"mil_{tag}": run["launches"]
           for tag, run in mil["paths"].items() if isinstance(run, dict)},
        **{f"mil_cli_{tag}": run["counts"]
           for tag, run in mil["cli"].items() if tag != "checks"},
        # phase 25: the deconfounder network served (B=2) and stepped
        # (B=16), SegCatNet served (B=2) and stepped (f32), the
        # classification_deconfounder CLIs and the logger's train run (f32),
        # and the exported artifacts run on the card (f32, B=2)
        **{f"{name}_{what}{'' if p == 'bf16' else '_f32'}":
           deconf["deconfounder"][p][what]["launches"]
           for name, what in (("deconfounder", "serving"),
                              ("deconfounder", "training"))
           for p in ("bf16", "32")},
        "segcatnet_serving": deconf["segcatnet"]["bf16"]["launches"],
        "segcatnet_serving_f32": deconf["segcatnet"]["32"]["launches"],
        "segcatnet_step_f32": deconf["segcatnet"]["step_f32"]["launches"],
        **{f"deconfounder_cli_{tag}_f32": run["counts"]
           for tag, run in deconf["cli"]["runs"].items()
           if tag != "predict_plain"},
        **{f"{tag}_export_f32": run["launches"]
           for tag, run in deconf["exports"].items()},
        # phase 26: VICRegL, DINO, iBOT and MAE at B=28 (2 steps each in
        # bf16 and f32) and the ssl train CLI for DINO (bf16) and VICRegL
        # (f32)
        **{f"ssl_{m}_training{'' if p == 'bf16' else '_f32'}":
           ssl_methods[m][p]["launches"]
           for m in SSL_NEW_METHODS for p in ("bf16", "32")},
        **{f"ssl_train_{tag}": run["counts"]
           for tag, run in ssl_methods["cli"].items()},
    }

    def launches_of(name):
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        return sum(paths.values()), paths

    att16 = attention["bfloat16"]
    k3, k2 = intensity_rows["float32"]["k3"], intensity_rows["float32"]["k2"]
    flash = "adell_mri_torch/csrc/flash_attention.cu"
    pallas_attention = "adell_mri_tpu/ops/pallas/attention.py"
    kernels = [
        entry("conv3d_igemm", "adell_mri_torch/csrc/conv3d_igemm.cu",
              "adell_mri_tpu/ops/pallas/conv.py:60",
              launches_of("conv3d_igemm")[0], totals,
              "window batch of 4 at 128x128x32 (the U-Net's 31 convs), "
              "bf16; launches: the U-Net's served case in bf16 and f32, 3 "
              "bf16 and 2 f32 training steps, UNETR's served case, 2 "
              "training steps and its f32 step, phase 14's crop steps, "
              "train, resume, test and predict runs, phase 15's four- and "
              "ten-flag crop steps and train runs, phase 16's SWIN-UNet "
              "served cases, steps and CLI runs and UNETR at head dim 16, "
              "phase 17's CatNet forwards, steps and CLI runs, phase 18's "
              "resnet U-Net served cases, steps and CLI runs and the other "
              "U-Net options' steps and served cases, phase 19's VGG and "
              "ConvNeXt CatNet forwards, steps and clinical-feature CLI "
              "runs, phase 20's VICReg, BYOL and served SSL forwards and "
              "steps and the ssl CLIs, phase 21's OrdNet and U-Net encoder "
              "classifier forwards, steps and CLI runs, phase 22's GP "
              "CatNet forwards, steps, covariance fit, accumulated and "
              "frozen steps and CLI runs and the ensemble's CLI runs, "
              "phase 23's encoder U-Net served cases, steps and CLI runs, "
              "phase 25's deconfounder and SegCatNet forwards and steps, "
              "deconfounder and logger CLI runs and the exported SSL "
              "encoder's and CatNet's artifacts, phase 26's VICRegL steps "
              "and CLI run, every route",
              totals["library_ms"]),
        entry("conv3d_igemm_dx", "adell_mri_torch/csrc/conv3d_igemm.cu",
              "adell_mri_tpu/ops/pallas/conv.py:60",
              launches_of("conv3d_igemm_dx")[0], dx_totals,
              "the 30 dx launches of one U-Net training step (B=4 at "
              "128x128x32), bf16; library: F.conv3d of the cotangent; "
              "launches: every route",
              dx_totals["library_ms"]),
        entry("intensity_aug_batch", "adell_mri_torch/csrc/intensity_aug.cu",
              "adell_mri_tpu/ops/pallas/intensity.py:155",
              launches_of("intensity_aug")[0], k3,
              "one call at [4,128,128,32,1] f32, Rician, every sample "
              "noisy, L2 cold (warm_ms: L2 warm); no single PyTorch call "
              "computes it", None),
        entry("intensity_aug", "adell_mri_torch/csrc/intensity_aug.cu",
              "adell_mri_tpu/ops/pallas/intensity.py:49",
              intensity_rows["k2_launches"], k2,
              "the B=1 call of the same kernel at [128,128,32,1] f32, "
              "Rician, L2 cold (warm_ms: L2 warm); launches: the B=1 calls "
              "of phase 6 (the training "
              "path runs the kernel at B=4 only); no single PyTorch call "
              "computes it", None),
        entry("flash_attention_fwd", flash,
              f"{pallas_attention}:49 and :151",
              launches_of("flash_attention_fwd")[0], att16[1]["fwd"],
              "one call at q, k, v [1,8,2048,64] bf16 (UNETR serving; 8 per "
              "case; training runs it at B=2, 8 per step; phase 16's UNETR "
              "at head dim 16 runs it at D=32 on zero-padded inputs, 8 per "
              "case); library: F.scaled_dot_product_attention forward",
              att16[1]["fwd"]["library_ms"]),
        entry("flash_attention_bwd_dq", flash, f"{pallas_attention}:300",
              launches_of("flash_attention_bwd_dq")[0],
              att16[2]["bwd_dq"],
              "one call at [2,8,2048,64] bf16 (UNETR training; 8 per step); "
              "library: F.scaled_dot_product_attention forward + backward, "
              "which also computes dK and dV; library_bwd_ms: that minus "
              "its forward",
              att16[2]["bwd_dq"]["library_ms"]),
        entry("flash_attention_bwd_dkv", flash, f"{pallas_attention}:355",
              launches_of("flash_attention_bwd_dkv")[0],
              att16[2]["bwd_dkv"],
              "one call at [2,8,2048,64] bf16 (UNETR training; 8 per step); "
              "library: F.scaled_dot_product_attention forward + backward, "
              "which also computes dQ; library_bwd_ms: that minus its "
              "forward",
              att16[2]["bwd_dkv"]["library_ms"]),
    ]
    # dQ and dK/dV together are the library's backward alone
    for k in kernels[5:7]:
        k["library_bwd_ms"] = att16[2][
            k["name"].replace("flash_attention_", "")]["library_bwd_ms"]
    for k in kernels:
        k["launches_by_path"] = launches_of({
            "intensity_aug_batch": "intensity_aug",
        }.get(k["name"], k["name"]))[1]
    # K1's launches by route: the two wgmma kernels (bf16 and 3xTF32), the
    # narrow one and the gathered-tile one, which is also timed straight at
    # the 29 bf16 convs the wgmma route now takes
    for k in kernels[:2]:
        routes = {r: launches_of(f"{k['name']}_{r}")[0]
                  for r in ("wgmma", "tf32", "narrow")}
        routes["igemm"] = k["launches"] - sum(routes.values())
        k["launches_by_route"] = routes
    # phase 17: CatNet's 8 K1 convs of a B=16 step's forward, dx and dW,
    # per precision (K1 routes: wgmma in bf16, tf32 in f32)
    catnet_rows = {d: [r for r in catnet["convs"] if r["dtype"] == d]
                   for d in ("bfloat16", "float32")}
    kernels[0]["catnet_step_forward"] = {
        d: sum_rows(rows) for d, rows in catnet_rows.items()}
    kernels[1]["catnet_step_dx"] = {
        d: {"convs": sum(r["count"] for r in rows),
            "ms": sum(r["dx_ms"] * r["count"] for r in rows),
            "library_ms": sum(r["dx_library_ms"] * r["count"]
                              for r in rows),
            "bound_ms": sum(r["dx_bound_ms"] * r["count"] for r in rows)}
        for d, rows in catnet_rows.items()}
    # phase 19: VGG's 8 K1 convs of a B=16 step's forward and dx, per
    # precision (the stem on the narrow route; wgmma in bf16, tf32 in f32)
    vgg_rows = {d: [r for r in classifiers["vgg"]["convs"]
                    if r["dtype"] == d] for d in ("bfloat16", "float32")}
    kernels[0]["vgg_step_forward"] = {
        d: sum_rows(rows) for d, rows in vgg_rows.items()}
    kernels[1]["vgg_step_dx"] = {
        d: {"convs": sum(r["count"] for r in rows),
            "ms": sum(r["dx_ms"] * r["count"] for r in rows),
            "library_ms": sum(r["dx_library_ms"] * r["count"]
                              for r in rows),
            "bound_ms": sum(r["dx_bound_ms"] * r["count"] for r in rows)}
        for d, rows in vgg_rows.items()}
    # phase 20: the two-view step's 7 K1 convs of a B=28 forward, dx and
    # dW, per precision (wgmma in bf16, tf32 in f32; dW: bf16 wgrad at
    # 64/128/256, the patch product at 512 and in f32)
    ssl_rows = {d: [r for r in ssl["convs"] if r["dtype"] == d]
                for d in ("bfloat16", "float32")}
    kernels[0]["ssl_step_forward"] = {
        d: sum_rows(rows) for d, rows in ssl_rows.items()}
    kernels[0]["ssl_stem_64"] = {
        d: {k: rows[0][k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "max_abs_err", "tol")}
        for d, rows in ssl_rows.items()}
    kernels[1]["ssl_step_dx"] = {
        d: {"convs": sum(r["count"] for r in rows),
            "ms": sum(r["dx_ms"] * r["count"] for r in rows),
            "library_ms": sum(r["dx_library_ms"] * r["count"]
                              for r in rows),
            "bound_ms": sum(r["dx_bound_ms"] * r["count"] for r in rows)}
        for d, rows in ssl_rows.items()}
    # phase 18: the resnet U-Net's K1 convs of one window batch of 4
    kernels[0]["resnet_window_batch"] = {
        d: options["convs"][d]["totals"] for d in ("bfloat16", "float32")}
    wgmma_totals = sum_rows([r for r in path_rows if r["route"] == "wgmma"])
    kernels[0]["igemm_bf16"] = {
        key: wgmma_totals[key] for key in ("convs", "igemm_ms", "ms",
                                           "library_ms", "bound_ms")}
    # K2 is the B=1 call of K3's kernel: no main path runs it at B=1
    kernels[3]["launches_by_path"] = {
        "intensity_phase": kernels[3]["launches"]}
    # the narrow kernel on its own: forward and dx launches of every path
    narrow = narrow_step_row(path_rows, bwd_rows)
    kernels.append(entry(
        "conv3d_narrow", "adell_mri_torch/csrc/conv3d_igemm.cu",
        "adell_mri_tpu/ops/pallas/conv.py:60",
        launches_of("conv3d_igemm_narrow")[0]
        + launches_of("conv3d_igemm_dx_narrow")[0], narrow,
        "the narrow launches of one U-Net training step (B=4 at "
        "128x128x32, bf16): the stems 1->1 and 1->32 and the 32->1 dx; "
        "library: F.conv3d at the same shapes", narrow["library_ms"]))
    kernels[-1]["launches_by_path"] = {
        p: c.get("conv3d_igemm_narrow", 0)
        + c.get("conv3d_igemm_dx_narrow", 0) for p, c in by_path.items()}
    # dW: the wgrad kernel's 29 launches of a U-Net step, and all 31 dW
    wg, dw_all = dx_totals["dw_wgmma"], dx_totals["dw"]
    kernels.append(entry(
        "conv3d_wgrad", "adell_mri_torch/csrc/conv3d_wgrad.cu",
        "adell_mri_tpu/ops/conv.py:170",
        launches_of("conv3d_weight_grad")[0],
        dict(max_abs_err=wg["dw_max_abs_err"], tol=wg["dw_tol"],
             ms=wg["dw_ms"], plain_ms=wg["dw_plain_ms"],
             bound_ms=wg["dw_bound_ms"], bound_by=wg["dw_bound_by"]),
        "the dW half of _conv3d_im2col_bwd (K1's custom VJP, XLA in the "
        "JAX package): the 29 wgrad launches of one U-Net training step "
        "(B=4 at 128x128x32, bf16); plain: the patch product; library: "
        "cuDNN's weight gradient (aten.convolution_backward)",
        wg["dw_library_ms"]))
    kernels[-1]["launches_by_path"] = launches_of("conv3d_weight_grad")[1]
    kernels[-1]["patch_calls_by_path"] = launches_of(
        "conv3d_weight_grad_patches")[1]
    step_keys = ("convs", "dw_ms", "dw_plain_ms", "dw_library_ms",
                 "dw_bound_ms", "dw_max_abs_err", "dw_tol", "dw_peak_bytes",
                 "dw_plain_peak_bytes")
    kernels[-1]["step_all_dw"] = {k: dw_all[k] for k in step_keys}
    # CatNet's 8 dW of a B=16 step: bf16 6 on the kernel and the two
    # 512->512 on the patch product; f32 all 8 on the patch product
    kernels[-1]["catnet_step_dw"] = {
        d: dw_totals(rows) for d, rows in catnet_rows.items()}
    kernels[-1]["vgg_step_dw"] = {
        d: dw_totals(rows) for d, rows in vgg_rows.items()}
    kernels[-1]["ssl_step_dw"] = {
        d: dw_totals(rows) for d, rows in ssl_rows.items()}
    # f32 dW of a U-Net step (all 31 on the patch product), beside cuDNN's
    # f32 weight gradient (TF32 off) and the 3xTF32 and FMA bounds
    kernels[-1]["f32_step_dw"] = {
        k: dx_totals["dw_f32"][k] for k in (
            "convs", "dw_ms", "dw_library_ms", "dw_bound_ms",
            "dw_bound_fma_ms")}
    # UNETR's step at B=2: the kernel's 8 dW and all 9
    kernels[-1]["unetr_step"] = {
        part: {k: unetr_training["dw_per_step"][part][k] for k in step_keys}
        for part in ("dw_wgmma", "dw")}
    # K1 in f32 (the CLI's default precision): the 3xTF32 kernel, forward
    # and dx, against the gathered-tile FMA kernel timed straight at the
    # same convs
    tf32_keys = ("convs", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_fma_ms", "igemm_ms", "max_abs_err", "tol")
    dx_tf32 = dx_totals["f32_tf32"]
    kernels.append(entry(
        "conv3d_wgmma_tf32x3", "adell_mri_torch/csrc/conv3d_tf32.cu",
        "adell_mri_tpu/ops/pallas/conv.py:60",
        launches_of("conv3d_igemm_tf32")[0]
        + launches_of("conv3d_igemm_dx_tf32")[0], tf32_totals,
        "the 29 tf32-route convs of an f32 window batch of 4 at 128x128x32 "
        "(3xTF32: bound_ms at 494.7/3 TFLOP/s, bound_fma_ms at 67); "
        "library: F.conv3d with TF32 off; igemm_ms: the gathered-tile FMA "
        "kernel (conv3d_igemm_f32_kernel) at the same convs; dx_per_step: "
        "the 29 "
        "tf32-route dx launches of an f32 U-Net step; launches: forward and "
        "dx of the f32 served cases (U-Net, UNETR, SWIN-UNet, CatNet), 3 "
        "f32 U-Net steps, UNETR's f32 step, SWIN-UNet's and CatNet's f32 "
        "steps and CLI runs, phase 18's f32 resnet U-Net cases, steps and "
        "CLI runs and the option variants' steps and cases",
        tf32_totals["library_ms"]))
    kernels[-1].update(bound_fma_ms=tf32_totals["bound_fma_ms"],
                       igemm_ms=tf32_totals["igemm_ms"],
                       dx_per_step={k: dx_tf32[k] for k in tf32_keys
                                    if k != "igemm_ms"})
    kernels[-1]["launches_by_path"] = {
        p: c.get("conv3d_igemm_tf32", 0) + c.get("conv3d_igemm_dx_tf32", 0)
        for p, c in by_path.items()}
    # the f32 attention kernels (3xTF32 wgmma, each after its preparation
    # kernel), on UNETR's f32 paths: the forward on the served case and the
    # step (B=1), dQ and dK/dV on the step
    f32_paths = ("unetr_serving_f32", "unetr_training_f32",
                 "ssl_ijepa_training_f32", "ssl_dino_training_f32",
                 "ssl_ibot_training_f32", "ssl_mae_training_f32", "vit_serving_f32",
                 "vit_training_f32", "vit_cli_train_f32", "vit_cli_test_f32",
                 "vit_cli_predict_probability_f32", "vit_export_f32")
    att32 = attention["float32"]
    for name, what, b, lines in (
            ("fwd", "forward", 1, ":49 and :151"), ("bwd_dq", "dQ", 2, ":300"),
            ("bwd_dkv", "dK/dV", 2, ":355")):
        t = att32[b][name]
        paths = {p: n for p, n in launches_of(f"flash_attention_{name}")[1]
                 .items() if p in f32_paths}
        kernels.append(entry(
            f"flash_attention_{name}_f32", flash,
            f"{pallas_attention}{lines}", sum(paths.values()), t,
            f"the f32 {what} kernel (3xTF32 wgmma; ms includes its "
            "preparation kernel, which writes the split, transposed and "
            f"swizzled images of the streamed tiles) at [{b},8,2048,64]; "
            "bound_ms at 3xTF32, bound_fma_ms at 67 TFLOP/s; launches: "
            + ("UNETR's f32 served case and f32 step" if name == "fwd"
               else "UNETR's f32 step")
            + "; library: F.scaled_dot_product_attention in f32"
            + ("" if name == "fwd" else " forward + backward"),
            t["library_ms"]))
        kernels[-1]["bound_fma_ms"] = t["bound_fma_ms"]
        kernels[-1]["kernel"] = f"flash_{name}_tf32x3_kernel"
        kernels[-1]["launches_by_path"] = paths
        if name != "fwd":
            kernels[-1]["library_bwd_ms"] = t["library_bwd_ms"]
    # the bf16 attention entries count the bf16 paths only
    for k in kernels[4:7]:
        for path in f32_paths:
            k["launches_by_path"].pop(path, None)
        k["launches"] = sum(k["launches_by_path"].values())
    # phase 20: each attention kernel at I-JEPA's shapes ([28,4,8192,48]
    # and [28,4,8192,24] on the D=64 and D=32 kernels), by dtype
    flash_kernels = {k["name"]: k for k in kernels
                     if k["name"].startswith("flash_attention_")}
    for row in ssl["flash"]:
        for stem in ("fwd", "bwd_dq", "bwd_dkv"):
            name = f"flash_attention_{stem}" + (
                "" if row["dtype"] == "bfloat16" else "_f32")
            flash_kernels[name].setdefault("ijepa_shapes", []).append(dict(
                shape=[row["batch"], row["heads"], row["tokens"], row["d"]],
                padded_d=row["padded_d"], ms=row["ms"][stem],
                bound_ms=row["bound_ms"][stem],
                bound_by=row["bound_by"][stem],
                library_ms=(row["library_fwd_ms"] if stem == "fwd"
                            else row["library_fwd_bwd_ms"]),
                library_bwd_ms=row["library_bwd_ms"],
                max_abs_err=(row["errs"]["out"] if stem == "fwd" else
                             row["errs"]["dq"] if stem == "bwd_dq" else
                             max(row["errs"]["dk"], row["errs"]["dv"]))))
    # phase 21: each attention kernel at the ViT classifier's shape
    # [2,12,4097,64], by dtype
    for dtype, row in new_classifiers["attention"].items():
        for stem, t in row["times"].items():
            name = f"flash_attention_{stem}" + (
                "" if dtype == "bfloat16" else "_f32")
            flash_kernels[name]["vit_shape"] = dict(
                shape=[CATNET_SERVE_BATCH, VIT_HEADS, VIT_TOKENS,
                       VIT_HEAD_DIM],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "max_abs_err", "tol")},
                **({"library_bwd_ms": t["library_bwd_ms"]}
                   if stem != "fwd" else {}))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        device=kind, nvidia_smi=smi, build_s=build_s,
        kernel_vs_plain=kernel_rows, serving=serving,
        serving_f32=serving_f32, window_batch=window_rows,
        main_path_convs=path_rows, main_path_convs_f32=f32_path_rows,
        window_batch_f32=f32_totals, window_batch_tf32=tf32_totals,
        cli=cli, intensity=intensity_rows, conv_backward=bwd_rows,
        conv_dx_per_step=dx_totals, training=training, train_cli=train_cli,
        attention=attention_rows, unetr_serving=unetr_serving,
        unetr_serving_f32=unetr_serving_f32,
        unetr_training=unetr_training, unetr_cli=unetr_cli,
        flagship_pipeline=pipeline, full_augmentation=augmentation,
        swin=swin, catnet=catnet, unet_options=options,
        classifiers=classifiers, ssl=ssl, new_classifiers=new_classifiers,
        gp_ensemble=gp_ensemble, finetune=finetune, mil=mil,
        deconfounder_export=deconf, ssl_methods=ssl_methods,
        launches_by_path=by_path,
        phase_s=phase_s,
        kernels=kernels, total_s=time.perf_counter() - t_start,
    ), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
