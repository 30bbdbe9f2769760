"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device   — name, count, and nvidia-smi's name and power limit;
2. build    — nvcc builds the kernels from ops/csrc (sm_90a), one process
              per source, all at once; prints the build seconds,
              ptxas's register / spill report and warnings, the
              tensor-core (HMMA) instruction count of the bf16 attention
              forward and of both kernels of the bf16 attention backward
              (in attention.cu and attn_block_bwd.cu) and of K1's bf16
              attention step (attention_fwd_mma with the deferred
              division, in vit_block.cu), and the warpgroup (HGMMA) count
              of every instantiation of the bf16 products of K1, K2, K4
              and the attention chain rule (gemm_sm90.cuh's
              gemm_kernel), the int8 warpgroup (IGMMA) count of every
              int8 product of K7/K8 (gemm_kernel in vit_block_q8.cu) and
              of the int8 convolution (gemm_kernel in conv_q8.cu), and
              the HMMA count of their bf16 attention step, the HGMMA
              count of every instantiation of K11's bf16 products and
              3x3 (gemm_kernel in resnet_block.cu), of K12's bf16
              stage kernel (stage_kernel) and of K10's bf16 products
              (gemm_kernel in attn_block_bwd.cu, the WGRAD weight
              gradients among them), failing on a count of zero but the
              K6/K9 forward's, on any int8 WMMA (IMMA) left in
              vit_block_q8.cu or conv_q8.cu and on any WMMA kernel
              (gemm_bf16_wmma,
              stage_bf16_wmma, wgrad_bf16_wmma) left in resnet_block.cu
              or attn_block_bwd.cu;
3. kernels  — each forward kernel against its plain PyTorch version on
              the card at the serving and training paths' shapes
              (ViT-B/16 blocks at B = 8, 16 and 128 in fp32 and bf16, K1
              at N = 577 — a 384² image, its fp32 attention on the tiled
              kernel — the fusion head K3 at B = 8, 13, 128 in fp32 and
              bf16), with error and CUDA-event times; K3 also with its
              weights as nn.Linear's transposed views bit-equal to
              row-major ones, two calls bit-equal, and the device time
              (profiler) of the kernel and of its plain version; the
              bf16 K1 and K2 (TMA + wgmma
              products, K1's attention on the tensor cores) also no
              further from the fp32 result than their plain versions
              (BF16_VS_PLAIN) and two calls bit-equal, at each B and at
              N = 577, with their device time by kernel (profiler) beside
              cuBLAS's products on the same operands through
              ``torch.matmul`` (and, for K1, SDPA's attention), and the
              host's tensor-map encoding per block;
3b. backward kernels — K4 ``mlp_block_bwd`` and K5
              ``qkv_attention_fwdbwd`` against their plain versions at
              B = 16 and 128 in fp32 and bf16, likewise, and K5 at
              N = 5, 40, 208, 209, 226, 257 and 577 (B = 16; fp32 past
              208: the tiled kernels); the bf16 K4 (TMA + wgmma
              products) and K5 (tensor-core backward) also no further
              from the fp32 result than their plain versions
              (BF16_VS_PLAIN), two calls bit-equal, their device time by
              kernel (K5 at B = 16, 128 and N = 577 beside SDPA forward
              + backward's), K4's three products through
              ``torch.matmul`` (cuBLAS) as a yardstick in turns, and the
              host's cost of a tensor map;
3c. int8 kernels — ``attn_block_q8``, ``mlp_block_q8`` (K7) and
              ``attn_block_q8s``, ``mlp_block_q8s`` (K8) against their plain
              versions at B = 8 and 128 in fp32 and bf16, and K7's
              attention block at N = 577 (B = 8); each int8 product of
              the blocks (qkv, proj, fc1, fc2; dynamic and static) on
              seeded int8 operands, bit for bit against the plain integer
              arithmetic ``gemm_q8_ref`` (GELU_F32 within Q8_ERF_TOL) at
              B = 8 and 128 in both dtypes; in bf16 the blocks' device
              time by kernel (profiler) and each product's beside
              ``torch._int_mm`` (cuBLASLt s8·s8→s32, a yardstick the port
              never calls) on the same operands;
3d. ResNet kernels — the fused bottleneck (K11, identity and projection)
              against its plain version at ResNet-50's five stride-1 block
              shapes, B = 8 and 128, fp32 and bf16, each with its device
              time (profiler) beside the CUDA-event and device times of
              the port's cuDNN ``Bottleneck.forward`` (eval) and the
              kernel's bound, and two calls bit-equal;
3e. attention kernels — K6 ``qkv_attention_fwd`` / ``_bwd`` and K9
              ``flash_attention_fwd`` / ``_bwd`` against their plain
              versions at ViT-B/16's attention (N = 197, 12 heads, D = 64)
              at B = 8, 16 and 128 in fp32 and bf16, and at N = 40 with
              D = 8 and 32 (the scale that is no power of two), each beside
              ``F.scaled_dot_product_attention`` on the same operands (for
              K6 the strided q/k/v views of the packed tensor; for the
              backward rows SDPA forward + backward beside the kernel's
              forward + backward); then K9's own entry point,
              ``flash_attention`` forward and backward through autograd
              at B = 16 in bf16, with its launches counted; K6 and K9 also
              at N = 226, 257 and 577 (B = 16, 12 heads, D = 64: the
              fp32 tiled kernels; bf16 runs one tensor-core path at every
              N) and at N = 5 and 40 (B = 16); every bf16 output also
              against the fp32 result on the same values (no further
              from it than the plain version's, BF16_VS_PLAIN), two calls
              bit-equal, and the device time from the profiler beside
              SDPA's (backward rows: backward alone, forward + backward,
              SDPA forward + backward);
3f. K10     — ``attn_block_bwd_fused`` (the one-kernel attention-block
              backward) against its plain version at ViT-B/16's block,
              B = 16 and 32, fp32 and bf16, each beside the K5 chain rule
              ``attn_block_bwd`` in turns (and, in fp32, held against
              its gradients), at N = 40 with D = 8 and 32 and at N = 5,
              226 and 577; two calls bit-equal; its bf16 device time by
              kernel (and its attention step's) at B = 16 and 32, beside
              the chain rule's by kernel; the device kernels
              one call runs (the
              port's own only, from the profiler); then its entry point,
              a 12-block ``AttnBlockFusedBwd`` chain through autograd at
              B = 32 in bf16 (12 K10 launches per backward and no K5),
              bit-equal across two runs, timed in turns beside
              ``AttnBlock``'s chain;
3g. K12     — ``fused_stage`` (one cooperative launch for a stage's
              identity bottlenecks) against its plain version
              ``stage_ref`` at ResNet-50's four stage tails, B = 8 and
              128, fp32 (whole stage within KERNEL_TOL) and bf16 (each
              block within KERNEL_TOL, the stage's mean distance from the
              fp32 result within 10% of the plain version's), bit-equal to
              the K11 chain and across two calls, timed in turns beside
              the plain version, the K11 chain and the cuDNN chain
              (``Bottleneck.forward``, eval) of the same blocks; a seeded
              full-width ResNet-50's ``layer3[1:]`` (BN off identity, the
              activations of 8 images) on K12 against its cuDNN blocks
              within phase 7's budget; the device kernels of one call (the
              port's stage kernel only, no GEMM-tile launch; profiled in
              a fresh process); in bf16 at each tail and batch, in a
              fresh process, the tile shape (``dfu_stage_tile``, held to
              the plain mirror ``_stage_tile``), the 3n - 1 grid
              barriers, and the device time of the stage kernel beside
              the K11 chain's and the bound;
              ``FusedStage`` gradients on the card (fp32) against autograd
              through ``stage_ref`` on the CPU; then its entry point,
              ``FusedStage`` over the four stage tails of a ResNet-50
              forward and backward in bf16 (4 launches, no K11);
4. serve    — the full-width multimodal model (ResNet50 + ViT-B/16, random
              weights from a seeded generator) behind Trainer +
              ServingEngine(max_batch=8) in bf16: 24 requests from 3
              threads, launch counts, and the card (bf16 and fp32) against
              the CPU's plain fp32 path on the same weights and inputs;
5. train    — the full-width thermal_only ViT-B/16 (seeded weights) in
              bf16 at batch 16, built by ``tools/profile_train.py``'s
              ``recipe_trainer`` (the trainer that tool profiles): 8 steps
              of ``run_train_epoch`` over a 128-image synthetic dataset
              (step ms, images/s, peak memory, loss per step, 12 launches
              per step of each ViT kernel), then one fp32 train step on
              the card against the CPU's plain fp32 step on the same
              weights and batch, each parameter's gradient within 1e-5 of
              its own max|g|;
6. int8     — the full-width thermal_only ViT-B/16 (seeded weights)
              quantised on the card by ``quantize_for_serving`` behind
              ``ServingEngine(max_batch=8)`` in bf16: 24 requests from 3
              threads, 12 launches per batch of each dynamic int8 block and
              none of the bf16 blocks, the card (bf16 and fp32) against the
              CPU's plain int8 fp32 path on the same quantised weights, and
              how many predictions agree with the bf16 model; then the
              calibrated static configuration (16 synthetic normalised
              images calibrated on the card, 3 eval batches through the
              q8s kernels, card against CPU likewise);
7. rgb      — the full-width rgb_only ResNet-50 (seeded weights, BN
              statistics off identity) built as ``Trainer(...,
              block_impl="fused")`` behind ``ServingEngine(max_batch=8)`` in
              bf16: 24 requests from 3 threads, 12 identity and 1
              projection bottleneck launches per batch and none of the ViT
              or fusion-head kernels, the card (bf16 and fp32) against the
              CPU's plain fp32 path, and the card's fused fp32 against its
              cuDNN fp32 blocks (``block_impl="flax"``, TF32 off); the
              bf16 eval step at batch 8 with fused and with cuDNN blocks,
              and a profile of the fused steps (device busy, idle share);
8. flax serve — the full-width thermal_only ViT-B/16 with the flax blocks
              (``block_impl="flax", attention_impl="pallas"``, seeded
              weights) behind ``ServingEngine(max_batch=8)`` in bf16: 24
              requests from 3 threads, 12 K6 forward launches per batch
              and none of the fused, int8 or ResNet kernels; card fp32
              against the CPU's plain fp32 path and against the card's
              fused blocks on the same weights, card bf16 against CPU fp32
              with every prediction equal; the bf16 eval step at batch 8
              with flax/pallas, flax/xla and fused blocks;
9. flax train — the same model from ``recipe_trainer(..., "flax",
              "pallas")``: 8 bf16 steps of ``run_train_epoch`` at batch 16
              (step ms, images/s, peak memory, 12 K6 forward and 12 K6
              backward launches per step and none of K1, K2, K4, K5), then
              a card fp32 step against the CPU's plain fp32 step at phase
              5's budgets;
10. large images — thermal_only at 240² (N = 226, the attention
              backward on its tiled kernels): two bf16 train steps of the
              full-width model with the fused blocks (12 K5 launches per
              step) and with flax/pallas (12 K6 backward launches), each
              loss finite; then for each a depth-2 model's fp32 train
              step on the card against the CPU's plain step at phase 5's
              budgets;
11. train all — rgb_only (ResNet-50, batch 32) and multimodal (ResNet-50
              + ViT-B/16, batch 6) at 224², bf16: four steps of
              ``run_train_epoch`` each after a warm-up step (step ms,
              images/s, peak memory, finite losses, every BatchNorm
              buffer moved by every step; multimodal 12 launches a step
              of K1, K2, K4 and K5 and none of K3, rgb_only none of the
              port's kernels: its convolutions train on cuDNN); an fp32
              step of each on the card against the CPU's (TF32 off; each
              gradient and BatchNorm statistic within phase 5's 1e-5 of
              its own max); then multimodal ``fit`` for two epochs
              (save_last, async saves) into a directory under build/, a
              fresh Trainer restoring its best checkpoint with eval logits
              bit-equal to the saving model's, and a third Trainer
              resuming at epoch 3 with its optimizer count restored;
12. train from disk — the JPEG decode route (libjpeg, or nvJPEG where
              the host has no libjpeg) and what selected it; every file
              of ``dfu_multimodal_tpu_torch/data/fixtures`` decoded at
              48² and 128² against the JAX package's decode of it
              (bit-equal, but a JPEG on the nvJPEG route within
              NVJPEG_MAX_ABS / NVJPEG_MEAN_ABS levels); a 224² synthetic
              tree written by the port's ``make_synthetic_dataset`` (20
              images per class and modality) and decoded, with the
              seconds of each; the three reference train CLIs through
              their ``main(argv)`` at full width with their own models and
              batches (32 / 16 / 6) in bf16, ``--epochs 2
              --save-best-after 1 --save-last``: each epoch's seconds, the
              artifact contract (checkpoints, ``test_results.pt`` with its
              six keys, ``run_info.json``, the drift baseline), and the
              launches of each run (thermal_only and multimodal K1, K2, K4
              and K5, multimodal also K3 in its evaluations, rgb_only none
              of the port's kernels); then the multimodal CLI again with
              ``--resume --epochs 3``, which runs epoch 3 only;
13. from a download to the artifacts — on phase 12's tree and
              checkpoints: its JPEGs laid out as the two raw Kaggle
              downloads (cross-class duplicates, a 224 x 160 PNG), then
              ``organize_clean_dataset`` (the duplicate counts, ulcer wins,
              each split's size by scikit-learn's ceil rule, no hash in
              two splits) and ``dataset_tools`` ``verify``, ``analyze``,
              ``standardize --verify`` (each output within STD_MAX_ABS /
              STD_MEAN_ABS levels of its canvas before the q95 write),
              ``patient-split`` and ``stats``; ``extended_metrics`` in
              bf16 over the three checkpoints with ``--operating-point
              youden --calibration --temperature-from-val --bootstrap 200
              --save-deployment`` (every artifact, each PNG decoded at its
              size, each model's launches: thermal_only K1/K2, multimodal
              K1/K2/K3, rgb_only none); ``extended_metrics --models
              multimodal`` in fp32 on the card (TF32 off) against the
              same on the CPU; ``test_time_augmentation --num-tta 5`` (its
              clean metrics equal extended_metrics' on rgb_only and
              thermal_only, its launches); ``ablation_study --epochs 1
              --with-multimodal`` (finite F1s, its launches); the seconds
              of each step;
14. explain — on phase 12's tree and checkpoints: K3's backward
              (``FusedMlp``: the kernel's forward, autograd through the
              plain version) at B = 8 in fp32 and bf16 against plain
              autograd, each gradient within K3_GRAD_TOL of its max;
              the Grad-CAM CLI over the three models in fp32 (the JAX
              file names, the figures' sizes, each model's launches:
              thermal_only K1/K2/K4/K5, multimodal those and K3, rgb_only
              none); the multimodal CAMs (fused and strict) and
              thermal_only's rollout and Chefer on the card and, the model
              moved there on purpose, on the CPU (fp32, TF32 off, within
              CAM_CARD_TOL, predictions equal), and the bf16 explanation's
              distance from the fp32 one (recorded); ``cli/serve`` on
              127.0.0.1:0 three times — multimodal and rgb_only in bf16
              with ``--explain`` behind one router (JPEG bytes and base64
              JSON, probabilities equal to the eval step's on the same
              decoded image, ``/v1/explain`` overlays decoded at the
              submitted size, ``/healthz``, ``/metrics``,
              ``/metrics/prometheus``, a duplicate-field 400 and an
              unknown-model 404, p50 / p99 of 16 requests from 4 threads
              at the client over HTTP and in the engine),
              thermal_only ``--int8 --explain`` (int8 predictions, the
              full-fidelity model explained), rgb_only without
              ``--explain`` (501); ``cli/predict`` over a directory pair
              (its rows equal to the eval step's); the phase's seconds;
15. int8    — ``conv_q8`` (the int8 convolution, ``ops/csrc/conv_q8.cu``)
              against ``conv_q8_ref`` on the card, bit for bit, at every
              distinct conv of ResNet-50 at B = 8 in fp32 and bf16, each
              bf16 shape's CUDA-event and device time beside the plain
              version's, the library route's (the plain gather and
              ``torch._int_mm``) and its bound, and their sums over the 52
              convs of one trunk forward; ``quantize_act_q8`` likewise at
              the inputs of the four projection blocks, its sums over the
              4 quantisations of a forward; ``quantize_for_serving`` of the
              full-width rgb_only and multimodal (seeded weights, BatchNorm
              statistics off identity, calibrated on 32 images on the
              card): the int8 trunk with the kernels against the same
              trunk on the plain version, features and taps bit-equal, 52
              convs and 4 quantisations a forward; each model behind the
              ServingEngine at b1 and b8 in bf16 (p50 / p99, the int8
              against bf16 probability gap and decision agreement, launches
              a batch: 52 ``conv_q8`` and 4 ``quantize_act_q8``, multimodal
              12 of each K7 block and 1 K3); then on phase 12's tree and checkpoints ``cli/predict
              --int8 --calib-images`` for rgb_only and multimodal (rows
              equal to an int8 trainer of the same checkpoint and
              calibration), the daemon with the int8 multimodal as its
              primary (``--int8 --calib-images``) and the same checkpoint
              as its bf16 ``--shadow`` at ``--pipeline-depth`` 1 and 2,
              one request a batch, 4 client threads
              (``dfu_shadow_compared_total`` equal to the requests; at
              depth 2 batches dispatched while another was in flight, at
              depth 1 none; each answer equal to depth 1's for the same
              request),
              and the three train CLIs with ``--qat`` for one epoch (their
              launches; the snapped ViT and ResNet weights equal the
              serving grid's and requantise to the same int8 codes);
16. token merging (ToMe) — K1, K7 and K8 with the key bias of
              proportional attention against their plain versions at B = 8,
              N = 128 (``--token-merge 4:128``) and 99 (the least keep at
              224²), fp32 and bf16, a random log-size bias, in bf16 at
              N = 128 timed beside the unbiased kernel (turns, and device
              time); full-width thermal_only and multimodal on the fused,
              ``fused_q8`` (``quantize_for_serving``) and ``fused_q8s``
              (calibrated) blocks, each rebuilt by ``tome_for_serving(...,
              4, 128)`` with and without proportional attention behind the
              ServingEngine (9 requests: batches of 8 and 1; 12 launches a
              batch of the family's attention and MLP kernels, 8 of the
              attention ones biased with proportional attention);
              ``keep = 197`` bit-equal to the unmerged model on each
              family; thermal_only 4:128 with proportional attention in
              fp32 on the card against the CPU; the bf16 ViT-B/16 trunk's
              device time at B = 8 and 128 without and with the merge;
              then on phase 12's checkpoints the daemon over all three
              with ``--token-merge 4:128 --tome-prop-attn`` (rgb_only's
              skip line; two requests a model, each answer equal to its
              engine's eval step) and ``predict --int8 --token-merge
              4:128`` for thermal_only and multimodal (rows equal to
              ``tome_for_serving(quantize_for_serving(...))``'s);
17. export  — on phase 12's checkpoints, ``cli/export_model --verify``
              of three bundles (``serve/export.py``: one
              ``torch.export`` program a bucket, the kernels as ``dfu::``
              ops, the weights once): bf16 multimodal with the fused ViT
              blocks, K3 and the fused ResNet-50 trunk (buckets 1 and 8),
              int8 multimodal (bucket 8) and thermal_only ``--token-merge
              4:128 --tome-prop-attn`` (bucket 8); each bundle and its
              checkpoint behind a ServingEngine (seconds from load or
              restore to the first answer, p50), 16 requests each
              (predictions equal, |dP| within 1e-5, 1e-2 int8), the
              bundle's launches a batch, its program's ``dfu::`` ops, the
              hand-written kernels of one replayed step (profiler), and
              no plain version called; export seconds by bucket and the
              bundle's MB;
18. students — ``conv_q8`` bit-equal to plain at the ResNet-18 trunk's
              10 distinct conv shapes (fp32, bf16); ``resnet18_rgb`` and
              ``resnet18_thermal`` at full width served in bf16 and int8
              at b1 and b8 (p50), each against the CPU's fp32 forward,
              the int8 one also against the CPU's plain int8 path (19
              conv_q8 and 3 quantize_act_q8 launches a batch, none in
              bf16), and an int8 student bundle replayed;
19. research — on phase 12's tree and checkpoints and phase 13's
              extended_metrics, through each CLI's ``main(argv)`` at
              224²: ``embed`` (a multimodal index over train, the test
              images retrieved against it, 5 neighbours, ranked by
              uncertainty; 8 rows of each feature space against the
              CPU's fp32 forward, RESEARCH_FEAT_TOL, beside a known-bad
              control; the index's probabilities equal to the eval
              step's; a row's self-match), ``robustness`` (multimodal
              over 4 corruptions at severities 1 and 5, each cell's
              counts the split's size, the clean counts the eval step's;
              rgb_only once on the fused trunk, K11), ``compare``
              (rgb_only vs multimodal: the flip table of the eval steps'
              decisions), ``model_card`` for the three checkpoints
              (parameters, SHA-256, results.pt's metric lines),
              ``cross_validate`` (thermal, 2 folds, 1 epoch), ``sweep``
              (two learning rates, then ``--resume``, which trains
              nothing) and ``soup`` (phase 12's thermal_only with a
              ``--seed 1`` fine-tune of it, uniform and ``--greedy``; a
              self-soup bit-equal; the soup answers ``predict``); each
              drive's host seconds and launches, and no plain version
              called on the card;
20. trainers — on phase 12's tree and checkpoints, through each CLI's
              ``main(argv)`` at full width and 224²: ``pretrain`` SimCLR
              on ViT-B/16 (fused blocks, batch 64: 128 views a step),
              SimCLR on ResNet-50 (train-mode BatchNorm) and MAE on
              ViT-B/16 (mask 0.75, decoder 256x2x8), then
              ``train_thermal_only`` and ``train_multimodal_fusion``
              ``--init-from`` the ViT checkpoint (the loaded trunk under
              ``vit.`` / ``thermal_branch.`` bit-equal to it); ``distill``
              of the multimodal teacher into ``resnet18_rgb`` and of the
              thermal_only one into ``resnet18_thermal``; ``self_train``
              (thermal_only, 2 rounds, the test split as the pool: the
              adopted counts, best_model promoted); ``train_legacy``'s
              four variants; ``convert_checkpoint`` of a reference-layout
              rgb_only ``.pt`` written from seeded weights (its logits on
              the card equal to the source's in the same module); each
              new step's first outputs and loss in bf16 against the CPU's
              fp32 on the same weights and injected views (TRAINER_TOL,
              beside an internal known-bad control); each drive's host seconds and
              launches, and no plain version called on the card;
then the kernels' JSON line (times, bounds, launches, the SDPA times,
the K6/K9 forwards' device times and SDPA's, K10's and K12's chain
times, phase 14's launches as ``explain_launches``, and the rows of
``conv_q8`` and ``quantize_act_q8``: the int8 convolution and the int8
quantisation, which replace no TPU kernel but ``models/resnet_q8.py``'s
XLA conv and quantisation, their times the sums over a trunk forward and
their launches phase 15's serving drive's; and phase 16's rows
``attn_block_bias``, ``attn_block_q8_bias`` and ``attn_block_q8s_bias``,
each with ``unbiased_ms`` beside its time and its launches phase 16's
serving drives'; phase 17's bundle replays as ``export_launches`` and
phase 18's int8 students' b1 and b8 serving drives and bundle replay as
``student_launches``, phase 19's drives as ``research_launches``,
phase 20's as ``trainer_launches``), and the device JSON line last.

Exits non-zero with no result line when no CUDA device is present.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfu_multimodal_tpu_torch.config import AugmentConfig
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import Bottleneck, ResNet50
from dfu_multimodal_tpu_torch.models.vit import quantize_variables
from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import conv_q8 as cq
from dfu_multimodal_tpu_torch.ops import fused_mlp as fm
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8
from dfu_multimodal_tpu_torch.serve.engine import (ServingEngine,
                                                   quantize_for_serving,
                                                   tome_for_serving)
from dfu_multimodal_tpu_torch.tools.profile_train import (TRAIN_BATCH,
                                                          recipe_trainer,
                                                          synthetic_thermal)
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   class_weights_from_labels,
                                                   rgb_modality,
                                                   thermal_modality)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_errors(out: torch.Tensor, ref: torch.Tensor):
    err = (out.float() - ref.float()).abs()
    rel = err / ref.float().abs().clamp_min(1e-3)
    return float(err.max()), float(rel.max())


# ---------------------------------------------------------------- phase 1


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; device_count={torch.cuda.device_count()}")
    log(card())
    return name


# ---------------------------------------------------------------- phase 2


SOURCES = ("vit_block", "fused_mlp", "attention", "vit_block_q8",
           "resnet_block", "attn_block_bwd", "conv_q8")


def phase_build() -> None:
    def build(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        seconds = dict(zip(SOURCES, pool.map(build, SOURCES)))
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        log(f"[build] {name}.cu: {seconds[name]:.2f} s "
            f"-> {_build.library_path(name)}")
        for line in _build.ptxas_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "entry",
                                       "warning")):
                log(f"[ptxas] {line.strip()}")
    _log_tensor_core_sass("attention", "attention_fwd_mma")
    # K1's bf16 attention step (the deferred division): tensor-core MMAs
    # in every instantiation, or the phase fails
    _log_tensor_core_sass("vit_block", "attention_fwd_mma", required=True)
    # the bf16 backward of K5/K6/K9 and K10's attention step: tensor-core
    # MMAs in every instantiation, or the phase fails
    for name in ("attention", "attn_block_bwd"):
        for kernel in ("attention_bwd_q_mma", "attention_bwd_kv_mma"):
            _log_tensor_core_sass(name, kernel, required=True)
    # the bf16 products of K1, K2, K4 and the attention chain rule
    # (gemm_sm90.cuh): warpgroup MMAs in every instantiation, or the phase
    # fails
    _log_tensor_core_sass("vit_block", "gemm_kernel", op="HGMMA",
                          required=True)
    # K7/K8: their int8 products on int8 warpgroup MMAs in every
    # instantiation, no int8 WMMA (IMMA) left, and their bf16 attention
    # step on mma.sync
    _log_tensor_core_sass("vit_block_q8", "gemm_kernel", op="IGMMA",
                          required=True)
    _log_tensor_core_sass("vit_block_q8", "attention_fwd_mma", required=True)
    _log_tensor_core_sass("vit_block_q8", "", op="IMMA", forbidden=True)
    # the int8 convolution's products: int8 warpgroup MMAs in every
    # instantiation of its GEMM, no int8 WMMA
    _log_tensor_core_sass("conv_q8", "gemm_kernel", op="IGMMA",
                          required=True)
    _log_tensor_core_sass("conv_q8", "", op="IMMA", forbidden=True)
    # K11 in bf16: its products (B_MN) and its 3x3 (CONV) on warpgroup MMAs
    # in every instantiation; K12's bf16 stage kernel walks the same tiles
    # (warpgroup MMAs in every instantiation); K10's bf16 products (qkv,
    # dattn, dy and the WGRAD weight gradients) too, beside its mma.sync
    # attention step (HMMA, above).  No WMMA kernel left in either library
    _log_tensor_core_sass("resnet_block", "gemm_kernel", op="HGMMA",
                          required=True)
    _log_tensor_core_sass("resnet_block", "stage_kernel", op="HGMMA",
                          required=True)
    _log_tensor_core_sass("attn_block_bwd", "gemm_kernel", op="HGMMA",
                          required=True)
    for name, kernels in (("resnet_block", ("gemm_bf16_wmma",
                                            "stage_bf16_wmma")),
                          ("attn_block_bwd", ("gemm_bf16_wmma",
                                              "wgrad_bf16_wmma"))):
        for kernel in kernels:
            _log_tensor_core_sass(name, kernel, forbidden=True)
    # bind the entry points now, so a missing symbol fails this phase
    vb._lib()
    at._lib()
    q8._lib()
    rb._lib()
    vb._k10_lib()
    cq._lib()
    _build.load("fused_mlp", fm._SIGNATURES)


def _log_tensor_core_sass(name: str, kernel: str, op: str = "HMMA",
                          required: bool = False,
                          forbidden: bool = False) -> None:
    """The count of tensor-core instructions ``op`` (HMMA: mma.sync;
    HGMMA / IGMMA: bf16 / int8 wgmma; IMMA: int8 mma / WMMA) in the SASS
    of each instantiation of ``kernel`` in library ``name`` (cuobjdump
    -sass, beside nvcc), which shows that the kernel runs on the tensor
    cores.  ``required``: raise when the tool is missing, no
    instantiation is found, or one has none.  ``forbidden``: raise when
    the tool is missing or any function ``kernel`` names ("" every one)
    has one."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        log(f"[sass] {kernel}: {op} count not measured (no {tool})")
        if required or forbidden:
            raise AssertionError(f"{kernel}: no cuobjdump to count {op}")
        return
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts = []
    for section in sass.split("Function : ")[1:]:
        func = section.split(None, 1)[0]
        if kernel in func:
            ops = re.findall(rf"\b{op}\.[\w.]+", section)
            counts.append(len(ops))
            if not forbidden or ops:
                log(f"[sass] {func}: {len(ops)} {op} instructions "
                    f"({', '.join(sorted(set(ops))) or 'none'})")
    if required and (not counts or min(counts) == 0):
        raise AssertionError(f"{kernel} in lib{name}.so: {op} counts "
                             f"{counts}, want at least one in each")
    if forbidden:
        log(f"[sass] lib{name}.so: {sum(counts)} {op} instructions in "
            f"{len(counts)} functions (none allowed)")
        if sum(counts):
            raise AssertionError(f"lib{name}.so: {sum(counts)} {op} "
                                 "instructions, want none")


# ---------------------------------------------------------------- phase 3

KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# token counts past one block's shared memory for the whole-head attention
# kernels (the backward's past 208 at D = 64, the forward's past ~420):
# 240², 256² and 384² images
LARGE_N = (226, 257, 577)
# at D = 64 the largest head each whole-head kernel takes, and the next,
# which goes to its tiled kernel: the backward of K5/K6/K9, the fp32
# forward of K6/K9 (attention_kernels.cuh's bwd_smem, fwd_smem; the bf16
# forward is one kernel for every N) and K1/K7/K8's attention core
# (attention_core.cuh's launch_attention)
SPLIT_BWD, SPLIT_FWD, SPLIT_CORE = (208, 209), (421, 422), (424, 425)


def _log_split(label, rows) -> None:
    """The whole-head kernel's time at the last N it takes beside the
    tiled kernel's at the next N (``rows``: two (N, result) pairs)."""
    (nw, whole), (nt, tiled) = rows
    log(f"[split] {label}: whole-head N={nw} {whole['ms']:.4f} ms, tiled "
        f"N={nt} {tiled['ms']:.4f} ms, tiled / whole "
        f"{tiled['ms'] / whole['ms']:.3f} (work {(nt / nw) ** 2:.4f}x)")


def _randn(gen, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    t = torch.randn(*shape, generator=gen, device=gen.device)
    return (offset + scale * t).to(dtype)


def _attn_block_params(gen, c, dtype):
    """(g1, b1, wqkv, bqkv, wproj, bproj) of an attention block, weights
    in ``dtype``, vectors fp32."""
    return (_randn(gen, c, scale=0.1, offset=1.0), _randn(gen, c, scale=0.1),
            _randn(gen, c, 3 * c, scale=c ** -0.5, dtype=dtype),
            _randn(gen, 3 * c, scale=0.1),
            _randn(gen, c, c, scale=c ** -0.5, dtype=dtype),
            _randn(gen, c, scale=0.1))


def _attn_block_args(gen, b, n, c, dtype):
    """x (B, N, C) and the block's parameters (_attn_block_params)."""
    x = _randn(gen, b, n, c, dtype=dtype)
    return x, _attn_block_params(gen, c, dtype)


def _check_and_time(label, kernel, plain, tol, mean_tol=None,
                    sums=()):
    """Hold the kernel's output(s) against the plain version's within
    |err| <= tol·(1 + |ref|) (and, with ``mean_tol``, the mean of
    |err| / (1 + |ref|) within it), then time both in turns.  Outputs
    whose index is in ``sums`` (sums over all rows of rounded terms) are
    held within tol·(1 + max|ref|) instead."""
    outs, refs = kernel(), None
    torch.cuda.synchronize()
    refs = plain()
    if isinstance(outs, torch.Tensor):
        outs, refs = (outs,), (refs,)
    abs_err = rel_err = mean_err = 0.0
    ok = True
    for i, (out, ref) in enumerate(zip(outs, refs)):
        a, r = max_errors(out, ref)
        abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        mag = ref.float().abs()
        scaled = (out.float() - ref.float()).abs() / (
            1.0 + (mag.max() if i in sums else mag))
        mean_err = max(mean_err, float(scaled.mean()))
        ok = ok and out.shape == ref.shape and bool(
            torch.isfinite(out.float()).all()) and bool((scaled <= tol).all())
    if mean_tol is not None:
        ok = ok and mean_err <= mean_tol
    del outs, refs
    k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
    p_ms2, k_ms2 = cuda_ms(plain), cuda_ms(kernel)     # turns: p, k, k, p
    k_ms, p_ms = (k_ms + k_ms2) / 2, (p_ms + p_ms2) / 2
    mean = ("" if mean_tol is None else
            f" mean_err={mean_err:.3e} (tol {mean_tol:g})")
    sums = f" (outputs {list(sums)}: 1+max|ref|)" if sums else ""
    log(f"[kernel] {label}: max_abs_err={abs_err:.3e} max_rel_err="
        f"{rel_err:.3e} tol=|err|<={tol:g}*(1+|ref|){sums}{mean} kernel_ms="
        f"{k_ms:.4f} plain_ms={p_ms:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max abs err {abs_err:.3e})")
    return {"max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms}


def phase_kernels(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, c, heads = 197, 768, 12
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (8, 16, 128):       # serving 8, training 16, a large batch
            g = torch.Generator(device=dev).manual_seed(b)
            x = _randn(g, b, n, c, dtype=dtype)
            ln = (_randn(g, c, scale=0.1, offset=1.0),
                  _randn(g, c, scale=0.1))
            wqkv = _randn(g, c, 3 * c, scale=c ** -0.5, dtype=dtype)
            bqkv = _randn(g, 3 * c, scale=0.1)
            wproj = _randn(g, c, c, scale=c ** -0.5, dtype=dtype)
            bproj = _randn(g, c, scale=0.1)
            w1 = _randn(g, c, 4 * c, scale=c ** -0.5, dtype=dtype)
            b1 = _randn(g, 4 * c, scale=0.1)
            w2 = _randn(g, 4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype)
            b2 = _randn(g, c, scale=0.1)
            tag = f"{str(dtype).split('.')[1]} B={b}"
            attn = _check_and_time(
                f"attn_block {tag}",
                lambda: vb.attn_block(x, *ln, wqkv, bqkv, wproj, bproj,
                                      heads),
                lambda: vb.attn_block_ref(x, *ln, wqkv, bqkv, wproj, bproj,
                                          heads), KERNEL_TOL[dtype])
            mlp = _check_and_time(
                f"mlp_block {tag}",
                lambda: vb.mlp_block(x, *ln, w1, b1, w2, b2),
                lambda: vb.mlp_block_ref(x, *ln, w1, b1, w2, b2),
                KERNEL_TOL[dtype])
            if dtype == torch.bfloat16:
                _k1_k2_bf16_checks(tag, x, ln, (wqkv, bqkv, wproj, bproj),
                                   (w1, b1, w2, b2), heads, attn, mlp)
            if dtype == torch.bfloat16 and b == 8:   # the serving shape
                main["attn_block"], main["mlp_block"] = attn, mlp
            del x, wqkv, wproj, w1, w2
            torch.cuda.empty_cache()
    # a 384² image (N = 577): the attention core's tiled kernel; and the
    # two sides of its split
    for dtype in (torch.float32, torch.bfloat16):
        rows = []
        for n_large in (LARGE_N[-1], *SPLIT_CORE):
            g = torch.Generator(device=dev).manual_seed(n_large)
            x, p = _attn_block_args(g, 8, n_large, c, dtype)
            rows.append((n_large, _check_and_time(
                f"attn_block {str(dtype).split('.')[1]} B=8 N={n_large}",
                lambda: vb.attn_block(x, *p, heads),
                lambda: vb.attn_block_ref(x, *p, heads), KERNEL_TOL[dtype])))
            if dtype == torch.bfloat16 and n_large == LARGE_N[-1]:
                _bf16_checks(f"B=8 N={n_large}", "attn_block",
                             lambda: vb.attn_block(x, *p, heads),
                             lambda: vb.attn_block_ref(x, *p, heads),
                             lambda: vb.attn_block_ref(
                                 x.float(), *(t.float() for t in p), heads),
                             prefix="kernel")
            del x, p
        _log_split(f"attn_block {str(dtype).split('.')[1]} B=8", rows[1:])
    dims = (2816, 512, 256, 2)
    for dtype in (torch.float32, torch.bfloat16):
        for b in (8, 13, 128):
            g = torch.Generator(device=dev).manual_seed(1000 + b)
            args = [_randn(g, b, dims[0], dtype=dtype)]
            for din, dout in zip(dims[:-1], dims[1:]):
                args += [_randn(g, din, dout, scale=din ** -0.5,
                                dtype=dtype),
                         _randn(g, dout, scale=0.1)]
            tag = f"{str(dtype).split('.')[1]} B={b}"
            res = _check_and_time(f"fused_mlp {tag}",
                                  lambda: fm.fused_mlp(*args),
                                  lambda: fm.fused_mlp_ref(*args),
                                  KERNEL_TOL[dtype])
            _k3_checks(tag, args, res)
            if dtype == torch.float32 and b == 8:
                main["fused_mlp"] = res
    return main


def _k3_checks(tag, args, res) -> None:
    """K3 as the model calls it: each weight the transposed view of an
    (out, in) row-major matrix (``fusion_mlp_params``), bit-equal to the
    same weights row-major (in, out); two calls bit-equal (no atomics);
    device ms of the kernel and of the plain version from the profiler
    (``res`` takes the kernel's as ``device_ms``)."""
    x, w1, b1, w2, b2, w3, b3 = args
    views = [w.t().contiguous().t() for w in (w1, w2, w3)]

    def linear_views():
        return fm.fused_mlp(x, views[0], b1, views[1], b2, views[2], b3)

    out = fm.fused_mlp(*args)
    calls = torch.equal(out, fm.fused_mlp(*args))
    layouts = torch.equal(out, linear_views())
    res["device_ms"] = _device_ms(lambda: fm.fused_mlp(*args))
    views_ms = _device_ms(linear_views)
    plain_ms = _device_ms(lambda: fm.fused_mlp_ref(*args))
    log(f"[kernel] fused_mlp {tag}: device {_ms_or_none(res['device_ms'])}"
        f" (nn.Linear views {_ms_or_none(views_ms)}, plain "
        f"{_ms_or_none(plain_ms)}); views bit-equal to (in, out) weights: "
        f"{layouts}; two calls bit-equal: {calls} "
        f"{'ok' if calls and layouts else 'FAIL'}")
    if not (calls and layouts):
        raise AssertionError(f"fused_mlp {tag}: bits differ")


# the host's tensor maps of one bf16 forward block: two a product (A and
# B), two products a block
FWD_TENSOR_MAPS = 4


def _k1_k2_bf16_checks(tag, x, ln, attn_w, mlp_w, heads, attn, mlp) -> None:
    """The bf16 K1 and K2 (TMA + wgmma products, K1's attention step on
    the tensor cores): each no further from the fp32 result on the same
    values than its plain version and two calls bit-equal
    (_bf16_checks); their device time by kernel (profiler) beside the
    CUDA-event time; and the yardsticks, logged and never called by the
    port: their two products each through ``torch.matmul`` (cuBLAS, bf16
    results) on the same operands, timed in turns with the kernel, and
    for K1 SDPA over the strided views of the block's packed qkv (no
    single PyTorch call computes either block, so library_ms stays
    null)."""
    wqkv, bqkv, wproj, bproj = attn_w
    w1, b1, w2, b2 = mlp_w
    b, n, c = x.shape
    rows = b * n
    gen = torch.Generator(device=x.device).manual_seed(rows)
    y = _randn(gen, rows, c, dtype=x.dtype)          # the products' A
    a_attn = _randn(gen, rows, c, dtype=x.dtype)
    h = _randn(gen, rows, 4 * c, dtype=x.dtype)
    qkv = _randn(gen, b, n, 3 * c, dtype=x.dtype)
    q, k, v = at._unpack(qkv, heads)
    for name, res, kernel, plain, fp32, products, extra in (
            ("attn_block", attn,
             lambda: vb.attn_block(x, *ln, *attn_w, heads),
             lambda: vb.attn_block_ref(x, *ln, *attn_w, heads),
             lambda: vb.attn_block_ref(
                 x.float(), *ln, *(t.float() for t in attn_w), heads),
             lambda: (torch.matmul(y, wqkv), torch.matmul(a_attn, wproj)),
             lambda: F.scaled_dot_product_attention(q, k, v)),
            ("mlp_block", mlp,
             lambda: vb.mlp_block(x, *ln, *mlp_w),
             lambda: vb.mlp_block_ref(x, *ln, *mlp_w),
             lambda: vb.mlp_block_ref(
                 x.float(), *ln, *(t.float() for t in mlp_w)),
             lambda: (torch.matmul(y, w1), torch.matmul(h, w2)), None)):
        _bf16_checks(tag, name, kernel, plain, fp32, prefix="kernel")
        k_ms, l_ms = _turns(kernel, products)
        split = _device_split(kernel)
        res.update(device_ms=sum(split.values()) or None,
                   cublas_products_ms=l_ms,
                   cublas_products_device_ms=_device_ms(products))
        line = (f"[kernel] {name} {tag}: CUDA events {k_ms:.4f} ms, device "
                f"(profiler) {_ms_or_none(res['device_ms'])}: "
                + ", ".join(f"{kn} {ms:.4f}" for kn, ms in split.items())
                + f"; yardstick, its two products through torch.matmul "
                f"(cuBLAS, bf16): events {l_ms:.4f} ms, device "
                f"{_ms_or_none(res['cublas_products_device_ms'])}")
        if extra is not None:
            res["sdpa_device_ms"] = _device_ms(extra)
            line += (f"; SDPA on the block's qkv, device "
                     f"{_ms_or_none(res['sdpa_device_ms'])}")
        log(line)
    lib, ns = vb._lib(), ctypes.c_double()
    _build.check(lib, lib.dfu_tensor_map_encode_ns(
        y.data_ptr(), rows, c, 1000, ctypes.addressof(ns)), "encode")
    log(f"[kernel] attn_block / mlp_block {tag}: tensor-map encoding on "
        f"the host {ns.value:.1f} ns each, {FWD_TENSOR_MAPS} a block "
        f"({FWD_TENSOR_MAPS * ns.value / 1e3:.2f} us)")


# --------------------------------------------------------------- phase 3b

K4_OUTPUTS = ("dx", "y", "h", "dhpre", "dg2", "db2")
K4_TENSOR_MAPS = 6              # encoded on the host for each bf16 call


def _k4_bf16_checks(tag, args, res) -> None:
    """The bf16 K4 (TMA + wgmma products, csrc/gemm_sm90.cuh): each output
    no further from the fp32 result on the same values than the plain
    version and two calls bit-equal (_bf16_checks); its device time
    (profiler, by kernel) beside the CUDA-event time; and a yardstick,
    logged and never called by the port: its three products through
    ``torch.matmul`` (cuBLAS, bf16 results) on the same operands, timed
    in turns with the kernel (no single PyTorch call computes K4, so its
    library_ms stays null)."""
    def kernel():
        return vb.mlp_block_bwd(*args)

    _bf16_checks(tag, "mlp_block_bwd", kernel,
                     lambda: vb.mlp_block_bwd_ref(*args),
                     lambda: vb.mlp_block_bwd_ref(*(t.float() for t in args)),
                     prefix="kernel", names=K4_OUTPUTS)
    _, g, _, _, w1, _, w2 = args
    _, y, _, dhpre, _, _ = kernel()
    g2d = g.reshape(y.shape)

    def products():
        return (torch.matmul(y, w1), torch.matmul(g2d, w2.t()),
                torch.matmul(dhpre, w1.t()))

    k_ms, l_ms = _turns(kernel, products)
    split = _device_split(kernel)
    res.update(device_ms=sum(split.values()) or None,
               cublas_products_ms=l_ms,
               cublas_products_device_ms=_device_ms(products))
    log(f"[kernel] mlp_block_bwd {tag}: CUDA events {k_ms:.4f} ms, device "
        f"(profiler) {_ms_or_none(res['device_ms'])}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"[kernel] mlp_block_bwd {tag}: yardstick, its three products "
        f"through torch.matmul (cuBLAS, bf16): events {l_ms:.4f} ms, device "
        f"{_ms_or_none(res['cublas_products_device_ms'])}")


def _log_tensor_map_cost(x) -> None:
    """The host's cost of one tensor map of K4's bf16 products (the C
    entry encodes K4_TENSOR_MAPS a call), over 1000 encodings."""
    lib, ns = vb._lib(), ctypes.c_double()
    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    _build.check(lib, lib.dfu_tensor_map_encode_ns(
        x.data_ptr(), rows, c, 1000, ctypes.addressof(ns)), "encode")
    log(f"[kernel] mlp_block_bwd: tensor-map encoding on the host "
        f"{ns.value:.1f} ns each, {K4_TENSOR_MAPS} a bf16 call")


# token counts of the bf16 backward's small cases: one partial 64-row
# tile, and 40 of 64
BWD_SMALL_N = (5, 40)


def _k5_bf16_checks(tag, qkv, dout, heads, res, timed=True) -> None:
    """The bf16 K5 (csrc/attention_bwd_mma.cuh) no further from the fp32
    result than its plain version and two calls bit-equal
    (_bf16_checks); with ``timed`` its device time (profiler, by kernel)
    beside SDPA forward + backward's on the strided views of the same
    operands, the yardstick (no single call computes K5)."""
    def kernel():
        return at.qkv_attention_fwdbwd(qkv, dout, heads)

    _bf16_checks(tag, "qkv_attention_fwdbwd", kernel,
                 lambda: at.qkv_attention_fwdbwd_ref(qkv, dout, heads),
                 lambda: at.qkv_attention_fwdbwd_ref(qkv.float(),
                                                     dout.float(), heads),
                 names=("attn", "dqkv"))
    if not timed:
        return
    b, n, c = dout.shape
    q, k, v = at._unpack(qkv, heads)
    do = dout.view(b, n, heads, c // heads).transpose(1, 2)
    split = _device_split(kernel)
    res.update(device_ms=sum(split.values()) or None,
               library_fwd_bwd_device_ms=_device_ms(
                   lambda: _sdpa_fwd_bwd(q, k, v, do)))
    log(f"[kernel] qkv_attention_fwdbwd {tag}: device (profiler) "
        f"{_ms_or_none(res['device_ms'])}: "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in split.items())
        + f"; SDPA forward + backward device "
        f"{_ms_or_none(res['library_fwd_bwd_device_ms'])}; bound "
        f"{_attention_bwd_bound(b, n, c, True)}")


def phase_backward_kernels(dev) -> dict:
    """K4 and K5 against their plain versions at the training path's
    shapes (ViT-B/16, B = 16) and at B = 128; in bf16 K4 also against the
    fp32 result, across two calls and beside cuBLAS (_k4_bf16_checks)."""
    n, c, heads = 197, 768, 12
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (16, 128):
            g = torch.Generator(device=dev).manual_seed(2000 + b)
            x = _randn(g, b, n, c, dtype=dtype)
            dout = _randn(g, b, n, c, dtype=dtype)
            ln = (_randn(g, c, scale=0.1, offset=1.0),
                  _randn(g, c, scale=0.1))
            w1 = _randn(g, c, 4 * c, scale=c ** -0.5, dtype=dtype)
            b1 = _randn(g, 4 * c, scale=0.1)
            w2 = _randn(g, 4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype)
            qkv = _randn(g, b, n, 3 * c, dtype=dtype)
            tag = f"{str(dtype).split('.')[1]} B={b}"
            mlp = _check_and_time(
                f"mlp_block_bwd {tag}",
                lambda: vb.mlp_block_bwd(x, dout, *ln, w1, b1, w2),
                lambda: vb.mlp_block_bwd_ref(x, dout, *ln, w1, b1, w2),
                KERNEL_TOL[dtype])
            if dtype == torch.bfloat16:
                _k4_bf16_checks(tag, (x, dout, *ln, w1, b1, w2), mlp)
            att = _check_and_time(
                f"qkv_attention_fwdbwd {tag}",
                lambda: at.qkv_attention_fwdbwd(qkv, dout, heads),
                lambda: at.qkv_attention_fwdbwd_ref(qkv, dout, heads),
                KERNEL_TOL[dtype])
            if dtype == torch.bfloat16:
                _k5_bf16_checks(tag, qkv, dout, heads, att)
            if dtype == torch.bfloat16 and b == 16:  # the training shape
                main["mlp_block_bwd"], main["qkv_attention_fwdbwd"] = mlp, att
                _log_tensor_map_cost(x)
            del x, dout, w1, w2, qkv
            torch.cuda.empty_cache()
        rows = {}
        # one partial tile, a tile edge, fp32's split, then past it
        for n_other in (*BWD_SMALL_N, *SPLIT_BWD, *LARGE_N):
            g = torch.Generator(device=dev).manual_seed(2500 + n_other)
            qkv = _randn(g, TRAIN_BATCH, n_other, 3 * c, dtype=dtype)
            dout = _randn(g, TRAIN_BATCH, n_other, c, dtype=dtype)
            tag = f"{str(dtype).split('.')[1]} B={TRAIN_BATCH} N={n_other}"
            rows[n_other] = _check_and_time(
                f"qkv_attention_fwdbwd {tag}",
                lambda: at.qkv_attention_fwdbwd(qkv, dout, heads),
                lambda: at.qkv_attention_fwdbwd_ref(qkv, dout, heads),
                KERNEL_TOL[dtype])
            if dtype == torch.bfloat16:
                _k5_bf16_checks(tag, qkv, dout, heads, rows[n_other],
                                timed=n_other == LARGE_N[-1])
            del qkv, dout
        if dtype == torch.float32:      # the bf16 backward has no split
            _log_split(f"qkv_attention_fwdbwd float32 B={TRAIN_BATCH}",
                       [(n, rows[n]) for n in SPLIT_BWD])
    return main


# --------------------------------------------------------------- phase 3c

# int8 kernels vs their plain versions: the two take the LayerNorm and
# attention sums in another order, so a value within an ulp of a rounding
# boundary quantises one int8 step apart; when it is a row's absmax the
# whole row's scale moves, up to the int8 noise itself.  So each element
# within 2e-2·(1+|ref|), and the mean of |err|/(1+|ref|) within 5e-4,
# which a systematic fault (a wrong scale, a wrong chunk) would exceed.
Q8_TOL, Q8_MEAN_TOL = 2e-2, 5e-4
# calibrated act scales of the static kernels' inputs: LN output, then
# attention / GELU output
Q8_ACT = (4.5 / 127, 1.5 / 127)
Q8_BATCHES = (8, 128)        # the serving batch, and a large one
# the int8 products against the plain integer arithmetic: bit for bit (the
# int32 sums are exact in any order, the flush and epilogues round the
# same operations in the same order) but GELU_F32, whose erf may differ
# from PyTorch's gelu in its last bits
Q8_ERF_TOL = 1e-6
# a block's int8 products: name -> (dynamic epilogue, static epilogue, n,
# k, K groups), at ViT-B/16's C = 768, hidden 3072
Q8_PRODUCTS = {"qkv": (q8.QEPI_OUT, q8.QEPI_OUT, 3 * 768, 768, 1),
               "proj": (q8.QEPI_RESID, q8.QEPI_RESID, 768, 768, 1),
               "fc1": (q8.QEPI_GELU_F32, q8.QEPI_GELU_Q8, 3072, 768, 1),
               "fc2": (q8.QEPI_RESID, q8.QEPI_RESID, 768, 3072, 4)}


def _q8_gemm_checks(dev, dtype, b, timed) -> dict:
    """Each int8 product of the blocks at B images of 197 tokens, with
    dynamic row scales and static (K8's epilogues), on seeded int8
    operands and scales: the card's GEMM bit for bit against the plain
    integer arithmetic (``q8.gemm_q8_ref``; GELU_F32 within
    Q8_ERF_TOL·(1+|ref|)).  ``timed``: the device ms of each (profiler)
    beside ``torch._int_mm`` (cuBLASLt s8·s8→s32, no dequantisation) on
    the same operands, a yardstick the port never calls.  Returns
    {product: (kernel dynamic ms, kernel static ms, _int_mm ms)}."""
    rows, lib = b * 197, q8._lib()
    g = torch.Generator(device=dev).manual_seed(4000 + b)
    inv = torch.tensor([127 / 1.5], device=dev)
    times = {}
    for name, (epi_dyn, epi_st, n, k, groups) in Q8_PRODUCTS.items():
        a_q = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                            dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        w_t = w.t().contiguous()
        row_scale = torch.rand(rows, groups, generator=g, device=dev) \
            * 0.02 + 1e-3
        col = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
        bias = _randn(g, n, scale=0.1)
        resid = _randn(g, rows, n, dtype=dtype)
        ms = []
        for epi, rs, sc in ((epi_dyn, row_scale, col),
                            (epi_st, None, col * 0.02)):
            out = torch.empty(rows, n, device=dev, dtype={
                q8.QEPI_GELU_F32: torch.float32,
                q8.QEPI_GELU_Q8: torch.int8}.get(epi, dtype))

            def kernel():
                q8._gemm(lib, dtype, epi, a_q, w_t, rs, sc, bias, resid,
                         inv.data_ptr(), out, k // groups, name)
            kernel()
            torch.cuda.synchronize()
            ref = q8.gemm_q8_ref(epi, a_q, w, rs, sc, bias, resid, inv,
                                 k // groups, dtype)
            if epi == q8.QEPI_GELU_F32:
                err = float(((out - ref).abs() / (1 + ref.abs())).max())
                ok, what = err <= Q8_ERF_TOL, f"max {err:.3e} (tol " \
                    f"{Q8_ERF_TOL:g}·(1+|ref|))"
            else:
                diff = int((out != ref).sum())
                ok, what = diff == 0, f"{diff} elements differ"
            scales = "static" if rs is None else "dynamic"
            label = (f"int8 product {name} {scales} "
                     f"{str(dtype).split('.')[1]} rows={rows}")
            log(f"[kernel] {label}: against the plain integer arithmetic "
                f"{what} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: not the plain arithmetic")
            if timed:
                ms.append(_device_ms(kernel))
        if timed:
            ms.append(_device_ms(lambda: torch._int_mm(a_q, w_t.t())))
            ops = 2 * rows * n * k
            log(f"[kernel] int8 product {name} rows={rows} n={n} k={k}: "
                f"device dynamic {_ms_or_none(ms[0])}, static "
                f"{_ms_or_none(ms[1])}; yardstick torch._int_mm "
                f"{_ms_or_none(ms[2])}"
                + ("" if not ms[0] else
                   f"; {ops / ms[0] / 1e9:.0f} TOP/s dynamic"))
            times[name] = tuple(ms)
        del a_q, w, w_t, resid
    return times


def _q8_dense(gen, din, dout):
    w = _randn(gen, din, dout, scale=din ** -0.5)
    w_q8, s = q8.quantize_weight(w)
    return w_q8, s, _randn(gen, dout, scale=0.1)


def _q8_device_split(tag, res, products, blocks) -> None:
    """The int8 blocks' device time by kernel (profiler) into ``res``
    (device_ms), beside the yardstick of their two products through
    ``torch._int_mm`` (int_mm_products_device_ms)."""
    pairs = {"attn": ("qkv", "proj"), "mlp": ("fc1", "fc2")}
    for name, fn in blocks.items():
        split = _device_split(fn)
        int_mm = sum(products[p][2] or 0.0 for p in pairs[name.split("_")[0]])
        res[name].update(device_ms=sum(split.values()) or None,
                         int_mm_products_device_ms=int_mm or None)
        log(f"[kernel] {name} {tag}: device (profiler) "
            f"{_ms_or_none(res[name]['device_ms'])}: "
            + ", ".join(f"{kn} {ms:.4f}" for kn, ms in split.items())
            + f"; yardstick, its two products through torch._int_mm "
            f"{_ms_or_none(res[name]['int_mm_products_device_ms'])}")


def phase_q8_kernels(dev) -> dict:
    """K7 and K8 against their plain versions at the serving path's shape
    (ViT-B/16, B = 8) and at B = 128, in fp32 and bf16; their int8
    products against the plain integer arithmetic (_q8_gemm_checks); in
    bf16 their device time by kernel beside torch._int_mm's products."""
    n, c, heads = 197, 768, 12
    inv = torch.tensor([1.0 / a for a in Q8_ACT], device=dev)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in Q8_BATCHES:
            g = torch.Generator(device=dev).manual_seed(3000 + b)
            x = _randn(g, b, n, c, dtype=dtype)
            ln = (_randn(g, c, scale=0.1, offset=1.0),
                  _randn(g, c, scale=0.1))
            wqkv, sqkv, bqkv = _q8_dense(g, c, 3 * c)
            wproj, sproj, bproj = _q8_dense(g, c, c)
            w1, s1, b1 = _q8_dense(g, c, 4 * c)
            w2, s2, b2 = _q8_dense(g, 4 * c, c)
            attn = (*ln, wqkv, sqkv, bqkv, wproj, sproj, bproj)
            attn_s = (*ln, wqkv, sqkv * Q8_ACT[0], bqkv, wproj,
                      sproj * Q8_ACT[1], bproj, inv)
            mlp = (*ln, w1, s1, b1, w2, s2, b2)
            mlp_s = (*ln, w1, s1 * Q8_ACT[0], b1, w2, s2 * Q8_ACT[1], b2,
                     inv)
            # the weights' K-major copies, made once as the model makes
            # them (a call without them makes its own)
            attn_t = (wqkv.t().contiguous(), wproj.t().contiguous())
            mlp_t = (w1.t().contiguous(), w2.t().contiguous())
            tag = f"{str(dtype).split('.')[1]} B={b}"
            blocks = {
                "attn_block_q8": lambda: q8.attn_block_q8(
                    x, *attn, heads, kmajor=attn_t),
                "mlp_block_q8": lambda: q8.mlp_block_q8(x, *mlp,
                                                        kmajor=mlp_t),
                "attn_block_q8s": lambda: q8.attn_block_q8s(
                    x, *attn_s, heads, kmajor=attn_t),
                "mlp_block_q8s": lambda: q8.mlp_block_q8s(x, *mlp_s,
                                                          kmajor=mlp_t)}
            plains = {
                "attn_block_q8": lambda: q8.attn_block_q8_ref(x, *attn,
                                                              heads),
                "mlp_block_q8": lambda: q8.mlp_block_q8_ref(x, *mlp),
                "attn_block_q8s": lambda: q8.attn_block_q8s_ref(
                    x, *attn_s, heads),
                "mlp_block_q8s": lambda: q8.mlp_block_q8s_ref(x, *mlp_s)}
            res = {name: _check_and_time(f"{name} {tag}", blocks[name],
                                         plains[name], Q8_TOL, Q8_MEAN_TOL)
                   for name in blocks}
            products = _q8_gemm_checks(dev, dtype, b,
                                       timed=dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                _q8_device_split(tag, res, products, blocks)
            if dtype == torch.bfloat16 and b == 8:   # the serving shape
                main = res
            del x, attn, attn_s, mlp, mlp_s, attn_t, mlp_t, blocks, plains
            torch.cuda.empty_cache()
        # a 384² image: the attention core's tiled kernel; and the two
        # sides of its split
        rows = []
        for n_large in (LARGE_N[-1], *SPLIT_CORE):
            g = torch.Generator(device=dev).manual_seed(3000 + n_large)
            x = _randn(g, 8, n_large, c, dtype=dtype)
            ln = (_randn(g, c, scale=0.1, offset=1.0),
                  _randn(g, c, scale=0.1))
            wqkv, sqkv, bqkv = _q8_dense(g, c, 3 * c)
            wproj, sproj, bproj = _q8_dense(g, c, c)
            attn = (*ln, wqkv, sqkv, bqkv, wproj, sproj, bproj)
            attn_t = (wqkv.t().contiguous(), wproj.t().contiguous())
            rows.append((n_large, _check_and_time(
                f"attn_block_q8 {str(dtype).split('.')[1]} B=8 N={n_large}",
                lambda: q8.attn_block_q8(x, *attn, heads, kmajor=attn_t),
                lambda: q8.attn_block_q8_ref(x, *attn, heads), Q8_TOL,
                Q8_MEAN_TOL)))
            del x, attn
        _log_split(f"attn_block_q8 {str(dtype).split('.')[1]} B=8",
                   rows[1:])
    return main


# --------------------------------------------------------------- phase 3d

# ResNet-50's stride-1 bottlenecks: (label, H = W, Cin, Cmid, Cout); the
# projection block is stage 1's first, the others are identity blocks
RESNET_BLOCKS = (("stage1 block0 proj", 56, 64, 64, 256),
                 ("stage1 blocks1-2", 56, 256, 64, 256),
                 ("stage2 blocks1-3", 28, 512, 128, 512),
                 ("stage3 blocks1-5", 14, 1024, 256, 1024),
                 ("stage4 blocks1-2", 7, 2048, 512, 2048))
RESNET_BATCHES = (8, 128)            # the serving batch, and a large one
# the kernels line's shape of each variant, at B = 8 in bf16
RESNET_MAIN = {"stage3 blocks1-5": "bottleneck",
               "stage1 block0 proj": "bottleneck_proj"}


def _bottleneck_weights(gen, cin, cmid, cout, dtype):
    """BN-folded (w1, b1, w2, b2, w3, b3[, wd, bd]) in the kernel's layouts;
    the projection when Cin != Cout."""
    args = [_randn(gen, cin, cmid, scale=cin ** -0.5, dtype=dtype),
            _randn(gen, cmid, scale=0.1),
            _randn(gen, 9 * cmid, cmid, scale=(9 * cmid) ** -0.5,
                   dtype=dtype),
            _randn(gen, cmid, scale=0.1),
            _randn(gen, cmid, cout, scale=cmid ** -0.5, dtype=dtype),
            _randn(gen, cout, scale=0.1)]
    if cin != cout:
        args += [_randn(gen, cin, cout, scale=cin ** -0.5, dtype=dtype),
                 _randn(gen, cout, scale=0.1)]
    return args


def _cudnn_block_ms(dev, x, cin, cmid) -> tuple:
    """The default path's yardstick for the same block: the port's
    ``Bottleneck.forward`` in eval (cuDNN convs, BatchNorm, ReLU, add: a
    few launches, not one library call) on x's channels-last view; (CUDA
    events ms, profiler device ms)."""
    block = Bottleneck(cin, cmid).to(dev).eval()
    xc = x.permute(0, 3, 1, 2)

    def run():
        with torch.inference_mode():
            return block(xc)

    return cuda_ms(run), _device_ms(run)


def phase_resnet_kernels(dev) -> dict:
    """K11 against its plain version at every stride-1 bottleneck shape of
    ResNet-50, B = 8 and 128, fp32 and bf16, beside the cuDNN block (CUDA
    events and profiler device ms of both); in bf16 two calls bit-equal."""
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in RESNET_BATCHES:
            for label, hw, cin, cmid, cout in RESNET_BLOCKS:
                g = torch.Generator(device=dev).manual_seed(4000 + b + hw)
                x = _randn(g, b, hw, hw, cin, dtype=dtype)
                args = _bottleneck_weights(g, cin, cmid, cout, dtype)
                tag = f"{label} {str(dtype).split('.')[1]} B={b}"
                bound = _bottleneck_bound(b, hw, cin, cmid, cout)
                res = _check_and_time(
                    f"fused_bottleneck {tag}",
                    lambda: rb.fused_bottleneck(x, *args),
                    lambda: rb.bottleneck_ref(x, *args), KERNEL_TOL[dtype])
                res["device_ms"] = _device_ms(
                    lambda: rb.fused_bottleneck(x, *args))
                cudnn_ms, cudnn_dev = _cudnn_block_ms(dev, x, cin, cmid)
                calls = torch.equal(rb.fused_bottleneck(x, *args),
                                    rb.fused_bottleneck(x, *args))
                log(f"[resnet] {tag}: device {_ms_or_none(res['device_ms'])};"
                    f" cuDNN Bottleneck.forward (eval) {cudnn_ms:.4f} ms, "
                    f"device {_ms_or_none(cudnn_dev)}; bound "
                    f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})"
                    f"; two calls bit-equal: {calls} "
                    f"{'ok' if calls else 'FAIL'}")
                if not calls:
                    raise AssertionError(f"fused_bottleneck {tag}: bits "
                                         f"differ across calls")
                if dtype == torch.bfloat16 and b == 8 and label in RESNET_MAIN:
                    main[RESNET_MAIN[label]] = res
                del x, args
                torch.cuda.empty_cache()
    return main



# --------------------------------------------------------------- phase 3e

ATTN_BATCHES = (8, 16, 128)      # serving 8, training 16, a large batch
# (B, heads, N, D) of the small cases: the scale d**-0.5 is no power of
# two at D = 8 and 32, so the scores are scaled after the product; then
# one partial tile (N = 5) and N = 40 at the training batch
ATTN_SMALL = ((2, 4, 40, 8), (2, 4, 40, 32), (16, 12, 5, 64),
              (16, 12, 40, 8), (16, 12, 40, 32))
# bf16 tensor-core kernels (the K6/K9 forwards, the K5/K6/K9 backwards,
# K4): the kernel's distance from the fp32 result on the same values
# within 10% of the plain version's (as K10_VS_PLAIN in phase 3f)
BF16_VS_PLAIN = 0.1


def _turns(a, b):
    """Mean ms per call of ``a`` and of ``b``, timed in turns a, b, b, a."""
    a1, b1 = cuda_ms(a), cuda_ms(b)
    b2, a2 = cuda_ms(b), cuda_ms(a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _sdpa_fwd_bwd(q, k, v, do):
    """SDPA forward + backward: (dq, dk, dv) of <SDPA(q, k, v), do>."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad(F.scaled_dot_product_attention(q, k, v),
                               (q, k, v), do)


def _device_split(fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` runs (short name: the
    kernel's own, template arguments kept), from the profiler over
    ``iters`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].rsplit("::", 1)[-1] + (
                "<" + name.split("<", 1)[1] if "<" in name else "")
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / iters)
    return split


def _device_ms(fn, iters: int = 20):
    """Device time per call of ``fn``: the sum of its kernels' times from
    the profiler over ``iters`` calls, after a warm-up call (the host's
    launch cost left out); None when the profiler recorded no kernel."""
    return sum(_device_split(fn, iters).values()) or None


def _ms_or_none(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _bf16_checks(tag, name, kernel, plain, fp32, prefix="attention",
                 names=None) -> None:
    """A bf16 tensor-core kernel (the K6/K9 forwards, the K5/K6/K9
    backwards, K4's products) no further from the fp32 result on the same
    values than its plain version: each output's max|err| within
    BF16_VS_PLAIN of the plain's,
    plus fp32's KERNEL_TOL·(1 + max|fp32|) for the summation order; two
    calls bit-equal.  ``names`` labels the outputs of a kernel that
    returns a tuple of them."""
    outs, again, truths, plains = kernel(), kernel(), fp32(), plain()
    if names is None:
        outs, again, truths, plains = (outs,), (again,), (truths,), (plains,)
    ok = True
    for label, out, out2, truth, ref in zip(names or ("",), outs, again,
                                            truths, plains):
        truth = truth.float()
        a = float((out.float() - truth).abs().max())
        p = float((ref.float() - truth).abs().max())
        slack = KERNEL_TOL[torch.float32] * (1 + float(truth.abs().max()))
        near = a <= (1 + BF16_VS_PLAIN) * p + slack
        equal = torch.equal(out, out2)
        ok = ok and near and equal
        log(f"[{prefix}] {name}{' ' + label if label else ''} {tag}: "
            f"max|err| against the fp32 result on the same values, kernel "
            f"/ plain {a:.3e} / {p:.3e} (kernel within "
            f"{1 + BF16_VS_PLAIN:g}x plain + {slack:.2e}) "
            f"{'ok' if near else 'FAIL'}; two calls bit-equal: {equal}")
    if not ok:
        raise AssertionError(f"{name} {tag}: further from the fp32 result "
                             "than its plain version, or two calls differ")


def _attention_case(g, b, heads, n, d, dtype) -> dict:
    """K6 and K9, forward and backward, against their plain versions on
    one shape, each row with SDPA's time on the same operands; in bf16
    (the tensor-core kernels) every output also against the fp32 result
    and across two calls (_bf16_checks), with the device time of each
    kernel and of SDPA (_device_ms; a backward row's backward alone and
    its forward + backward, beside SDPA's forward + backward)."""
    c = heads * d
    tol = KERNEL_TOL[dtype]
    tag = f"{str(dtype).split('.')[1]} B={b} N={n} H={heads} D={d}"
    qkv = _randn(g, b, n, 3 * c, dtype=dtype)
    do = _randn(g, b, n, c, dtype=dtype)
    q6, k6, v6 = at._unpack(qkv, heads)           # strided (B, H, N, D)
    do6 = do.view(b, n, heads, d).transpose(1, 2)
    q, k, v, do9 = (_randn(g, b, heads, n, d, dtype=dtype) for _ in range(4))
    res = {
        "qkv_attention_fwd": _check_and_time(
            f"qkv_attention_fwd {tag}", lambda: at.qkv_attention_fwd(qkv,
                                                                     heads),
            lambda: at.qkv_attention_ref(qkv, heads), tol),
        "qkv_attention_bwd": _check_and_time(
            f"qkv_attention_bwd {tag}",
            lambda: at.qkv_attention_bwd(qkv, do, heads),
            lambda: at.qkv_attention_bwd_ref(qkv, do, heads), tol),
        "flash_attention_fwd": _check_and_time(
            f"flash_attention_fwd {tag}",
            lambda: at.flash_attention_fwd(q, k, v),
            lambda: at.flash_attention_ref(q, k, v), tol),
        "flash_attention_bwd": _check_and_time(
            f"flash_attention_bwd {tag}",
            lambda: at.flash_attention_bwd(q, k, v, do9),
            lambda: at.flash_attention_bwd_ref(q, k, v, do9), tol)}
    if dtype == torch.bfloat16:
        _bf16_checks(
            tag, "qkv_attention_fwd",
            lambda: at.qkv_attention_fwd(qkv, heads),
            lambda: at.qkv_attention_ref(qkv, heads),
            lambda: at.qkv_attention_ref(qkv.float(), heads))
        _bf16_checks(
            tag, "flash_attention_fwd",
            lambda: at.flash_attention_fwd(q, k, v),
            lambda: at.flash_attention_ref(q, k, v),
            lambda: at.flash_attention_ref(q.float(), k.float(), v.float()))
        _bf16_checks(
            tag, "qkv_attention_bwd",
            lambda: at.qkv_attention_bwd(qkv, do, heads),
            lambda: at.qkv_attention_bwd_ref(qkv, do, heads),
            lambda: at.qkv_attention_bwd_ref(qkv.float(), do.float(), heads))
        _bf16_checks(
            tag, "flash_attention_bwd",
            lambda: at.flash_attention_bwd(q, k, v, do9),
            lambda: at.flash_attention_bwd_ref(q, k, v, do9),
            lambda: at.flash_attention_bwd_ref(q.float(), k.float(),
                                               v.float(), do9.float()),
            names=("dq", "dk", "dv"))
    # SDPA in turns with the kernels: a forward row beside one SDPA call;
    # a backward row's forward + backward beside SDPA forward + backward
    # (a backward needs the forward's statistics, so no single call
    # computes it: its library_ms stays null)
    pairs = {
        "qkv_attention_fwd": (
            lambda: at.qkv_attention_fwd(qkv, heads),
            lambda: F.scaled_dot_product_attention(q6, k6, v6)),
        "flash_attention_fwd": (
            lambda: at.flash_attention_fwd(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v)),
        "qkv_attention_bwd": (
            lambda: (at.qkv_attention_fwd(qkv, heads),
                     at.qkv_attention_bwd(qkv, do, heads)),
            lambda: _sdpa_fwd_bwd(q6, k6, v6, do6)),
        "flash_attention_bwd": (
            lambda: (at.flash_attention_fwd(q, k, v),
                     at.flash_attention_bwd(q, k, v, do9)),
            lambda: _sdpa_fwd_bwd(q, k, v, do9))}
    backward = {
        "qkv_attention_bwd": lambda: at.qkv_attention_bwd(qkv, do, heads),
        "flash_attention_bwd": lambda: at.flash_attention_bwd(q, k, v, do9)}
    for name, (kernel, library) in pairs.items():
        k_ms, l_ms = _turns(kernel, library)
        if name.endswith("_fwd"):
            res[name]["library_ms"] = l_ms
            log(f"[attention] {name} {tag}: kernel {k_ms:.4f} ms, SDPA "
                f"{l_ms:.4f} ms")
            if dtype == torch.bfloat16:
                d_ms, ld_ms = _device_ms(kernel), _device_ms(library)
                res[name].update(device_ms=d_ms, library_device_ms=ld_ms)
                log(f"[attention] {name} {tag}: device time (profiler) "
                    f"kernel {_ms_or_none(d_ms)}, SDPA {_ms_or_none(ld_ms)}")
        else:
            res[name].update(library_ms=None, fwd_bwd_ms=k_ms,
                             library_fwd_bwd_ms=l_ms)
            log(f"[attention] {name} {tag}: kernel forward + backward "
                f"{k_ms:.4f} ms, SDPA forward + backward {l_ms:.4f} ms")
            if dtype == torch.bfloat16:
                d_ms = _device_ms(backward[name])
                f_ms, ld_ms = _device_ms(kernel), _device_ms(library)
                res[name].update(device_ms=d_ms, fwd_bwd_device_ms=f_ms,
                                 library_fwd_bwd_device_ms=ld_ms)
                log(f"[attention] {name} {tag}: device time (profiler) "
                    f"backward {_ms_or_none(d_ms)}, forward + backward "
                    f"{_ms_or_none(f_ms)}, SDPA forward + backward "
                    f"{_ms_or_none(ld_ms)}; backward's bound "
                    f"{_attention_bwd_bound(b, n, c)}")
    return res


def phase_attention_kernels(dev) -> tuple:
    """K6 and K9 against their plain versions at ViT-B/16's attention,
    then K9's entry point through autograd.  Returns (the rows at the
    paths' shapes: forward at B = 8, backward at B = 16, bf16; K9's
    launch counts)."""
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in ATTN_BATCHES:
            g = torch.Generator(device=dev).manual_seed(5000 + b)
            res = _attention_case(g, b, 12, 197, 64, dtype)
            if dtype == torch.bfloat16 and b == 8:    # the serving shape
                main.update((k, v) for k, v in res.items()
                            if k.endswith("_fwd"))
            if dtype == torch.bfloat16 and b == TRAIN_BATCH:
                main.update((k, v) for k, v in res.items()
                            if k.endswith("_bwd"))
            torch.cuda.empty_cache()
        for shape in ATTN_SMALL:
            g = torch.Generator(device=dev).manual_seed(5500 + shape[-1])
            _attention_case(g, *shape, dtype)
        rows = {}
        for n in (*SPLIT_BWD, *SPLIT_FWD, *LARGE_N):  # splits, then tiled
            g = torch.Generator(device=dev).manual_seed(5600 + n)
            rows[n] = _attention_case(g, TRAIN_BATCH, 12, n, 64, dtype)
            torch.cuda.empty_cache()
        splits = []
        if dtype == torch.float32:      # no bf16 attention kernel splits
            splits += [("qkv_attention_bwd", SPLIT_BWD),
                       ("flash_attention_bwd", SPLIT_BWD),
                       ("qkv_attention_fwd", SPLIT_FWD),
                       ("flash_attention_fwd", SPLIT_FWD)]
        for name, split in splits:
            _log_split(f"{name} {str(dtype).split('.')[1]} B={TRAIN_BATCH}",
                       [(n, rows[n][name]) for n in split])

    # K9 is on no model path: its path is its own trainable entry point
    g = torch.Generator(device=dev).manual_seed(5900)
    q, k, v = (_randn(g, TRAIN_BATCH, 12, 197, 64, dtype=torch.bfloat16
                      ).requires_grad_() for _ in range(3))
    do = _randn(g, TRAIN_BATCH, 12, 197, 64, dtype=torch.bfloat16)
    _reset_launches()
    at.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize(dev)
    launches = {"flash_attention_fwd": at.flash_attention_fwd.launches,
                "flash_attention_bwd": at.flash_attention_bwd.launches}
    log(f"[attention] flash_attention forward + backward through autograd "
        f"at B={TRAIN_BATCH} bf16: launches {launches}")
    if launches != {"flash_attention_fwd": 1, "flash_attention_bwd": 1}:
        raise AssertionError(f"flash_attention launches {launches}")
    grads = at.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       do)
    for t, ref in zip((q, k, v), grads):
        a, _ = max_errors(t.grad, ref)
        if a > KERNEL_TOL[torch.bfloat16] * (1 + float(ref.float().abs(
                ).max())):
            raise AssertionError(f"flash_attention gradient off by {a}")
    return main, launches


# --------------------------------------------------------------- phase 3f

K10_BATCHES = (16, 32)      # the training batch, and the A/B script's
# (B, heads, N, D): K10 scales q in the compute dtype for every head dim,
# where K5 scales the fp32 scores at D = 8 and 32
K10_SMALL = ((2, 4, 40, 8), (2, 4, 40, 32))
K10_NAMES = ("dx", "dg1", "db1", "dwqkv", "dbqkv", "dwproj", "dbproj")
# bf16: K10's distance from the fp32 result within 10% of the plain's
K10_VS_PLAIN = 0.1
DEPTH = 12


def _k10_args(gen, b, n, c, dtype):
    """K10's operands: x, g (B, N, C) and the block parameters."""
    x, p = _attn_block_args(gen, b, n, c, dtype)
    return (x, _randn(gen, b, n, c, dtype=dtype), *p)


def _k10_kernel_names(args, heads) -> list:
    """Device kernels (name, count) of one K10 call, from the profiler."""
    vb.attn_block_bwd_fused(*args, heads)              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vb.attn_block_bwd_fused(*args, heads)
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _k10_case(gen, b, heads, n, c, dtype, chain=True) -> dict:
    """K10 against its plain version, each of its seven results within
    KERNEL_TOL: dx per element; in bf16 the six parameter gradients, sums
    over B·N rows of bf16-rounded terms, within KERNEL_TOL of 1 + their
    own max|ref| (as phase 5 holds each parameter's gradient against its
    own max|g|: their rounding noise follows the summed terms, not the
    element — the k-bias gradient is 0 in exact arithmetic), and each of
    the seven no further from the fp32 result on the same values than the
    plain version: within K10_VS_PLAIN of the plain's distance, plus
    fp32's KERNEL_TOL·(1 + max|fp32|) for the summation order.  Two calls
    bit-equal; with ``chain`` the port's K5 chain rule ``attn_block_bwd``
    timed in turns with it and, in fp32, K10 against the chain's
    gradients."""
    tag = f"{str(dtype).split('.')[1]} B={b} N={n} H={heads} D={c // heads}"
    args = _k10_args(gen, b, n, c, dtype)
    res = _check_and_time(
        f"attn_block_bwd_fused {tag}",
        lambda: vb.attn_block_bwd_fused(*args, heads),
        lambda: vb.attn_block_bwd_fused_ref(*args, heads), KERNEL_TOL[dtype],
        sums=range(1, 7) if dtype == torch.bfloat16 else ())
    if dtype == torch.bfloat16:
        f32 = [a.float() for a in args]
        truth = vb.attn_block_bwd_fused_ref(*f32, heads)
        dist = {name: (float((o.float() - t).abs().max()),
                       float((r.float() - t).abs().max()),
                       KERNEL_TOL[torch.float32] * (1 + float(t.abs().max())))
                for name, o, r, t in zip(
                    K10_NAMES, vb.attn_block_bwd_fused(*args, heads),
                    vb.attn_block_bwd_fused_ref(*args, heads), truth)}
        ok = all(a <= (1 + K10_VS_PLAIN) * p + s for a, p, s in dist.values())
        log(f"[k10] {tag}: max|err| against the fp32 result on the same "
            f"values, K10 / plain (K10 within {1 + K10_VS_PLAIN:g}x plain + "
            f"1e-4*(1+max|fp32|)): "
            f"{({k: f'{a:.3e} / {p:.3e}' for k, (a, p, _) in dist.items()})}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K10 {tag}: further from the fp32 result "
                                 "than its plain version")
    first = vb.attn_block_bwd_fused(*args, heads)
    second = vb.attn_block_bwd_fused(*args, heads)
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[k10] {tag}: two calls bit-equal: {equal}")
    if not equal:
        raise AssertionError(f"K10 {tag}: two calls differ")
    if not chain:
        return res
    x, g, g1, b1, wqkv, bqkv, wproj, bproj = args
    chain_fn = lambda: vb.attn_block_bwd(x, g, g1, b1, wqkv, bqkv, wproj,
                                         heads)
    k_ms, c_ms = _turns(lambda: vb.attn_block_bwd_fused(*args, heads),
                        chain_fn)
    res["chain_ms"] = c_ms
    log(f"[k10] {tag}: K10 {k_ms:.4f} ms, K5 chain rule (attn_block_bwd) "
        f"{c_ms:.4f} ms, in turns")
    if dtype == torch.bfloat16:
        split = _device_split(lambda: vb.attn_block_bwd_fused(*args, heads))
        res["device_ms"] = sum(split.values()) or None
        attention = sum(ms for name, ms in split.items()
                        if "attention_bwd" in name)
        log(f"[k10] {tag}: device (profiler) "
            f"{_ms_or_none(res['device_ms'])}, of which the attention step "
            f"(attention_bwd_*) {attention:.4f} ms; by kernel "
            f"(gemm_kernel<BN, mode>: 1 B_MN, 2 B_K, 7 WGRAD) "
            f"{({k: round(v, 4) for k, v in sorted(split.items(), key=lambda kv: -kv[1])})}")
        chain_split = _device_split(chain_fn)
        log(f"[k10] {tag}: the K5 chain rule's device (profiler) "
            f"{sum(chain_split.values()):.4f} ms, by kernel "
            f"{({k: round(v, 4) for k, v in sorted(chain_split.items(), key=lambda kv: -kv[1])})}")
    if dtype == torch.float32:
        errs = {}
        for name, a, r in zip(K10_NAMES, first, chain_fn()):
            errs[name] = float(((a - r.to(a.dtype)).abs()
                                / (1.0 + r.abs())).max())
        ok = max(errs.values()) <= KERNEL_TOL[dtype]
        log(f"[k10] {tag}: K10 vs the K5 chain's fp32 gradients, max "
            f"|err|/(1+|ref|) {({k: f'{v:.2e}' for k, v in errs.items()})} "
            f"(tol {KERNEL_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K10 {tag} disagrees with the chain rule")
    return res


def _block_chain(dev, b, n, c, heads, seed):
    """x0, dout (B, N, C) bf16 and DEPTH blocks' parameters (bf16
    weights, fp32 vectors), leaves that take gradients."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = _randn(gen, b, n, c, dtype=torch.bfloat16)
    dout = _randn(gen, b, n, c, dtype=torch.bfloat16)
    blocks = [[t.requires_grad_() for t in _attn_block_params(
        gen, c, torch.bfloat16)] for _ in range(DEPTH)]
    return x0, dout, blocks


def _chain_grads(fn, x0, dout, blocks, heads):
    """Gradients of <chain(x0), dout> for x0 and every block parameter,
    the DEPTH blocks applied through ``fn`` (an autograd Function)."""
    x = x0.detach().requires_grad_()
    h = x
    for p in blocks:
        h = fn.apply(h, *p, heads)
    leaves = [x] + [t for p in blocks for t in p]
    return torch.autograd.grad(h, leaves, dout)


def phase_k10(dev) -> tuple:
    """K10 against its plain version at ViT-B/16's block (B = 16 and 32,
    fp32 and bf16; beside the K5 chain rule) and at N = 40 with D = 8
    and 32; the kernels one call runs; then its entry point, a DEPTH-
    block ``AttnBlockFusedBwd`` chain through autograd at B = 32 in bf16
    (launches counted, beside ``AttnBlock``'s chain in turns, two runs
    bit-equal).  Returns (the row at the training shape, B = 16 bf16;
    the chain's launch counts)."""
    n, c, heads = 197, 768, 12
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in K10_BATCHES:
            g = torch.Generator(device=dev).manual_seed(6000 + b)
            res = _k10_case(g, b, heads, n, c, dtype)
            if dtype == torch.bfloat16 and b == TRAIN_BATCH:
                main["attn_block_bwd_fused"] = res
            torch.cuda.empty_cache()
        for b, h, n_small, d in K10_SMALL:
            g = torch.Generator(device=dev).manual_seed(6100 + d)
            _k10_case(g, b, h, n_small, h * d, dtype, chain=False)
        # one partial tile, past fp32's split, and a 384² image
        for n_other in (BWD_SMALL_N[0], LARGE_N[0], LARGE_N[-1]):
            g = torch.Generator(device=dev).manual_seed(6000 + n_other)
            _k10_case(g, TRAIN_BATCH, heads, n_other, c, dtype, chain=False)

    # one call's device kernels: the port's own only (fp32: the results
    # need no cast; bf16: the two weight gradients' casts to bf16 follow)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(6300)
        args = _k10_args(g, TRAIN_BATCH, n, c, dtype)
        _reset_launches()
        names = _k10_kernel_names(args, heads)
        own = sum(k for name, k in names if "dfu::" in name)
        other = [name for name, _ in names if "dfu::" not in name]
        log(f"[k10] {str(dtype).split('.')[1]} B={TRAIN_BATCH}: one call "
            f"runs {own} device kernels of the port's own "
            f"({len([1 for name, _ in names if 'dfu::' in name])} distinct)"
            f"; others: {other}")
        casts = all("copy" in name for name in other)
        if (dtype == torch.float32 and other) or not casts or \
                at.qkv_attention_fwdbwd.launches:
            raise AssertionError(f"K10 ran kernels not its own: {other}")

    b = max(K10_BATCHES)
    x0, dout, blocks = _block_chain(dev, b, n, c, heads, 6400)
    _reset_launches()
    grads = _chain_grads(vb.AttnBlockFusedBwd, x0, dout, blocks, heads)
    torch.cuda.synchronize(dev)
    launches = {"attn_block": vb.attn_block.launches,
                "attn_block_bwd_fused": vb.attn_block_bwd_fused.launches,
                "qkv_attention_fwdbwd": at.qkv_attention_fwdbwd.launches}
    log(f"[k10] {DEPTH}-block AttnBlockFusedBwd chain through autograd at "
        f"B={b} bf16: launches {launches}")
    if launches != {"attn_block": DEPTH, "attn_block_bwd_fused": DEPTH,
                    "qkv_attention_fwdbwd": 0}:
        raise AssertionError(f"chain launches {launches}")
    again = _chain_grads(vb.AttnBlockFusedBwd, x0, dout, blocks, heads)
    equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in grads)
    log(f"[k10] chain gradients finite: {finite}; two runs bit-equal: "
        f"{equal}")
    if not (equal and finite):
        raise AssertionError("K10 chain gradients differ or are not finite")
    k10_ms, k5_ms = _turns(
        lambda: _chain_grads(vb.AttnBlockFusedBwd, x0, dout, blocks, heads),
        lambda: _chain_grads(vb.AttnBlock, x0, dout, blocks, heads))
    log(f"[k10] {DEPTH}-block chain forward + backward at B={b} bf16, in "
        f"turns: AttnBlockFusedBwd (K1 + K10) {k10_ms:.4f} ms, AttnBlock "
        f"(K1 + K5 chain rule) {k5_ms:.4f} ms")
    del x0, dout, blocks, grads, again
    torch.cuda.empty_cache()
    return main, {"attn_block_bwd_fused": launches["attn_block_bwd_fused"]}


# --------------------------------------------------------------- phase 3g

# ResNet-50's stride-1 stage tails, the identity blocks after each stage's
# first: (label, H = W, C, Cmid, blocks)
RESNET_STAGES = (("stage1", 56, 256, 64, 2), ("stage2", 28, 512, 128, 3),
                 ("stage3", 14, 1024, 256, 5), ("stage4", 7, 2048, 512, 2))
STAGE_MAIN = "stage3"           # the kernels line's shape, B = 8 in bf16
# bf16: over a stage the one-step roundings that KERNEL_TOL admits for one
# block carry into the next block, so each block is held within KERNEL_TOL
# of its plain version on the same input (the stage equals the K11 chain
# bit for bit), and the whole stage's mean distance from the fp32 result
# on the same values within STAGE_VS_PLAIN of the plain version's
STAGE_VS_PLAIN = 0.1


def _stage_modules(dev, c, cmid, n, gen) -> list:
    """n identity ``Bottleneck``s (eval) with seeded weights and BatchNorm
    statistics off identity: their folded_weights feed the kernels, their
    forward is the cuDNN yardstick of the same blocks."""
    mods = []
    for _ in range(n):
        m = Bottleneck(c, cmid).to(dev).eval()
        zoo.init_model(m, gen)
        _perturb_batchnorm(m, gen)
        mods.append(m)
    return mods


def _k11_chain(x, blocks) -> list:
    """The inputs and outputs of the K11 chain over ``blocks``."""
    hs = [x]
    for blk in blocks:
        hs.append(rb.fused_bottleneck(hs[-1], *blk))
    return hs


def _stage_case(label, x, blocks, mods) -> dict:
    """K12 against its plain version (fp32: the whole stage within
    KERNEL_TOL; bf16: STAGE_VS_PLAIN's two checks), bit-equal to the K11
    chain and across two calls, then timed in turns with the plain
    version, the K11 chain and the cuDNN chain of the same blocks."""
    dtype, tol = x.dtype, KERNEL_TOL[x.dtype]
    out = rb.fused_stage(x, blocks)
    again = rb.fused_stage(x, blocks)
    hs = _k11_chain(x, blocks)
    ref = rb.stage_ref(x, blocks)
    torch.cuda.synchronize()
    abs_err, rel_err = max_errors(out, ref)
    scaled = float(((out.float() - ref.float()).abs()
                    / (1.0 + ref.float().abs())).max())
    chain_equal, calls_equal = torch.equal(out, hs[-1]), torch.equal(out,
                                                                     again)
    finite = bool(torch.isfinite(out.float()).all())
    ok = chain_equal and calls_equal and finite and out.shape == x.shape
    if dtype == torch.float32:
        ok = ok and scaled <= tol
        detail = f"whole stage |err|/(1+|ref|) {scaled:.3e} (tol {tol:g})"
    else:
        per_block = max(float(((o.float() - r.float()).abs()
                               / (1.0 + r.float().abs())).max())
                        for o, r in ((hs[k + 1], rb.bottleneck_ref(hs[k],
                                                                   *blk))
                                     for k, blk in enumerate(blocks)))
        truth = rb.stage_ref(x.float(), [[t.float() for t in blk]
                                         for blk in blocks])
        d_k = float((out.float() - truth).abs().mean())
        d_p = float((ref.float() - truth).abs().mean())
        ok = (ok and per_block <= tol
              and d_k <= (1 + STAGE_VS_PLAIN) * d_p)
        detail = (f"each block |err|/(1+|ref|) {per_block:.3e} (tol {tol:g}"
                  f"); whole stage {scaled:.3e}; mean|err| against the fp32 "
                  f"result, K12 / plain {d_k:.3e} / {d_p:.3e} (within "
                  f"{1 + STAGE_VS_PLAIN:g}x)")
    log(f"[stage] fused_stage {label}: max_abs_err={abs_err:.3e} "
        f"max_rel_err={rel_err:.3e}; {detail}; bit-equal to the K11 chain: "
        f"{chain_equal}; two calls bit-equal: {calls_equal} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_stage {label} disagrees")
    del out, again, hs, ref
    xc = x.permute(0, 3, 1, 2)                 # channels-last NCHW view

    def k12():
        return rb.fused_stage(x, blocks)

    def plain():
        return rb.stage_ref(x, blocks)

    def chain():
        return _k11_chain(x, blocks)[-1]

    def cudnn():
        with torch.inference_mode():
            h = xc
            for m in mods:
                h = m(h)
            return h

    k_ms, p_ms = _turns(k12, plain)
    c_ms, n_ms = _turns(chain, cudnn)
    k_ms2, c_ms2 = _turns(k12, chain)
    res = {"max_abs_err": abs_err, "ms": (k_ms + k_ms2) / 2,
           "plain_ms": p_ms, "chain_ms": (c_ms + c_ms2) / 2,
           "cudnn_ms": n_ms}
    log(f"[stage] {label}: K12 {res['ms']:.4f} ms ({k_ms:.4f}, "
        f"{k_ms2:.4f}), K11 chain {res['chain_ms']:.4f} ms, cuDNN "
        f"Bottleneck.forward chain (eval) {n_ms:.4f} ms, plain {p_ms:.4f} "
        f"ms, in turns")
    return res


def _stage_tails(net, dtype) -> list:
    """The folded identity tails of the four stages of a ResNet."""
    with torch.no_grad():
        return [[blk.folded_weights(dtype) for blk in getattr(
            net, f"layer{i}")[1:]] for i in range(1, 5)]


# one fused_stage call under torch.profiler in a fresh process: late in
# this long process the profiler kept the host's cudaLaunchCooperativeKernel
# but not the device's record of the kernel (plain launches were kept),
# while a fresh process records both.  Prints the device kernels (name,
# count) and the host's launch calls (cudaLaunch*, cuLaunch*) as JSON.
STAGE_PROFILE = r"""
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
dt, dev = getattr(torch, "{dtype}"), torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(7200)
def r(*shape, s=1.0, d=dt):
    return (s * torch.randn(*shape, generator=g, device=dev)).to(d)
c, m = 1024, 256                      # ResNet-50's stage 3 tail, B = 8
x = r(8, 14, 14, c)
blocks = [(r(c, m, s=c ** -0.5), r(m, s=0.1, d=torch.float32),
           r(9 * m, m, s=(9 * m) ** -0.5), r(m, s=0.1, d=torch.float32),
           r(m, c, s=m ** -0.5), r(c, s=0.1, d=torch.float32))
          for _ in range(5)]
rb.fused_stage(x, blocks)             # warm
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    rb.fused_stage(x, blocks)
    torch.cuda.synchronize()
events = prof.key_averages()
print(json.dumps([
    [[e.key, e.count] for e in events if e.device_type == DeviceType.CUDA],
    [[e.key, e.count] for e in events
     if e.device_type == DeviceType.CPU and "Launch" in e.key]]))
"""


def _stage_kernel_names(dtype) -> tuple:
    """The device kernels (name, count) of one fused_stage call at stage
    3's tail, B = 8, and the launch calls the host made (STAGE_PROFILE)."""
    proc = subprocess.run(
        [sys.executable, "-c",
         STAGE_PROFILE.format(dtype=str(dtype).split(".")[1])],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        check=True)
    names, calls = json.loads(proc.stdout.strip().splitlines()[-1])
    return [tuple(n) for n in names], [tuple(c) for c in calls]


# the bf16 K12 and K11 chain's device times at the four stage tails, B = 8
# and 128, in a fresh process (as STAGE_PROFILE, for the cooperative
# kernel's device record).  Prints [label, batch, K12 device ms by kernel,
# K11 chain device ms] rows as JSON.
STAGE_DEVICE = r"""
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(7400)
def r(*shape, s=1.0, d=torch.bfloat16):
    return (s * torch.randn(*shape, generator=g, device=dev)).to(d)
def split(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {{}}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3 / iters
    return out
rows = []
for b in {batches}:
    for label, hw, c, m, n in {stages}:
        x = r(b, hw, hw, c)
        blocks = [(r(c, m, s=c ** -0.5), r(m, s=0.1, d=torch.float32),
                   r(9 * m, m, s=(9 * m) ** -0.5), r(m, s=0.1, d=torch.float32),
                   r(m, c, s=m ** -0.5), r(c, s=0.1, d=torch.float32))
                  for _ in range(n)]
        def chain():
            h = x
            for blk in blocks:
                h = rb.fused_bottleneck(h, *blk)
            return h
        rows.append([label, b, split(lambda: rb.fused_stage(x, blocks)),
                     sum(split(chain).values())])
        del x, blocks
        torch.cuda.empty_cache()
print(json.dumps(rows))
"""


def _stage_device_rows() -> list:
    """STAGE_DEVICE's rows: the bf16 stage kernel's and the K11 chain's
    device ms at every stage tail and batch."""
    proc = subprocess.run(
        [sys.executable, "-c",
         STAGE_DEVICE.format(batches=RESNET_BATCHES,
                             stages=RESNET_STAGES)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _log_stage_device(dev, main) -> None:
    """bf16 K12 by stage tail and batch: the tile shape (dfu_stage_tile,
    held to the plain mirror rb._stage_tile), the grid barriers (3n - 1),
    device ms by kernel beside the K11 chain's device ms and the bound,
    and (K12 - chain) / barriers, an upper estimate of a barrier's cost."""
    lib = rb._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {label: (hw, c, cmid, n)
              for label, hw, c, cmid, n in RESNET_STAGES}
    for label, b, split, chain_ms in _stage_device_rows():
        hw, c, cmid, n = shapes[label]
        rm, bn = ctypes.c_int(), ctypes.c_int()
        _build.check(lib, lib.dfu_stage_tile(
            dev.index, b * hw * hw, cmid, ctypes.addressof(rm),
            ctypes.addressof(bn)), "dfu_stage_tile")
        tile = (rm.value, bn.value)
        if tile != rb._stage_tile(b * hw * hw, cmid, sms):
            raise AssertionError(f"stage tile {tile} != the mirror's")
        k12_ms = sum(split.values())
        barriers = 3 * n - 1
        bound = _stage_bound(b, hw, c, [cmid] * n)["bound_ms"]
        log(f"[stage] {label} bfloat16 B={b}: {tile[0]}x{tile[1]} tiles, "
            f"{barriers} grid barriers; device K12 {k12_ms:.4f} ms "
            f"({({k: round(v, 4) for k, v in split.items()})}), K11 chain "
            f"{chain_ms:.4f} ms, bound {bound * 1e3:.2f} us; (K12 - chain) "
            f"/ barriers {(k12_ms - chain_ms) / barriers * 1e3:.2f} us")
        if (len(split) != 1 or "stage_kernel" not in next(iter(split))):
            raise AssertionError(f"fused_stage {label} ran {split}")
        if b == 8 and label == STAGE_MAIN:
            main["stage"]["device_ms"] = k12_ms
            main["stage"]["chain_device_ms"] = chain_ms


def phase_stage(dev) -> tuple:
    """K12 against its plain version at ResNet-50's four stage tails, B = 8
    and 128, fp32 and bf16 (bit-equal to the K11 chain, two calls
    bit-equal, timed beside the K11 and cuDNN chains); a seeded full-width
    ResNet-50's layer3 tail against its cuDNN blocks; the kernels of one
    call; FusedStage's gradients; then the entry point over the four tails
    of a ResNet-50 forward and backward.  Returns (the row at stage 3, B =
    8, bf16; the entry point's launch counts)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in RESNET_BATCHES:
            for label, hw, c, cmid, n in RESNET_STAGES:
                g = torch.Generator(device=dev).manual_seed(7000 + b + hw)
                mods = _stage_modules(dev, c, cmid, n, g)
                with torch.no_grad():
                    blocks = [m.folded_weights(dtype) for m in mods]
                x = _randn(g, b, hw, hw, c, dtype=dtype)
                bound = _stage_bound(b, hw, c, [cmid] * n)
                tag = f"{label} {str(dtype).split('.')[1]} B={b}"
                log(f"[stage] {tag}: {n} blocks, bound "
                    f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})")
                res = _stage_case(tag, x, blocks, mods)
                if dtype == torch.bfloat16 and b == 8 and label == STAGE_MAIN:
                    main["stage"] = res
                del x, blocks, mods
                torch.cuda.empty_cache()

    _log_stage_device(dev, main)

    # a seeded full-width ResNet-50 (BN off identity): layer3's tail on
    # K12 against its cuDNN blocks, on the activations a batch of images
    # brings there, within phase 7's budget
    net = ResNet50(block_impl="flax").to(dev).eval()
    zoo.init_model(net, torch.Generator(device=dev).manual_seed(7100))
    _perturb_batchnorm(net, torch.Generator(device=dev).manual_seed(7101))
    images = _randn(torch.Generator(device=dev).manual_seed(7102), 8, IMAGE,
                    IMAGE, 3)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        net.dtype = dtype
        seen = {}
        hook = net.layer3[1].register_forward_pre_hook(
            lambda m, a: seen.setdefault("x", a[0]))
        with torch.no_grad():
            net(images)
            hook.remove()
            h = seen["x"].contiguous(memory_format=torch.channels_last)
            ref = net.layer3[1:](h)
            out = rb.fused_stage(h.permute(0, 2, 3, 1),
                                 _stage_tails(net, dtype)[2])
        d = float((out.permute(0, 3, 1, 2).float() - ref.float()).abs().max())
        scale = 1.0 + float(ref.float().abs().max())
        tol = SLICE_TOL[name]["logits"]
        ok = d <= tol * scale
        log(f"[stage] ResNet-50 layer3[1:] {name} B=8 at {IMAGE}x{IMAGE}: "
            f"K12 vs cuDNN blocks max|d|={d:.3e} (tol {tol:g}*(1+max|ref|="
            f"{scale:.3f})) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_stage vs layer3[1:] {name}")
    net.dtype = torch.float32

    # one call's device kernels: the port's own stage kernel only
    for dtype in (torch.float32, torch.bfloat16):
        names, calls = _stage_kernel_names(dtype)
        log(f"[stage] {str(dtype).split('.')[1]} B=8: one call runs "
            f"{names}; host launch calls {calls}")
        if len(names) != 1 or names[0][1] != 1 or "dfu::" not in names[0][0] \
                or "stage_" not in names[0][0] \
                or calls != [("cudaLaunchCooperativeKernel", 1)]:
            raise AssertionError(f"fused_stage ran {names}, {calls}")

    # FusedStage's gradients on the card (fp32) against autograd through
    # stage_ref on the CPU: JAX's budgets, 5e-5 for x and 1e-4 for the
    # weights, of 1 + max|ref| of each tensor — the weight gradients are
    # sums over the B·H·W rows and x's over 5 blocks' channels, so their
    # rounding noise follows the summed terms, not the element (as phase 5
    # holds each parameter's gradient against its own max|g|)
    blocks = _stage_tails(net, torch.float32)[2]
    x = _randn(torch.Generator(device=dev).manual_seed(7300), 2, 14, 14,
               1024)
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.detach().to(where).requires_grad_()
                  for t in [x] + rb.FusedStage.flat(blocks)]
        if where == "cuda":
            out = rb.FusedStage.apply(*leaves)
        else:
            out = rb.stage_ref(leaves[0], [leaves[i:i + 6] for i in range(
                1, len(leaves), 6)])
        (out ** 2).sum().backward()
        grads[where] = [t.grad.cpu() for t in leaves]
    worst, element = [0.0, 0.0], [0.0, 0.0]
    for i, (a, r) in enumerate(zip(grads["cuda"], grads["cpu"])):
        d = (a - r).abs()
        worst[i > 0] = max(worst[i > 0],
                           float(d.max()) / (1.0 + float(r.abs().max())))
        element[i > 0] = max(element[i > 0], float((d / (1.0 + r.abs())
                                                    ).max()))
    ok = worst[0] <= 5e-5 and worst[1] <= 1e-4
    log(f"[stage] FusedStage gradients, card fp32 vs CPU autograd through "
        f"stage_ref (B=2, layer3[1:]), max|d|/(1+max|ref|) per tensor: x "
        f"{worst[0]:.3e} (tol 5e-5), weights {worst[1]:.3e} (tol 1e-4); "
        f"per element |d|/(1+|ref|), not held: x {element[0]:.3e}, weights "
        f"{element[1]:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("FusedStage gradients disagree")

    # the entry point: the four identity tails of a ResNet-50 through
    # FusedStage, forward and backward, bf16 at B = 8
    net.dtype = torch.bfloat16
    seen = {}
    hooks = [getattr(net, f"layer{i}")[1].register_forward_pre_hook(
        lambda m, a, i=i: seen.setdefault(i, a[0])) for i in range(1, 5)]
    with torch.no_grad():
        net(images)
    for hk in hooks:
        hk.remove()
    tails = _stage_tails(net, torch.bfloat16)
    _reset_launches()
    for i, blocks in enumerate(tails, start=1):
        h = seen[i].permute(0, 2, 3, 1).contiguous().requires_grad_()
        out = rb.FusedStage.apply(h, *rb.FusedStage.flat(blocks))
        out.float().square().sum().backward()
        if not bool(torch.isfinite(h.grad.float()).all()):
            raise AssertionError(f"layer{i} tail gradient not finite")
    torch.cuda.synchronize(dev)
    launches = {"stage": rb.fused_stage.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    log(f"[stage] FusedStage over ResNet-50's four stage tails, forward + "
        f"backward, bf16 B=8: launches {launches}")
    if launches != {"stage": 4, "bottleneck": 0}:
        raise AssertionError(f"stage launches {launches}")
    del net, tails, seen, images
    torch.cuda.empty_cache()
    return main, {"stage": launches["stage"]}


# ---------------------------------------------------------------- phase 4

N_REQUESTS, N_THREADS, IMAGE = 24, 3, 224
# card vs CPU (plain fp32) on the same weights and inputs: fp32 differs
# only in summation order; bf16 rounds every activation to 8 bits
SLICE_TOL = {"float32": {"logits": 1e-3, "probs": 1e-4},
             "bfloat16": {"logits": 1e-1, "probs": 5e-2}}


def _trainer(dtype: str, device):
    return Trainer("multimodal", TrainConfig(compute_dtype=dtype),
                   {"rgb": rgb_modality(), "thermal": thermal_modality()},
                   device=device, image_size=IMAGE)


def _logits(trainer, batch):
    with torch.inference_mode():
        trainer.module.eval()
        inputs = {m: torch.as_tensor(batch[m]).to(trainer.device)
                  for m in batch}
        return trainer.module(*trainer._preprocess_eval(inputs)).float().cpu()


def _drive(engine, samples, tag):
    """Start ``engine``, set every launch count to 0, submit ``samples``
    from N_THREADS client threads at a random pace, and stop it.  Returns
    the results in request order and the engine's stats, after checking
    that every request was served without error."""
    futures = [None] * len(samples)
    errors = []

    def client(k: int) -> None:
        try:
            pace = np.random.default_rng(100 + k)
            for i in range(k, len(samples), N_THREADS):
                futures[i] = engine.submit(samples[i])
                time.sleep(float(pace.uniform(0.0, 0.02)))
        except Exception as exc:              # re-raised below
            errors.append(exc)

    t0 = time.perf_counter()
    with engine:
        log(f"[{tag}] engine start (every bucket on the batcher thread): "
            f"{time.perf_counter() - t0:.3f} s")
        _reset_launches()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        results = [f.result(timeout=600) for f in futures]
    stats = engine.stats()
    hist = stats["batch_size_hist"]
    log(f"[{tag}] {stats['requests']} requests in {sum(hist.values())} "
        f"batches, batch sizes {hist}, errors {stats['errors']}")
    log(f"[{tag}] request latency p50={stats['latency_ms']['p50']:.3f} ms "
        f"p99={stats['latency_ms']['p99']:.3f} ms")
    if stats["requests"] != len(samples) or stats["errors"]:
        raise AssertionError(f"stats counted {stats['requests']} requests, "
                             f"{stats['errors']} errors")
    probs = np.array([p for p, _ in results])
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise AssertionError(f"served probabilities out of [0, 1]: {probs}")
    return results, stats


def phase_slice(dev) -> dict:
    torch.cuda.reset_peak_memory_stats(dev)
    served = _trainer("bfloat16", dev)
    zoo.init_model(served.module, torch.Generator(device=dev).manual_seed(0))
    n_params = zoo.param_count(served.module)
    log(f"[slice] multimodal at {IMAGE}x{IMAGE}: {n_params:,} params on "
        f"{dev}, compute bfloat16")
    if n_params != 110_880_834:
        raise AssertionError(f"param count {n_params} != 110,880,834")

    rng = np.random.default_rng(0)
    samples = [{m: rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
                for m in ("rgb", "thermal")} for _ in range(N_REQUESTS)]
    engine = ServingEngine(served, image_size=IMAGE, max_batch=8)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"[slice] warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")

    results, stats = _drive(engine, samples, "slice")
    launches = {"attn_block": vb.attn_block.launches,
                "mlp_block": vb.mlp_block.launches,
                "fused_mlp": fm.fused_mlp.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = sum(stats["batch_size_hist"].values())
    log(f"[slice] peak device memory {peak / 2**20:.1f} MiB; launches "
        f"{launches}")
    probs = np.array([p for p, _ in results])
    want = {"attn_block": 12 * n_batches, "mlp_block": 12 * n_batches,
            "fused_mlp": n_batches}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if any(_resnet_launches().values()):
        raise AssertionError(f"the multimodal RGB branch launched the fused "
                             f"bottleneck: {_resnet_launches()}")

    # the card (served bf16, and fp32) against the CPU's plain fp32 path
    cpu = _trainer("float32", "cpu")
    cpu.module.load_state_dict(served.variables())
    card32 = _trainer("float32", dev)
    card32.module.load_state_dict(served.variables())
    batches = [{m: np.stack([s[m] for s in samples[i:i + 8]])
                for m in ("rgb", "thermal")}
               for i in range(0, N_REQUESTS, 8)]
    ref = torch.cat([_logits(cpu, b) for b in batches])
    ref_probs = torch.softmax(ref, -1)[:, 1].numpy()
    scale = 1.0 + float(ref.abs().max())
    for dtype, trainer in (("float32", card32), ("bfloat16", served)):
        logits = torch.cat([_logits(trainer, b) for b in batches])
        dl = float((logits - ref).abs().max())
        p = (torch.softmax(logits, -1)[:, 1].numpy() if dtype == "float32"
             else probs)
        dp = float(np.abs(p - ref_probs).max())
        tol = SLICE_TOL[dtype]
        ok = dl <= tol["logits"] * scale and dp <= tol["probs"]
        log(f"[slice] card {dtype} vs CPU float32: max|dlogit|={dl:.3e} "
            f"(tol {tol['logits']:g}*(1+max|logit|={scale:.3f})), "
            f"max|dprob|={dp:.3e} (tol {tol['probs']:g}), preds agree "
            f"{int((logits.argmax(-1) == ref.argmax(-1)).sum())}/"
            f"{N_REQUESTS} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"card {dtype} disagrees with the CPU")
    return launches


# ---------------------------------------------------------------- phase 5

TRAIN_IMAGES, TRAIN_PARAMS = 128, 85_800_194
# card fp32 vs CPU fp32 train step on the same weights and batch: the
# gradients differ in summation order only, so each parameter's gradient
# is held within GRAD_TOL of that parameter's own max|g|; the params after
# one AdamW step within 2·lr (Adam's first step is lr·sign(g), and a
# gradient that is ~0 — e.g. the key bias's — may take either sign)
GRAD_TOL = 1e-5
# The gradients of a ResNet trunk in train mode (ReLU after BatchNorm)
# are not continuous at fp32's rounding: moving the trunk's normalised
# input by 1e-7 moves its fp64 gradient 8.0e3 times as far as moving it by
# 1e-9, where softplus in place of ReLU moves it 100 times as far
# (tests/test_torch_train_bn.py::test_trunk_gradient_jumps_at_relu_kinks,
# image 64).  So the card's fp32 trunk gradient is held as one vector
# within TRUNK_L2_TOL of the CPU's (this phase on an H100: 2.1e-2 for
# rgb_only, 2.4e-2 for multimodal; single parameters up to 20%), and the
# trunk's arithmetic in fp64, where no pre-activation crosses 0, at
# GRAD_TOL per parameter (_trunk_fp64_vs_cpu).
TRUNK_L2_TOL = 5e-2
# The layers right after such a trunk (AFTER_TRUNK) see its fp32 forward:
# with the same inputs on both sides the rgb_only loss moved by 4.2e-6
# relative and the head's weight gradient by 3.9e-5 of its max|g|, the
# multimodal fusion head's first weight by 1.8e-5 (this phase on an H100),
# so they are held per parameter at AFTER_TRUNK_TOL, not GRAD_TOL.
AFTER_TRUNK_TOL = 1e-3
TRAIN_KERNELS = ("attn_block", "mlp_block", "mlp_block_bwd",
                 "qkv_attention_fwdbwd")


def _train_launches() -> dict:
    """The launch counts of every kernel a thermal_only train step may
    run: the fused blocks' (K1, K2, K4, K5) and the flax blocks' (K6)."""
    return {"attn_block": vb.attn_block.launches,
            "mlp_block": vb.mlp_block.launches,
            "mlp_block_bwd": vb.mlp_block_bwd.launches,
            "qkv_attention_fwdbwd": at.qkv_attention_fwdbwd.launches,
            "qkv_attention_fwd": at.qkv_attention_fwd.launches,
            "qkv_attention_bwd": at.qkv_attention_bwd.launches}


def _reset_launches() -> None:
    vb.attn_block.launches = vb.mlp_block.launches = 0
    vb.mlp_block_bwd.launches = at.qkv_attention_fwdbwd.launches = 0
    at.qkv_attention_fwd.launches = at.qkv_attention_bwd.launches = 0
    at.flash_attention_fwd.launches = at.flash_attention_bwd.launches = 0
    fm.fused_mlp.launches = vb.attn_block_bwd_fused.launches = 0
    q8.attn_block_q8.launches = q8.mlp_block_q8.launches = 0
    q8.attn_block_q8s.launches = q8.mlp_block_q8s.launches = 0
    rb.fused_bottleneck.launches = rb.fused_bottleneck.proj_launches = 0
    rb.fused_stage.launches = 0
    cq.conv_q8.launches = cq.quantize_act_q8.launches = 0
    vb.attn_block.bias_launches = q8.attn_block_q8.bias_launches = 0
    q8.attn_block_q8s.bias_launches = 0


def _resnet_launches() -> dict:
    return {"bottleneck": rb.fused_bottleneck.launches,
            "bottleneck_proj": rb.fused_bottleneck.proj_launches,
            "stage": rb.fused_stage.launches}


class _StepMeter:
    """Host clock around a synchronize after every step, and the loss."""

    def __init__(self):
        self.t = time.perf_counter()
        self.ms, self.losses = [], []

    def update(self, n, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms.append((now - self.t) * 1e3)
        self.t = now
        self.losses.append(float(metrics["loss"]))


def _neutral_thermal():
    """The thermal modality with every augmentation probability and angle
    0: the warp is the identity and no blur applies."""
    aug = AugmentConfig(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                        rotation_degrees=0.0, aug_prob=0.0,
                        affine_degrees=0.0, color_jitter=False)
    return dataclasses.replace(thermal_modality(), augment=aug)


def _train_run(tag, dev, tr, data, labels) -> tuple:
    """A warm-up step on the first batch, then one epoch of
    ``run_train_epoch`` (8 steps) with every launch count set to 0 just
    before it; logs step ms, images/s, peak memory and the losses.
    Returns (the launch counts of the epoch, its step count)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    first = {"thermal": data.arrays["thermal"][:TRAIN_BATCH],
             "label": labels[:TRAIN_BATCH],
             "valid": np.ones(TRAIN_BATCH, np.float32)}
    t0 = time.perf_counter()
    tr.train_step(first, gen)                 # warm-up: optimizer, handles
    torch.cuda.synchronize(dev)
    log(f"[{tag}] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms")

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    meter = _StepMeter()
    epoch = tr.run_train_epoch(data, np.random.default_rng(1), gen,
                               meter=meter)
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = len(meter.ms)
    steady = meter.ms[1:]
    mean_ms = sum(steady) / len(steady)
    log(f"[{tag}] {steps} steps, step ms "
        f"{[round(m, 3) for m in meter.ms]}; mean of steps 2-{steps} "
        f"{mean_ms:.3f} ms = {1e3 * TRAIN_BATCH / mean_ms:.1f} images/s; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    log(f"[{tag}] loss per step {[round(x, 5) for x in meter.losses]}; "
        f"epoch loss {epoch.loss:.5f} acc {epoch.accuracy:.4f} "
        f"f1 {epoch.f1:.4f}")
    log(f"[{tag}] launches {launches}")
    if steps != TRAIN_IMAGES // TRAIN_BATCH:
        raise AssertionError(f"{steps} steps, expected "
                             f"{TRAIN_IMAGES // TRAIN_BATCH}")
    if not all(np.isfinite(meter.losses)):
        raise AssertionError(f"non-finite loss: {meter.losses}")
    return launches, steps


def _train_data():
    images, labels = synthetic_thermal(TRAIN_IMAGES)
    return (ArrayDataset({"thermal": images}, labels), labels,
            class_weights_from_labels(labels))


def _check_train_trainer(tag, tr, dev) -> None:
    cfg = tr.cfg
    n_params = zoo.param_count(tr.module)
    log(f"[{tag}] thermal_only at {IMAGE}x{IMAGE}: {n_params:,} params on "
        f"{dev}, compute bfloat16, blocks "
        f"{type(tr.module.vit.blocks[0]).__name__}, batch {TRAIN_BATCH}, "
        f"lr {cfg.learning_rate:g}, AdamW mu {cfg.optimizer_mu_dtype}")
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"param count {n_params} != {TRAIN_PARAMS:,}")


def phase_train(dev) -> dict:
    data, labels, weights = _train_data()
    tr = recipe_trainer(dev, labels)
    _check_train_trainer("train", tr, dev)
    launches, steps = _train_run("train", dev, tr, data, labels)
    want = {k: 12 * steps if k in TRAIN_KERNELS else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    _fp32_step_vs_cpu("train", dev, tr.variables(), data.arrays["thermal"],
                      labels, weights)
    return launches


def _fp32_step_vs_cpu(tag, dev, state, images, labels, weights,
                      image_size=IMAGE, **model_kw) -> None:
    """One fp32 thermal_only train step on the card against the CPU's
    (``_fp32_model_step_vs_cpu``) on the first 4 ``images``."""
    batch = {"thermal": images[:4], "label": labels[:4],
             "valid": np.array([1, 1, 1, 0], np.float32)}
    _fp32_model_step_vs_cpu(tag, "thermal_only",
                            {"thermal": _neutral_thermal()}, dev, state,
                            batch, weights, image_size, **model_kw)


def _fp32_model_step_vs_cpu(tag, name, modalities, dev, state, batch,
                            weights, image_size=IMAGE, trunk=None,
                            after_trunk=(), **model_kw) -> None:
    """One fp32 train step of zoo model ``name`` on the card against the
    CPU's plain fp32 step on the weights ``state`` and ``batch``: each
    parameter's gradient within GRAD_TOL of its own max|g|, each
    BatchNorm running statistic within GRAD_TOL of its own max, the params
    after AdamW within 2·lr, the loss within 1e-4 relative and the
    confusion counts equal.  With a ReLU/BatchNorm ``trunk`` (the prefix
    of its parameters' names) both steps take the inputs normalised once
    on the CPU, so that they see the same bits; the trunk's gradients are
    held as one vector within TRUNK_L2_TOL (see there), its per-parameter
    distance logged, and the parameters under the ``after_trunk``
    prefixes at AFTER_TRUNK_TOL."""
    cfg32 = TrainConfig(batch_size=len(batch["label"]),
                        compute_dtype="float32",
                        optimizer_mu_dtype="float32", drop_rate=0.0)
    card = Trainer(name, cfg32, modalities, class_weights=weights,
                   device=dev, image_size=image_size, **model_kw)
    cpu = Trainer(name, cfg32, modalities, class_weights=weights,
                  device="cpu", image_size=image_size, **model_kw)
    state = {k: v.detach().cpu() for k, v in state.items()}
    card.module.load_state_dict(state)
    cpu.module.load_state_dict(state)
    if trunk is not None:
        inputs = cpu._preprocess_eval({m: torch.from_numpy(batch[m])
                                       for m in cpu.spec.inputs})
        for tr in (card, cpu):
            tr._preprocess_train = (lambda b, g, d=tr.device:
                                    tuple(x.to(d) for x in inputs))
    out_card = card.train_step(batch, torch.Generator(device=dev))
    out_cpu = cpu.train_step(batch, torch.Generator())
    cpu_params = dict(cpu.module.named_parameters())
    g_rel, p_err, sq = {}, 0.0, [0.0, 0.0]
    for pname, p in card.module.named_parameters():
        q = cpu_params[pname]
        d = p.grad.cpu().double() - q.grad.double()
        g_rel[pname] = float(d.abs().max()) / float(q.grad.abs().max())
        if trunk is not None and pname.startswith(trunk):
            sq[0] += float(d.square().sum())
            sq[1] += float(q.grad.double().square().sum())
        p_err = max(p_err, float((p.detach().cpu() - q.detach()).abs().max()))
    trunk_l2 = (sq[0] / sq[1]) ** 0.5 if sq[1] else 0.0
    held = {k: v for k, v in g_rel.items()
            if trunk is None or not k.startswith(trunk)}
    tols = {k: AFTER_TRUNK_TOL if after_trunk and k.startswith(after_trunk)
            else GRAD_TOL for k in held}
    cpu_buffers = dict(cpu.module.named_buffers())
    s_rel = {}
    for bname, b in card.module.named_buffers():
        if bname.endswith(("running_mean", "running_var")):
            q = cpu_buffers[bname]
            s_rel[bname] = float((b.cpu() - q).abs().max()) / float(
                q.abs().max())
    worst = sorted(held, key=lambda k: held[k] / tols[k], reverse=True)[:3]
    lr = cfg32.learning_rate
    loss_card, loss_cpu = float(out_card["loss"]), float(out_cpu["loss"])
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    # a trunk's gradients take either sign where they are ~0, so some
    # parameter lands lr·(1 - -1) apart after Adam's first step, plus the
    # two roundings of p ± lr to fp32 (an ulp of the largest |p|)
    p_tol = 2 * lr
    if trunk is not None:
        p_tol += torch.finfo(torch.float32).eps * max(
            float(p.detach().abs().max()) for p in cpu_params.values())
    ok = (all(held[k] <= tols[k] for k in held) and p_err <= p_tol
          and loss_rel <= 1e-4 and trunk_l2 <= TRUNK_L2_TOL
          and max(s_rel.values(), default=0.0) <= GRAD_TOL
          and torch.equal(out_card["counts"].cpu(), out_cpu["counts"]))
    extra = ""
    if s_rel:
        s_worst = max(s_rel, key=s_rel.get)
        extra += (f"; BatchNorm statistics max|d| / their max, worst of "
                  f"{len(s_rel)}: {s_worst} {s_rel[s_worst]:.3e} (tol "
                  f"{GRAD_TOL:g})")
    if trunk is not None:
        in_trunk = {k: v for k, v in g_rel.items() if k not in held}
        t_worst = max(in_trunk, key=in_trunk.get)
        extra += (f"; {trunk}* gradients ({len(in_trunk)} parameters) as "
                  f"one vector: |d|_2 / |g|_2 {trunk_l2:.3e} (tol "
                  f"{TRUNK_L2_TOL:g}), per parameter worst {t_worst} "
                  f"{in_trunk[t_worst]:.3e} (not held)")
    log(f"[{tag}] card fp32 vs CPU fp32 step: loss {loss_card:.6f} vs "
        f"{loss_cpu:.6f} (rel {loss_rel:.2e}, tol 1e-4); grad max|d| per "
        f"parameter / its max|g|, worst {len(worst)} of {len(held)}: "
        f"{ {k: f'{held[k]:.3e} (tol {tols[k]:g})' for k in worst} }; "
        f"param max|d| after AdamW {p_err:.6e} (tol 2*lr = {2 * lr:g}"
        f"{'' if trunk is None else f' + an ulp: {p_tol:.6e}'})"
        f"{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] card fp32 train step disagrees with "
                             "the CPU")


# ---------------------------------------------------------------- phase 6

CALIB_IMAGES = 16
# card vs CPU, int8 both on the same quantised weights: fp32 differs in
# summation order only, plus the int8 roundings that flips, each up to one
# int8 step of a row (or a row's scale), compounding through 12 blocks:
# max|dlogit| measured 1.15e-2·(1+max|logit|) in this phase's first run,
# so 3e-2; bf16 also rounds every activation to 8 bits (SLICE_TOL).
# P(ulcer) moves most where a sample's logits sit near 0, as they do with
# flax's truncated LeCun draw (zoo.init_model): the static path reads
# max|dprob| 1.867e-2 there with the kernels before and after the tiled
# attention alike (PERF.md §6), against 2.115e-2 for bf16 on the
# same samples, so 2e-2: above every fp32 reading, below bf16's, and well
# inside the ~5e-2 that the logit bound admits (half of it)
INT8_TOL = {"float32": {"logits": 3e-2, "probs": 2e-2},
            "bfloat16": SLICE_TOL["bfloat16"]}


def _q8_launches() -> dict:
    """The int8 blocks' launch counts, and the bf16 blocks' (which the
    int8 path must not run)."""
    return {"attn_block_q8": q8.attn_block_q8.launches,
            "mlp_block_q8": q8.mlp_block_q8.launches,
            "attn_block_q8s": q8.attn_block_q8s.launches,
            "mlp_block_q8s": q8.mlp_block_q8s.launches,
            "attn_block": vb.attn_block.launches,
            "mlp_block": vb.mlp_block.launches}


def _thermal(dtype: str, device, block_impl: str = "fused",
             attention_impl: str = "auto") -> Trainer:
    return Trainer("thermal_only", TrainConfig(compute_dtype=dtype),
                   {"thermal": thermal_modality()}, device=device,
                   image_size=IMAGE, block_impl=block_impl,
                   attention_impl=attention_impl)


def _int8_vs_cpu(tag, served, block_impl, batches) -> None:
    """The served int8 trainer (bf16) and an fp32 int8 trainer on the
    card against the CPU's plain int8 fp32 path, all three on the served
    trainer's quantised weights."""
    state = {k: v.detach().cpu() for k, v in served.variables().items()}
    cpu = _thermal("float32", "cpu", block_impl)
    cpu.module.load_state_dict(state)
    card32 = _thermal("float32", served.device, block_impl)
    card32.module.load_state_dict(state)
    ref = torch.cat([_logits(cpu, b) for b in batches])
    for dtype, trainer in (("float32", card32), ("bfloat16", served)):
        _compare(f"[{tag}] card {dtype} vs CPU float32, int8 both", trainer,
                 ref, batches, INT8_TOL[dtype])


def phase_int8(dev) -> dict:
    """Int8 serving of the full-width thermal_only ViT-B/16: the dynamic
    configuration behind the ServingEngine, then the calibrated static
    one through three eval steps.  Returns the int8 launch counts."""
    images, _ = synthetic_thermal(N_REQUESTS + CALIB_IMAGES, seed=3)
    samples = [{"thermal": im} for im in images[:N_REQUESTS]]
    batches = [{"thermal": images[i:i + 8]} for i in range(0, N_REQUESTS, 8)]
    base = _thermal("bfloat16", dev)
    zoo.init_model(base.module, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    served = quantize_for_serving(base, image_size=IMAGE)
    torch.cuda.synchronize(dev)
    log(f"[int8] thermal_only at {IMAGE}x{IMAGE} quantised on {dev} by "
        f"quantize_for_serving in {time.perf_counter() - t0:.2f} s; compute "
        f"bfloat16, blocks {type(served.module.vit.blocks[0]).__name__}")
    torch.cuda.reset_peak_memory_stats(dev)
    engine = ServingEngine(served, image_size=IMAGE, max_batch=8)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize(dev)
    log(f"[int8] warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")
    results, stats = _drive(engine, samples, "int8")
    launches = _q8_launches()
    n_batches = sum(stats["batch_size_hist"].values())
    log(f"[int8] peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; launches "
        f"{launches}")
    want = {k: 0 for k in launches}
    want.update(attn_block_q8=12 * n_batches, mlp_block_q8=12 * n_batches)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    counts = {k: launches[k] for k in ("attn_block_q8", "mlp_block_q8")}
    _int8_vs_cpu("int8", served, "fused_q8", batches)
    bf16 = torch.cat([_logits(base, b) for b in batches]).argmax(-1)
    int8 = torch.tensor([pred for _, pred in results])
    log(f"[int8] predictions equal to the bf16 model's on the same inputs: "
        f"{int((bf16 == int8).sum())}/{N_REQUESTS}")

    # the calibrated static configuration
    t0 = time.perf_counter()
    calib = eval_normalize(torch.as_tensor(images[N_REQUESTS:], device=dev),
                           thermal_modality(), torch.float32)
    qstate = quantize_variables(base.variables(), calib_batches=[calib])
    static = _thermal("bfloat16", dev, "fused_q8s")
    static.module.load_state_dict(qstate)
    torch.cuda.synchronize(dev)
    act = qstate["vit.blocks.0.act_scales"].tolist()
    log(f"[int8 static] calibrated on {CALIB_IMAGES} normalised images and "
        f"quantised on {dev} in {time.perf_counter() - t0:.2f} s; block 0 "
        f"act_scales {[round(a, 6) for a in act]}")
    static.eval_step(batches[0])                          # warm-up
    torch.cuda.synchronize(dev)
    _reset_launches()
    ms = []
    for b in batches:
        t0 = time.perf_counter()
        probs = static.eval_step(b)["probs"]
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"static int8 probabilities {probs}")
    launches = _q8_launches()
    log(f"[int8 static] eval step ms at batch 8 {[round(m, 3) for m in ms]};"
        f" launches {launches}")
    want = {k: 0 for k in launches}
    want.update(attn_block_q8s=12 * len(batches),
                mlp_block_q8s=12 * len(batches))
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    counts.update((k, launches[k]) for k in ("attn_block_q8s",
                                             "mlp_block_q8s"))
    _int8_vs_cpu("int8 static", static, "fused_q8s", batches)
    return counts


# ---------------------------------------------------------------- phase 7

RGB_PARAMS = 23_512_130     # ResNet-50 trunk 23,508,032 + head 4,098


def _rgb(dtype: str, device, block_impl: str = "fused") -> Trainer:
    return Trainer("rgb_only", TrainConfig(compute_dtype=dtype),
                   {"rgb": rgb_modality()}, device=device, image_size=IMAGE,
                   block_impl=block_impl)


@torch.no_grad()
def _perturb_batchnorm(module, gen) -> None:
    """Move every BatchNorm's statistics and affine parameters off their
    identity init (from ``gen``), so the kernel path's folding is
    exercised."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.uniform_(0.5, 1.5, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.weight.normal_(1.0, 0.1, generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)


def _compare(label, trainer, ref, batches, tol) -> None:
    """The trainer's logits of ``batches`` against ``ref``: max|dlogit|
    within tol["logits"]·(1+max|ref logit|) and max|dprob| within
    tol["probs"]."""
    logits = torch.cat([_logits(trainer, b) for b in batches])
    scale = 1.0 + float(ref.abs().max())
    dl = float((logits - ref).abs().max())
    dp = float((torch.softmax(logits, -1)[:, 1]
                - torch.softmax(ref, -1)[:, 1]).abs().max())
    ok = dl <= tol["logits"] * scale and dp <= tol["probs"]
    log(f"{label}: max|dlogit|={dl:.3e} (tol {tol['logits']:g}*(1+max"
        f"|logit|={scale:.3f})), max|dprob|={dp:.3e} (tol {tol['probs']:g}),"
        f" preds agree {int((logits.argmax(-1) == ref.argmax(-1)).sum())}/"
        f"{len(ref)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: disagree")


def phase_rgb(dev) -> dict:
    """Serving of the full-width rgb_only model with every stride-1
    bottleneck on K11.  Returns K11's launch counts."""
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 is compared
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)
    served = _rgb("bfloat16", dev)
    zoo.init_model(served.module, torch.Generator(device=dev).manual_seed(0))
    _perturb_batchnorm(served.module,
                       torch.Generator(device=dev).manual_seed(1))
    n_params = zoo.param_count(served.module)
    log(f"[rgb] rgb_only at {IMAGE}x{IMAGE}: {n_params:,} params on {dev}, "
        f"compute bfloat16, block_impl fused")
    if n_params != RGB_PARAMS:
        raise AssertionError(f"param count {n_params} != {RGB_PARAMS:,}")
    rng = np.random.default_rng(4)
    samples = [{"rgb": rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)}
               for _ in range(N_REQUESTS)]
    engine = ServingEngine(served, image_size=IMAGE, max_batch=8)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize(dev)
    log(f"[rgb] warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")
    _, stats = _drive(engine, samples, "rgb")
    launches = {**_resnet_launches(), **_q8_launches(),
                "fused_mlp": fm.fused_mlp.launches}
    n_batches = sum(stats["batch_size_hist"].values())
    log(f"[rgb] peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; launches "
        f"{launches}")
    want = {k: 0 for k in launches}
    want.update(bottleneck=12 * n_batches, bottleneck_proj=n_batches)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    counts = {k: v for k, v in _resnet_launches().items() if k != "stage"}

    # the card (served bf16, fused fp32) against the CPU's plain fp32 path,
    # and the card's fused fp32 against its cuDNN fp32 blocks
    state = {k: v.detach().cpu() for k, v in served.variables().items()}
    trainers = {}
    for name, device, block_impl in (("cpu", "cpu", "fused"),
                                     ("fused", dev, "fused"),
                                     ("cudnn", dev, "flax")):
        trainers[name] = _rgb("float32", device, block_impl)
        trainers[name].module.load_state_dict(state)
    batches = [{"rgb": np.stack([s["rgb"] for s in samples[i:i + 8]])}
               for i in range(0, N_REQUESTS, 8)]
    ref = torch.cat([_logits(trainers["cpu"], b) for b in batches])
    _compare("[rgb] card fused float32 vs CPU float32", trainers["fused"],
             ref, batches, SLICE_TOL["float32"])
    _compare("[rgb] card fused bfloat16 (served) vs CPU float32", served, ref,
             batches, SLICE_TOL["bfloat16"])
    cudnn = torch.cat([_logits(trainers["cudnn"], b) for b in batches])
    _compare("[rgb] card fused float32 vs card cuDNN float32 (TF32 off)",
             trainers["fused"], cudnn, batches, SLICE_TOL["float32"])

    # the bf16 eval step at batch 8, fused blocks against cuDNN blocks
    # (host clock + sync), and the fused step's device busy time
    cudnn16 = _rgb("bfloat16", dev, "flax")
    cudnn16.module.load_state_dict(state)
    for name, trainer in (("fused", served), ("cuDNN", cudnn16)):
        log(f"[rgb] eval step ms at batch 8, bf16, {name} blocks: "
            f"{[round(m, 3) for m in _eval_ms(trainer, batches, dev)]}")
    # the rgb path's only kernels of the port's own are K11's launches
    _profile_eval("rgb", served, batches, dev, "K11")
    return counts


def _eval_ms(trainer, batches, dev) -> list:
    """Host-clock ms of each batch's eval step (synchronised), after a
    warm-up step."""
    trainer.eval_step(batches[0])
    ms = []
    for b in batches:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer.eval_step(b)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def _profile_eval(tag, trainer, batches, dev, own: str) -> None:
    """Eval steps under torch.profiler: host ms per step, the device's
    busy time split into the port's own kernels (``own``; every port
    kernel's name starts in ``dfu::``) and the others, and the idle
    share."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.eval_step(b)
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = {k: sum(e.self_device_time_total for e in kernels
                   if ("dfu::" in e.key) == (k == own)) / 1e3
            for k in (own, "other")}
    n = len(batches)
    log(f"[{tag}] profiled eval steps: host {wall_ms / n:.3f} ms per "
        f"step; device busy {sum(busy.values()) / n:.3f} ms ({own}'s "
        f"launches {busy[own] / n:.3f}, other kernels "
        f"{busy['other'] / n:.3f}); idle share "
        f"{1.0 - sum(busy.values()) / wall_ms:.4f}")


# ---------------------------------------------------------------- phase 8

# card fp32 flax blocks vs card fp32 fused blocks (K1/K2) on the same
# weights: both exact-erf GELU and fp32 throughout; they differ in sum
# order and in where the softmax divides (K1 after P·V, K6 before)
FLAX_FUSED_TOL = {"logits": 1e-4, "probs": 1e-5}


def _all_launches() -> dict:
    """Every kernel's launch count."""
    return {**_train_launches(), **_q8_launches(), **_resnet_launches(),
            "fused_mlp": fm.fused_mlp.launches,
            "flash_attention_fwd": at.flash_attention_fwd.launches,
            "flash_attention_bwd": at.flash_attention_bwd.launches,
            "attn_block_bwd_fused": vb.attn_block_bwd_fused.launches,
            "conv_q8": cq.conv_q8.launches,
            "quantize_act_q8": cq.quantize_act_q8.launches}


def phase_flax_serve(dev) -> dict:
    """Serving of the full-width thermal_only ViT-B/16 with the flax blocks
    and the packed-qkv attention kernel K6.  Returns K6's forward
    launches."""
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 is compared
    served = _thermal("bfloat16", dev, "flax", "pallas")
    zoo.init_model(served.module, torch.Generator(device=dev).manual_seed(0))
    n_params = zoo.param_count(served.module)
    log(f"[flax serve] thermal_only at {IMAGE}x{IMAGE}: {n_params:,} params "
        f"on {dev}, compute bfloat16, blocks "
        f"{type(served.module.vit.blocks[0]).__name__}, attention "
        f"{served.module.vit.blocks[0].attn.attention_impl}")
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"param count {n_params} != {TRAIN_PARAMS:,}")
    images, _ = synthetic_thermal(N_REQUESTS, seed=5)
    samples = [{"thermal": im} for im in images]
    batches = [{"thermal": images[i:i + 8]} for i in range(0, N_REQUESTS, 8)]
    torch.cuda.reset_peak_memory_stats(dev)
    engine = ServingEngine(served, image_size=IMAGE, max_batch=8)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize(dev)
    log(f"[flax serve] warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")
    results, stats = _drive(engine, samples, "flax serve")
    launches = _all_launches()
    n_batches = sum(stats["batch_size_hist"].values())
    log(f"[flax serve] peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; launches "
        f"{launches}")
    want = {k: 0 for k in launches}
    want["qkv_attention_fwd"] = 12 * n_batches
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    # the card (fp32 and the served bf16) against the CPU's plain fp32
    # path, and the card's flax fp32 against its fused fp32 blocks
    state = {k: v.detach().cpu() for k, v in served.variables().items()}
    trainers = {}
    for name, dtype, device, block_impl, attention_impl in (
            ("cpu", "float32", "cpu", "flax", "pallas"),
            ("flax32", "float32", dev, "flax", "pallas"),
            ("fused32", "float32", dev, "fused", "auto"),
            ("xla16", "bfloat16", dev, "flax", "xla"),
            ("fused16", "bfloat16", dev, "fused", "auto")):
        trainers[name] = _thermal(dtype, device, block_impl, attention_impl)
        trainers[name].module.load_state_dict(state)
    ref = torch.cat([_logits(trainers["cpu"], b) for b in batches])
    _compare("[flax serve] card flax float32 vs CPU float32",
             trainers["flax32"], ref, batches, SLICE_TOL["float32"])
    fused = torch.cat([_logits(trainers["fused32"], b) for b in batches])
    _compare("[flax serve] card flax float32 vs card fused float32 (K1/K2)",
             trainers["flax32"], fused, batches, FLAX_FUSED_TOL)
    _compare("[flax serve] card flax bfloat16 (served) vs CPU float32",
             served, ref, batches, SLICE_TOL["bfloat16"])
    preds = torch.tensor([pred for _, pred in results])
    agree = int((preds == ref.argmax(-1)).sum())
    margin = float((ref[:, 1] - ref[:, 0]).abs().min())
    log(f"[flax serve] served predictions equal to the CPU float32 ones: "
        f"{agree}/{N_REQUESTS} (smallest CPU logit margin {margin:.3e})")
    if agree != N_REQUESTS:
        raise AssertionError("served bf16 predictions differ from the CPU's")

    # the bf16 eval step at batch 8 on the same weights, in turns
    impls = (("flax/pallas", served), ("flax/xla", trainers["xla16"]),
             ("fused", trainers["fused16"]))
    for name, trainer in impls + impls[::-1]:
        log(f"[flax serve] eval step ms at batch 8, bf16, {name} blocks: "
            f"{[round(m, 3) for m in _eval_ms(trainer, batches, dev)]}")
    _profile_eval("flax serve", served, batches, dev, "K6")
    return {"qkv_attention_fwd": launches["qkv_attention_fwd"]}


# ---------------------------------------------------------------- phase 9


def phase_flax_train(dev) -> dict:
    """Training of the full-width thermal_only ViT-B/16 with the flax
    blocks: K6 forward and backward on every block.  Returns K6's
    backward launches."""
    data, labels, weights = _train_data()
    tr = recipe_trainer(dev, labels, "flax", "pallas")
    _check_train_trainer("flax train", tr, dev)
    launches, steps = _train_run("flax train", dev, tr, data, labels)
    want = {k: 0 for k in launches}
    want.update(qkv_attention_fwd=12 * steps, qkv_attention_bwd=12 * steps)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    _fp32_step_vs_cpu("flax train", dev, tr.variables(),
                      data.arrays["thermal"], labels, weights,
                      block_impl="flax", attention_impl="pallas")
    return {"qkv_attention_bwd": launches["qkv_attention_bwd"]}


# --------------------------------------------------------------- phase 10

LARGE_IMAGE = 240           # N = 226: past the whole-head backward kernel
LARGE_DEPTH = 2             # the fp32 card-vs-CPU step's cut-down depth
LARGE_PATHS = {             # block_impl, attention_impl -> K5 or K6 bwd
    "fused": (("fused", "auto"), "qkv_attention_fwdbwd"),
    "flax/pallas": (("flax", "pallas"), "qkv_attention_bwd")}


def phase_large_images(dev) -> None:
    """Thermal training at 240² (N = 226, the attention backward on its
    tiled kernels): two bf16 train steps of the full-width model with
    the fused blocks and with flax/pallas, each loss finite and 12 K5 or
    K6-backward launches per step; then, for each, one fp32 train step of
    a depth-2 model on the card against the CPU's plain step at phase 5's
    budgets."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (TRAIN_BATCH, LARGE_IMAGE, LARGE_IMAGE,
                                   3), dtype=np.uint8)
    labels = rng.integers(0, 2, TRAIN_BATCH).astype(np.int32)
    weights = class_weights_from_labels(labels)
    batch = {"thermal": images, "label": labels,
             "valid": np.ones(TRAIN_BATCH, np.float32)}
    for name, ((block_impl, attention_impl), kernel) in LARGE_PATHS.items():
        tr = Trainer("thermal_only",
                     TrainConfig(batch_size=TRAIN_BATCH,
                                 compute_dtype="bfloat16"),
                     {"thermal": thermal_modality()}, class_weights=weights,
                     device=dev, image_size=LARGE_IMAGE,
                     block_impl=block_impl, attention_impl=attention_impl)
        zoo.init_model(tr.module, torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        _reset_launches()
        losses, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            out = tr.train_step(batch, gen)
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(out["loss"]))
        launches = _train_launches()
        log(f"[large] thermal_only at {LARGE_IMAGE}x{LARGE_IMAGE} "
            f"(N={(LARGE_IMAGE // 16) ** 2 + 1}), {name} blocks, bf16, "
            f"batch {TRAIN_BATCH}: 2 steps, ms {[round(m, 3) for m in ms]}, "
            f"loss {[round(x, 5) for x in losses]}; launches {launches}")
        if launches[kernel] != 2 * DEPTH or not all(np.isfinite(losses)):
            raise AssertionError(f"[large] {name}: launches {launches}, "
                                 f"losses {losses}")
        del tr
        torch.cuda.empty_cache()
        small = dict(depth=LARGE_DEPTH, block_impl=block_impl,
                     attention_impl=attention_impl)
        src = Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                      {"thermal": thermal_modality()}, device="cpu",
                      image_size=LARGE_IMAGE, **small)
        zoo.init_model(src.module, torch.Generator().manual_seed(2))
        _fp32_step_vs_cpu(f"large {name} depth {LARGE_DEPTH}", dev,
                          src.variables(), images, labels, weights,
                          image_size=LARGE_IMAGE, **small)


# --------------------------------------------------------------- phase 11

# the reference trainers' batches (PERF.md §2) and the steps of each run
ALL_BATCH = {"rgb_only": 32, "multimodal": 6}
ALL_STEPS = 4
ALL_PARAMS = {"rgb_only": RGB_PARAMS, "multimodal": 110_880_834}
ALL_INPUTS = {"rgb_only": ("rgb",), "multimodal": ("rgb", "thermal")}
TRUNKS = {"rgb_only": "resnet.", "multimodal": "rgb_branch."}
AFTER_TRUNK = {"rgb_only": ("head.",), "multimodal": ("fusion.",)}
# fit: train and validation pairs, epochs before and after the resume
FIT_TRAIN, FIT_VAL, FIT_EPOCHS = 12, 6, 2


def _all_data(name, n, seed):
    """(arrays of ``n`` random uint8 images per input, alternating
    labels)."""
    rng = np.random.default_rng(seed)
    arrays = {m: rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
              for m in ALL_INPUTS[name]}
    return arrays, np.arange(n, dtype=np.int32) % 2


def _all_modalities(name, neutral=False) -> dict:
    mods = {"rgb": rgb_modality(), "thermal": thermal_modality()}
    if neutral:
        mods = {m: dataclasses.replace(v, augment=_neutral_thermal().augment)
                for m, v in mods.items()}
    return {m: mods[m] for m in ALL_INPUTS[name]}


def _bn_buffers(module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_buffers()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def _train_all_run(name, dev) -> Trainer:
    """ALL_STEPS bf16 steps of ``run_train_epoch`` of the full-width model
    at its recipe batch (after a warm-up step), every launch count set to
    0 just before: step ms, images/s, peak memory, the losses, the launch
    counts (12 a step of K1, K2, K4, K5 for multimodal's ViT; none of
    K3, whose head trains as separate layers, nor of K11, since training
    runs cuDNN's convolutions; no kernel of the port for rgb_only), and
    every BatchNorm buffer moved by every step."""
    tag = f"train all {name}"
    b = ALL_BATCH[name]
    arrays, labels = _all_data(name, ALL_STEPS * b, seed=5)
    tr = Trainer(name, TrainConfig(batch_size=b, compute_dtype="bfloat16"),
                 _all_modalities(name),
                 class_weights=class_weights_from_labels(labels),
                 device=dev, image_size=IMAGE)
    zoo.init_model(tr.module, torch.Generator(device=dev).manual_seed(0))
    n_params = zoo.param_count(tr.module)
    log(f"[{tag}] {name} at {IMAGE}x{IMAGE}: {n_params:,} params on {dev}, "
        f"compute bfloat16, batch {b}, lr {tr.cfg.learning_rate:g}, AdamW "
        f"mu {tr.cfg.optimizer_mu_dtype}, BatchNorm live")
    if n_params != ALL_PARAMS[name]:
        raise AssertionError(f"param count {n_params} != "
                             f"{ALL_PARAMS[name]:,}")
    gen = torch.Generator(device=dev).manual_seed(1)
    first = {**{m: v[:b] for m, v in arrays.items()}, "label": labels[:b],
             "valid": np.ones(b, np.float32)}
    t0 = time.perf_counter()
    tr.train_step(first, gen)                 # warm-up: optimizer, plans
    torch.cuda.synchronize(dev)
    log(f"[{tag}] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms")
    before = _bn_buffers(tr.module)

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    meter = _StepMeter()
    epoch = tr.run_train_epoch(ArrayDataset(arrays, labels),
                               np.random.default_rng(1), gen, meter=meter)
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = len(meter.ms)
    mean_ms = sum(meter.ms[1:]) / (steps - 1)
    log(f"[{tag}] {steps} steps, step ms {[round(m, 3) for m in meter.ms]}"
        f"; mean of steps 2-{steps} {mean_ms:.3f} ms = "
        f"{1e3 * b / mean_ms:.1f} images/s; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[{tag}] loss per step {[round(x, 5) for x in meter.losses]}; "
        f"epoch loss {epoch.loss:.5f} acc {epoch.accuracy:.4f} "
        f"f1 {epoch.f1:.4f}")
    log(f"[{tag}] launches {launches}")
    if steps != ALL_STEPS:
        raise AssertionError(f"{steps} steps, expected {ALL_STEPS}")
    if not all(np.isfinite(meter.losses)):
        raise AssertionError(f"non-finite loss: {meter.losses}")
    want = {k: 0 for k in launches}
    if name == "multimodal":
        want.update({k: 12 * steps for k in TRAIN_KERNELS})
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    after = _bn_buffers(tr.module)
    still = [k for k, v in before.items()
             if not k.endswith("num_batches_tracked")
             and torch.equal(v, after[k])]
    counts = {int(v) for k, v in after.items()
              if k.endswith("num_batches_tracked")}
    log(f"[{tag}] BatchNorm buffers: {len(before)} (running mean, var, "
        f"count of {len(before) // 3} layers), unchanged by the epoch "
        f"{len(still)}, counts {sorted(counts)}")
    if still or counts != {1 + steps}:
        raise AssertionError(f"BatchNorm buffers did not move: {still[:3]} "
                             f"counts {counts}")
    return tr


def _fit_run(dev) -> None:
    """multimodal ``fit`` for FIT_EPOCHS epochs (bf16, batch 6, save_last,
    async saves) on FIT_TRAIN/FIT_VAL synthetic pairs into a directory
    under build/; the head's ulcer bias starts at +10, so every validation
    prediction is "ulcer" and the all-ulcer validation set gives epoch 1 a
    val F1 of 1, hence a best checkpoint.  The eval logits of the live
    model are taken when the best checkpoint is saved; a fresh Trainer
    restoring it must give the same logits bit for bit.  Then a new
    Trainer resumes with num_epochs FIT_EPOCHS + 1 from last_model: epoch
    FIT_EPOCHS + 1 only, its optimizer count restored."""
    import tempfile
    tag = "fit"
    arrays, labels = _all_data("multimodal", FIT_TRAIN + FIT_VAL, seed=6)
    train = ArrayDataset({m: v[:FIT_TRAIN] for m, v in arrays.items()},
                         labels[:FIT_TRAIN])
    val_arrays = {m: v[FIT_TRAIN:] for m, v in arrays.items()}
    val = ArrayDataset(val_arrays, np.ones(FIT_VAL, np.int32))
    steps = FIT_TRAIN // ALL_BATCH["multimodal"]

    def trainer(epochs):
        cfg = TrainConfig(batch_size=ALL_BATCH["multimodal"],
                          compute_dtype="bfloat16", num_epochs=epochs,
                          save_best_after_epoch=1, save_last=True,
                          async_checkpoint=True)
        return Trainer("multimodal", cfg, _all_modalities("multimodal"),
                       class_weights=class_weights_from_labels(
                           labels[:FIT_TRAIN]), device=dev,
                       image_size=IMAGE)

    tr = trainer(FIT_EPOCHS)
    zoo.init_model(tr.module, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tr.module.fusion.fc3.bias.copy_(torch.tensor([0.0, 10.0]))
    saved = {}
    lines = []

    def capture(msg):
        lines.append(msg)
        log(f"[{tag}] {msg}")
        if msg.strip().startswith("Saved BEST"):
            saved["logits"] = _logits(tr, val_arrays)
            saved["epoch"] = sum(m.startswith("[Epoch") for m in lines)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        t0 = time.perf_counter()
        history, best = tr.fit(train, val, Path(d), log=capture)
        log(f"[{tag}] {FIT_EPOCHS} epochs of {steps} steps + validation + "
            f"saves: {time.perf_counter() - t0:.2f} s; best val F1 {best}, "
            f"saved at epoch {saved.get('epoch')}; files "
            f"{sorted(p.name for p in Path(d).iterdir())}")
        if "logits" not in saved or len(history["val_f1"]) != FIT_EPOCHS:
            raise AssertionError("fit saved no best checkpoint or ran "
                                 f"{len(history['val_f1'])} epochs")
        restored = trainer(FIT_EPOCHS)
        restored.restore(Path(d))
        logits = _logits(restored, val_arrays)
        equal = torch.equal(logits, saved["logits"])
        log(f"[{tag}] restored best_model eval logits bit-equal to the "
            f"saving model's: {equal}")
        if not equal:
            raise AssertionError("the restored best checkpoint's logits "
                                 "differ from the model that saved it")

        resumed = trainer(FIT_EPOCHS + 1)
        lines.clear()
        t0 = time.perf_counter()
        history, _ = resumed.fit(train, val, Path(d), resume_from=Path(d),
                                 log=capture)
        log(f"[{tag}] resumed run: {time.perf_counter() - t0:.2f} s, "
            f"history of {len(history['val_f1'])} epochs, optimizer count "
            f"{resumed.optimizer.count}")
        want = f"at epoch {FIT_EPOCHS + 1}"
        if (want not in lines[0] or len(history["val_f1"]) != FIT_EPOCHS + 1
                or resumed.optimizer.count != (FIT_EPOCHS + 1) * steps):
            raise AssertionError(f"resume: {lines[0]!r}, "
                                 f"{len(history['val_f1'])} epochs, count "
                                 f"{resumed.optimizer.count}")


def _trunk_fp64_vs_cpu(tag, dev, state, images) -> None:
    """The full-width ResNet-50 trunk in train mode, fp64, on the card
    (cuDNN) and on the CPU from the same weights (``state``, the
    ``resnet.`` keys) and the same normalised ``images``: a fixed random
    projection of its features backpropagated; each parameter's gradient
    within GRAD_TOL of its own max|g| and each BatchNorm running
    statistic within GRAD_TOL of its own max."""
    trunk = {k[len("resnet."):]: v.detach().cpu().double()
             for k, v in state.items() if k.startswith("resnet.")}
    x = eval_normalize(torch.from_numpy(images), rgb_modality()).double()
    proj = torch.randn(4, 2048, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(3))
    grads, stats = {}, {}
    for device in (dev, "cpu"):
        net = ResNet50(dtype=torch.float64).double().to(device).train()
        net.load_state_dict(trunk)
        feats = net(x.to(device)).double()
        (feats * proj.to(device)).sum().backward()
        grads[str(device)] = {k: p.grad.cpu() for k, p in
                              net.named_parameters()}
        stats[str(device)] = {k: b.cpu() for k, b in net.named_buffers()
                              if k.endswith(("running_mean", "running_var"))}
    card, cpu = grads[str(dev)], grads["cpu"]
    g_rel = {k: float((card[k] - v).abs().max() / v.abs().max())
             for k, v in cpu.items()}
    s_rel = {k: float((stats[str(dev)][k] - v).abs().max() / v.abs().max())
             for k, v in stats["cpu"].items()}
    g_worst, s_worst = max(g_rel, key=g_rel.get), max(s_rel, key=s_rel.get)
    ok = g_rel[g_worst] <= GRAD_TOL and s_rel[s_worst] <= GRAD_TOL
    log(f"[{tag}] ResNet-50 trunk, train mode, fp64, card vs CPU: grad "
        f"max|d| / its max|g|, worst of {len(g_rel)}: {g_worst} "
        f"{g_rel[g_worst]:.3e}; BatchNorm statistics worst of {len(s_rel)}"
        f": {s_worst} {s_rel[s_worst]:.3e} (tol {GRAD_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the fp64 trunk step disagrees with "
                             "the CPU")


def phase_train_all(dev) -> None:
    """rgb_only and multimodal training at full width: their bf16 train
    steps, an fp32 step of each on the card against the CPU, and
    multimodal ``fit`` with a checkpoint restore and a resume."""
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 is compared
    torch.backends.cudnn.allow_tf32 = False
    for name in ("rgb_only", "multimodal"):
        tr = _train_all_run(name, dev)
        arrays, labels = _all_data(name, 4, seed=7)
        batch = {**arrays, "label": labels,
                 "valid": np.array([1, 1, 1, 0], np.float32)}
        _fp32_model_step_vs_cpu(f"train all {name}", name,
                                _all_modalities(name, neutral=True), dev,
                                tr.variables(), batch,
                                class_weights_from_labels(labels), IMAGE,
                                trunk=TRUNKS[name],
                                after_trunk=AFTER_TRUNK[name])
        if name == "rgb_only":
            _trunk_fp64_vs_cpu(f"train all {name}", dev, tr.variables(),
                               arrays["rgb"])
        del tr
    _fit_run(dev)


# --------------------------------------------------------------- phase 12

FIXTURES = Path(__file__).resolve().parent / "dfu_multimodal_tpu_torch" / \
    "data" / "fixtures"
# nvJPEG against the JAX package's libjpeg decode of the fixture: its IDCT
# and its 4:2:0 chroma upsampling (not libjpeg's "fancy" one) are its own.
# Measured on an H100 host (PERF.md §6): worst JPEG max 20 levels
# (progressive 4:2:0 at 128²), worst mean 1.196 levels; 4:4:4 max 3, mean
# 0.48; grayscale max 1.  PNGs and every libjpeg-route file bit-equal.
NVJPEG_MAX_ABS, NVJPEG_MEAN_ABS = 24, 1.5
# the reference trainers: CLI module, model, batch
DISK_CLIS = {"rgb_only": ("train_rgb_only", 32),
             "thermal_only": ("train_thermal_only", 16),
             "multimodal": ("train_multimodal_fusion", 6)}
DISK_IMAGES_PER_CLASS, DISK_EPOCHS = 20, 2
DISK_KERNELS = {"rgb_only": (),
                "thermal_only": TRAIN_KERNELS,
                "multimodal": TRAIN_KERNELS + ("fused_mlp",)}
TEST_KEYS = {"test_preds", "test_labels", "test_probs", "test_acc",
             "test_f1", "test_loss"}


def _decode_vs_fixture(route: str) -> None:
    """Each fixture file through the port's decoder against the JAX
    package's decode of it (``decode.npz``): bit-equal, but a JPEG on the
    nvJPEG route within NVJPEG_MAX_ABS / NVJPEG_MEAN_ABS levels."""
    from dfu_multimodal_tpu_torch.data.loader import decode_raw, image_format
    ref = np.load(FIXTURES / "decode.npz")
    worst = {"max": 0, "mean": 0.0}
    for key in sorted(ref.files):
        name, size = key.split("@")
        got = decode_raw([FIXTURES / name], int(size))[0].astype(np.int16)
        diff = np.abs(got - ref[key].astype(np.int16))
        near = route == "nvjpeg" and image_format(FIXTURES / name) == "jpeg"
        log(f"[disk] decode {key}: max {int(diff.max())} mean "
            f"{float(diff.mean()):.4f} levels "
            f"({'within tolerance' if near else 'bit-equal'} expected)")
        if near:
            worst["max"] = max(worst["max"], int(diff.max()))
            worst["mean"] = max(worst["mean"], float(diff.mean()))
            if diff.max() > NVJPEG_MAX_ABS or diff.mean() > NVJPEG_MEAN_ABS:
                raise AssertionError(
                    f"nvJPEG decode of {key}: max {diff.max()} / mean "
                    f"{diff.mean():.4f} levels, tolerance "
                    f"{NVJPEG_MAX_ABS} / {NVJPEG_MEAN_ABS}")
        elif diff.any():
            raise AssertionError(f"decode of {key} is not bit-equal to the "
                                 "JAX package's")
    if route == "nvjpeg":
        log(f"[disk] nvJPEG vs libjpeg on the fixture: worst max "
            f"{worst['max']} levels, worst mean {worst['mean']:.4f} "
            f"(tolerance {NVJPEG_MAX_ABS} / {NVJPEG_MEAN_ABS})")


def _check_artifacts(tag, ckpt: Path, epochs: int, batch: int) -> None:
    """The JAX package's artifact contract with the port's checkpoints,
    from a bf16 run on the card at the recipe's batch."""
    from dfu_multimodal_tpu_torch.eval import drift
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    files = sorted(p.name for p in ckpt.iterdir())
    log(f"[{tag}] artifacts: {files}")
    saved = load_pt(ckpt / "test_results.pt")
    meta = json.loads((ckpt / "last_model.meta.json").read_text())
    info = json.loads((ckpt / "run_info.json").read_text())
    drift._validate_baseline(drift.load_baseline(
        ckpt / drift.BASELINE_FILENAME))
    ok = (set(saved) == TEST_KEYS
          and len(saved["test_preds"]) == len(saved["test_probs"])
          and np.isfinite(saved["test_loss"])
          and ((ckpt / "best_model.pt").exists()
               == (ckpt / "best_model.meta.json").exists())
          and (ckpt / "last_model.pt").exists() and meta["epoch"] == epochs
          and len(meta["history"]["val_f1"]) == epochs
          and info["backend"] == "gpu"
          and info["config"]["batch_size"] == batch
          and info["config"]["compute_dtype"] == "bfloat16")
    if not ok:
        raise AssertionError(f"{tag}: artifact contract broken: {files}, "
                             f"test keys {sorted(saved)}, last epoch "
                             f"{meta['epoch']}, run_info {info}")


def _run_cli(tag, name, argv, jsonl: Path) -> list:
    """One CLI run through its ``main(argv)`` with every launch count set to
    0 just before it; returns the epochs it logged to ``jsonl``."""
    import importlib
    module = importlib.import_module(
        f"dfu_multimodal_tpu_torch.cli.{DISK_CLIS[name][0]}")
    before = len(jsonl.read_text().splitlines()) if jsonl.exists() else 0
    _reset_launches()
    t0 = time.perf_counter()
    res = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in _all_launches().items() if v}
    epochs = [json.loads(x) for x in jsonl.read_text().splitlines()[before:]]
    log(f"[{tag}] {seconds:.2f} s in main (load, gate, epochs, saves, test); "
        f"epochs " + ", ".join(f"{e['epoch']}: {e['seconds']} s "
                               f"({e['images_per_sec_per_chip']} img/s)"
                               for e in epochs)
        + f"; test acc {res['test_acc']:.4f} F1 {res['test_f1']:.4f}; "
        f"launches {counts}")
    missing = [k for k in DISK_KERNELS[name] if not counts.get(k)]
    extra = sorted(set(counts) - set(DISK_KERNELS[name]))
    if missing or extra:
        raise AssertionError(f"{tag}: kernels not launched {missing}, "
                             f"launched unexpectedly {extra}")
    return [e["epoch"] for e in epochs]


def phase_train_disk(dev, d: Path) -> None:
    """The three reference train CLIs from a synthetic image tree on disk
    (``d/data``), at full width, through their ``main(argv)``, writing
    their checkpoints under ``d/logs`` (phase 13 evaluates them)."""
    from dfu_multimodal_tpu_torch import native
    from dfu_multimodal_tpu_torch.data.loader import decode_raw
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
    gpu = card()
    log(f"[disk] {native.describe()}; {gpu}")
    route = native.route()
    _decode_vs_fixture(route)
    data, logs = d / "data", d / "logs"
    t0 = time.perf_counter()
    make_synthetic_dataset(data, images_per_class=DISK_IMAGES_PER_CLASS,
                           size=IMAGE)
    files = list_images(data)
    t1 = time.perf_counter()
    decode_raw(files, IMAGE)
    t2 = time.perf_counter()
    log(f"[disk] wrote {len(files)} JPEGs at {IMAGE}² in {t1 - t0:.3f} s; "
        f"decoded them ({route}) in {t2 - t1:.3f} s (host clock; {gpu})")
    for name, (_, batch) in DISK_CLIS.items():
        tag = f"disk {name}"
        jsonl = d / f"{name}.jsonl"
        argv = ["--data-dir", str(data), "--checkpoint-root", str(logs),
                "--epochs", str(DISK_EPOCHS), "--save-best-after", "1",
                "--save-last", "--log-jsonl", str(jsonl), "--seed", "0"]
        epochs = _run_cli(tag, name, argv, jsonl)
        if epochs != list(range(1, DISK_EPOCHS + 1)):
            raise AssertionError(f"{tag}: ran epochs {epochs}")
        _check_artifacts(tag, logs / f"checkpoints_{name}", DISK_EPOCHS,
                         batch)
    tag = "disk multimodal resume"
    jsonl = d / "multimodal.jsonl"
    epochs = _run_cli(tag, "multimodal", [
        "--data-dir", str(data), "--checkpoint-root", str(logs),
        "--epochs", str(DISK_EPOCHS + 1), "--save-best-after", "1",
        "--save-last", "--log-jsonl", str(jsonl), "--seed", "0",
        "--resume"], jsonl)
    if epochs != [DISK_EPOCHS + 1]:
        raise AssertionError(f"{tag}: ran epochs {epochs}")
    _check_artifacts(tag, logs / "checkpoints_multimodal",
                     DISK_EPOCHS + 1, DISK_CLIS["multimodal"][1])


# --------------------------------------------------------------- phase 13

# The q95 round trip of a standardized file: ``dataset_tools standardize``
# writes each canvas with ``native.encode_jpeg(quality=95)`` (4:2:0) and
# the decoder reads it back; held against the canvas before the write.
# On phase 12's blocky synthetic textures at 224 -> 160 the worst file
# measured max 48 / mean 3.46 levels on nvJPEG (an H100 host, PERF.md).
STD_TARGET = 160
STD_MAX_ABS, STD_MEAN_ABS = 64, 4.5
# --bootstrap and the rest of the reference evaluation's options
EM_OPTIONS = ["--operating-point", "youden", "--calibration",
              "--temperature-from-val", "--bootstrap", "200",
              "--save-deployment"]
EM_MODELS = {"rgb_only": ("checkpoints_rgb_only", "RGB-Only", ()),
             "thermal_only": ("checkpoints_thermal_only", "Thermal-Only",
                              ("attn_block", "mlp_block")),
             "multimodal": ("checkpoints_multimodal", "Multimodal",
                            ("attn_block", "mlp_block", "fused_mlp"))}
EM_FP32_TOL, EM_PRED_MARGIN = 1e-4, 1e-3
NUM_TTA = 5
# the kernels TTA launches over the three models (rgb_only runs on cuDNN)
# and those the ablation's three trainings and validations launch
TTA_KERNELS = {"attn_block", "mlp_block", "fused_mlp"}
ABLATION_KERNELS = set(TRAIN_KERNELS) | {"fused_mlp"}


def _step(tag: str, t0: float) -> float:
    """Log a step's host seconds; returns the clock for the next."""
    t = time.perf_counter()
    log(f"[artifacts] {tag}: {t - t0:.2f} s (host clock)")
    return t


def _raw_download(data: Path, raw: Path) -> dict:
    """Phase 12's 224² JPEGs laid out as the two Kaggle downloads: RGB
    ``Patches/{Normal,Abnormal}`` (every split's healthy / ulcer images,
    the ulcer test images in ``TestSet``),
    thermal ``ThermoDataBase/{train,val}/{Control Group,DM Group}`` (train
    and val images as train, test images as val), two RGB and one thermal
    healthy image copied into the ulcer folder (cross-class duplicates,
    ulcer wins), and one RGB healthy image cropped to 224 x 160 as a PNG
    (at IMAGE = 224).
    Returns the unique healthy / ulcer counts each modality should give."""
    import shutil
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import load_image
    from dfu_multimodal_tpu_torch.data.png import write_png
    rgb = raw / "DFU_RGB" / "Patches"
    th = raw / "DFU_Thermal" / "ThermoDataBase"
    expect = {}
    for cls, folder in (("healthy", "Normal"), ("ulcer", "Abnormal")):
        dst = rgb / folder
        dst.mkdir(parents=True)
        for split in ("train", "val", "test"):
            for p in list_images(data / "rgb" / split / cls):
                shutil.copy(p, dst / f"{split}_{p.name}")
    test_set = raw / "DFU_RGB" / "TestSet"
    test_set.mkdir()
    for p in sorted((rgb / "Abnormal").glob("test_*")):
        p.rename(test_set / p.name)
    healthy = sorted((rgb / "Normal").iterdir())
    for p in healthy[:2]:
        shutil.copy(p, rgb / "Abnormal" / f"dup_{p.name}")
    write_png(rgb / "Normal" / "crop.png",
              load_image(healthy[3], IMAGE)[:IMAGE * 5 // 7])
    # the two copies' hashes move to ulcer; the PNG is one more healthy
    expect["rgb"] = (len(healthy) - 2 + 1,
                     len(list((rgb / "Abnormal").iterdir()))
                     + len(list(test_set.iterdir())))
    for cls, folder in (("healthy", "Control Group"), ("ulcer", "DM Group")):
        for split, raw_split in (("train", "train"), ("val", "train"),
                                 ("test", "val")):
            dst = th / raw_split / folder
            dst.mkdir(parents=True, exist_ok=True)
            for p in list_images(data / "thermal" / split / cls):
                shutil.copy(p, dst / f"{split}_{p.name}")
    dup = sorted((th / "train" / "Control Group").iterdir())[0]
    shutil.copy(dup, th / "train" / "DM Group" / "dup.jpg")
    n_h = sum(len(list((th / s / "Control Group").iterdir()))
              for s in ("train", "val"))
    n_u = sum(len(list((th / s / "DM Group").iterdir()))
              for s in ("train", "val"))
    expect["thermal"] = (n_h - 1, n_u - 1 + 1)
    return expect


def _split_sizes(n: int) -> dict:
    """The organizer's 70/15/15 by scikit-learn's rule: the test side of
    each split is ceil(t·n), the train side the rest."""
    if n < 3:
        return {"train": n, "val": 0, "test": 0}
    temp = math.ceil(0.3 * n)
    test = math.ceil(0.5 * temp)
    return {"train": n - temp, "val": temp - test, "test": test}


def _check_organized(out: Path, res: dict, expect: dict) -> None:
    from dfu_multimodal_tpu_torch.data.leakage import compute_sha256
    for modality, (n_h, n_u) in expect.items():
        r = res[modality]
        want = {"healthy": _split_sizes(n_h), "ulcer": _split_sizes(n_u)}
        dups = 2 if modality == "rgb" else 1
        log(f"[artifacts] organize {modality}: {r.dedupe_report}, healthy "
            f"{r.healthy}, ulcer {r.ulcer}, splits {r.split_counts}")
        if ((r.healthy, r.ulcer) != (n_h, n_u) or r.errors
                or r.dedupe_report["duplicates_removed"] != dups
                or r.split_counts != want):
            raise AssertionError(f"organize {modality}: expected healthy "
                                 f"{n_h} ulcer {n_u}, {dups} duplicates, "
                                 f"splits {want}")
        seen = {}
        for split in ("train", "val", "test"):
            for p in sorted((out / modality / split).rglob("*.jpg")):
                h = compute_sha256(p)
                if h in seen and seen[h] != split:
                    raise AssertionError(f"{p}: its hash is also in "
                                         f"{seen[h]}")
                seen[h] = split
        if len(seen) != n_h + n_u:
            raise AssertionError(f"{modality}: {len(seen)} unique files, "
                                 f"expected {n_h + n_u}")


def _check_standardized(src: Path, dst: Path) -> None:
    """Each standardized file against its canvas (the source decoded,
    resized and padded as ``standardize_image`` does, before the write)."""
    from dfu_multimodal_tpu_torch.data.loader import image_info, load_image
    worst_max, worst_mean = 0, 0.0
    for p in sorted(src.rglob("*.jpg")):
        ow, oh, _, _ = image_info(p)
        s = STD_TARGET / max(ow, oh)
        nw, nh = max(1, round(ow * s)), max(1, round(oh * s))
        canvas = np.zeros((STD_TARGET, STD_TARGET, 3), np.int16)
        x0, y0 = (STD_TARGET - nw) // 2, (STD_TARGET - nh) // 2
        canvas[y0:y0 + nh, x0:x0 + nw] = load_image(p, (nw, nh))
        got = load_image(dst / p.relative_to(src), STD_TARGET)
        diff = np.abs(got.astype(np.int16) - canvas)
        worst_max = max(worst_max, int(diff.max()))
        worst_mean = max(worst_mean, float(diff.mean()))
    log(f"[artifacts] standardize round trip (decode, resize to "
        f"{STD_TARGET}, q95 write, decode): worst max {worst_max} levels, "
        f"worst mean {worst_mean:.4f} (tolerance {STD_MAX_ABS} / "
        f"{STD_MEAN_ABS})")
    if worst_max > STD_MAX_ABS or worst_mean > STD_MEAN_ABS:
        raise AssertionError("standardized JPEGs beyond the round-trip "
                             "tolerance")


def _em_run(argv, per_model: dict) -> dict:
    """``extended_metrics.main(argv)``, every launch count set to 0 before
    each model's evaluation and read after it into ``per_model``."""
    from dfu_multimodal_tpu_torch.cli import extended_metrics as em
    evaluate = em.evaluate_model

    def counted(trainer, ckpt_dir, dataset, val_dataset=None):
        _reset_launches()
        out = evaluate(trainer, ckpt_dir, dataset, val_dataset)
        torch.cuda.synchronize()
        per_model[Path(ckpt_dir).name] = {
            k: v for k, v in _all_launches().items() if v}
        return out

    em.evaluate_model = counted
    try:
        return em.main(argv)
    finally:
        em.evaluate_model = evaluate


def _check_em_artifacts(out: Path, logs: Path, launches: dict) -> None:
    from dfu_multimodal_tpu_torch.data.png import read_png
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    keys = {"y_true", "y_pred", "y_probs", "metrics", "operating_point",
            "calibration", "bootstrap"}
    for subdir, (ckpt, display, kernels) in EM_MODELS.items():
        saved = load_pt(out / subdir / "results.pt")
        for name, size in (("confusion_matrix", (1800, 2400)),
                           ("roc_curve", (1800, 2400)),
                           ("pr_curve", (1800, 2400)),
                           ("reliability_diagram", (2400, 2400))):
            img = read_png(out / subdir / f"{name}_{display}.png")
            if img.shape[:2] != size or img.min() == 255:
                raise AssertionError(f"{subdir} {name}: {img.shape}")
        dep = json.loads((logs / ckpt / "deployment.json").read_text())
        got = launches[ckpt]
        missing = [k for k in kernels if not got.get(k)]
        extra = sorted(set(got) - set(kernels))
        log(f"[artifacts] extended_metrics {subdir}: accuracy "
            f"{saved['metrics']['accuracy']:.4f} F1 "
            f"{saved['metrics']['f1']:.4f}, youden threshold "
            f"{saved['operating_point']['info']['threshold']:.4f}, T = "
            f"{dep['temperature']:.4f}, bootstrap F1 "
            f"[{saved['bootstrap']['f1']['lo']:.4f}, "
            f"{saved['bootstrap']['f1']['hi']:.4f}]; launches {got}")
        if (set(saved) != keys or not np.isfinite(saved["y_probs"]).all()
                or missing or extra):
            raise AssertionError(f"{subdir}: keys {sorted(saved)}, kernels "
                                 f"not launched {missing}, launched "
                                 f"unexpectedly {extra}")
    summary = (out / "EVALUATION_SUMMARY.txt").read_text()
    if not all(f"{d.upper()} MODEL:" in summary
               for _, d, _ in EM_MODELS.values()):
        raise AssertionError(f"EVALUATION_SUMMARY.txt: {summary}")


def _em_fp32_vs_cpu(data: Path, logs: Path, d: Path) -> None:
    """``extended_metrics --models multimodal`` in fp32 on the card (TF32
    off) and on the CPU, on the same checkpoint and test split."""
    from dfu_multimodal_tpu_torch.cli import extended_metrics as em
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        for device in ("cuda", "cpu"):
            out = d / f"em_fp32_{device}"
            em.main(["--data-dir", str(data), "--checkpoint-root", str(logs),
                     "--output-dir", str(out), "--models", "multimodal",
                     "--compute-dtype", "float32", "--device", device])
            res[device] = load_pt(out / "multimodal" / "results.pt")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    card, cpu = res["cuda"], res["cpu"]
    err = float(np.abs(card["y_probs"] - cpu["y_probs"]).max())
    clear = np.abs(cpu["y_probs"] - 0.5) > EM_PRED_MARGIN
    same = bool((card["y_pred"][clear] == cpu["y_pred"][clear]).all())
    log(f"[artifacts] extended_metrics multimodal fp32 card vs CPU: max "
        f"|dp| {err:.3e} (tolerance {EM_FP32_TOL}), predictions equal on "
        f"{int(clear.sum())}/{len(clear)} rows with |p - 0.5| > "
        f"{EM_PRED_MARGIN}: {same}")
    if err > EM_FP32_TOL or not same:
        raise AssertionError("extended_metrics fp32 card vs CPU")


def phase_artifacts(dev, d: Path) -> None:
    """From a download to the reference's evaluation artifacts, on phase
    12's tree and checkpoints (``d``), through the CLIs' ``main(argv)``."""
    from dfu_multimodal_tpu_torch.cli import ablation_study
    from dfu_multimodal_tpu_torch.cli import dataset_tools
    from dfu_multimodal_tpu_torch.cli import organize_clean_dataset
    from dfu_multimodal_tpu_torch.cli import test_time_augmentation
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    data, logs = d / "data", d / "logs"
    t = t_start = time.perf_counter()
    expect = _raw_download(data, d / "raw")
    organized = d / "organized"
    res = organize_clean_dataset.main([
        "--rgb-source", str(d / "raw" / "DFU_RGB"), "--thermal-source",
        str(d / "raw" / "DFU_Thermal"), "--output", str(organized)])
    _check_organized(organized, res, expect)
    t = _step("raw layout + organize_clean_dataset", t)

    checks = dataset_tools.main([
        "verify", "--rgb-source", str(d / "raw" / "DFU_RGB"),
        "--thermal-source", str(d / "raw" / "DFU_Thermal"), "--organized",
        str(organized)])
    if not all(all(v.values()) for v in checks.values()):
        raise AssertionError(f"verify: {checks}")
    stats = dataset_tools.main(["analyze", "--root",
                                str(organized / "rgb")])
    n_rgb = sum(expect["rgb"])
    log(f"[artifacts] analyze rgb: count {stats['count']}, modes "
        f"{stats['modes']}, formats {stats['formats']}, width "
        f"{stats['width']}, height {stats['height']}")
    if (stats["count"] != n_rgb or stats["formats"] != {
            "JPEG": n_rgb - 1, "PNG": 1}
            or stats["height"]["min"] != IMAGE * 5 // 7):
        raise AssertionError(f"analyze: {stats}")
    std = d / "standardized"
    res = dataset_tools.main(["standardize", "--src", str(organized / "rgb"),
                              "--dst", str(std / "rgb"), "--target",
                              str(STD_TARGET), "--verify"])
    if res != {"processed": n_rgb, "errors": 0, "ok": n_rgb, "bad": 0}:
        raise AssertionError(f"standardize: {res}")
    _check_standardized(organized / "rgb", std / "rgb")
    counts = dataset_tools.main([
        "patient-split", "--src", str(organized / "rgb" / "train"),
        "--out", str(d / "patient_split")])
    n_split = sum(sum(c.values()) for c in counts.values())
    if n_split != sum(_split_sizes(n)["train"] for n in expect["rgb"]):
        raise AssertionError(f"patient-split: {counts}")
    dataset_tools.main(["stats", "--data-dir", str(organized)])
    t = _step("dataset_tools verify / analyze / standardize --verify / "
              "patient-split / stats", t)

    em_out = logs / "extended_metrics"
    per_model = {}
    _em_run(["--data-dir", str(data), "--checkpoint-root", str(logs)]
            + EM_OPTIONS, per_model)
    _check_em_artifacts(em_out, logs, per_model)
    t = _step("extended_metrics bf16, three models, every option", t)

    _em_fp32_vs_cpu(data, logs, d)
    t = _step("extended_metrics multimodal fp32, card and CPU", t)

    _reset_launches()
    tta = test_time_augmentation.main([
        "--data-dir", str(data), "--checkpoint-root", str(logs),
        "--num-tta", str(NUM_TTA)])
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    for subdir in ("rgb_only", "thermal_only"):
        em_metrics = load_pt(em_out / subdir / "results.pt")["metrics"]
        clean = tta[subdir]["clean"]
        pairs = {k: (clean[k], em_metrics[k]) for k in (
            "accuracy", "f1", "sensitivity", "specificity")}
        pairs["auc"] = (clean["auc"], em_metrics["auc_roc"])
        log(f"[artifacts] TTA {subdir}: clean vs extended_metrics {pairs}; "
            f"TTA accuracy {tta[subdir]['tta']['accuracy']:.4f}")
        if any(a != b for a, b in pairs.values()):
            raise AssertionError(f"TTA {subdir} clean metrics differ")
    log(f"[artifacts] TTA launches (three models, clean + {NUM_TTA} views): "
        f"{launches}")
    if (set(launches) != TTA_KERNELS
            or not all((logs / c / "tta_results.pt").exists()
                       for c, _, _ in EM_MODELS.values())):
        raise AssertionError(f"TTA: launches {launches}")
    t = _step(f"test_time_augmentation --num-tta {NUM_TTA}", t)

    _reset_launches()
    f1s = ablation_study.main(["--data-dir", str(data), "--epochs", "1",
                               "--with-multimodal"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    log(f"[artifacts] ablation F1s {f1s}; launches {launches}")
    if (set(f1s) != set(EM_MODELS) or not all(np.isfinite(list(
            f1s.values()))) or set(launches) != ABLATION_KERNELS):
        raise AssertionError(f"ablation: {f1s}, launches {launches}")
    t = _step("ablation_study --epochs 1 --with-multimodal", t)
    log(f"[artifacts] phase 13 in {t - t_start:.2f} s (host clock; "
        f"{card()})")


# --------------------------------------------------------------- phase 14

# K3's backward: FusedMlp's gradients (autograd through the plain version
# after the kernel's forward) against plain autograd on the same inputs,
# each gradient within K3_GRAD_TOL of its own max|g|: both backwards are
# the same plain computation, only the forward differs.
K3_GRAD_BATCH, K3_GRAD_TOL = 8, 1e-5
# the kernels each model's explanation runs on the card (fp32 CLI)
EXPLAIN_KERNELS = {"rgb_only": set(),
                   "thermal_only": {"attn_block", "mlp_block",
                                    "mlp_block_bwd", "qkv_attention_fwdbwd"},
                   "multimodal": {"attn_block", "mlp_block", "mlp_block_bwd",
                                  "qkv_attention_fwdbwd", "fused_mlp"}}
# card fp32 (TF32 off) against the CPU: max |Δcam| of CAMs each divided by
# its max, and the probabilities
CAM_CARD_TOL, CAM_PROB_TOL = 1e-2, 1e-4
CAM_SAMPLES = 2                 # per class, for the card-vs-CPU checks
# daemon B (thermal_only --int8 --explain): the int8 blocks predict, the
# full-fidelity blocks explain (forward and backward)
DAEMON_B_KERNELS = {"attn_block_q8", "mlp_block_q8", "attn_block",
                    "mlp_block", "mlp_block_bwd", "qkv_attention_fwdbwd"}
SERVE_REQUESTS, SERVE_THREADS = 16, 4
# a served probability against the eval step's on the same decoded image,
# both at batch 1 (measured up to 4e-7 in bf16 on the card)
SERVE_PROB_TOL = 1e-5


def _k3_backward(dev) -> dict:
    """FusedMlp forward (K3) and backward on the card against plain
    autograd through ``fused_mlp_ref``, B = 8, fp32 and bf16; returns the
    launches of the FusedMlp calls."""
    from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
    head = FusionMLP().to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(14)
    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        w = [t.detach() for t in fm.fusion_mlp_params(head)]
        args = [torch.randn(K3_GRAD_BATCH, 2816, generator=gen,
                            device=dev).to(dtype)]
        args += [t.to(dtype) if i % 2 == 0 else t for i, t in enumerate(w)]
        g = torch.randn(K3_GRAD_BATCH, 2, generator=gen, device=dev)
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = fm.fused_mlp.launches
        out = fm.FusedMlp.apply(*leaves)
        launches += fm.fused_mlp.launches - before
        if fm.fused_mlp.launches != before + 1:
            raise AssertionError("FusedMlp did not launch K3")
        ours = torch.autograd.grad(out, leaves, g)
        plain_leaves = [a.clone().requires_grad_(True) for a in args]
        ref_out = fm.fused_mlp_ref(*plain_leaves)
        ref = torch.autograd.grad(ref_out, plain_leaves, g)
        fwd = float((out - ref_out).detach().abs().max())
        errs = [float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(ours, ref)]
        log(f"[explain] K3 FusedMlp B={K3_GRAD_BATCH} {str(dtype)[6:]}: "
            f"forward max|d| {fwd:.3e} (tolerance {KERNEL_TOL[dtype]}); "
            f"gradients x, w1, b1, w2, b2, w3, b3 max|d|/max|g| "
            + ", ".join(f"{e:.2e}" for e in errs)
            + f" (tolerance {K3_GRAD_TOL})")
        if fwd > KERNEL_TOL[dtype] or max(errs) > K3_GRAD_TOL:
            raise AssertionError(f"FusedMlp {dtype} disagrees")
    return launches


def _gradcam_cli(dev, data: Path, logs: Path, out: Path) -> dict:
    """The Grad-CAM CLI over each model in turn (fp32, its defaults),
    with its files, sizes and launches checked; returns the launches."""
    from dfu_multimodal_tpu_torch.cli import grad_cam_visualization as gc
    from dfu_multimodal_tpu_torch.data.png import read_png
    total = {}
    for name in ("rgb_only", "thermal_only", "multimodal"):
        _reset_launches()
        t0 = time.perf_counter()
        n = gc.main(["--data-dir", str(data), "--checkpoint-root", str(logs),
                     "--output-dir", str(out), "--models", name,
                     "--seed", "0", "--image-size", str(IMAGE),
                     "--device", str(dev)])[name]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in _all_launches().items() if v}
        files = sorted(p.name for p in (out / name).iterdir())
        per_class = n // 2
        want = sorted(f"{c}_{i:02d}.png" for c in ("healthy", "ulcer")
                      for i in range(per_class))
        size = gc.MULTI_SIZE if name == "multimodal" else gc.SINGLE_SIZE
        shapes = {read_png(out / name / f).shape for f in files}
        log(f"[explain] grad_cam_visualization {name}: {n} figures "
            f"{files[0]}..{files[-1]}, {shapes} in {seconds:.2f} s; "
            f"launches {launches}")
        if (files != want or n != 8 or shapes != {(size[1], size[0], 3)}
                or set(launches) != EXPLAIN_KERNELS[name]):
            raise AssertionError(f"grad_cam_visualization {name}: {files}, "
                                 f"{shapes}, launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _cams_card_vs_cpu(dev, data: Path, logs: Path) -> None:
    """The multimodal CAMs (fused and strict) and thermal_only's rollout
    and Chefer on the card and, the model moved there on purpose, on the
    CPU: fp32 (TF32 off), the same checkpoints and samples."""
    from dfu_multimodal_tpu_torch.cli import grad_cam_visualization as gc
    from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                      load_single_modality)
    from dfu_multimodal_tpu_torch.serve.explain import normalize_inputs
    cases = {
        "multimodal": load_paired(data, "test", IMAGE, strategy="pseudo",
                                  seed=0),
        "thermal_only": load_single_modality(data / "thermal", "test", IMAGE,
                                             "thermal")}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, ds in cases.items():
            sel = np.asarray(gc._select_samples(ds.labels, CAM_SAMPLES))
            outs = {}
            for label, device in (("card", dev), ("cpu", "cpu")):
                tr = Trainer(name, TrainConfig(batch_size=1,
                                               compute_dtype="float32"),
                             {"rgb": rgb_modality(),
                              "thermal": thermal_modality()},
                             device=device, image_size=IMAGE)
                tr.restore(logs / f"checkpoints_{name}")
                inputs = normalize_inputs(
                    tr, {m: ds.arrays[m][sel] for m in tr.spec.inputs})
                if name == "multimodal":
                    outs[label] = {
                        f"{mode} {branch}": o for mode in ("fused", "strict")
                        for branch, o in zip(("rgb", "thermal"),
                                             gc.multimodal_cams(
                                                 tr, inputs, 0, mode))}
                else:
                    outs[label] = {method: gc._vit_branch_cam(
                        tr, inputs, "pred", 0, method)
                        for method in ("rollout", "chefer")}
            if name == "multimodal":
                _bf16_vs_fp32_cams(dev, ds, sel, logs)
            for key, card_outs in outs["card"].items():
                cpu_outs = outs["cpu"][key]
                dcam = max(float(np.abs(a["cam"] - b["cam"]).max())
                           for a, b in zip(card_outs, cpu_outs))
                dprob = max(float(np.abs(np.asarray(a["probs"])
                                         - np.asarray(b["probs"])).max())
                            for a, b in zip(card_outs, cpu_outs))
                same = all(a["pred"] == b["pred"]
                           for a, b in zip(card_outs, cpu_outs))
                log(f"[explain] {name} {key} card vs CPU, {len(sel)} "
                    f"samples fp32: max |dcam| {dcam:.3e} (tolerance "
                    f"{CAM_CARD_TOL}), max |dp| {dprob:.3e} (tolerance "
                    f"{CAM_PROB_TOL}), predictions equal {same}")
                if dcam > CAM_CARD_TOL or dprob > CAM_PROB_TOL or not same:
                    raise AssertionError(f"{name} {key}: card vs CPU")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _bf16_vs_fp32_cams(dev, ds, sel, logs: Path) -> None:
    """The daemon's explanation (``Explainer``, class "pred") of the same
    multimodal samples in bf16, its serving dtype, and in fp32, on the
    card: the difference is recorded, not held to a budget."""
    from dfu_multimodal_tpu_torch.serve.explain import Explainer
    outs = {}
    for dtype in ("bfloat16", "float32"):
        tr = Trainer("multimodal", TrainConfig(compute_dtype=dtype),
                     {"rgb": rgb_modality(), "thermal": thermal_modality()},
                     device=dev, image_size=IMAGE)
        tr.restore(logs / "checkpoints_multimodal")
        ex = Explainer(tr)
        outs[dtype] = [ex.explain_one({m: ds.arrays[m][i]
                                       for m in ("rgb", "thermal")})
                       for i in sel]
    for m in ("rgb", "thermal"):
        d = [float(np.abs(a["cams"][m]["cam"] - b["cams"][m]["cam"]).max())
             for a, b in zip(outs["bfloat16"], outs["float32"])]
        log(f"[explain] multimodal {m} CAM bf16 vs fp32 on the card "
            f"(Explainer, class pred, {len(d)} samples): max |dcam| "
            + ", ".join(f"{v:.3e}" for v in d))
        if not all(np.isfinite(d)):
            raise AssertionError("bf16 CAM not finite")
    same = [a["class_explained"] == b["class_explained"]
            for a, b in zip(outs["bfloat16"], outs["float32"])]
    log(f"[explain] bf16 vs fp32 explained class equal: {same}")


def _http(url, body=None, ctype=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _daemon(dev, argv, max_batch=4):
    """``cli/serve``'s daemon on 127.0.0.1:0 in a thread: (url, server,
    router, thread)."""
    from dfu_multimodal_tpu_torch.cli import serve
    server, router, _ = serve.build_daemon(
        argv + ["--host", "127.0.0.1", "--port", "0", "--max-batch",
                str(max_batch),
                "--ignore-deployment", "--device", str(dev),
                "--image-size", str(IMAGE)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", server, router, \
        thread


def _stop_daemon(server, router, thread) -> None:
    server.shutdown()
    server.server_close()
    router.stop()
    thread.join(timeout=30)


def _serve_http(dev, data: Path, logs: Path) -> dict:
    """The serving daemon over HTTP: multimodal and rgb_only (bf16,
    --explain) behind one router, thermal_only --int8 --explain (int8
    predictions, explanations of the full-fidelity restore), rgb_only
    without --explain (501); returns daemon A's and B's launches."""
    import base64
    from dfu_multimodal_tpu_torch.data.loader import decode_bytes
    from dfu_multimodal_tpu_torch.data.png import decode_png
    jpegs = {m: sorted((data / m / "test").rglob("*.jpg"))[:4]
             for m in ("rgb", "thermal")}
    raw = {m: [p.read_bytes() for p in ps] for m, ps in jpegs.items()}
    b64 = {m: [base64.b64encode(r).decode() for r in rs]
           for m, rs in raw.items()}
    launches = {}

    _reset_launches()
    url, *a = _daemon(dev, ["--checkpoint", str(logs / "checkpoints_multimodal"),
                       "--checkpoint", str(logs / "checkpoints_rgb_only"),
                       "--explain"])
    router = a[1]
    try:
        # one request at a time: bucket 1, the eval step's batch below
        for k in range(2):
            code, body = _http(url + "/v1/predict", raw["rgb"][k],
                               "image/jpeg")
            res = json.loads(body)
            step = router.engines["rgb_only"].trainer.eval_step(
                {"rgb": decode_bytes(raw["rgb"][k], IMAGE)[None]})
            code2, body2 = _http(url + "/v1/predict", json.dumps(
                {"rgb": b64["rgb"][k], "thermal": b64["thermal"][k]}
            ).encode(), "application/json")
            res2 = json.loads(body2)
            step2 = router.engines["multimodal"].trainer.eval_step(
                {m: decode_bytes(raw[m][k], IMAGE)[None]
                 for m in ("rgb", "thermal")})
            d1 = abs(res["prob_ulcer"] - float(step["probs"][0]))
            d2 = abs(res2["prob_ulcer"] - float(step2["probs"][0]))
            log(f"[explain] daemon A request {k}: JPEG -> {res['model']} "
                f"p {res['prob_ulcer']} (eval step |d| {d1:.2e}); JSON "
                f"base64 -> {res2['model']} p {res2['prob_ulcer']} (|d| "
                f"{d2:.2e}; tolerance {SERVE_PROB_TOL})")
            if (code, code2) != (200, 200) or res["model"] != "rgb_only" \
                    or res2["model"] != "multimodal" \
                    or max(d1, d2) > SERVE_PROB_TOL:
                raise AssertionError(f"daemon A predict: {res}, {res2}")
        code, body = _http(url + "/v1/explain", json.dumps(
            {"rgb": b64["rgb"][0], "thermal": b64["thermal"][0]}).encode(),
            "application/json")
        exp = json.loads(body)
        shapes = {m: decode_png(base64.b64decode(e["overlay_png"])).shape
                  for m, e in exp["explanations"].items()}
        methods = {m: e["method"] for m, e in exp["explanations"].items()}
        log(f"[explain] daemon A /v1/explain multimodal: {code}, class "
            f"{exp.get('class_explained')}, methods {methods}, overlays "
            f"{shapes}")
        if code != 200 or shapes != {m: (IMAGE, IMAGE, 3)
                                     for m in ("rgb", "thermal")}:
            raise AssertionError(f"daemon A explain: {code} {exp}")
        code, body = _http(url + "/v1/predict/multimodal", json.dumps(
            {"image": b64["rgb"][0], "rgb": b64["rgb"][0]}).encode(),
            "application/json")
        code404, _ = _http(url + "/v1/predict/nope", raw["rgb"][0],
                           "image/jpeg")
        health = json.loads(_http(url + "/healthz")[1])
        metrics = json.loads(_http(url + "/metrics")[1])
        prom = _http(url + "/metrics/prometheus")[1].decode()
        log(f"[explain] daemon A: duplicate field {code} "
            f"{json.loads(body)['error']!r}; unknown model {code404}; "
            f"healthz {health}; prometheus {len(prom.splitlines())} lines")
        if (code != 400 or code404 != 404 or health["status"] != "ok"
                or health["explain"] != ["multimodal", "rgb_only"]
                or 'dfu_explains_total{model="multimodal"} 1' not in prom):
            raise AssertionError("daemon A health / errors / metrics")
        # p50 / p99 of concurrent multimodal requests (smoke figures): at
        # the client (HTTP, base64 and the two JPEG decodes included) and
        # in the engine (submit to result)
        body = json.dumps({"rgb": b64["rgb"][1],
                           "thermal": b64["thermal"][1]}).encode()

        def timed(_):
            t0 = time.perf_counter()
            code = _http(url + "/v1/predict/multimodal", body,
                         "application/json")[0]
            return code, 1e3 * (time.perf_counter() - t0)

        with ThreadPoolExecutor(SERVE_THREADS) as ex:
            codes, client_ms = zip(*ex.map(timed, range(SERVE_REQUESTS)))
        lat = json.loads(_http(url + "/metrics")[1])["models"][
            "multimodal"]["latency_ms"]
        c50, c99 = np.percentile(client_ms, [50, 99])
        log(f"[explain] daemon A multimodal bf16, {SERVE_REQUESTS} requests "
            f"from {SERVE_THREADS} threads: HTTP end to end at the client "
            f"p50 {c50:.2f} ms, p99 {c99:.2f} ms; engine (submit to "
            f"result) p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms "
            f"(smoke figures; {card()})")
        if set(codes) != {200}:
            raise AssertionError(f"daemon A load: {codes}")
        del metrics
    finally:
        _stop_daemon(*a)
    torch.cuda.synchronize()
    launches["A"] = {k: v for k, v in _all_launches().items() if v}

    _reset_launches()
    url, *b = _daemon(dev, ["--checkpoint", str(logs / "checkpoints_thermal_only"),
                       "--int8", "--explain"])
    try:
        code, body = _http(url + "/v1/predict", raw["thermal"][0],
                           "image/jpeg")
        code2, body2 = _http(url + "/v1/explain", raw["thermal"][0],
                             "image/jpeg")
        exp = json.loads(body2)
        shape = decode_png(base64.b64decode(
            exp["explanations"]["thermal"]["overlay_png"])).shape
        log(f"[explain] daemon B thermal_only int8: predict {code} "
            f"{json.loads(body)}; explain {code2} method "
            f"{exp['explanations']['thermal']['method']} overlay {shape}")
        if (code, code2) != (200, 200) or shape != (IMAGE, IMAGE, 3):
            raise AssertionError("daemon B")
    finally:
        _stop_daemon(*b)
    torch.cuda.synchronize()
    launches["B"] = {k: v for k, v in _all_launches().items() if v}
    if not DAEMON_B_KERNELS <= set(launches["B"]):
        raise AssertionError(f"daemon B launches {launches['B']}")

    url, *c = _daemon(dev, ["--checkpoint", str(logs / "checkpoints_rgb_only")])
    try:
        code, body = _http(url + "/v1/explain", raw["rgb"][0], "image/jpeg")
        log(f"[explain] daemon C rgb_only without --explain: /v1/explain "
            f"{code} {json.loads(body)['error']!r}")
        if code != 501:
            raise AssertionError("daemon C: no 501")
    finally:
        _stop_daemon(*c)
    log(f"[explain] daemon launches A (multimodal + rgb_only bf16) "
        f"{launches['A']}, B (thermal_only int8 + explain) {launches['B']}")
    if not EXPLAIN_KERNELS["multimodal"] <= set(launches["A"]):
        raise AssertionError(f"daemon A launches {launches['A']}")
    return launches


def _predict_cli(dev, data: Path, logs: Path, out: Path) -> None:
    """``cli/predict`` over a directory pair: its rows against the eval
    step's on the same decoded images and batches."""
    from dfu_multimodal_tpu_torch.cli import predict
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import decode_all
    ckpt = logs / "checkpoints_multimodal"
    rgb, thermal = data / "rgb" / "test", data / "thermal" / "test"
    res = predict.main(["--checkpoint", str(ckpt), "--images", str(rgb),
                        "--thermal-images", str(thermal), "--batch-size",
                        "8", "--output", str(out / "preds.csv"),
                        "--explain-dir", str(out / "explain"),
                        "--drift-check", "--ignore-deployment",
                        "--image-size", str(IMAGE), "--device", str(dev)])
    tr = Trainer("multimodal", TrainConfig(batch_size=8, eval_batch_size=8),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device=dev, image_size=IMAGE)
    tr.restore(ckpt)
    n = len(res)
    ds = ArrayDataset({"rgb": decode_all(list_images(rgb)[:n], IMAGE),
                       "thermal": decode_all(list_images(thermal)[:n],
                                             IMAGE)}, np.zeros(n, np.int32))
    _, ref = tr.run_eval_epoch(ds)
    probs = np.asarray([p for p, _ in res.values()])
    preds = [d for _, d in res.values()]
    err = float(np.abs(probs - ref["y_probs"]).max())
    overlays = sorted((out / "explain").iterdir())
    rows = (out / "preds.csv").read_text().splitlines()
    log(f"[explain] predict CLI multimodal bf16: {n} rows, max |dp| vs the "
        f"eval step {err:.2e}, predictions equal "
        f"{preds == ref['y_pred'].tolist()}, {len(overlays)} overlays, CSV "
        f"{len(rows)} lines")
    if (err > 1e-6 or preds != ref["y_pred"].tolist()
            or len(overlays) != 2 * n or len(rows) != n + 1):
        raise AssertionError("predict CLI")


def phase_explain(dev, d: Path) -> dict:
    """Explanations on the card, on phase 12's tree and checkpoints
    (``d``): K3's backward, the Grad-CAM CLI, the CAMs card against CPU,
    the serving daemon over HTTP and the predict CLI.  Returns the
    launches of the explain paths by kernel."""
    data, logs = d / "data", d / "logs"
    t0 = time.perf_counter()
    launches = {"fused_mlp": _k3_backward(dev)}
    for k, v in _gradcam_cli(dev, data, logs, d / "gradcam").items():
        launches[k] = launches.get(k, 0) + v
    _cams_card_vs_cpu(dev, data, logs)
    for daemon in _serve_http(dev, data, logs).values():
        for k, v in daemon.items():
            launches[k] = launches.get(k, 0) + v
    _predict_cli(dev, data, logs, d / "predict")
    log(f"[explain] phase 14 in {time.perf_counter() - t0:.2f} s (host "
        f"clock; {card()}); launches {launches}")
    return launches


# --------------------------------------------------------------- phase 15

Q8_CONV_BATCH = 8            # the serving batch of the conv checks
Q8_CALIB = 32                # calibration images (the CLIs take the first 32)
Q8_REQUESTS = 16             # requests a served model answers at b1 and b8
Q8_DAEMON_REQUESTS = 8       # HTTP requests a round to a phase-15 daemon
Q8_DAEMON_ROUNDS = 4         # at most, at depth 2, until batches overlap
# what one batch of each int8 model launches: 52 convs a trunk forward
# (48 of the bottlenecks, 4 projections); multimodal's ViT on the int8
# blocks (12 of each) and its head on K3
TRUNK_CONVS, TRUNK_QUANTS = 52, 4
Q8_SERVE_KERNELS = {"rgb_only": {"conv_q8": TRUNK_CONVS,
                                 "quantize_act_q8": TRUNK_QUANTS},
                    "multimodal": {"conv_q8": TRUNK_CONVS,
                                   "quantize_act_q8": TRUNK_QUANTS,
                                   "attn_block_q8": DEPTH,
                                   "mlp_block_q8": DEPTH, "fused_mlp": 1}}
# the predict CLI's int8 runs: the kernels each model must launch
Q8_PREDICT_KERNELS = {"rgb_only": {"conv_q8"},
                      "multimodal": {"conv_q8", "attn_block_q8",
                                     "mlp_block_q8", "fused_mlp"}}
# the daemon's: the int8 multimodal primary's and its bf16 shadow's
Q8_DAEMON_KERNELS = {"attn_block", "mlp_block", "fused_mlp", "conv_q8",
                     "quantize_act_q8", "attn_block_q8", "mlp_block_q8"}


def resnet_conv_shapes(image: int = 224,
                       stage_sizes=(3, 4, 6, 3),
                       widths=(64, 128, 256, 512),
                       distinct: bool = True) -> list:
    """The convs of an int8 bottleneck trunk at ``image``², in the order
    the forward runs them (only the first of equal ones when
    ``distinct``): (name, H, Cin, Cout, k, stride, role) with H the
    input's side and role "conv1" (ReLU; the block input, int8 when the
    block has a projection), "conv2" (ReLU), "conv3" (the shortcut added,
    then ReLU) or "down" (the projection, int8 input)."""
    h = -(-(-(-image // 2)) // 2)              # the stem's two halvings
    cin, seen, out = 64, set(), []
    for s, (blocks, width) in enumerate(zip(stage_sizes, widths), start=1):
        for j in range(blocks):
            stride = 2 if s > 1 and j == 0 else 1
            ho = -(-h // stride)
            proj = j == 0
            convs = [("conv1", h, cin, width, 1, 1),
                     ("conv2", h, width, width, 3, stride),
                     ("conv3", ho, width, 4 * width, 1, 1)]
            if proj:
                convs.append(("down", h, cin, 4 * width, 1, stride))
            for role, hh, ci, co, k, st in convs:
                key = (hh, ci, co, k, st, role, proj and role == "conv1")
                if not distinct or key not in seen:
                    seen.add(key)
                    out.append((f"stage{s} block{j} {role}", hh, ci, co, k,
                                st, role))
            h, cin = ho, 4 * width
    return out


def _q8_conv_case(dev, b, h, cin, cout, k, stride, role, int8_in, dtype,
                  seed) -> dict:
    """Seeded operands of one conv of the int8 trunk in ``conv_q8``'s
    keywords: x in the compute dtype, or int8 for a projection block's
    conv1 and its projection; the kernel's K-major int8 copy, its column
    scale and bias, the shortcut of a conv3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ho = -(-h // stride)
    act = torch.tensor(0.02 + 0.01 * (seed % 3), device=dev)
    x = _randn(g, b, h, h, cin, dtype=dtype)
    if int8_in:
        x = cq.quantize_act(x, act)
    w = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                      device=dev, dtype=torch.int32).to(torch.int8)
    scale = _randn(g, cout, scale=1e-3, offset=4e-3).abs()
    resid = (_randn(g, b, ho, ho, cout, dtype=dtype) if role == "conv3"
             else None)
    return dict(x=x, kernel_kmajor=w, col_scale=act * scale,
                bias=_randn(g, cout, scale=0.1), act_scale=act, k=k,
                stride=stride, relu=role != "down", resid=resid,
                dtype=dtype)


def _library_conv_q8(x, kernel_kmajor, col_scale, bias, act_scale, k,
                     stride):
    """The same conv (no shortcut, no ReLU) on PyTorch's calls: the plain
    gather and ``torch._int_mm`` (cuBLASLt s8·s8→s32), dequantised in
    PyTorch ops; a yardstick the port never calls."""
    a = cq.im2col_q8_ref(x, act_scale, k, stride)
    acc = torch._int_mm(a, kernel_kmajor.t())
    b, h, w, _ = x.shape
    ho, wo = cq.out_hw(h, w, k, stride)
    dtype = x.dtype if x.dtype != torch.int8 else torch.bfloat16
    return (acc.float() * col_scale + bias).to(dtype).reshape(b, ho, wo, -1)


def _q8_conv_bound(b, h, cin, cout, k, stride, role, int8_in,
                   dtype) -> tuple:
    """(operations, bytes) of one conv: 2·M·K·Cout int8 operations (M =
    B·Ho·Wo, K = k²·Cin); x read once (int8 or the compute dtype), the
    int8 kernel, the scales and biases, the shortcut of a conv3, and the
    output written once."""
    ho = -(-h // stride)
    m, depth, t = b * ho * ho, k * k * cin, torch.finfo(dtype).bits // 8
    nbytes = (b * h * h * cin * (1 if int8_in else t) + cout * depth
              + 8 * cout + 4 + m * cout * t * (2 if role == "conv3" else 1))
    return 2 * m * depth * cout, nbytes


def _q8_conv_key(name, h, cin, cout, k, stride, role) -> tuple:
    return (h, cin, cout, k, stride, role,
            name.endswith("block0 conv1") or role == "down")


def phase_q8_conv(dev) -> dict:
    """``conv_q8`` against ``conv_q8_ref`` on the card, bit for bit, at
    every distinct ResNet-50 conv at B = 8 in bf16 and fp32; in bf16 each
    shape's CUDA-event and device (profiler) time beside the plain
    version's, the library route's (the plain gather and
    ``torch._int_mm``) and its bound; then the sums over the 52 convs of
    one trunk forward, the kernels line's row."""
    gpu = card()
    rows, worst = {}, 0.0
    for name, h, cin, cout, k, stride, role in resnet_conv_shapes(IMAGE):
        key = _q8_conv_key(name, h, cin, cout, k, stride, role)
        for dtype in (torch.float32, torch.bfloat16):
            case = _q8_conv_case(dev, Q8_CONV_BATCH, h, cin, cout, k, stride,
                                 role, key[-1], dtype, seed=h + cin + cout)
            out = cq.conv_q8(**case)
            ref = cq.conv_q8_ref(**case)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            worst = max(worst, err)
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"conv_q8 {name} {dtype}: not bit-equal to plain, max "
                    f"{err}")
            if dtype != torch.bfloat16:
                continue
            lib_args = {a: case[a] for a in ("x", "kernel_kmajor",
                                              "col_scale", "bias",
                                              "act_scale", "k", "stride")}
            ms = cuda_ms(lambda: cq.conv_q8(**case))
            plain = cuda_ms(lambda: cq.conv_q8_ref(**case), iters=5)
            library = cuda_ms(lambda: _library_conv_q8(**lib_args))
            # the profiler now and then records no kernel of a short
            # region: ask again before calling the time not measured
            split = {}
            for _ in range(3):
                split = _device_split(lambda: cq.conv_q8(**case))
                if split:
                    break
            dev_ms = sum(split.values()) or None
            ops, nbytes = _q8_conv_bound(Q8_CONV_BATCH, h, cin, cout, k,
                                         stride, role, key[-1], dtype)
            bound = _bound({torch.int8: ops}, nbytes)
            rows[key] = dict(ms=ms, plain_ms=plain, library_ms=library,
                             device_ms=dev_ms, ops=ops, nbytes=nbytes,
                             **bound)
            log(f"[q8 conv] {name} ({h}², {cin}->{cout}, {k}x{k}/{stride}, "
                f"{'int8' if key[-1] else 'bf16'} in): bit-equal to plain "
                f"(fp32 and bf16); events {ms:.4f} ms, device "
                f"{_ms_or_none(dev_ms)} ("
                + ", ".join(f"{n.split('<')[0]} {t:.4f}"
                            for n, t in split.items())
                + f"), plain {plain:.4f} ms, library (im2col + "
                f"torch._int_mm) {library:.4f} ms, bound "
                f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})")
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "device_ms": 0.0, "ops": 0, "nbytes": 0}
    convs = resnet_conv_shapes(IMAGE, distinct=False)
    for name, *shape in convs:
        row = rows[_q8_conv_key(name, *shape)]
        for field in total:
            # a shape the profiler never saw leaves the device sum unknown
            total[field] = (None if total[field] is None or row[field] is None
                            else total[field] + row[field])
    bound = _bound({torch.int8: total["ops"]}, total["nbytes"])
    log(f"[q8 conv] the {len(convs)} convs of one ResNet-50 int8 trunk "
        f"forward at B = {Q8_CONV_BATCH}, bf16: events {total['ms']:.4f} "
        f"ms, device {_ms_or_none(total['device_ms'])}, plain "
        f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
        f"{total['ops'] / 1e9:.2f} GOP, {total['nbytes'] / 1e6:.1f} MB); "
        f"max |kernel - plain| {worst} over every shape and dtype ({gpu})")
    return {"conv_q8": {"max_abs_err": worst, "ms": total["ms"],
                        "plain_ms": total["plain_ms"],
                        "library_ms": total["library_ms"],
                        "device_ms": total["device_ms"], **bound},
            "quantize_act_q8": _q8_quant_times(dev, gpu)}


def _q8_quant_times(dev, gpu) -> dict:
    """``quantize_act_q8`` against the plain ``quantize_act`` on the card,
    bit for bit in fp32 and bf16, at the inputs of the trunk's four
    projection blocks (the 4 quantisations of one forward; a projection
    block's conv1 and its projection share them); in bf16 each shape's
    CUDA-event, device and plain times and its bound, then their sums.
    No single PyTorch call computes it (library_ms null)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "ops": 0,
             "nbytes": 0}
    worst = 0.0
    shapes = [(name, h, cin) for name, h, cin, *_ in
              resnet_conv_shapes(IMAGE, distinct=False)
              if name.endswith("block0 conv1")]
    for name, h, cin in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(h + cin)
            x = _randn(g, Q8_CONV_BATCH, h, h, cin, dtype=dtype)
            act = torch.tensor(0.03, device=dev)
            out = cq.quantize_act_q8(x, act)
            ref = cq.quantize_act(x, act)
            torch.cuda.synchronize()
            err = float((out.int() - ref.int()).abs().max())
            worst = max(worst, err)
            if not torch.equal(out, ref):
                raise AssertionError(f"quantize_act_q8 {name} {dtype}: not "
                                     f"bit-equal to plain, max {err}")
        ms = cuda_ms(lambda: cq.quantize_act_q8(x, act))
        plain = cuda_ms(lambda: cq.quantize_act(x, act))
        split = {}
        for _ in range(3):
            split = _device_split(lambda: cq.quantize_act_q8(x, act))
            if split:
                break
        dev_ms = sum(split.values()) or None
        # one division an element; x read in bf16, the int8 written
        n = x.numel()
        ops, nbytes = n, 3 * n + 4
        bound = _bound({torch.float32: ops}, nbytes)
        for field, v in (("ms", ms), ("plain_ms", plain),
                         ("device_ms", dev_ms), ("ops", ops),
                         ("nbytes", nbytes)):
            total[field] = (None if total[field] is None or v is None
                            else total[field] + v)
        log(f"[q8 quant] {name} input ({h}², {cin}): bit-equal to plain "
            f"(fp32 and bf16); events {ms:.4f} ms, device "
            f"{_ms_or_none(dev_ms)}, plain {plain:.4f} ms, bound "
            f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})")
    bound = _bound({torch.float32: total["ops"]}, total["nbytes"])
    log(f"[q8 quant] the {len(shapes)} quantisations of one ResNet-50 int8 "
        f"trunk forward at B = {Q8_CONV_BATCH}, bf16: events "
        f"{total['ms']:.4f} ms, device {_ms_or_none(total['device_ms'])}, "
        f"plain {total['plain_ms']:.4f} ms, bound {bound['bound_ms']:.4f} "
        f"ms ({bound['bound_by']}); max |kernel - plain| {worst} ({gpu})")
    if len(shapes) != TRUNK_QUANTS:
        raise AssertionError(f"quantize_act_q8: {len(shapes)} shapes")
    return {"max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "library_ms": None,
            "device_ms": total["device_ms"], **bound}


def _q8_float_trainer(name, dev, seed) -> Trainer:
    """The full-width ``name`` in bf16 with weights from ``seed`` and
    BatchNorm statistics off identity."""
    tr = Trainer(name, TrainConfig(compute_dtype="bfloat16", batch_size=8,
                                   eval_batch_size=8),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device=dev, image_size=IMAGE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    zoo.init_model(tr.module, gen)
    with torch.no_grad():
        _perturb_batchnorm(tr.module, gen)
    return tr


def _q8_images(n, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256,
                                                (n, IMAGE, IMAGE, 3),
                                                dtype=np.uint8)


def _q8_trunk_vs_plain(dev, q) -> None:
    """The int8 trunk of the served ``rgb_only`` with the kernels against
    the same trunk on ``conv_q8_ref`` (and the plain quantisation), on the
    card: features and taps bit-equal; one forward launches 52 convs and
    4 quantisations."""
    from unittest import mock
    from dfu_multimodal_tpu_torch.models import resnet_q8 as rq
    trunk = q.module.resnet
    x = eval_normalize(torch.from_numpy(_q8_images(8, 40)).to(dev),
                       rgb_modality(), torch.bfloat16)
    with torch.inference_mode():
        before = (cq.conv_q8.launches, cq.quantize_act_q8.launches)
        taps = {}
        out = trunk(x, taps)
        torch.cuda.synchronize()
        counts = (cq.conv_q8.launches - before[0],
                  cq.quantize_act_q8.launches - before[1])
        with mock.patch.object(rq, "conv_q8", cq.conv_q8_ref), \
                mock.patch.object(rq, "quantize_act_q8", cq.quantize_act):
            ref_taps = {}
            ref = trunk(x, ref_taps)
    equal = torch.equal(out, ref) and all(
        torch.equal(taps[k], ref_taps[k]) for k in ref_taps)
    log(f"[q8 trunk] ResNet-50 int8 trunk, B = 8, bf16: features and taps "
        f"kernel vs plain bit-equal {equal} (max |d| "
        f"{float((out - ref).abs().max()):.3e}); launches a forward: "
        f"conv_q8 {counts[0]}, quantize_act_q8 {counts[1]}")
    if not equal or counts != (TRUNK_CONVS, TRUNK_QUANTS):
        raise AssertionError("int8 trunk: kernel vs plain, or launches")


def _q8_serve_one(tag, q, base, samples, batch_np) -> dict:
    """``q`` behind the ServingEngine at b1 (one request at a time) and b8
    (Q8_REQUESTS submitted together, max_batch 8), bf16; latency p50 /
    p99, int8 against bf16 on the same samples, launches per batch of the
    b8 drive (its counts set to 0 just before it).  Returns the b8
    drive's launches."""
    name = q.spec.name
    lat = {}
    for label, max_batch in (("b1", 1), ("b8", 8)):
        eng = ServingEngine(q, image_size=IMAGE, max_batch=max_batch,
                            max_wait_ms=5.0)
        with eng:
            _reset_launches()
            if max_batch == 1:
                got = [eng.submit(s).result(timeout=120) for s in samples]
            else:
                futs = [eng.submit(s) for s in samples]
                got = [f.result(timeout=120) for f in futs]
            torch.cuda.synchronize()
            launches = {k: v for k, v in _all_launches().items() if v}
            stats = eng.stats()
        lat[label] = stats["latency_ms"]
    batches = sum(stats["batch_size_hist"].values())
    per_batch = {k: v / batches for k, v in launches.items()}
    probs = np.asarray([p for p, _ in got])
    preds = np.asarray([c for _, c in got])
    ref = base.eval_step(batch_np)
    ref_p, ref_c = ref["probs"].float().cpu().numpy(), \
        ref["preds"].cpu().numpy()
    gap = float(np.abs(probs - ref_p).max())
    agree = float((preds == ref_c).mean())
    log(f"[{tag}] {name} int8 ServingEngine bf16, {len(samples)} requests: "
        f"b1 p50 {lat['b1']['p50']:.2f} ms p99 {lat['b1']['p99']:.2f} ms; "
        f"b8 p50 {lat['b8']['p50']:.2f} ms p99 {lat['b8']['p99']:.2f} ms "
        f"(batches {stats['batch_size_hist']}); int8 vs bf16 max |dP| "
        f"{gap:.4e}, decisions agree {agree:.4f}; launches a batch "
        f"{per_batch} ({card()})")
    want = Q8_SERVE_KERNELS[name]
    if (set(per_batch) != set(want)
            or any(per_batch[k] != v for k, v in want.items())
            or not np.isfinite(probs).all()):
        raise AssertionError(f"{tag} {name}: launches a batch {per_batch}, "
                             f"want {want}")
    return launches


def phase_q8_serve(dev) -> dict:
    """``quantize_for_serving`` of the full-width rgb_only and multimodal
    (seeded weights, BatchNorm statistics off identity, calibrated on
    Q8_CALIB synthetic images on the card) behind the ServingEngine, and
    the int8 trunk against its plain version.  Returns the main path's
    launches (both models' b8 drives)."""
    launches = {}
    for seed, name in enumerate(("rgb_only", "multimodal")):
        t0 = time.perf_counter()
        base = _q8_float_trainer(name, dev, 70 + seed)
        calib = _q8_images(Q8_CALIB, 50 + seed)
        q = quantize_for_serving(base, image_size=IMAGE, calib_u8=calib)
        torch.cuda.synchronize()
        log(f"[q8 serve] {name}: quantised and calibrated on {Q8_CALIB} "
            f"images on the card in {time.perf_counter() - t0:.2f} s "
            "(host clock)")
        if name == "rgb_only":
            _q8_trunk_vs_plain(dev, q)
        inputs = q.spec.inputs
        batch_np = {m: _q8_images(Q8_REQUESTS, 60 + i)
                    for i, m in enumerate(inputs)}
        samples = [{m: batch_np[m][i] for m in inputs}
                   for i in range(Q8_REQUESTS)]
        for k, v in _q8_serve_one("q8 serve", q, base, samples,
                                  batch_np).items():
            launches[k] = launches.get(k, 0) + v
        del base, q
        torch.cuda.empty_cache()
    return launches


def _q8_predict_cli(dev, data: Path, logs: Path) -> None:
    """``cli/predict --int8 --calib-images`` for rgb_only and multimodal on
    phase 12's checkpoints: its rows against an int8 trainer built from
    the same checkpoint and calibration images, and its launches."""
    from dfu_multimodal_tpu_torch.cli import predict
    from dfu_multimodal_tpu_torch.cli.serve import calibration_images
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import decode_all
    calib_dir = data / "rgb" / "train"
    for name in ("rgb_only", "multimodal"):
        ckpt = logs / f"checkpoints_{name}"
        argv = ["--checkpoint", str(ckpt), "--images",
                str(data / "rgb" / "test"), "--int8", "--calib-images",
                str(calib_dir), "--batch-size", "8", "--ignore-deployment",
                "--image-size", str(IMAGE), "--device", str(dev)]
        if name == "multimodal":
            argv += ["--thermal-images", str(data / "thermal" / "test")]
        _reset_launches()
        t0 = time.perf_counter()
        res = predict.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in _all_launches().items() if v}
        tr = Trainer(name, TrainConfig(batch_size=8, eval_batch_size=8),
                     {"rgb": rgb_modality(), "thermal": thermal_modality()},
                     device=dev, image_size=IMAGE)
        tr.restore(ckpt)
        q = quantize_for_serving(
            tr, image_size=IMAGE,
            calib_u8=calibration_images(calib_dir, IMAGE))
        n = len(res)
        arrays = {"rgb": decode_all(list_images(data / "rgb" / "test")[:n],
                                    IMAGE)}
        if name == "multimodal":
            arrays["thermal"] = decode_all(
                list_images(data / "thermal" / "test")[:n], IMAGE)
        _, ref = q.run_eval_epoch(ArrayDataset(arrays,
                                               np.zeros(n, np.int32)))
        probs = np.asarray([p for p, _ in res.values()])
        err = float(np.abs(probs - ref["y_probs"]).max())
        same = [d for _, d in res.values()] == ref["y_pred"].tolist()
        log(f"[q8 cli] predict --int8 {name}: {n} rows in {seconds:.2f} s "
            f"(host clock), max |dp| vs an int8 trainer of the same "
            f"checkpoint and calibration {err:.2e}, predictions equal "
            f"{same}; launches {launches}")
        if (err > 1e-6 or not same
                or not Q8_PREDICT_KERNELS[name] <= set(launches)
                or {"attn_block", "mlp_block", "bottleneck"} & set(launches)):
            raise AssertionError(f"predict --int8 {name}")
        del tr, q


def _count_in_flight(engine) -> dict:
    """Wrap ``engine``'s dispatch and resolve (both run on its batcher
    thread) to count the batches in flight: ``overlapped`` counts the
    recorded batches dispatched while another was not yet resolved."""
    seen = {"in_flight": 0, "overlapped": 0, "most": 0}
    dispatch, resolve = engine._dispatch, engine._resolve

    def counted_dispatch(items, record=True):
        handle = dispatch(items, record)
        if handle is not None and record:
            seen["overlapped"] += seen["in_flight"] > 0
            seen["in_flight"] += 1
            seen["most"] = max(seen["most"], seen["in_flight"])
        return handle

    def counted_resolve(items, results, event, record=True):
        try:
            resolve(items, results, event, record)
        finally:
            if record:
                seen["in_flight"] -= 1

    engine._dispatch, engine._resolve = counted_dispatch, counted_resolve
    return seen


def _q8_daemon(dev, data: Path, logs: Path) -> None:
    """The daemon with the int8 multimodal as its primary (``--int8
    --calib-images``) and the same checkpoint as its full-fidelity bf16
    ``--shadow``, at ``--pipeline-depth`` 1 and 2, one request a batch
    (``--max-batch 1``: every batch has the same shape at both depths).
    SERVE_THREADS clients send the requests in rounds: each answer equals
    depth 1's for the same request; at depth 2 batches were dispatched
    while the one before was in flight (rounds are sent until one was, at
    most Q8_DAEMON_ROUNDS), at depth 1 none was; and after them
    ``/metrics/prometheus`` counts every request compared by the
    shadow."""
    import base64
    ckpt = logs / "checkpoints_multimodal"
    jpegs = {m: sorted((data / m / "test").rglob("*.jpg"))
             [:Q8_DAEMON_REQUESTS] for m in ("rgb", "thermal")}
    bodies = [json.dumps({m: base64.b64encode(jpegs[m][i].read_bytes())
                          .decode() for m in jpegs}).encode()
              for i in range(min(len(v) for v in jpegs.values()))]
    answers = {}
    for depth in (1, 2):
        t0 = time.perf_counter()
        url, *a = _daemon(dev, ["--checkpoint", str(ckpt), "--int8",
                                "--calib-images", str(data / "rgb" / "train"),
                                "--shadow", str(ckpt),
                                "--pipeline-depth", str(depth)], max_batch=1)
        up = time.perf_counter() - t0
        router = a[1]

        def ask(i):
            code, res = _http(url + "/v1/predict", bodies[i],
                              "application/json")
            res = json.loads(res)
            if code != 200:
                raise AssertionError(f"daemon depth {depth}: {res}")
            return i, (res["prob_ulcer"], res["prediction"])

        try:
            seen = _count_in_flight(router.single)
            _reset_launches()
            got, sent, rounds = {}, 0, 0
            while rounds < (1 if depth == 1 else Q8_DAEMON_ROUNDS):
                with ThreadPoolExecutor(SERVE_THREADS) as ex:
                    for i, ans in ex.map(ask, range(len(bodies))):
                        got.setdefault(i, set()).add(ans)
                sent, rounds = sent + len(bodies), rounds + 1
                if depth == 2 and seen["overlapped"]:
                    break
            answers[depth] = got
            tracker = router.single.shadow
            deadline = time.monotonic() + 60
            while (tracker.stats()["compared"] < sent
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _all_launches().items() if v}
            prom = _http(url + "/metrics/prometheus")[1].decode()
            metrics = json.loads(_http(url + "/metrics")[1])
            health = json.loads(_http(url + "/healthz")[1])
        finally:
            _stop_daemon(*a)
        shadow = metrics["shadow"]
        line = (f'dfu_shadow_compared_total{{model="multimodal",'
                f'shadow="multimodal"}} {sent}')
        log(f"[q8 daemon] multimodal int8 primary + bf16 shadow, "
            f"--pipeline-depth {depth}, --max-batch 1: up in {up:.2f} s; "
            f"{sent} requests from {SERVE_THREADS} threads in {rounds} "
            f"round(s); batches {metrics['batch_size_hist']}, dispatched "
            f"with another in flight {seen['overlapped']} (most in flight "
            f"{seen['most']}); shadow compared {shadow['compared']}, "
            f"agreement {shadow['agreement']}, mean |P_bf16 - P_int8| "
            f"{shadow['mean_abs_prob_delta']}, errors {shadow['errors']}; "
            f"prometheus has '{line}': {line in prom}; healthz shadows "
            f"{health.get('shadows')}; launches {launches}")
        if (line not in prom or shadow["errors"]
                or health.get("shadows") != {"multimodal": "multimodal"}
                or not Q8_DAEMON_KERNELS <= set(launches)):
            raise AssertionError(f"daemon depth {depth}: shadow")
        if (seen["overlapped"] == 0) == (depth == 2) or seen["in_flight"]:
            raise AssertionError(f"daemon depth {depth}: batches in flight "
                                 f"{seen}")
    # one answer for each request, whatever the depth and the round
    same = all(len(answers[2][i] | answers[1][i]) == 1 for i in answers[1])
    log(f"[q8 daemon] every depth-2 answer equals depth 1's for the same "
        f"request: {same}")
    if not same or set(answers[2]) != set(answers[1]):
        raise AssertionError(f"depth 2 {answers[2]} != depth 1 {answers[1]}")


def _qat_requantizes(tag, ckpt: Path, dev) -> None:
    """The QAT run's weights on the card: each ViT encoder dense weight and
    ResNet stage conv of ``last_model.pt``, snapped by ``--qat``'s
    transform, equals the serving quantiser's dequantised weight, and
    quantising the snapped weight again gives the same int8 codes and
    each channel's scale back, or one ulp from it (fl(fl(127·s)/127)
    misses s by one ulp for under 1% of scales)."""
    from dfu_multimodal_tpu_torch.models.resnet_q8 import (
        quantize_conv_weight)
    from dfu_multimodal_tpu_torch.train.qat import fake_quant_trunks

    def quantize(w):
        """(int8 codes, scales, dequantised) in the port's layout."""
        if w.dim() == 2:
            q, s = q8.quantize_weight(w.t())
            return q, s, (q.float() * s).t()
        q, s = quantize_conv_weight(w.permute(2, 3, 1, 0))
        return q, s, (q.float() * s).permute(3, 2, 0, 1)

    state = torch.load(ckpt / "last_model.pt", weights_only=True)
    weights = {k: v.to(dev) for k, v in state["model_state_dict"].items()
               if v.is_floating_point()}
    snapped = fake_quant_trunks(weights)
    changed = [k for k in weights if snapped[k] is not weights[k]]
    kinds, moved, channels = {2: 0, 4: 0}, 0, 0
    for k in changed:
        q1, s1, dq = quantize(weights[k])
        q2, s2, _ = quantize(snapped[k])
        ulp = torch.nextafter(s1, torch.full_like(s1, math.inf)) - s1
        if (not torch.equal(snapped[k], dq) or not torch.equal(q1, q2)
                or bool(((s2 - s1).abs() > ulp).any())):
            raise AssertionError(f"{tag}: {k} does not requantise "
                                 "losslessly")
        kinds[weights[k].dim()] += 1
        moved += int((s2 != s1).sum())
        channels += s1.numel()
    log(f"[{tag}] snapped weights = the serving grid's, requantised to "
        f"the same int8 codes: {kinds[2]} ViT dense weights, {kinds[4]} "
        f"ResNet stage convs; {moved} of {channels} channel scales one ulp "
        f"off")
    if not changed:
        raise AssertionError(f"{tag}: no trunk weight in scope")


def _qat_cli(dev, data: Path, d: Path) -> None:
    """The three reference train CLIs with ``--qat`` for one epoch on phase
    12's tree (their own models and batches, bf16), their launches, then
    the lossless requantisation of their snapped weights."""
    logs = d / "qat_logs"
    for name, (_, batch) in DISK_CLIS.items():
        tag = f"qat {name}"
        jsonl = d / f"qat_{name}.jsonl"
        epochs = _run_cli(tag, name, [
            "--data-dir", str(data), "--checkpoint-root", str(logs),
            "--epochs", "1", "--save-best-after", "1", "--save-last",
            "--log-jsonl", str(jsonl), "--seed", "0", "--qat"], jsonl)
        if epochs != [1]:
            raise AssertionError(f"{tag}: ran epochs {epochs}")
        ckpt = logs / f"checkpoints_{name}"
        meta = json.loads((ckpt / "run_info.json").read_text())
        if not meta["config"].get("qat"):
            raise AssertionError(f"{tag}: run_info has no qat: {meta}")
        _qat_requantizes(tag, ckpt, dev)


def phase_q8_cli(dev, d: Path) -> None:
    """Phase 15's CLIs on phase 12's tree and checkpoints (``d``): predict
    --int8, the daemon with an int8 primary and its bf16 shadow at pipeline
    depths 1 and 2, and the --qat train CLIs."""
    data, logs = d / "data", d / "logs"
    t0 = time.perf_counter()
    _q8_predict_cli(dev, data, logs)
    _q8_daemon(dev, data, logs)
    _qat_cli(dev, data, d)
    log(f"[q8 cli] in {time.perf_counter() - t0:.2f} s (host clock; "
        f"{card()})")


# --------------------------------------------------------------- phase 16

TOME = (4, 128)              # --token-merge 4:128, the JAX CLIs' example
TOME_KEEP_MIN = 99           # the least keep at 224²: r = 98, all of A
TOME_TOKENS = (IMAGE // 16) ** 2 + 1      # 197: keep them all, merge none
TOME_REQUESTS = 9            # served as a batch of 8 and a batch of 1
# block family -> (its attention kernel, its MLP kernel)
TOME_FAMILIES = {"fused": (vb.attn_block, vb.mlp_block),
                 "fused_q8": (q8.attn_block_q8, q8.mlp_block_q8),
                 "fused_q8s": (q8.attn_block_q8s, q8.mlp_block_q8s)}
# the kernels line's rows: each attention kernel with ToMe's key bias
TOME_ROWS = {"attn_block_bias": "fused", "attn_block_q8_bias": "fused_q8",
             "attn_block_q8s_bias": "fused_q8s"}


def _bias_launches() -> dict:
    """The attention kernels' launches that carried ToMe's key bias."""
    return {row: TOME_FAMILIES[fam][0].bias_launches
            for row, fam in TOME_ROWS.items()}


def _log_sizes(gen, b, n) -> torch.Tensor:
    """A proportional-attention bias: log of random token sizes 1..8,
    (B, N) fp32."""
    return torch.randint(1, 9, (b, n), generator=gen,
                         device=gen.device).float().log()


def phase_tome_kernels(dev) -> dict:
    """K1, K7 and K8 with ToMe's key bias against their plain versions at
    the token-merged path's shapes: ViT-B/16 blocks at B = 8 with N = 128
    (``--token-merge 4:128``) and N = 99 (the least keep at 224², a
    partial second key tile), fp32 and bf16, a random log-size bias; in
    bf16 at N = 128 each also beside the same kernel without the bias, in
    turns, and both device times (profiler).  Returns the kernels line's
    rows (bf16, N = 128)."""
    c, heads, b = 768, 12, 8
    inv = torch.tensor([1.0 / a for a in Q8_ACT], device=dev)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (TOME[1], TOME_KEEP_MIN):
            g = torch.Generator(device=dev).manual_seed(5000 + n)
            x, p = _attn_block_args(g, b, n, c, dtype)
            wqkv, sqkv, bqkv = _q8_dense(g, c, 3 * c)
            wproj, sproj, bproj = _q8_dense(g, c, c)
            attn = (*p[:2], wqkv, sqkv, bqkv, wproj, sproj, bproj)
            attn_s = (*p[:2], wqkv, sqkv * Q8_ACT[0], bqkv, wproj,
                      sproj * Q8_ACT[1], bproj, inv)
            kt = (wqkv.t().contiguous(), wproj.t().contiguous())
            bias = _log_sizes(g, b, n)
            kernels = {
                "attn_block_bias": lambda kb: vb.attn_block(
                    x, *p, heads, bias=kb),
                "attn_block_q8_bias": lambda kb: q8.attn_block_q8(
                    x, *attn, heads, kb, kmajor=kt),
                "attn_block_q8s_bias": lambda kb: q8.attn_block_q8s(
                    x, *attn_s, heads, kb, kmajor=kt)}
            plains = {
                "attn_block_bias": lambda: vb.attn_block_ref(
                    x, *p, heads, bias=bias),
                "attn_block_q8_bias": lambda: q8.attn_block_q8_ref(
                    x, *attn, heads, bias),
                "attn_block_q8s_bias": lambda: q8.attn_block_q8s_ref(
                    x, *attn_s, heads, bias)}
            tag = f"{str(dtype).split('.')[1]} B={b} N={n}"
            for name, kernel in kernels.items():
                q8_row = name != "attn_block_bias"
                res = _check_and_time(
                    f"{name} {tag}", lambda: kernel(bias), plains[name],
                    Q8_TOL if q8_row else KERNEL_TOL[dtype],
                    Q8_MEAN_TOL if q8_row else None)
                if dtype != torch.bfloat16 or n != TOME[1]:
                    continue
                ms, unbiased = _turns(lambda: kernel(bias),
                                      lambda: kernel(None))
                dev_ms = _device_ms(lambda: kernel(bias))
                dev_unbiased = _device_ms(lambda: kernel(None))
                res.update(ms=ms, unbiased_ms=unbiased, device_ms=dev_ms,
                           unbiased_device_ms=dev_unbiased)
                log(f"[tome kernel] {name} {tag}: with the bias {ms:.4f} "
                    f"ms, without {unbiased:.4f} ms (turns); device "
                    f"{_ms_or_none(dev_ms)} with, {_ms_or_none(dev_unbiased)}"
                    f" without ({card()})")
                rows[name] = res
            del x, p, attn, attn_s, kt, kernels, plains
            torch.cuda.empty_cache()
    return rows


def _tome_sources(name, dev, seed) -> dict:
    """The full-width ``name`` (seeded, BatchNorm statistics off identity,
    bf16) on each block family: the fused trainer itself, its
    ``quantize_for_serving`` rebuild (``fused_q8``; multimodal's ResNet
    trunk calibrated too) and the calibrated static rebuild
    (``fused_q8s``), each the source a serving process hands
    ``tome_for_serving``."""
    base = _q8_float_trainer(name, dev, seed)
    calib = _q8_images(Q8_CALIB, seed + 1)
    dyn = quantize_for_serving(base, image_size=IMAGE,
                               calib_u8=calib if name == "multimodal"
                               else None)
    normalised = eval_normalize(torch.as_tensor(calib[:CALIB_IMAGES])
                                .to(dev), thermal_modality(), torch.float32)
    static = Trainer(name, base.cfg, base.modalities, device=dev,
                     **{**base.model_kwargs, "block_impl": "fused_q8s"})
    static.module.load_state_dict(quantize_variables(
        base.variables(), calib_batches=[normalised]))
    return {"fused": base, "fused_q8": dyn, "fused_q8s": static}


def _tome_serve_one(tag, t, family, prop, samples) -> dict:
    """``t`` behind the ServingEngine (max_batch 8): TOME_REQUESTS
    requests submitted together, counts set to 0 after the warm-up;
    every probability finite, and a batch's launches: 12 of the family's
    attention and MLP kernels, 8 of the attention ones with the key bias
    when ``prop``, none of another family's.  Returns the launches."""
    attn_k, mlp_k = TOME_FAMILIES[family]
    eng = ServingEngine(t, image_size=IMAGE, max_batch=8, max_wait_ms=50.0)
    with eng:
        _reset_launches()
        got = eng.predict(samples)
        torch.cuda.synchronize()
        stats = eng.stats()
    launches = {k: v for k, v in {**_all_launches(),
                                  **_bias_launches()}.items() if v}
    batches = sum(stats["batch_size_hist"].values())
    want = {attn_k.__name__: DEPTH * batches,
            mlp_k.__name__: DEPTH * batches}
    if prop:
        want[next(r for r, f in TOME_ROWS.items() if f == family)] = \
            (DEPTH - TOME[0]) * batches
    vit_kernels = {f.__name__ for pair in TOME_FAMILIES.values()
                   for f in pair} | set(TOME_ROWS)
    vit_launches = {k: v for k, v in launches.items() if k in vit_kernels}
    probs = np.asarray([p for p, _ in got])
    log(f"[{tag}] {len(samples)} requests in batches "
        f"{stats['batch_size_hist']}, p50 {stats['latency_ms']['p50']:.2f} "
        f"ms; ViT launches {vit_launches}")
    if vit_launches != want or not np.isfinite(probs).all():
        raise AssertionError(f"{tag}: launches {vit_launches}, want {want}")
    return launches


def _tome_fp32_vs_cpu(dev, src, batch) -> None:
    """thermal_only with ``--token-merge 4:128 --tome-prop-attn`` in fp32,
    the card's kernels against the CPU's plain path on the same weights:
    the tokens entering the merge (blocks 0-3 from the same images), then
    the logits, the CPU's blocks 4-11 running from the card's merged
    tokens and sizes.  The merge picks among near-equal similarities, a
    choice two summation orders may tip either way, so the CPU's own merge
    of the card's tokens is compared and recorded, not held."""
    from unittest import mock
    from dfu_multimodal_tpu_torch.models import vit as vit_mod
    from dfu_multimodal_tpu_torch.ops.token_merge import bipartite_merge
    state = {k: v.detach().cpu() for k, v in src.variables().items()}
    pair = []
    for device in (dev, "cpu"):
        tr = _thermal("float32", device)
        tr.module.load_state_dict(state)
        pair.append(tome_for_serving(tr, *TOME, image_size=IMAGE,
                                     prop_attn=True))
    seen = {}

    def record(x, sizes, r):
        seen["card_in"] = x.cpu()
        out = bipartite_merge(x, sizes, r)
        seen["card_out"] = tuple(t.cpu() for t in out)
        seen["cpu_own"] = bipartite_merge(seen["card_in"], sizes.cpu(), r)
        return out

    def replay(x, sizes, r):
        seen["cpu_in"] = x
        return seen["card_out"]

    with mock.patch.object(vit_mod, "bipartite_merge", record):
        logits = _logits(pair[0], batch)
    with mock.patch.object(vit_mod, "bipartite_merge", replay):
        ref = _logits(pair[1], batch)
    scale = 1.0 + float(seen["cpu_in"].abs().max())
    d_in = float((seen["card_in"] - seen["cpu_in"]).abs().max())
    moved = int((seen["cpu_own"][1] != seen["card_out"][1]).sum())
    log(f"[tome] thermal_only 4:128 prop-attn float32: tokens entering the "
        f"merge, card vs CPU max|d| {d_in:.3e} (tol "
        f"{SLICE_TOL['float32']['logits']:g}*(1+max|x|={scale:.3f})); the "
        f"CPU's merge of the card's tokens gives {moved} of "
        f"{seen['cpu_own'][1].numel()} token sizes otherwise (recorded)")
    if d_in > SLICE_TOL["float32"]["logits"] * scale:
        raise AssertionError("tome fp32: tokens entering the merge")
    _compare("[tome] thermal_only 4:128 prop-attn card float32 vs CPU "
             "float32 (blocks 4-11 from the card's merge)", pair[0], ref,
             [batch], SLICE_TOL["float32"])


def _encoder_device_ms(dev) -> None:
    """The bf16 fused ViT-B/16 trunk's device time (profiler) at B = 8
    and 128: without ToMe, with ``--token-merge 4:128``, and with
    proportional attention too."""
    tr = _thermal("bfloat16", dev)
    zoo.init_model(tr.module, torch.Generator(device=dev).manual_seed(95))
    vits = {"no merge": tr.module.vit}
    for label, prop in (("4:128", False), ("4:128 prop-attn", True)):
        vits[label] = tome_for_serving(tr, *TOME, image_size=IMAGE,
                                       prop_attn=prop).module.vit
    for b in (8, 128):
        x = eval_normalize(torch.as_tensor(_q8_images(b, 96 + b)).to(dev),
                           thermal_modality(), torch.bfloat16)
        ms = {}
        with torch.inference_mode():
            for label, vit in vits.items():
                ms[label] = _device_ms(lambda: vit.eval()(x), iters=10)
        log(f"[tome encoder] bf16 ViT-B/16 trunk, B = {b}, device ms "
            f"(profiler): " + ", ".join(f"{k} {_ms_or_none(v)}"
                                        for k, v in ms.items())
            + f" ({card()})")
    del tr, vits
    torch.cuda.empty_cache()


def phase_tome(dev) -> dict:
    """The token-merged serving path at full width: the biased kernels
    against their plain versions (phase_tome_kernels); thermal_only and
    multimodal at 224² on the three block families, each rebuilt by
    ``tome_for_serving(..., 4, 128)`` with and without proportional
    attention behind the ServingEngine (a batch of 8 and one of 1);
    ``keep = 197`` bit-equal to the unmerged model on each family with
    proportional attention (its bias log 1 = 0 goes through the biased
    kernels); thermal_only fused in fp32 on the card against the CPU;
    the encoder's device time with and without the merge.  Returns the
    kernels line's rows, their launches the serving drives'."""
    t0 = time.perf_counter()
    rows = phase_tome_kernels(dev)
    for row in rows:
        rows[row]["launches"] = 0
    for seed, name in enumerate(("thermal_only", "multimodal")):
        sources = _tome_sources(name, dev, 80 + 2 * seed)
        inputs = sources["fused"].spec.inputs
        batch_np = {m: _q8_images(TOME_REQUESTS, 85 + i)
                    for i, m in enumerate(inputs)}
        samples = [{m: batch_np[m][i] for m in inputs}
                   for i in range(TOME_REQUESTS)]
        first8 = {m: v[:8] for m, v in batch_np.items()}
        for family, src in sources.items():
            for prop in (False, True):
                t = tome_for_serving(src, *TOME, image_size=IMAGE,
                                     prop_attn=prop)
                launches = _tome_serve_one(
                    f"tome {name} {family} 4:128"
                    + (" prop-attn" if prop else ""), t, family, prop,
                    samples)
                for row in rows:
                    rows[row]["launches"] += launches.get(row, 0)
                del t
            keep_all = tome_for_serving(src, TOME[0], TOME_TOKENS,
                                        image_size=IMAGE, prop_attn=True)
            same = torch.equal(_logits(keep_all, first8),
                               _logits(src, first8))
            log(f"[tome] {name} {family}: --token-merge {TOME[0]}:"
                f"{TOME_TOKENS} --tome-prop-attn bit-equal to the unmerged "
                f"model {same}")
            if not same:
                raise AssertionError(f"{name} {family}: keep = "
                                     f"{TOME_TOKENS} differs")
            del keep_all
        if name == "thermal_only":
            _tome_fp32_vs_cpu(dev, sources["fused"], first8)
        del sources
        torch.cuda.empty_cache()
    _encoder_device_ms(dev)
    log(f"[tome] in {time.perf_counter() - t0:.2f} s (host clock; "
        f"{card()}); launches of the biased kernels "
        f"{ {r: v['launches'] for r, v in rows.items()} }")
    return rows


def phase_tome_cli(dev, d: Path) -> None:
    """ToMe on phase 12's tree and checkpoints (``d``): the daemon over
    every checkpoint with ``--token-merge 4:128 --tome-prop-attn`` (the
    skip line for rgb_only; a few requests to each model, each answer
    equal to its engine's eval step on the same decoded image; the biased
    K1 launched), then ``predict --token-merge 4:128 --int8`` for
    thermal_only and multimodal (rows equal to
    ``tome_for_serving(quantize_for_serving(...))`` of the same checkpoint
    and calibration images, the biased kernels not launched without
    ``--tome-prop-attn``)."""
    import base64
    import contextlib
    import io
    from dfu_multimodal_tpu_torch.cli import predict
    from dfu_multimodal_tpu_torch.cli.serve import calibration_images
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import decode_all, decode_bytes
    data, logs = d / "data", d / "logs"
    flag = f"{TOME[0]}:{TOME[1]}"
    t0 = time.perf_counter()
    raw = {m: [p.read_bytes()
               for p in sorted((data / m / "test").rglob("*.jpg"))[:2]]
           for m in ("rgb", "thermal")}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        url, *a = _daemon(dev, ["--checkpoint-root", str(logs),
                                "--token-merge", flag,
                                "--tome-prop-attn"])
    log(printed.getvalue().rstrip())
    router = a[1]
    try:
        _reset_launches()
        worst = 0.0
        for k in range(2):
            bodies = {
                "rgb_only": (raw["rgb"][k], "image/jpeg", ("rgb",)),
                "thermal_only": (raw["thermal"][k], "image/jpeg",
                                 ("thermal",)),
                "multimodal": (json.dumps(
                    {m: base64.b64encode(raw[m][k]).decode()
                     for m in ("rgb", "thermal")}).encode(),
                    "application/json", ("rgb", "thermal"))}
            for name, (body, ctype, mods) in bodies.items():
                code, out = _http(f"{url}/v1/predict/{name}", body, ctype)
                res = json.loads(out)
                step = router.engines[name].trainer.eval_step(
                    {m: decode_bytes(raw[m][k], IMAGE)[None] for m in mods})
                dp = abs(res["prob_ulcer"] - float(step["probs"][0]))
                worst = max(worst, dp)
                if code != 200 or dp > SERVE_PROB_TOL:
                    raise AssertionError(f"tome daemon {name}: {code} {res}")
        torch.cuda.synchronize()
        bias = _bias_launches()
        merged = {n: e.trainer.module for n, e in router.engines.items()}
    finally:
        _stop_daemon(*a)
    skip = "checkpoints_rgb_only: --token-merge skipped (rgb_only has no " \
           "ViT trunk)"
    log(f"[tome cli] daemon --token-merge {flag} --tome-prop-attn over "
        f"{sorted(merged)}: 6 requests, max |dP| vs each engine's eval step "
        f"{worst:.2e} (tolerance {SERVE_PROB_TOL}); skip line printed "
        f"{skip in printed.getvalue()}; biased launches {bias}")
    vit = {n: getattr(m, "vit", getattr(m, "thermal_branch", None))
           for n, m in merged.items()}
    if (skip not in printed.getvalue() or bias["attn_block_bias"] == 0
            or vit["rgb_only"] is not None
            or vit["thermal_only"].token_merge != TOME
            or vit["multimodal"].token_merge != TOME):
        raise AssertionError("tome daemon: skip line, merge or launches")

    calib_dir = data / "rgb" / "train"
    for name in ("thermal_only", "multimodal"):
        ckpt = logs / f"checkpoints_{name}"
        mods = ("thermal",) if name == "thermal_only" else ("rgb",
                                                           "thermal")
        argv = ["--checkpoint", str(ckpt), "--images",
                str(data / mods[0] / "test"), "--int8", "--calib-images",
                str(calib_dir), "--token-merge", flag, "--batch-size",
                "8", "--ignore-deployment", "--image-size", str(IMAGE),
                "--device", str(dev)]
        if name == "multimodal":
            argv += ["--thermal-images", str(data / "thermal" / "test")]
        _reset_launches()
        res = predict.main(argv)
        torch.cuda.synchronize()
        launches = {k: v for k, v in {**_all_launches(),
                                      **_bias_launches()}.items() if v}
        tr = Trainer(name, TrainConfig(batch_size=8, eval_batch_size=8),
                     {"rgb": rgb_modality(), "thermal": thermal_modality()},
                     device=dev, image_size=IMAGE)
        tr.restore(ckpt)
        q = tome_for_serving(quantize_for_serving(
            tr, image_size=IMAGE,
            calib_u8=(calibration_images(calib_dir, IMAGE)
                      if name == "multimodal" else None)),
            *TOME, image_size=IMAGE)
        n = len(res)
        arrays = {m: decode_all(list_images(data / m / "test")[:n], IMAGE)
                  for m in mods}
        _, ref = q.run_eval_epoch(ArrayDataset(arrays,
                                               np.zeros(n, np.int32)))
        err = float(np.abs(np.asarray([p for p, _ in res.values()])
                           - ref["y_probs"]).max())
        same = [c for _, c in res.values()] == ref["y_pred"].tolist()
        log(f"[tome cli] predict --int8 --token-merge {flag} {name}: {n} "
            f"rows, max |dp| vs tome_for_serving(quantize_for_serving()) "
            f"{err:.2e}, predictions equal {same}; launches {launches}")
        if (err > 1e-6 or not same or "attn_block_q8" not in launches
                or "attn_block" in launches
                or any(_bias_launches().values())):
            raise AssertionError(f"predict --token-merge --int8 {name}")
        del tr, q
        torch.cuda.empty_cache()
    log(f"[tome cli] in {time.perf_counter() - t0:.2f} s (host clock; "
        f"{card()})")


# --------------------------------------------------------------- phase 17

EXPORT_REQUESTS = 16         # requests each bundle and its checkpoint answer
EXPORT_GROUP = 8             # submitted together: one batch of bucket 8
# the bundles exported from phase 12's checkpoints: tag -> (model, the
# export CLI's flags, buckets, what one batch of bucket 8 launches, the
# dfu:: ops of its programs, the hand-written kernels the profiler must
# see in one replayed step, the |dP| budget against the live engine)
EXPORTS = {
    "bf16": ("multimodal", ["--resnet-block-impl", "fused"], "1,8",
             {"attn_block": 12, "mlp_block": 12, "fused_mlp": 1,
              "bottleneck": 12, "bottleneck_proj": 1},
             {"attn_block", "mlp_block", "fused_mlp", "fused_bottleneck"},
             {"layernorm_kernel", "gemm_kernel", "attention_fwd_mma",
              "fused_mlp_kernel"}, 1e-5),
    "int8": ("multimodal", ["--int8", "--calib-images", "{calib}"], "8",
             {"attn_block_q8": 12, "mlp_block_q8": 12, "fused_mlp": 1,
              "conv_q8": TRUNK_CONVS, "quantize_act_q8": TRUNK_QUANTS},
             {"attn_block_q8", "mlp_block_q8", "fused_mlp", "conv_q8",
              "quantize_act_q8"},
             {"ln_quant_kernel", "quant_rows_kernel", "gemm_kernel",
              "attention_fwd_mma", "im2col_q8_kernel", "fused_mlp_kernel"},
             1e-2),
    "tome": ("thermal_only", ["--token-merge", f"{TOME[0]}:{TOME[1]}",
                              "--tome-prop-attn"], "8",
             {"attn_block": 12, "mlp_block": 12, "attn_block_bias": 8},
             {"attn_block", "mlp_block"},
             {"layernorm_kernel", "gemm_kernel", "attention_fwd_mma"}, 1e-5)}
# the plain versions of the registered ops: none may run on the card
PLAINS = ((vb, "attn_block_ref"), (vb, "mlp_block_ref"),
          (fm, "fused_mlp_ref"), (at, "qkv_attention_ref"),
          (rb, "bottleneck_ref"), (q8, "attn_block_q8_ref"),
          (q8, "mlp_block_q8_ref"), (q8, "attn_block_q8s_ref"),
          (q8, "mlp_block_q8s_ref"), (cq, "conv_q8_ref"),
          (cq, "quantize_act"))


class _PlainCalls:
    """Count the calls of every plain version in ``plains`` (PLAINS by
    default) while active (each op's CPU implementation looks its plain
    version up at call time, so a plain version reached from an op counts
    too)."""

    def __init__(self, plains=PLAINS):
        self.plains = plains

    def __enter__(self):
        self.calls, self._saved = {}, []
        for mod, name in self.plains:
            real = getattr(mod, name)

            def counted(*args, _real=real, _name=name, **kwargs):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*args, **kwargs)

            self._saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def _launches_now() -> dict:
    return {k: v for k, v in {**_all_launches(),
                              **_bias_launches()}.items() if v}


def _program_ops(path: Path) -> dict:
    """The dfu:: ops of an exported program and how many nodes each."""
    ops = {}
    for node in torch.export.load(path).graph.nodes:
        target = str(node.target)
        if target.startswith("dfu."):
            op = target.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def _replayed_kernels(fn) -> dict:
    """The device kernels one call of ``fn`` runs (profiler): each
    kernel's name without its template arguments -> device ms."""
    names = {}
    for name, ms in _device_split(fn, 1).items():
        names[name.split("<")[0]] = names.get(name.split("<")[0], 0.0) + ms
    return names


def _first_answer(make_engine, sample) -> tuple:
    """(seconds from nothing to the first answer, the started engine):
    ``make_engine`` restores or loads and builds the engine, which then
    warms every bucket on its batcher thread and answers ``sample``."""
    t0 = time.perf_counter()
    engine = make_engine().start()
    engine.submit(sample).result(timeout=300)
    return time.perf_counter() - t0, engine


def _answer(engine, samples) -> tuple:
    """Every sample's (P(ulcer), prediction) from ``engine``, EXPORT_GROUP
    at a time (one batch each), and the engine's latency p50."""
    got = []
    for i in range(0, len(samples), EXPORT_GROUP):
        got += engine.predict(samples[i:i + EXPORT_GROUP])
    return got, engine.stats()["latency_ms"]["p50"]


def _export_one(dev, tag, d: Path) -> dict:
    """Phase 17 for one bundle: the export CLI with --verify, then the
    bundle and its checkpoint each behind a ServingEngine (the seconds
    from loading to the first answer beside those from the checkpoint's
    restore), both answering the same EXPORT_REQUESTS; returns the
    bundle's launches."""
    from dfu_multimodal_tpu_torch.cli import export_model
    from dfu_multimodal_tpu_torch.cli.serve import restore_trainer
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import decode_all
    from dfu_multimodal_tpu_torch.serve.export import load_bundle
    import contextlib
    import io
    name, flags, buckets, want, ops, kernels, tol = EXPORTS[tag]
    data, logs, out = d / "data", d / "logs", d / "export" / tag
    flags = [f.format(calib=data / "rgb" / "train") for f in flags]
    argv = ["--checkpoint", str(logs / f"checkpoints_{name}"), "--out",
            str(out), "--image-size", str(IMAGE), "--buckets", buckets,
            "--device", str(dev), "--verify", *flags]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        meta = export_model.main(argv)
    cli_s = time.perf_counter() - t0
    mb = sum(p.stat().st_size for p in out.iterdir()) / 1e6
    verify = [ln for ln in printed.getvalue().splitlines()
              if ln.startswith("verify:")]
    log(f"[export {tag}] export_model {' '.join(flags)} --buckets {buckets}"
        f" --verify: {cli_s:.2f} s of CLI, export s by bucket "
        + ", ".join(f"b{b} {s:.2f}" for b, s in
                    meta["export_seconds"].items())
        + f"; bundle {mb:.1f} MB; {verify[0] if verify else 'no verify'}")

    mods = ("rgb", "thermal") if name == "multimodal" else ("thermal",)
    images = {m: decode_all(list_images(data / m)[:EXPORT_REQUESTS], IMAGE)
              for m in mods}
    n = min(len(v) for v in images.values())
    samples = [{m: images[m][i] for m in mods} for i in range(n)]
    args = export_model.build_parser().parse_args(argv)
    cfg = TrainConfig(batch_size=8, eval_batch_size=8,
                      compute_dtype="bfloat16")
    modalities = {"rgb": rgb_modality(), "thermal": thermal_modality()}
    bucket_list = [int(b) for b in buckets.split(",")]
    ckpt_s, live = _first_answer(lambda: ServingEngine(
        restore_trainer(args.checkpoint, None, args, cfg, modalities,
                        dev)[1], image_size=IMAGE, buckets=bucket_list,
        max_wait_ms=20.0), samples[0])
    load_s, frozen = _first_answer(lambda: ServingEngine(
        load_bundle(out, dev), image_size=IMAGE, buckets=bucket_list,
        max_wait_ms=20.0), samples[0])
    try:
        live_got, live_p50 = _answer(live, samples)
        _reset_launches()
        with _PlainCalls() as plain:
            got, p50 = _answer(frozen, samples)
            torch.cuda.synchronize()
            launches = _launches_now()
            batch = {m: np.stack([s[m] for s in samples[:8]]) for m in mods}
            seen = _replayed_kernels(
                lambda: frozen.trainer.eval_step(batch))
        batches = sum(frozen.stats()["batch_size_hist"].values()) - 1
    finally:
        live.stop()
        frozen.stop()
    dp = max(abs(a[0] - b[0]) for a, b in zip(got, live_got))
    same = [a[1] for a in got] == [b[1] for b in live_got]
    per_batch = {k: v / batches for k, v in launches.items()}
    graph = _program_ops(out / "forward_b8.pt2")
    own = {k: round(v, 4) for k, v in seen.items() if k in kernels}
    log(f"[export {tag}] {name}: {n} requests, bundle vs checkpoint engine "
        f"max |dP| {dp:.2e} (tolerance {tol:g}), predictions equal {same}; "
        f"seconds to the first answer: checkpoint restore {ckpt_s:.2f}, "
        f"bundle load {load_s:.2f}; served p50 live {live_p50:.2f} ms, "
        f"bundle {p50:.2f} ms; bundle launches a batch {per_batch}; "
        f"program ops {graph}; hand-written kernels of one replayed step "
        f"(device ms) {own}; plain versions called {plain.calls} ({card()})")
    if (not verify or dp > tol or not same or per_batch != want
            or set(graph) != ops or set(own) != kernels or plain.calls):
        raise AssertionError(f"export {tag}: rows, launches, program ops, "
                             f"kernels or a plain version")
    return {k: v for k, v in launches.items() if k in want}


def phase_export(dev, d: Path) -> dict:
    """Phase 17 on phase 12's checkpoints (``d``): the EXPORTS bundles.
    Returns their launches by kernel (the kernels line's
    ``export_launches``)."""
    t0 = time.perf_counter()
    launches = {}
    for tag in EXPORTS:
        for k, v in _export_one(dev, tag, d).items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    log(f"[export] in {time.perf_counter() - t0:.2f} s (host clock; "
        f"{card()})")
    return launches


# --------------------------------------------------------------- phase 18

STUDENTS = ("resnet18_rgb", "resnet18_thermal")
STUDENT_PARAMS = 11_177_538
# one int8 student forward: 16 block convs and 3 projections, and the
# input of each of the 3 projection blocks quantised once
STUDENT_CONVS, STUDENT_QUANTS = 19, 3


def resnet18_conv_shapes(image: int = 224) -> list:
    """The distinct convs of the int8 ResNet-18 trunk at ``image``², in
    ``resnet_conv_shapes``' form and roles: a block's conv1 is "conv1"
    (ReLU; an int8 input in a projection block), conv2 "conv3" (the
    shortcut added, then ReLU), the projection "down" (int8 input)."""
    h, cin, seen, out = -(-(-(-image // 2)) // 2), 64, set(), []
    for s, width in enumerate((64, 128, 256, 512), start=1):
        for j in range(2):
            stride = 2 if s > 1 and j == 0 else 1
            ho = -(-h // stride)
            proj = stride != 1 or cin != width
            convs = [("conv1", h, cin, width, 3, stride, "conv1"),
                     ("conv2", ho, width, width, 3, 1, "conv3")]
            if proj:
                convs.append(("proj", h, cin, width, 1, stride, "down"))
            for label, hh, ci, co, k, st, role in convs:
                key = (hh, ci, co, k, st, role, proj and role != "conv3")
                if key not in seen:
                    seen.add(key)
                    out.append((f"stage{s} block{j} {label}", key))
            h, cin = ho, width
    return out


def _student_convs(dev) -> None:
    """``conv_q8`` bit-equal to ``conv_q8_ref`` at every distinct conv of
    the ResNet-18 student, B = 8, fp32 and bf16."""
    cases = resnet18_conv_shapes(IMAGE)
    shapes = {key[:5] for _, key in cases}
    for label, (h, cin, cout, k, stride, role, int8_in) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            case = _q8_conv_case(dev, Q8_CONV_BATCH, h, cin, cout, k,
                                 stride, role, int8_in, dtype,
                                 seed=h + cin + cout + k)
            out, ref = cq.conv_q8(**case), cq.conv_q8_ref(**case)
            if not torch.equal(out, ref):
                raise AssertionError(f"conv_q8 {label} {dtype}: not "
                                     "bit-equal to plain")
    log(f"[students] conv_q8 bit-equal to plain at the ResNet-18 trunk's "
        f"{len(shapes)} distinct conv shapes ({len(cases)} with their "
        f"epilogue and input type), B = {Q8_CONV_BATCH}, fp32 and bf16")


def _student_engine(trainer, samples) -> tuple:
    """``trainer`` behind the ServingEngine at b1 and b8: the b8 drive's
    answers, and by drive its p50 and (launches, batches) counted from a
    reset just before it."""
    lat, drives = {}, {}
    for label, max_batch in (("b1", 1), ("b8", 8)):
        with ServingEngine(trainer, image_size=IMAGE, max_batch=max_batch,
                           max_wait_ms=20.0) as eng:
            _reset_launches()
            if max_batch == 1:
                [eng.submit(s).result(timeout=120) for s in samples]
            else:
                got = eng.predict(samples[:8]) + eng.predict(samples[8:])
            torch.cuda.synchronize()
            launches = _launches_now()
            stats = eng.stats()
        lat[label] = stats["latency_ms"]["p50"]
        drives[label] = (launches, sum(stats["batch_size_hist"].values()))
    return got, lat, drives


def _student_features(tr, images) -> torch.Tensor:
    """The student trunk's pooled fp32 features of ``images`` (N, S, S,
    3) uint8 on the trainer's device, eight images a forward, on the
    CPU."""
    mod, out = tr.spec.inputs[0], []
    tr.module.eval()
    with torch.inference_mode():
        for i in range(0, len(images), 8):
            x = torch.from_numpy(images[i:i + 8]).to(tr.device)
            out.append(tr.module.resnet(
                *tr._preprocess_eval({mod: x})).float().cpu())
    return torch.cat(out)


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


def _with_wrong_scale(tr, images, key) -> torch.Tensor:
    """The known-bad control: ``tr``'s features with the state entry
    ``key`` (one conv's weight or per-channel scale) doubled, the state
    then put back."""
    state = {k: v.clone() for k, v in tr.module.state_dict().items()}
    tr.module.load_state_dict({**state, key: 2 * state[key]})
    try:
        return _student_features(tr, images)
    finally:
        tr.module.load_state_dict(state)


# phase 18's student features on the card (pooled trunk features of the
# Q8_REQUESTS images, max |d| over max |feature|) against the fp32 forward
# on the CPU, and the int8 path against its plain version on the CPU.
# Each limit is about twice the largest sound reading on an H100 (bf16
# 7.3e-3, int8 1.5e-2, int8 vs plain 6.0e-3; both students) and far under
# the known-bad control's (one block conv's weight or scale doubled,
# STUDENT_CONTROL: 0.56-0.58)
STUDENT_FEAT_TOL = {"bf16": 1.5e-2, "int8": 3e-2, "int8_vs_plain": 1.5e-2}
STUDENT_CONTROL = {"bf16": "resnet.layer3.0.conv2.weight",
                   "int8": "resnet.layer3.0.conv2.scale"}


def phase_students(dev, d: Path) -> dict:
    """Phase 18: the ResNet-18 students.  ``conv_q8`` at the trunk's convs;
    both students at full width (seeded weights, BatchNorm statistics off
    identity) served in bf16 and int8 (``quantize_for_serving``,
    calibrated on Q8_CALIB images) at b1 and b8, and their trunk features
    against the fp32 forward on the CPU (STUDENT_FEAT_TOL, beside a
    known-bad control); an int8 student bundle (under ``d``) replayed.
    Returns the launches of the serving drives and the replay."""
    from dfu_multimodal_tpu_torch.serve.export import (export_bundle,
                                                       load_bundle)
    t0 = time.perf_counter()
    _student_convs(dev)
    launches = {}
    for seed, name in enumerate(STUDENTS):
        base = _q8_float_trainer(name, dev, 90 + seed)
        n_params = zoo.param_count(base.module)
        if n_params != STUDENT_PARAMS:
            raise AssertionError(f"{name}: {n_params} params")
        mod = base.spec.inputs[0]
        images = _q8_images(Q8_REQUESTS, 95 + seed)
        batch_np = {mod: images}
        samples = [{mod: images[i]} for i in range(Q8_REQUESTS)]
        cpu = Trainer(name, TrainConfig(compute_dtype="float32"),
                      base.modalities, device="cpu", image_size=IMAGE)
        cpu.module.load_state_dict({k: v.cpu() for k, v in
                                    base.variables().items()})
        ref = cpu.eval_step(batch_np)["probs"].numpy()
        ref_feat = _student_features(cpu, images)
        q = quantize_for_serving(base, image_size=IMAGE,
                                 calib_u8=_q8_images(Q8_CALIB, 97 + seed))
        int8 = {k: v for k, v in (("conv_q8", STUDENT_CONVS),
                                  ("quantize_act_q8", STUDENT_QUANTS)) if v}
        # the int8 student's plain version on the CPU
        qcpu = Trainer(name, TrainConfig(compute_dtype="bfloat16"),
                       base.modalities, device="cpu", image_size=IMAGE,
                       block_impl="int8")
        qcpu.module.load_state_dict({k: v.cpu() for k, v in
                                     q.variables().items()})
        plain_feat = _student_features(qcpu, images)
        errs = {}
        for label, tr, want in (("bf16", base, {}), ("int8", q, int8)):
            got, lat, drives = _student_engine(tr, samples)
            dp = float(np.abs(np.asarray([p for p, _ in got]) - ref).max())
            feat = _student_features(tr, images)
            bad = _with_wrong_scale(tr, images, STUDENT_CONTROL[label])
            errs[label] = (_rel_err(feat, ref_feat),
                           _rel_err(bad, ref_feat))
            if label == "int8":
                errs["int8_vs_plain"] = (_rel_err(feat, plain_feat),
                                         _rel_err(bad, plain_feat))
            per_batch = {k: {op: v / n for op, v in counts.items()}
                         for k, (counts, n) in drives.items()}
            log(f"[students] {name} {label} on the card: p50 b1 "
                f"{lat['b1']:.2f} ms, b8 {lat['b8']:.2f} ms; served max "
                f"|dP| vs the CPU's fp32 forward {dp:.3e}; launches "
                f"{ {k: c for k, (c, _) in drives.items()} } in "
                f"{ {k: n for k, (_, n) in drives.items()} } batches ("
                f"{card()})")
            if (any(pb != want for pb in per_batch.values())
                    or not np.isfinite(dp)):
                raise AssertionError(f"{name} {label}: launches a batch "
                                     f"{per_batch}")
            for counts, _ in drives.values():
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
        for label, (sound, bad) in errs.items():
            tol = STUDENT_FEAT_TOL[label]
            log(f"[students] {name} {label} features: max |d| / max |f| "
                f"{sound:.3e}, known-bad control ({STUDENT_CONTROL[label[:4]]}"
                f" doubled) {bad:.3e}; limit {tol:g}")
            if not sound <= tol < bad:
                raise AssertionError(f"{name} {label} features: {sound} "
                                     f"(control {bad}, limit {tol})")
        if name == "resnet18_rgb":
            out = d / "export" / "student"
            meta = export_bundle(q, out, image_size=IMAGE, buckets=[8])
            frozen = load_bundle(out, dev)
            b8 = {mod: images[:8]}
            _reset_launches()
            with _PlainCalls() as plain:
                res = frozen.eval_step(b8)
                torch.cuda.synchronize()
                replay = _launches_now()
            live = q.eval_step(b8)
            dp = float((res["probs"] - live["probs"]).abs().max())
            same = torch.equal(res["preds"], live["preds"])
            log(f"[students] int8 {name} bundle: exported in "
                f"{meta['export_seconds']['8']:.2f} s; replayed b8 vs the "
                f"live eval step max |dP| {dp:.2e}, predictions equal "
                f"{same}; launches {replay}; plain versions called "
                f"{plain.calls}")
            if dp > 1e-2 or not same or plain.calls or replay != int8:
                raise AssertionError(f"{name} bundle replay")
            for k, v in replay.items():
                launches[k] = launches.get(k, 0) + v
        del base, q, cpu, qcpu
        torch.cuda.empty_cache()
    log(f"[students] in {time.perf_counter() - t0:.2f} s (host clock; "
        f"{card()})")
    return launches


# --------------------------------------------------------------- phase 19

# the feature spaces embed writes for multimodal, and the known-bad
# control: one ResNet conv's and one ViT block's weight doubled at once
# (of eight single weights probed on an H100, the ones each space reads
# most: layer4.0.conv2 0.489 rgb, blocks.5's attention projection 0.173
# thermal; block 5's fc1 read 0.127, block 11's fc2 0.086)
RESEARCH_SPACES = ("feat_rgb", "feat_thermal", "feat_fused")
RESEARCH_CONTROL = ("rgb_branch.layer4.0.conv2.weight",
                    "thermal_branch.blocks.5.attn.proj.weight")
# phase 19's bf16 index features on the card (RESEARCH_ROWS train rows,
# max |d| over max |feature| a space) against the fp32 forward on the
# CPU: about twice the largest sound reading (rgb 6.45e-3, thermal
# 1.37e-2 on an H100); the control must read at least five times the
# limit
RESEARCH_FEAT_TOL = 3e-2
RESEARCH_ROWS = 8
RESEARCH_CORRUPTIONS = ("gaussian_noise", "gaussian_blur", "brightness",
                        "contrast")
# the plain versions of every kernel the phase's drives run (the
# registered ops' and the ViT's backward chain)
RESEARCH_PLAINS = PLAINS + ((vb, "mlp_block_bwd_ref"),
                            (vb, "attn_block_bwd_ref"),
                            (at, "qkv_attention_fwdbwd_ref"))
# the kernels a drive launches: a ViT eval forward, with the fusion head,
# and a thermal_only training run (its validation and test included)
VIT_EVAL = {"attn_block", "mlp_block"}
FUSION_EVAL = VIT_EVAL | {"fused_mlp"}
VIT_TRAIN = set(TRAIN_KERNELS)


def _subset_rows(ds, n: int):
    return ArrayDataset({m: a[:n] for m, a in ds.arrays.items()},
                        ds.labels[:n])


def _research_cpu_features(ckpt: Path, rows) -> dict:
    """The fp32 forward of ``ckpt``'s multimodal model on the CPU: the
    reference of the card's index features."""
    from dfu_multimodal_tpu_torch.eval import embed
    cpu = Trainer("multimodal", TrainConfig(compute_dtype="float32",
                                            eval_batch_size=RESEARCH_ROWS),
                  {"rgb": rgb_modality(), "thermal": thermal_modality()},
                  device="cpu", image_size=IMAGE)
    cpu.restore(ckpt)
    with torch.inference_mode():
        return embed.extract_features(cpu, rows)


class _Drives:
    """Each drive through a CLI's ``main(argv)`` with the launch counts
    set to 0 just before it: its host seconds and launches logged, the
    kernels it launched checked against ``kernels``, its launches
    summed."""

    def __init__(self, gpu: str, phase: str = "research"):
        self.gpu, self.total, self.phase = gpu, {}, phase

    def __call__(self, tag: str, kernels: set, fn, argv):
        _reset_launches()
        t0 = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches_now()
        log(f"[{self.phase}] {tag}: {seconds:.2f} s (host clock; "
            f"{self.gpu}); launches {launches}")
        if set(launches) != kernels:
            raise AssertionError(f"{self.phase} {tag}: launched {launches}, "
                                 f"expected {sorted(kernels)}")
        for k, v in launches.items():
            self.total[k] = self.total.get(k, 0) + v
        return res


def _research_embed(drive, dev, data: Path, logs: Path, d: Path,
                    ref: dict) -> None:
    """embed: a multimodal index over train, the test images retrieved
    against it (5 neighbours) and ranked by uncertainty; the index's
    features against the CPU's fp32 forward beside the known-bad control,
    its probabilities against the card eval step's, a row's self-match."""
    from dfu_multimodal_tpu_torch.cli import embed as embed_cli
    from dfu_multimodal_tpu_torch.data.loader import load_paired
    from dfu_multimodal_tpu_torch.eval import embed
    from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
    ckpt, out = logs / "checkpoints_multimodal", d / "research"
    index = out / "train_index.npz"
    res = drive("embed index", FUSION_EVAL, embed_cli.main, [
        "--checkpoint", str(ckpt), "--data-dir", str(data), "--split",
        "train", "--output", str(index)])
    table = out / "retrieval.csv"
    got = drive("embed retrieval", FUSION_EVAL, embed_cli.main, [
        "--checkpoint", str(ckpt), "--images", str(data / "rgb" / "test"),
        "--thermal-images", str(data / "thermal" / "test"), "--index",
        str(index), "--neighbors", "5", "--rank-uncertainty", "--csv",
        str(table)])
    idx = embed.load_embeddings(index)
    rows = table.read_text().splitlines()
    probs = np.asarray([float(r.split(",")[1]) for r in rows[1:]])
    dep = json.loads((ckpt / "deployment.json").read_text())
    dist = np.abs(probs - dep["threshold"])
    errs = {}
    for space in RESEARCH_SPACES:
        f = torch.from_numpy(idx[space][:RESEARCH_ROWS])
        errs[space] = _rel_err(f, torch.from_numpy(ref[space]))
    # the card's eval step on the index's rows, then the control
    tr = Trainer("multimodal", TrainConfig(batch_size=64,
                                           eval_batch_size=64),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device=dev, image_size=IMAGE)
    tr.restore(ckpt)
    train = load_paired(data, "train", IMAGE, strategy="pseudo", seed=42)
    _, arrays = tr.run_eval_epoch(train)
    eval_probs = apply_temperature(arrays["y_probs"], dep["temperature"])
    state = {k: v.clone() for k, v in tr.module.state_dict().items()}
    tr.module.load_state_dict({**state, **{k: 2 * state[k]
                                           for k in RESEARCH_CONTROL}})
    bad = embed.extract_features(tr, _subset_rows(train, RESEARCH_ROWS))
    control = {s: _rel_err(torch.from_numpy(bad[s]),
                           torch.from_numpy(ref[s])) for s in errs}
    del tr, state
    top, sims = embed.cosine_topk(idx["feat_fused"], idx["feat_fused"], 1)
    self_match = float(np.abs(sims[:, 0] - 1.0).max())
    log(f"[research] embed: index {res}, retrieval {got}; bf16 index "
        f"features vs the CPU's fp32 forward (max |d| / max |f|, "
        f"{RESEARCH_ROWS} rows) {({k: f'{v:.3e}' for k, v in errs.items()})}"
        f", limit {RESEARCH_FEAT_TOL:g}; known-bad control "
        f"({' and '.join(RESEARCH_CONTROL)} doubled) "
        f"{({k: f'{v:.3e}' for k, v in control.items()})}; index probs "
        f"vs the eval step's (temperature {dep['temperature']:.4f}) max "
        f"|d| {float(np.abs(idx['probs'] - eval_probs).max()):.2e}; "
        f"self-match |cos - 1| {self_match:.2e}")
    if (res["n"] != len(train) or res["embedding"] != "fused"
            or res["dims"] != idx["feat_rgb"].shape[1]
            + idx["feat_thermal"].shape[1] or got["n"] != len(probs)
            or len(rows[0].split(",")) != 3 + 3 * 5
            or np.any(np.diff(dist) < -1e-6)):
        raise AssertionError(f"embed: {res}, {got}, {rows[:2]}")
    if (max(errs.values()) > RESEARCH_FEAT_TOL
            or min(control.values()) < 5 * RESEARCH_FEAT_TOL):
        raise AssertionError(f"embed features: {errs}, control {control}")
    if (not np.array_equal(idx["probs"], eval_probs)
            or not np.array_equal(top[:, 0], np.arange(len(top)))
            or self_match > 1e-5):
        raise AssertionError("embed: index probabilities or self-match")


def _research_robustness(drive, dev, data: Path, logs: Path) -> None:
    """robustness: multimodal over RESEARCH_CORRUPTIONS at severities 1 and
    5 (each cell's counts sum to the split, the clean counts the eval
    step's), rgb_only once on the fused trunk (K11)."""
    from dfu_multimodal_tpu_torch.cli import robustness as rob_cli
    from dfu_multimodal_tpu_torch.data.loader import load_paired
    from dfu_multimodal_tpu_torch.eval import metrics as M
    from dfu_multimodal_tpu_torch.eval import robustness as rob
    cells, real = [], rob.corrupted_counts

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        cells.append((args[2], tuple(args[3]), out))
        return out

    ckpt = logs / "checkpoints_multimodal"
    rob.corrupted_counts = recorded
    try:
        drive("robustness multimodal", FUSION_EVAL, rob_cli.main, [
            "--checkpoint", str(ckpt), "--data-dir", str(data),
            "--corruptions", *RESEARCH_CORRUPTIONS, "--severities", "1",
            "5"])
    finally:
        rob.corrupted_counts = real
    report = json.loads((ckpt / "robustness_report.json").read_text())
    test = load_paired(data, "test", IMAGE, strategy="pseudo", seed=42)
    tr = Trainer("multimodal", TrainConfig(batch_size=32,
                                           eval_batch_size=32),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device=dev, image_size=IMAGE)
    tr.restore(ckpt)
    m, arrays = tr.run_eval_epoch(test)
    clean = M.binary_confusion(arrays["y_true"], arrays["y_pred"]).ravel()
    step = rob.make_step(tr, ("rgb", "thermal"))
    zero = sum(step(b, "brightness", 0.0, 0, i).cpu().numpy()
               for i, b in enumerate(_batches(test, 32, dev)))
    del tr
    sums = {c.sum() for _, _, counts in cells for c in counts}
    log(f"[research] robustness multimodal: {len(cells)} corruption x "
        f"subset rows of 2 severities, counts summing to {sorted(sums)} "
        f"(split {len(test)}); clean F1 {report['clean_f1']:.4f}; worst "
        + ", ".join(f"{r['corruption']}/{'+'.join(r['modalities'])} "
                    f"{r['worst_f1']:.3f} {r['verdict']}"
                    for r in report["results"])
        + f"; clean counts {clean.tolist()}, the corruption step at "
        f"brightness 0 {zero.tolist()}")
    if (len(cells) != 2 * len(RESEARCH_CORRUPTIONS) or sums != {len(test)}
            or len(report["results"]) != len(cells)
            or report["clean_f1"] != m.f1
            or not np.array_equal(zero, clean)):
        raise AssertionError(f"robustness multimodal: {report}")
    drive("robustness rgb_only fused", {"bottleneck", "bottleneck_proj"},
          rob_cli.main, [
        "--checkpoint", str(logs / "checkpoints_rgb_only"), "--data-dir",
        str(data), "--corruptions", "contrast", "--severities", "3",
        "--resnet-block-impl", "fused"])


def _batches(ds, bs: int, dev):
    from dfu_multimodal_tpu_torch.data import loader
    return loader.device_prefetch(loader.batch_slices(
        ds, np.arange(len(ds)), bs), dev)


def _research_compare(drive, dev, data: Path, logs: Path) -> None:
    """compare rgb_only (A) against multimodal (B) on test: the flip table
    sums to the rows; each side's decisions are its checkpoint's eval
    step on the card under its deployment.json."""
    from dfu_multimodal_tpu_torch.cli import compare as compare_cli
    from dfu_multimodal_tpu_torch.data.loader import load_paired
    from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
    from dfu_multimodal_tpu_torch.eval.compare import flip_table
    from dfu_multimodal_tpu_torch.eval.threshold import apply_threshold
    a, b = logs / "checkpoints_rgb_only", logs / "checkpoints_multimodal"
    drive("compare", FUSION_EVAL, compare_cli.main, [
        "--checkpoint-a", str(a), "--checkpoint-b", str(b), "--data-dir",
        str(data)])
    report = json.loads((b / "compare_report.json").read_text())
    test = load_paired(data, "test", IMAGE, strategy="pseudo", seed=42)
    preds = {}
    for side, ckpt in (("a", a), ("b", b)):
        name = ckpt.name.replace("checkpoints_", "")
        tr = Trainer(name, TrainConfig(batch_size=32, eval_batch_size=32),
                     {"rgb": rgb_modality(), "thermal": thermal_modality()},
                     device=dev, image_size=IMAGE)
        tr.restore(ckpt)
        _, arrays = tr.run_eval_epoch(test)
        dep = json.loads((ckpt / "deployment.json").read_text())
        probs = apply_temperature(arrays["y_probs"], dep["temperature"])
        preds[side] = apply_threshold(probs, dep["threshold"])
        del tr
    flips = report["flip_table"]
    ours = flip_table(test.labels, preds["a"], preds["b"])
    log(f"[research] compare rgb_only vs multimodal on {report['n']} rows: "
        f"flips {flips}, McNemar p {report['mcnemar']['p_value']:.4f}, "
        f"Δaccuracy {report['deltas']['accuracy']['delta']:+.4f}; the "
        f"eval steps' flip table {ours}")
    if (report["n"] != len(test) or flips != ours
            or sum(flips[k] for k in ("both_correct", "only_a", "only_b",
                                      "both_wrong")) != len(test)):
        raise AssertionError(f"compare: {report}")


def _research_cards(drive, dev, logs: Path) -> None:
    """model_card for the three checkpoints: parameter counts equal the
    restored models', the SHA-256 hashlib's, the metric lines phase 13's
    results.pt."""
    import hashlib
    from dfu_multimodal_tpu_torch.cli import model_card
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    for name in DISK_CLIS:
        ckpt = logs / f"checkpoints_{name}"
        drive(f"model_card {name}", set(), model_card.main,
              ["--checkpoint", str(ckpt)])
        card_md = (ckpt / "MODEL_CARD.md").read_text()
        with torch.device("meta"):
            module, _ = zoo.build(name, image_size=IMAGE)
        n_params = sum(p.numel() for p in module.parameters())
        sha = hashlib.sha256((ckpt / "best_model.pt").read_bytes())
        metrics = load_pt(logs / "extended_metrics" / name
                          / "results.pt")["metrics"]
        lines = [f"| {label} | {float(metrics[k]):.4f} |"
                 for k, label in model_card.METRIC_ROWS
                 if metrics.get(k) is not None]
        missing = [x for x in lines if x not in card_md]
        log(f"[research] model_card {name}: {n_params:,} parameters, "
            f"SHA-256 {sha.hexdigest()[:16]}…, {len(lines)} metric lines "
            f"of results.pt, missing {missing}")
        if (f"| Parameters | {n_params:,} |" not in card_md
                or f"`{sha.hexdigest()[:16]}…`" not in card_md or missing
                or not lines):
            raise AssertionError(f"model_card {name}:\n{card_md}")


def _research_harness(drive, data: Path, logs: Path) -> None:
    """cross_validate (2 folds, 1 epoch) and sweep (two learning rates,
    then --resume, which trains nothing) on thermal_only."""
    from dfu_multimodal_tpu_torch.cli import cross_validate, sweep
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    summary = drive("cross_validate", VIT_TRAIN, cross_validate.main, [
        "--data-dir", str(data), "--checkpoint-root", str(logs),
        "--modality", "thermal", "--folds", "2", "--epochs", "1"])
    cv = load_pt(logs / "cross_validation_thermal" / "cv_results.pt")
    log(f"[research] cross_validate: folds of "
        f"{[len(f) for f in cv['folds']['thermal']]} rows, F1 by fold "
        f"{[round(m['f1'], 4) for m in cv['fold_metrics']]}")
    if len(cv["fold_metrics"]) != 2 or summary != cv["summary"]:
        raise AssertionError(f"cross_validate: {cv}")
    argv = ["--data-dir", str(data), "--checkpoint-root", str(logs),
            "--modality", "thermal", "--param", "lr=1e-4,3e-4", "--epochs",
            "1"]
    jsonl = logs / "sweep_thermal" / "trials.jsonl"
    first = drive("sweep", VIT_TRAIN, sweep.main, argv)
    before = jsonl.read_text()
    again = drive("sweep --resume", set(), sweep.main, argv + ["--resume"])
    log(f"[research] sweep: {first['n_trials']} trials, best "
        f"{first['best']['params']} val F1 "
        f"{first['best']['best_val_f1_mean']:.4f}; --resume ranked "
        f"{again['n_trials']} and trained none")
    if (first["n_trials"] != 2 or again["n_trials"] != 2
            or jsonl.read_text() != before
            or len(before.splitlines()) != 2):
        raise AssertionError(f"sweep: {first}, {again}")


def _research_soup(drive, data: Path, logs: Path, d: Path) -> None:
    """A second thermal_only checkpoint (the train CLI, --seed 1, one
    epoch from phase 12's weights) souped with phase 12's, uniform and
    --greedy; phase 12's souped with itself is bit-equal to it; the
    uniform soup's directory answers predict."""
    from dfu_multimodal_tpu_torch.cli import predict, soup
    from dfu_multimodal_tpu_torch.cli import train_thermal_only
    from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
    a = logs / "checkpoints_thermal_only"
    seed1 = d / "logs_seed1"
    drive("train thermal_only --seed 1", VIT_TRAIN, train_thermal_only.main, [
        "--data-dir", str(data), "--checkpoint-root", str(seed1),
        "--epochs", "1", "--seed", "1", "--save-best-after", "1",
        "--init-from", str(a)])
    b = seed1 / "checkpoints_thermal_only"
    out = d / "research"
    for tag, extra in (("uniform", []), ("greedy", ["--greedy"])):
        drive(f"soup {tag}", VIT_EVAL, soup.main, [
            "--checkpoints", str(a), str(b), "--data-dir", str(data),
            "--out", str(out / f"soup_{tag}"), *extra])
    drive("soup self", VIT_EVAL, soup.main, [
        "--checkpoints", str(a), str(a), "--data-dir", str(data), "--out",
        str(out / "soup_self"), "--skip-test-eval"])
    own = ckpt_mod.load_checkpoint(a)[0]["model_state_dict"]
    souped = ckpt_mod.load_checkpoint(out / "soup_self")[0][
        "model_state_dict"]
    unequal = [k for k, v in own.items() if not torch.equal(v, souped[k])]
    metas = {t: ckpt_mod.load_meta(out / f"soup_{t}")
             for t in ("uniform", "greedy")}
    rows = drive("predict soup", VIT_EVAL, predict.main, [
        "--checkpoint", str(out / "soup_uniform"), "--images",
        str(data / "thermal" / "test")])
    log(f"[research] soup: uniform val F1 {metas['uniform']['val_f1']:.4f}, "
        f"greedy {metas['greedy']['val_f1']:.4f} with "
        f"{len(metas['greedy']['soup']['ingredients'])} ingredient(s); "
        f"self-soup entries unequal to the checkpoint {unequal}; predict "
        f"on the soup answered {len(rows)} images")
    if (unequal or set(souped) != set(own) or len(rows) != len(
            list((data / "thermal" / "test").rglob("*.jpg")))
            or metas["uniform"]["soup"]["recipe"] != "uniform"):
        raise AssertionError(f"soup: {metas}, {unequal}")


def phase_research(dev, d: Path) -> dict:
    """Phase 19 on phase 12's tree and checkpoints and phase 13's
    extended_metrics (``d``): embed, robustness, compare, model_card,
    cross_validate, sweep and soup through their ``main(argv)`` at full
    width, 224², with no plain version called on the card.  Returns the
    drives' launches by kernel (the kernels line's
    ``research_launches``)."""
    from dfu_multimodal_tpu_torch.data.loader import load_paired
    t0 = time.perf_counter()
    data, logs = d / "data", d / "logs"
    (d / "research").mkdir()
    gpu = card()
    train = load_paired(data, "train", IMAGE, strategy="pseudo", seed=42)
    ref = _research_cpu_features(logs / "checkpoints_multimodal",
                                 _subset_rows(train, RESEARCH_ROWS))
    log(f"[research] the CPU's fp32 features of {RESEARCH_ROWS} train rows "
        f"in {time.perf_counter() - t0:.2f} s (host clock)")
    drive = _Drives(gpu)
    with _PlainCalls(RESEARCH_PLAINS) as plain:
        _research_embed(drive, dev, data, logs, d, ref)
        _research_robustness(drive, dev, data, logs)
        _research_compare(drive, dev, data, logs)
        _research_cards(drive, dev, logs)
        _research_harness(drive, data, logs)
        _research_soup(drive, data, logs, d)
        torch.cuda.synchronize()
    log(f"[research] launches over the phase's drives {drive.total}; "
        f"plain versions called {plain.calls}")
    if plain.calls:
        raise AssertionError(f"research: plain versions ran {plain.calls}")
    torch.cuda.empty_cache()
    log(f"[research] phase 19 in {time.perf_counter() - t0:.2f} s (host "
        f"clock; {gpu})")
    return drive.total


# --------------------------------------------------------------- phase 20

# phase 20's first outputs on the card in bf16 (SimCLR's projections,
# MAE's patch predictions, the distilled students' train-mode logits, the
# self-trained model's pool logits, the legacy model's two trunks'
# features: max |d| over max |ref|) and their losses (|d| over |ref|)
# against the fp32 forward on the CPU on the same weights and injected
# views: (outputs limit, loss limit), each sized from an H100's reading
# (deterministic over four calls; NVIDIA H100 80GB HBM3, 700 W), outputs
# then loss: SimCLR ViT 1.24e-2, 2.2e-4; SimCLR ResNet-50 5.88e-2, 1.38e-3
# (50 train-mode BatchNorms in bf16); MAE 1.21e-2, 1.1e-4; the
# distillations 1.32e-2 / 2.53e-2, 2.4e-4 / 2.8e-4; the pool 1.6e-3,
# 5.7e-4; the legacy model 4.64e-3, 1.35e-3.  Each limit is about twice
# its reading or more but the ResNet-50's outputs', which its controls
# leave no more room for
TRAINER_TOL = {"simclr vit": (3e-2, 1e-3), "simclr resnet": (7e-2, 3e-3),
               "mae": (3e-2, 1e-3), "distill": (5e-2, 1e-3),
               "self_train": (5e-3, 2e-3), "legacy": (1.5e-2, 3e-3)}
TRAINER_ROWS = 8
# the known-bad controls: internal weights of each checked model, each
# doubled on the card in turn until one moves the outputs five times
# their limit (the readings of those tried are logged): a BatchNorm
# scale in a train-mode ResNet, whose conv weights the batch statistics
# undo; an attention projection or the patch embedding of a ViT; the
# last MBConv's project conv.  No last layer, which would double the
# outputs outright whatever the limit.  An H100 read 0.343 for SimCLR's
# block 5 projection, 0.451 for the ResNet-50's layer4.2.bn3 (0.374 for
# its layer4.1.bn3), 0.19 for
# MAE's block 5, 0.51 / 0.48 for the students' layer4.1.bn2, 0.045 /
# 0.105 for the pool model's block 5 and patch embedding, 0.315 for the
# EfficientNet's last project conv
TRAINER_CONTROL = {
    "simclr vit": ("vit.blocks.5.attn.proj.weight",),
    "simclr resnet": ("resnet.layer4.2.bn3.weight",
                      "resnet.layer4.1.bn3.weight"),
    "mae": ("vit.blocks.5.attn.proj.weight",),
    "distill": ("resnet.layer4.1.bn2.weight",),
    "self_train": ("vit.blocks.5.attn.proj.weight",
                   "vit.patch_embed.proj.weight"),
    "legacy": ("thermal_encoder.features.7.0.block.3.0.weight",)}


def _ssl_pair(dev, method: str, trunk: str):
    """(card bf16, CPU fp32) SSLTrainers of one pretraining run's model
    with the same seeded weights."""
    from dfu_multimodal_tpu_torch.config import rgb_modality as rgb
    from dfu_multimodal_tpu_torch.config import thermal_modality as thermal
    from dfu_multimodal_tpu_torch.train import ssl
    cfg = ssl.PretrainConfig(method=method)
    mod = rgb() if trunk == "resnet" else thermal()
    cpu = ssl.SSLTrainer(trunk, dataclasses.replace(
        cfg, compute_dtype="float32"), mod, IMAGE, device="cpu")
    ssl.init_ssl_model(cpu.module, torch.Generator().manual_seed(20))
    card = ssl.SSLTrainer(trunk, cfg, mod, IMAGE, device=dev)
    card.module.load_state_dict(cpu.module.state_dict())
    return card, cpu


def _ssl_outputs(tr, views, valid, keep_ids):
    """(loss, outputs) of one train-mode forward on injected views:
    SimCLR's 2B projections, MAE's patch predictions."""
    from dfu_multimodal_tpu_torch.train import ssl
    dev = tr.device
    views = tuple(v.to(dev) for v in views)
    valid = valid.to(dev)
    if tr.cfg.method == "simclr":
        z1, z2 = tr.project_views(*views)
        return (ssl.nt_xent_loss(z1, z2, valid, tr.cfg.temperature),
                torch.cat([z1, z2]))
    keep_ids = keep_ids.to(dev)
    tr.module.train()
    pred = tr.module(views[0], keep_ids)
    target = ssl.patchify(views[0].float(), tr.cfg.vit_patch)
    return (ssl.masked_pixel_loss(pred, target, keep_ids, valid,
                                  tr.cfg.norm_pix), pred)


class _FirstStep:
    """A card-vs-CPU check of one new step: the CPU's fp32 reference made
    first (outside the plain-call guard), the card's bf16 reading and the
    known-bad control's inside it."""

    def __init__(self, tag, card, cpu_fn, card_fn, kind):
        self.tag, self.card, self.card_fn = tag, card, card_fn
        self.control = TRAINER_CONTROL[kind]
        self.tol, self.loss_tol = TRAINER_TOL[kind]
        with torch.no_grad():
            self.ref_loss, self.ref = self._host(cpu_fn())

    @staticmethod
    def _host(res):
        """(loss, outputs) as fp32 CPU tensors; the outputs one tensor or
        a tuple of parts, each held against its own largest entry."""
        loss, out = res
        parts = out if isinstance(out, tuple) else (out,)
        return loss.float().cpu(), tuple(t.float().cpu() for t in parts)

    def _err(self, out) -> float:
        return max(_rel_err(o, r) for o, r in zip(out, self.ref))

    def check(self) -> dict:
        module = self.card.module
        with torch.no_grad():
            loss, out = self._host(self.card_fn())
            state = {k: v.clone() for k, v in module.state_dict().items()}
            controls = {}
            for key in self.control:
                module.load_state_dict({**state, key: 2 * state[key]})
                try:
                    controls[key] = self._err(self._host(self.card_fn())[1])
                finally:
                    module.load_state_dict(state)
                if controls[key] >= 5 * self.tol:
                    break
        err, bad_err = self._err(out), max(controls.values())
        loss_err = float((loss - self.ref_loss).abs()
                         / self.ref_loss.abs().clamp_min(1e-12))
        log(f"[trainers] {self.tag} first step, bf16 card vs fp32 CPU: "
            f"outputs {err:.3e}, loss {loss_err:.3e} "
            f"({float(loss):.5f} vs {float(self.ref_loss):.5f}; limits "
            f"{self.tol:g}, {self.loss_tol:g}); controls (one weight "
            f"doubled) " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in controls.items()))
        if (not math.isfinite(float(loss)) or err > self.tol
                or loss_err > self.loss_tol or bad_err < 5 * self.tol):
            raise AssertionError(f"{self.tag}: first step outputs {err}, "
                                 f"loss {loss_err}, controls {controls}")
        return {"outputs": err, "loss": loss_err, "control": bad_err}


def _ssl_first_step(dev, tag, method, trunk, images) -> _FirstStep:
    card, cpu = _ssl_pair(dev, method, trunk)
    views, keep_ids = cpu.draw_views(torch.from_numpy(images),
                                     torch.Generator().manual_seed(21))
    valid = torch.ones(len(images))
    return _FirstStep(
        tag, card, lambda: _ssl_outputs(cpu, views, valid, keep_ids),
        lambda: _ssl_outputs(card, views, valid, keep_ids), tag)


def _kd_outputs(tr, batch, views):
    """(KD loss, student logits) of one train-mode forward (dropout off)
    on injected views, the teacher's logits of the same step."""
    from dfu_multimodal_tpu_torch.train.distill import kd_loss
    dev = tr.device
    batch = {k: v.to(dev) for k, v in batch.items()}
    views = {m: v.to(dev) for m, v in views.items()}
    t_logits = tr.teacher_logits(batch, views)
    tr.module.train()
    logits = tr.module(*(views[m] for m in tr.spec.inputs)).float()
    valid = batch["valid"].float()
    return kd_loss(logits, t_logits, batch["label"].long(), valid, valid,
                   tr.dcfg.alpha, tr.dcfg.temperature), logits


def _kd_first_step(dev, logs: Path, teacher_name: str, student: str,
                   ds) -> _FirstStep:
    """The distill step of ``student`` under phase 12's ``teacher_name``
    checkpoint: the card's bf16 trainer and the CPU's fp32 one with the
    same seeded student (dropout off), views drawn on the CPU."""
    from dfu_multimodal_tpu_torch.config import rgb_modality, thermal_modality
    from dfu_multimodal_tpu_torch.train.distill import (DistillConfig,
                                                        DistillTrainer)
    mods = {"rgb": rgb_modality(),
            "thermal": thermal_modality(blur=teacher_name != "multimodal")}
    pair = []
    for dtype, device in (("float32", "cpu"), ("bfloat16", dev)):
        cfg = TrainConfig(compute_dtype=dtype, drop_rate=0.0)
        teacher = Trainer(teacher_name, cfg, mods, device=device,
                          image_size=IMAGE)
        teacher.load_weights(logs / f"checkpoints_{teacher_name}")
        pair.append(DistillTrainer(student, teacher_name, teacher.module,
                                   DistillConfig(), cfg, mods,
                                   device=device, image_size=IMAGE))
    cpu, card = pair
    zoo.init_model(cpu.module, torch.Generator().manual_seed(22))
    card.module.load_state_dict(cpu.module.state_dict())
    batch = {k: torch.from_numpy(v[:TRAINER_ROWS])
             for k, v in ds.arrays.items()}
    batch["label"] = torch.from_numpy(ds.labels[:TRAINER_ROWS])
    batch["valid"] = torch.ones(TRAINER_ROWS)
    views = dict(zip(cpu.spec.inputs, cpu._preprocess_train(
        batch, torch.Generator().manual_seed(23))))
    return _FirstStep(f"distill {teacher_name} -> {student}", card,
                      lambda: _kd_outputs(cpu, batch, views),
                      lambda: _kd_outputs(card, batch, views), "distill")


def _logits_outputs(tr, inputs, labels):
    """(CE, logits) of a forward in the trainer's current mode."""
    dev = tr.device
    logits = tr.module(*(x.to(dev) for x in inputs)).float()
    return F.cross_entropy(logits, labels.to(dev).long()), logits


def _pool_first_step(dev, logs: Path, pool: np.ndarray) -> _FirstStep:
    """The self-training pool's logits (thermal_only, phase 12's weights,
    eval mode, the pool's first rows)."""
    from dfu_multimodal_tpu_torch.config import thermal_modality
    mod = {"thermal": thermal_modality()}
    pair = []
    for dtype, device in (("float32", "cpu"), ("bfloat16", dev)):
        tr = Trainer("thermal_only", TrainConfig(compute_dtype=dtype), mod,
                     device=device, image_size=IMAGE)
        tr.load_weights(logs / "checkpoints_thermal_only")
        tr.module.eval()
        pair.append(tr)
    cpu, card = pair
    x = torch.from_numpy(pool[:TRAINER_ROWS])
    labels = torch.zeros(TRAINER_ROWS)

    def outputs(tr):
        return _logits_outputs(tr, (eval_normalize(
            x.to(tr.device), mod["thermal"], tr.compute_dtype),), labels)

    return _FirstStep("self_train pool", card, lambda: outputs(cpu),
                      lambda: outputs(card), "self_train")


def _legacy_first_step(dev, ds) -> _FirstStep:
    """legacy_rgb_resnet_fusion (ResNet-50 and EfficientNet-B0) on the
    phase's images in eval mode, its BatchNorm statistics off identity:
    its two trunks' features (the model's ``features`` record) and the CE
    of its logits.  Eval mode, because at a
    seeded init train-mode BatchNorm amplifies bf16 rounding in its
    near-constant channels by up to 1/sqrt(eps) (a CPU rehearsal read
    0.32 / 0.29 on the two trunks' train-mode features in bf16 against
    fp32, 1.6e-2 / 2.4e-2 in eval mode); the train path itself runs in
    the legacy drives."""
    from dfu_multimodal_tpu_torch import config as cfg_mod
    mods = {"rgb": cfg_mod.legacy_rgb_modality(),
            "thermal": cfg_mod.legacy_thermal_modality()}
    pair = []
    for dtype, device in (("float32", "cpu"), ("bfloat16", dev)):
        pair.append(Trainer("legacy_rgb_resnet_fusion", TrainConfig(
            compute_dtype=dtype, drop_rate=0.0), mods, device=device,
            image_size=IMAGE))
    cpu, card = pair
    zoo.init_model(cpu.module, torch.Generator().manual_seed(24))
    with torch.no_grad():
        _perturb_batchnorm(cpu.module, torch.Generator().manual_seed(25))
    card.module.load_state_dict(cpu.module.state_dict())
    batch = {m: torch.from_numpy(ds.arrays[m][:TRAINER_ROWS])
             for m in ("rgb", "thermal")}
    labels = torch.from_numpy(ds.labels[:TRAINER_ROWS])

    def outputs(tr):
        m, dev = tr.module, tr.device
        m.eval()
        rgb, thermal = (eval_normalize(batch[k].to(dev), mods[k],
                                       tr.compute_dtype)
                        for k in ("rgb", "thermal"))
        record = {}
        logits = m(rgb, thermal, features=record).float()
        return (F.cross_entropy(logits, labels.to(dev).long()),
                (record["rgb_encoder"], record["thermal_encoder"]))

    return _FirstStep("legacy_rgb_resnet_fusion", card,
                      lambda: outputs(cpu), lambda: outputs(card),
                      "legacy")


class _CaptureRestore:
    """Records the module state of every ``Trainer.restore`` of
    ``directory`` (a train CLI's ``--init-from``) right after it loads."""

    def __init__(self, directory: Path):
        self.directory, self.states = Path(directory), []

    def __enter__(self):
        self._real = real = Trainer.restore
        capture = self

        def restore(tr, checkpoint_dir, *args, **kwargs):
            real(tr, checkpoint_dir, *args, **kwargs)
            if Path(checkpoint_dir) == capture.directory:
                capture.states.append({k: v.detach().cpu().clone() for k, v
                                       in tr.module.state_dict().items()})

        Trainer.restore = restore
        return self

    def __exit__(self, *exc):
        Trainer.restore = self._real


def _trainers_pretrain(drive, data: Path, d: Path, checks: dict) -> None:
    """pretrain SimCLR (ViT-B/16 fused, ResNet-50) and MAE; their first
    steps; the ViT checkpoint warm-starting thermal_only and multimodal
    with the trunk bit-equal under both names; every checkpoint's trunk
    equal under both names."""
    from dfu_multimodal_tpu_torch.cli import (pretrain, train_multimodal_fusion,
                                              train_thermal_only)
    common = ["--data-dir", str(data), "--epochs", "2", "--warmup-epochs",
              "1"]
    runs = (("simclr vit", VIT_TRAIN, ["--modality", "thermal"]),
            ("simclr resnet", set(), ["--modality", "rgb"]),
            ("mae", set(), ["--modality", "thermal", "--method", "mae"]))
    for tag, kernels, extra in runs:
        out = d / "pretrain" / tag.replace(" ", "_")
        checks[tag].check()
        drive(f"pretrain {tag}", kernels, pretrain.main,
              common + ["--out", str(out)] + extra)
        state = torch.load(out / "best_model.pt", map_location="cpu",
                           weights_only=True)["model_state_dict"]
        meta = json.loads((out / "best_model.meta.json").read_text())
        canon, alias = (("resnet.", "rgb_branch.") if "resnet" in tag
                        else ("vit.", "thermal_branch."))
        trunk = {k: v for k, v in state.items() if k.startswith(canon)}
        unequal = [k for k, v in trunk.items()
                   if not torch.equal(v, state[alias + k[len(canon):]])]
        log(f"[trainers] pretrain {tag}: losses {meta['history']['loss']}, "
            f"{len(trunk)} trunk arrays under {canon} and {alias}")
        if (unequal or not trunk or len(meta["history"]["loss"]) != 2
                or not all(map(math.isfinite, meta["history"]["loss"]))):
            raise AssertionError(f"pretrain {tag}: {meta}, {unequal}")
    vit = d / "pretrain" / "simclr_vit"
    state = torch.load(vit / "best_model.pt", map_location="cpu",
                       weights_only=True)["model_state_dict"]
    for tag, cli, kernels, prefix in (
            ("thermal_only", train_thermal_only, VIT_TRAIN, "vit."),
            ("multimodal", train_multimodal_fusion,
             VIT_TRAIN | {"fused_mlp"}, "thermal_branch.")):
        with _CaptureRestore(vit) as cap:
            drive(f"train {tag} --init-from", kernels, cli.main, [
                "--data-dir", str(data), "--checkpoint-root",
                str(d / "warm"), "--epochs", "1", "--init-from", str(vit),
                "--skip-test-eval"])
        keys = [k for k in state if k.startswith(prefix)]
        unequal = [k for k in keys
                   if not torch.equal(cap.states[0][k], state[k])]
        log(f"[trainers] {tag} --init-from: {len(keys)} {prefix} arrays "
            f"loaded, unequal to the checkpoint {unequal}")
        if len(cap.states) != 1 or unequal or not keys:
            raise AssertionError(f"{tag} --init-from: {unequal}")


def _trainers_distill(drive, data: Path, logs: Path, d: Path,
                      checks: dict) -> None:
    from dfu_multimodal_tpu_torch.cli import distill
    from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
    for teacher, student, kernels in (
            ("multimodal", "resnet18_rgb", FUSION_EVAL),
            ("thermal_only", "resnet18_thermal", VIT_EVAL)):
        checks[f"distill {teacher}"].check()
        drive(f"distill {teacher} -> {student}", kernels, distill.main, [
            "--teacher-checkpoint", str(logs / f"checkpoints_{teacher}"),
            "--student", student, "--data-dir", str(data),
            "--checkpoint-root", str(d / "distill"), "--epochs", "1"])
        saved = load_pt(d / "distill" / f"checkpoints_{student}_distilled"
                        / "test_results.pt")
        log(f"[trainers] distill {teacher} -> {student}: student test F1 "
            f"{saved['test_f1']:.4f}, teacher {saved['teacher_test_f1']:.4f}")
        if (saved["teacher_model"] != teacher
                or not np.isfinite(saved["test_loss"])):
            raise AssertionError(f"distill {teacher}: {sorted(saved)}")


def _trainers_self_train(drive, data: Path, d: Path, checks: dict) -> None:
    from dfu_multimodal_tpu_torch.cli import self_train
    checks["self_train"].check()
    out = d / "self_train" / "checkpoints_thermal_only_selftrain"
    report = drive("self_train thermal_only", VIT_TRAIN, self_train.main, [
        "--data-dir", str(data), "--unlabeled-dir",
        str(data / "thermal" / "test"), "--modality", "thermal",
        "--checkpoint-root", str(d / "self_train"), "--rounds", "2",
        "--epochs", "1", "--threshold", "0.5", "--no-balance"])
    rounds = report["rounds"]
    best = max(rounds, key=lambda r: r["val_f1"])
    promoted = ((out / "best_model.pt").exists()
                and (out / "best_model.meta.json").exists())
    src = out / f"round_{best['round']}" / "best_model.pt"
    same = src.exists() and src.read_bytes() == (
        out / "best_model.pt").read_bytes()
    log(f"[trainers] self_train: rounds {rounds}; best round "
        f"{best['round']}; best_model promoted {promoted} (the round's own "
        f"file: {same}); test {report.get('test')}")
    if (len(rounds) != 2 or "adopted" not in rounds[0] or not promoted
            or (best["val_f1"] > 0 and not same)):
        raise AssertionError(f"self_train: {report}")


def _trainers_legacy(drive, data: Path, d: Path, checks: dict) -> None:
    from dfu_multimodal_tpu_torch.cli import train_legacy
    checks["legacy"].check()
    for variant in ("gated_fusion", "rgb_resnet_fusion", "single_rgb",
                    "smoke"):
        res = drive(f"train_legacy {variant}", set(), train_legacy.main, [
            "--variant", variant, "--data-dir", str(data),
            "--checkpoint-root", str(d / "legacy"), "--epochs", "1",
            "--save-last"])
        ckpt = d / "legacy" / f"checkpoints_legacy_{variant}"
        if not ((ckpt / "last_model.pt").exists()
                and np.isfinite(res["test_loss"])):
            raise AssertionError(f"train_legacy {variant}: {res}")


def _reference_layout(state: dict) -> dict:
    """The port's rgb_only state as the reference saves it: the trunk
    under ``backbone.``, the head a Sequential(Dropout, Linear)'s
    ``backbone.fc.1``."""
    return {("backbone.fc.1." + k[len("head."):]) if k.startswith("head.")
            else "backbone." + k[len("resnet."):]: v
            for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def _trainers_convert(drive, dev, d: Path) -> dict:
    """convert_checkpoint of a reference-layout rgb_only .pt written from
    seeded weights: the converted checkpoint's logits on the card equal
    to the source's loaded into the same module (limit 0), beside a
    control."""
    from dfu_multimodal_tpu_torch.cli import convert_checkpoint
    from dfu_multimodal_tpu_torch.config import rgb_modality
    src = Trainer("rgb_only", TrainConfig(), {"rgb": rgb_modality()},
                  device="cpu", image_size=IMAGE)
    zoo.init_model(src.module, torch.Generator().manual_seed(27))
    with torch.no_grad():
        _perturb_batchnorm(src.module, torch.Generator().manual_seed(28))
    ref_pt = d / "reference" / "best_model.pt"
    ref_pt.parent.mkdir(parents=True)
    torch.save({"model_state_dict": _reference_layout(
        src.module.state_dict()), "epoch": 5, "val_f1": 0.5}, ref_pt)
    out = d / "converted"
    drive("convert_checkpoint rgb_only", set(), convert_checkpoint.main, [
        "--model", "rgb_only", "--torch-checkpoint", str(ref_pt),
        "--output", str(out)])
    tr = Trainer("rgb_only", TrainConfig(), {"rgb": rgb_modality()},
                 device=dev, image_size=IMAGE)
    images = np.random.default_rng(29).integers(
        0, 256, (TRAINER_ROWS, IMAGE, IMAGE, 3), dtype=np.uint8)
    x = eval_normalize(torch.from_numpy(images).to(dev), rgb_modality(),
                       tr.compute_dtype)
    tr.module.eval()
    with torch.no_grad():
        tr.module.load_state_dict(src.module.state_dict())
        ref = tr.module(x).float().cpu()
        tr.load_weights(out)
        got = tr.module(x).float().cpu()
        key = "resnet.layer4.2.conv3.weight"
        state = tr.module.state_dict()
        tr.module.load_state_dict({**state, key: 2 * state[key]})
        bad = tr.module(x).float().cpu()
    err, bad_err = float((got - ref).abs().max()), _rel_err(bad, ref)
    log(f"[trainers] convert_checkpoint: logits on the card, converted vs "
        f"the source in the same module: max |d| {err} (limit 0); control "
        f"({key} doubled) {bad_err:.3e}")
    if err != 0.0 or bad_err == 0.0:
        raise AssertionError(f"convert_checkpoint: {err}, {bad_err}")
    return {"logits": err, "control": bad_err}


def phase_trainers(dev, d: Path) -> dict:
    """Phase 20 on phase 12's tree and checkpoints (``d``): pretrain,
    warm starts, distill, self_train, train_legacy and convert_checkpoint
    through their ``main(argv)`` at full width, 224², each new step's
    first outputs against the CPU's fp32 beside a control, with no plain
    version called on the card.  Returns the drives' launches by kernel
    (the kernels line's ``trainer_launches``)."""
    from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                      load_single_modality)
    t0 = time.perf_counter()
    data, logs = d / "data", d / "logs"
    gpu = card()
    rgb = load_single_modality(data / "rgb", "train", IMAGE, "rgb")
    thermal = load_single_modality(data / "thermal", "train", IMAGE,
                                   "thermal")
    paired = load_paired(data, "train", IMAGE, strategy="pseudo", seed=42)
    pool = load_single_modality(data / "thermal", "test", IMAGE, "thermal")
    rows = lambda ds, m: ds.arrays[m][:TRAINER_ROWS]
    checks = {
        "simclr vit": _ssl_first_step(dev, "simclr vit", "simclr", "vit",
                                      rows(thermal, "thermal")),
        "simclr resnet": _ssl_first_step(dev, "simclr resnet", "simclr",
                                         "resnet", rows(rgb, "rgb")),
        "mae": _ssl_first_step(dev, "mae", "mae", "vit",
                               rows(thermal, "thermal")),
        "distill multimodal": _kd_first_step(dev, logs, "multimodal",
                                             "resnet18_rgb", paired),
        "distill thermal_only": _kd_first_step(dev, logs, "thermal_only",
                                               "resnet18_thermal", thermal),
        "self_train": _pool_first_step(dev, logs, pool.arrays["thermal"]),
        "legacy": _legacy_first_step(dev, paired)}
    log(f"[trainers] the CPU's fp32 references of {len(checks)} first steps "
        f"in {time.perf_counter() - t0:.2f} s (host clock)")
    drive = _Drives(gpu, "trainers")
    with _PlainCalls(RESEARCH_PLAINS) as plain:
        _trainers_pretrain(drive, data, d, checks)
        _trainers_distill(drive, data, logs, d, checks)
        _trainers_self_train(drive, data, d, checks)
        _trainers_legacy(drive, data, d, checks)
        _trainers_convert(drive, dev, d)
        torch.cuda.synchronize()
    log(f"[trainers] launches over the phase's drives {drive.total}; plain "
        f"versions called {plain.calls}")
    if plain.calls:
        raise AssertionError(f"trainers: plain versions ran {plain.calls}")
    del checks
    torch.cuda.empty_cache()
    log(f"[trainers] phase 20 in {time.perf_counter() - t0:.2f} s (host "
        f"clock; {gpu})")
    return drive.total


# ---------------------------------------------------------------- bounds

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(ops: dict, nbytes: float) -> dict:
    """Least time the card could take: the larger of the operations over
    their type's peak rate (``ops`` maps a dtype to its operation count;
    the times of the types add) and the bytes over the memory rate (each
    input read once, each output written once)."""
    t_ops = sum(n / PEAK_FLOPS[dtype] for dtype, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _attention_bwd_bound(b, n, c, write_o=False) -> dict:
    """The bf16 attention backward of B images of N tokens over C = heads
    x D columns: five products (six with K5's O), 2·N²·C operations each
    an image; q, k, v and dO read and dq, dk, dv (and O) written once."""
    return _bound({torch.bfloat16: (12 if write_o else 10) * b * n * n * c},
                  (8 if write_o else 7) * b * n * c * 2)


def _bottleneck_bound(b, hw, cin, cmid, cout) -> dict:
    """K11 in bf16: 2·rows·(Cin·Cmid + 9·Cmid² + Cmid·Cout [+ Cin·Cout])
    operations; x read and the output written once, bf16 weights, fp32
    biases.  The projection variant when Cin != Cout."""
    rows, proj = b * hw * hw, cin != cout
    weights = (cin * cmid + 9 * cmid * cmid + cmid * cout
               + (cin * cout if proj else 0))
    biases = 2 * cmid + cout + (cout if proj else 0)
    return _bound({torch.bfloat16: 2 * rows * weights},
                  2 * (rows * (cin + cout) + weights) + 4 * biases)


def _stage_bound(b, hw, c, cmids) -> dict:
    """K12 in bf16: 2·rows·(2·C·Cmid + 9·Cmid²) operations per block;
    x read and the output written once, each block's bf16 weights and
    fp32 biases read once."""
    rows = b * hw * hw
    weights = sum(2 * c * m + 9 * m * m for m in cmids)
    biases = sum(2 * m + c for m in cmids)
    return _bound({torch.bfloat16: 2 * rows * weights},
                  2 * (2 * rows * c + weights) + 4 * biases)


def kernel_bounds() -> dict:
    """Bounds at each kernel's path shape: K1-K2, the int8 blocks and the
    K6/K9 forwards at the serving batch 8, K3 at batch 8 in fp32, K4-K5,
    K10 and the K6/K9 backwards at the training batch 16, ViT-B/16; K11 at
    batch 8, ResNet-50 stage 3 (identity) and stage 1 block 0
    (projection).  K6/K9 forward: q·kᵀ and P·V, q, k, v read and o
    written; backward: five products, q, k, v and dO read and dq, dk,
    dv written."""
    n, c, hid, heads = 197, 768, 3072, 12
    bf, f32 = 2, 4
    r8, r16 = 8 * n, TRAIN_BATCH * n
    fdims = (2816, 512, 256, 2)
    fw = sum(a * b + b for a, b in zip(fdims[:-1], fdims[1:]))
    attn_flops = 4 * 8 * n * n * c             # q·kᵀ and P·V
    # int8 blocks: x in and out in bf16, int8 weights, fp32 vectors (LN,
    # scales, biases) and, static, the two reciprocal scales
    attn_q8 = ({torch.int8: 2 * r8 * c * 4 * c, torch.bfloat16: attn_flops},
               2 * r8 * c * bf + 4 * c * c + 10 * c * f32)
    mlp_q8 = ({torch.int8: 4 * r8 * c * hid},
              2 * r8 * c * bf + 2 * c * hid + (4 * c + 2 * hid) * f32)
    return {
        "attn_block": _bound(
            {torch.bfloat16: 2 * r8 * c * 4 * c + attn_flops},
            2 * r8 * c * bf + 4 * c * c * bf + 6 * c * f32),
        "mlp_block": _bound(
            {torch.bfloat16: 4 * r8 * c * hid},
            2 * r8 * c * bf + 2 * c * hid * bf + (3 * c + hid) * f32),
        "fused_mlp": _bound(
            {torch.float32: 2 * 8 * sum(
                a * b for a, b in zip(fdims[:-1], fdims[1:]))},
            (8 * fdims[0] + fw + 8 * fdims[-1]) * f32),
        "mlp_block_bwd": _bound(
            {torch.bfloat16: 6 * r16 * c * hid},
            4 * r16 * c * bf + 2 * c * hid * bf + 2 * r16 * hid * bf
            + (4 * c + hid) * f32),
        "qkv_attention_fwdbwd": _attention_bwd_bound(TRAIN_BATCH, n, c, True),
        "qkv_attention_fwd": _bound({torch.bfloat16: attn_flops},
                                    4 * r8 * c * bf),
        "qkv_attention_bwd": _attention_bwd_bound(TRAIN_BATCH, n, c),
        "attn_block_q8": _bound(*attn_q8),
        "mlp_block_q8": _bound(*mlp_q8),
        "attn_block_q8s": _bound(attn_q8[0], attn_q8[1] + 2 * f32),
        "mlp_block_q8s": _bound(mlp_q8[0], mlp_q8[1] + 2 * f32),
        "bottleneck": _bottleneck_bound(8, 14, 1024, 256, 1024),
        "bottleneck_proj": _bottleneck_bound(8, 56, 64, 64, 256),
        "stage": _stage_bound(8, 14, 1024, [256] * 5),
        # K10: qkv 6, dattn 2, dwproj 2, dwqkv 6, dy 6 (units of B·N·C²),
        # attention forward 4 and backward 8 (B·N²·C); x, g read and dx
        # written, the weights read, dwqkv and dwproj written in fp32,
        # LN/bias vectors read and their gradients written in fp32
        "attn_block_bwd_fused": _bound(
            {torch.bfloat16: 22 * r16 * c * c + 12 * TRAIN_BATCH * n * n * c},
            3 * r16 * c * bf + 4 * c * c * bf + 4 * c * c * f32
            + (5 * c + 6 * c) * f32),
    } | {f"flash_attention_{p}": bounds for p, bounds in (
        ("fwd", _bound({torch.bfloat16: attn_flops}, 4 * r8 * c * bf)),
        ("bwd", _attention_bwd_bound(TRAIN_BATCH, n, c)))} | _tome_bounds()


def _tome_bounds() -> dict:
    """The biased K1, K7 and K8 at their phase-16 row's shape: ViT-B/16's
    attention block at B = 8 and N = 128 tokens (``--token-merge 4:128``),
    bf16, as kernel_bounds counts the unbiased blocks, plus the fp32
    (B, N) bias read once."""
    n, c, b, bf, f32 = TOME[1], 768, 8, 2, 4
    rows = b * n
    attn_flops = 4 * b * n * n * c
    q8_bytes = 2 * rows * c * bf + 4 * c * c + 10 * c * f32 + rows * f32
    return {
        "attn_block_bias": _bound(
            {torch.bfloat16: 2 * rows * c * 4 * c + attn_flops},
            2 * rows * c * bf + 4 * c * c * bf + 6 * c * f32 + rows * f32),
        "attn_block_q8_bias": _bound(
            {torch.int8: 2 * rows * c * 4 * c, torch.bfloat16: attn_flops},
            q8_bytes),
        "attn_block_q8s_bias": _bound(
            {torch.int8: 2 * rows * c * 4 * c, torch.bfloat16: attn_flops},
            q8_bytes + 2 * f32)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    times = phase_kernels(dev)
    times.update(phase_backward_kernels(dev))
    times.update(phase_q8_kernels(dev))
    times.update(phase_resnet_kernels(dev))
    attention, launches = phase_attention_kernels(dev)
    times.update(attention)
    k10, k10_launches = phase_k10(dev)
    times.update(k10)
    launches.update(k10_launches)
    stage, stage_launches = phase_stage(dev)
    times.update(stage)
    launches.update(stage_launches)
    launches.update(phase_slice(dev))
    launches.update({k: v for k, v in phase_train(dev).items()
                     if k in ("mlp_block_bwd", "qkv_attention_fwdbwd")})
    launches.update(phase_int8(dev))
    launches.update(phase_rgb(dev))
    launches.update(phase_flax_serve(dev))
    launches.update(phase_flax_train(dev))
    phase_large_images(dev)
    phase_train_all(dev)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    times.update(phase_q8_conv(dev))
    # the int8 trunk's main path: conv_q8's and quantize_act_q8's launches
    # (K7's and K3's stand from phases 6 and 4)
    q8_serve = phase_q8_serve(dev)
    for k in ("conv_q8", "quantize_act_q8"):
        launches[k] = q8_serve[k]
    # the token-merged path's biased K1/K7/K8: its rows and launches
    tome = phase_tome(dev)
    for k, row in tome.items():
        launches[k] = row.pop("launches")
        times[k] = row
    with tempfile.TemporaryDirectory(dir=build) as d:
        phase_train_disk(dev, Path(d))
        phase_artifacts(dev, Path(d))
        explain = phase_explain(dev, Path(d))
        phase_q8_cli(dev, Path(d))
        phase_tome_cli(dev, Path(d))
        export = phase_export(dev, Path(d))
        students = phase_students(dev, Path(d))
        research = phase_research(dev, Path(d))
        trainers = phase_trainers(dev, Path(d))
    for mod in ("jax", "flax", "optax", "PIL", "torchvision", "matplotlib",
                "sklearn", "cv2", "dfu_multimodal_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")
    bounds = kernel_bounds()
    sources = {
        "attn_block": ("vit_block.cu", "vit_block.py:122"),
        "mlp_block": ("vit_block.cu", "vit_block.py:564"),
        "fused_mlp": ("fused_mlp.cu", "fused_mlp.py:27"),
        "mlp_block_bwd": ("gemm_sm90.cuh", "vit_block.py:652"),
        "qkv_attention_fwdbwd": ("attention_bwd_mma.cuh",
                                 "attention.py:334"),
        "qkv_attention_fwd": ("attention_fwd_mma.cuh", "attention.py:208"),
        "qkv_attention_bwd": ("attention_bwd_mma.cuh", "attention.py:222"),
        "attn_block_q8": ("vit_block_q8.cu", "vit_block_q8.py:70"),
        "mlp_block_q8": ("vit_block_q8.cu", "vit_block_q8.py:107"),
        "attn_block_q8s": ("vit_block_q8.cu", "vit_block_q8.py:157"),
        "mlp_block_q8s": ("vit_block_q8.cu", "vit_block_q8.py:202"),
        "flash_attention_fwd": ("attention_fwd_mma.cuh", "attention.py:73"),
        "flash_attention_bwd": ("attention_bwd_mma.cuh", "attention.py:88"),
        "bottleneck": ("resnet_block.cu", "resnet_block.py:108"),
        "bottleneck_proj": ("resnet_block.cu", "resnet_block.py:130"),
        "attn_block_bwd_fused": ("attn_block_bwd.cu", "vit_block.py:264"),
        "stage": ("resnet_block.cu", "resnet_block.py:116"),
        "conv_q8": ("conv_q8.cu", "resnet_q8.py:59 (_QConv, an XLA conv)"),
        "quantize_act_q8": ("conv_q8.cu",
                            "resnet_q8.py:44 (quantize_act, XLA ops)"),
        # K1, K7 and K8 with ToMe's key bias (their bias_ref operand)
        "attn_block_bias": ("vit_block.cu", "vit_block.py:122"),
        "attn_block_q8_bias": ("vit_block_q8.cu", "vit_block_q8.py:70"),
        "attn_block_q8s_bias": ("vit_block_q8.cu", "vit_block_q8.py:157")}
    # library_ms: SDPA's time where one call computes the kernel's
    # function (the K6/K9 forwards), else null (no single PyTorch call
    # computes K10: its row carries the K5 chain rule's time as chain_ms)
    kernels = [{"name": k, "route": "cuda",
                "source": f"dfu_multimodal_tpu_torch/ops/csrc/{src}",
                "replaces": (f"dfu_multimodal_tpu/models/{tpu}"
                             if tpu.startswith("resnet_q8") else
                             f"dfu_multimodal_tpu/ops/{tpu}"),
                "launches": launches[k], "library_ms": None, **times[k],
                **bounds.get(k, {}), **({"explain_launches": explain[k]}
                                        if k in explain else {}),
                **({"export_launches": export[k]} if k in export else {}),
                **({"student_launches": students[k]}
                   if k in students else {}),
                **({"research_launches": research[k]}
                   if k in research else {}),
                **({"trainer_launches": trainers[k]}
                   if k in trainers else {})}
               for k, (src, tpu) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
